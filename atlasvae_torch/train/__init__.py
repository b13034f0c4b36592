from .loop import features
from .checkpoint import save_pytree, load_pytree, save_weights, load_weights

__all__ = ["features", "save_pytree", "load_pytree", "save_weights", "load_weights"]
