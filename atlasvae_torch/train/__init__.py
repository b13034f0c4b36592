from .loop import features, train_model, model_checkpoint
from .checkpoint import (save_pytree, load_pytree, save_weights, load_weights, save_history,
                         load_history)
from .step import (make_vae_step_fns, clip_gradients, batch_load, Adam, TrainState,
                   LoadCache)
from .keras_import import (load_keras_vae, load_keras_aae, load_keras_jetid,
                           read_keras_weights)

__all__ = ["features", "train_model", "model_checkpoint", "save_pytree", "load_pytree",
           "save_weights", "load_weights", "save_history", "load_history",
           "make_vae_step_fns", "clip_gradients", "batch_load", "Adam", "TrainState",
           "LoadCache", "load_keras_vae", "load_keras_aae", "load_keras_jetid",
           "read_keras_weights"]
