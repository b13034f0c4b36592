from .expr import evaluate_cut, CutError
from .chunks import bin_edges
from .logging import args_banner

__all__ = ["evaluate_cut", "CutError", "bin_edges", "args_banner"]
