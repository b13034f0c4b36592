from .expr import evaluate_cut, CutError
from .chunks import bin_edges, index_ranges
from .logging import args_banner

__all__ = ["evaluate_cut", "CutError", "bin_edges", "index_ranges", "args_banner"]
