from .expr import evaluate_cut, CutError

__all__ = ["evaluate_cut", "CutError"]
