from .lorentz import (pt_eta_phi_m_to_epxpypz, canonicalize_jets,
                      pt_order_jets, summed_4v)
from .merging import file_processing, mix_samples, merge_files
from .source import open_tree
from . import rootio, branches

__all__ = [
    "pt_eta_phi_m_to_epxpypz", "canonicalize_jets", "pt_order_jets",
    "summed_4v",
    "file_processing", "mix_samples", "merge_files",
    "open_tree", "rootio", "branches",
]
