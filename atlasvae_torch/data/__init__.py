from .registry import get_file, register_file, DATA_FILES
from .loader import load_data, sample_cuts, filtering, HLV_LIST
from .jets import (sort_constituents_by_pt, pad_constituents, jets_4v,
                   drop_energy_component)
from . import hdf5
from .scalers import fit_scaler, apply_scaler, inverse_scaler, Scaler
from .synthetic import make_synthetic_dataset, ensure_synthetic_registry
from .pairing import ood_pairing, ood_sampling
from .weights import reweight_sample, get_weights, weights_factors
from .generator import BatchGenerator

__all__ = [
    "hdf5", "get_file", "register_file", "DATA_FILES",
    "load_data", "sample_cuts", "filtering", "HLV_LIST",
    "sort_constituents_by_pt", "pad_constituents", "jets_4v", "drop_energy_component",
    "fit_scaler", "apply_scaler", "inverse_scaler", "Scaler",
    "make_synthetic_dataset", "ensure_synthetic_registry",
    "ood_pairing", "ood_sampling", "reweight_sample", "get_weights", "weights_factors",
    "BatchGenerator",
]
