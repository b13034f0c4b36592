from .registry import get_file, register_file, DATA_FILES
from .loader import (load_data, sample_cuts, make_sample, merge_samples, split_sample,
                     filtering, HLV_LIST)
from .jets import (sort_constituents_by_pt, pad_constituents, jets_4v, jets_3v,
                   drop_energy_component, count_constituents,
                   constituent_pt_cumulative, constituent_images)
from . import hdf5
from .scalers import fit_scaler, apply_scaler, inverse_scaler, Scaler
from .synthetic import make_synthetic_dataset, ensure_synthetic_registry
from .pairing import ood_pairing, ood_sampling
from .weights import reweight_sample, get_weights, weights_factors
from .generator import BatchGenerator

__all__ = [
    "hdf5", "get_file", "register_file", "DATA_FILES",
    "load_data", "sample_cuts", "make_sample", "merge_samples", "split_sample", "filtering",
    "HLV_LIST",
    "sort_constituents_by_pt", "pad_constituents", "jets_4v", "jets_3v",
    "drop_energy_component", "count_constituents", "constituent_pt_cumulative",
    "constituent_images",
    "fit_scaler", "apply_scaler", "inverse_scaler", "Scaler",
    "make_synthetic_dataset", "ensure_synthetic_registry",
    "ood_pairing", "ood_sampling", "reweight_sample", "get_weights", "weights_factors",
    "BatchGenerator",
]
