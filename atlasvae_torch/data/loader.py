"""Sample loading: HDF5 -> dict of float32 numpy arrays with derived kinematics.

Counterpart of ``load_data``, ``sample_cuts``, ``make_sample``, ``filtering``
and ``HLV_LIST`` of ``atlasvae/data/loader.py``.  The
per-jet constituent math runs in torch on ``device`` (data/jets.py); cuts
use the safe cut DSL (utils/expr.py).
"""

import time

import numpy as np

from ..utils.expr import evaluate_cut, CutError
from . import hdf5
from .registry import get_file
from .jets import sort_constituents_by_pt, pad_constituents, jets_4v, drop_energy_component

# Canonical high-level-variable list.
HLV_LIST = [
    "rljet_Tau1_wta", "rljet_Tau2_wta", "rljet_Tau3_wta", "rljet_eta",
    "rljet_ECF3", "ECF2", "d12", "d23", "pt", "m", "tau21", "tau32",
]


def _on(flag):
    """Accept 'ON'/'OFF' strings or booleans."""
    if isinstance(flag, str):
        return flag.upper() == "ON"
    return bool(flag)


def load_data(data_type, idx, cuts=(), n_const=20, n_dims=3, constituents="OFF",
              hlvs="ON", hlv_list=None, var_list=None, dsids=None,
              adjust_weights=False, verbose=True, pt_scaling=False, device="cuda"):
    """Load a slice of one sample into a dict of float32 numpy arrays.

    Slice the HDF5 by index range, pt-sort + pad constituents, derive
    (pt, m) from constituent sums when absent, default JZW/weights, apply
    cuts, optionally drop the energy component (n_dims=3) and assemble the
    HLV matrix with tau21/tau32.  ``adjust_weights`` scales the weights by
    the cross-section JZW-slice factors (data/weights.py).
    """
    start = time.time()
    if np.isscalar(idx):
        idx = (0, int(idx))
    hlv_list = list(hlv_list) if hlv_list is not None else list(HLV_LIST)
    data_file = get_file(data_type)
    with hdf5.File(data_file, "r") as data:
        if verbose:
            print("Loading", data_file.split("/")[-1], end="", flush=True)
        keys = set(data.keys()) if var_list is None else set(data.keys()) & set(var_list)
        sample = {
            key: np.asarray(data[key][idx[0]:idx[1]])
            for key in keys if "constituents" not in key
        }
        # derive from constituents when either kinematic family is missing
        need_derived = (
            len(set(sample) & {"rljet_pt_comb", "pt_calo"}) == 0
            or len(set(sample) & {"rljet_m_comb", "m_calo"}) == 0)
        if _on(constituents) or need_derived:
            raw = np.asarray(data["constituents"][idx[0]:idx[1], :])
            sorted_const = sort_constituents_by_pt(raw, device)
            if _on(constituents):
                sample["constituents"] = pad_constituents(sorted_const, n_const)
                if need_derived:
                    # derived kinematics use the truncated constituents
                    sample.update(jets_4v(sample["constituents"], device))
            elif need_derived:
                sample.update(jets_4v(sorted_const, device))

    sample["pt"] = sample.pop("rljet_pt_comb" if "rljet_pt_comb" in sample else "pt_calo")
    sample["m"] = sample.pop("rljet_m_comb" if "rljet_m_comb" in sample else "m_calo")
    size = len(next(iter(sample.values())))
    if "JZW" not in sample:
        sample["JZW"] = np.full(size, 0.0 if "QCD" in str(data_type).upper() else -1.0,
                                dtype=np.float32)
    if "weights" not in sample:
        sample["weights"] = np.full(size, 1.0, dtype=np.float32)

    sample = sample_cuts(sample, cuts, dsids)

    if adjust_weights:
        from .weights import weights_factors
        sample["weights"] = sample["weights"] * weights_factors(sample["JZW"], data_file)
    if pt_scaling and "constituents" in sample:
        sample["constituents"] = sample["constituents"] / np.float32(sample["pt"][:, None])
    if "constituents" in sample and n_dims == 3:
        sample["constituents"] = drop_energy_component(sample["constituents"])
    if verbose:
        print(f" ({time.time() - start:2.1f} s)")
    if _on(hlvs):
        if "tau21" in hlv_list:
            sample["tau21"] = sample["rljet_Tau2_wta"] / np.maximum(sample["rljet_Tau1_wta"], 1e-16)
        if "tau32" in hlv_list:
            sample["tau32"] = sample["rljet_Tau3_wta"] / np.maximum(sample["rljet_Tau2_wta"], 1e-16)
        sample["HLVs"] = np.hstack(
            [np.float32(sample[key])[:, None] for key in hlv_list]
        )
    return sample


def sample_cuts(sample, cuts, dsids=None):
    """Apply DSL cut strings + optional DSID selection."""
    size = len(next(iter(sample.values())))
    masks = [np.full(size, True)]
    for cut in cuts or ():
        if not cut:
            continue
        try:
            masks.append(evaluate_cut(cut, sample))
        except CutError as exc:
            print(f"WARNING: invalid cut: {cut} ({exc})")
    mask = np.logical_and.reduce(masks)
    if dsids is not None:
        if np.isscalar(dsids):
            dsids = [dsids]
        dsid_mask = np.logical_or.reduce([sample["DSID"] == int(n) for n in dsids])
        mask = np.logical_and(mask, dsid_mask)
    if not np.all(mask):
        sample = {key: val[mask] for key, val in sample.items()}
    return sample


def make_sample(bkg_data, sig_data, bkg_idx=1, sig_idx=1, cuts=(), n_const=20, n_dims=4,
                constituents="ON", hlvs="ON", hlv_list=None, var_list=None, dsids=None,
                adjust_weights=False, shuffling=False, verbose=True, device="cuda"):
    """Concatenated background+signal sample, optionally shuffled (numpy,
    seed 0: the same order as the JAX package's)."""
    sig_sample = load_data(sig_data, sig_idx, cuts, n_const, n_dims, constituents, hlvs,
                           hlv_list, var_list, dsids, adjust_weights, verbose, device=device)
    bkg_sample = load_data(bkg_data, bkg_idx, cuts, n_const, n_dims, constituents, hlvs,
                           hlv_list, var_list, dsids, adjust_weights, verbose, device=device)
    if "OoD" in str(sig_data):
        from .pairing import ood_sampling
        sig_sample = ood_sampling(bkg_sample, sig_sample)
    keys = sorted(set(bkg_sample) & set(sig_sample))
    sample = {key: np.concatenate([bkg_sample[key], sig_sample[key]]) for key in keys}
    if shuffling:
        order = np.random.default_rng(0).permutation(len(sample[keys[0]]))
        sample = {key: val[order] for key, val in sample.items()}
    return sample


def filtering(y_true, x_true, x_pred, sample):
    """Drop rows whose predictions are non-finite before metrics."""
    good = np.all(np.isfinite(x_pred), axis=tuple(range(1, x_pred.ndim)))
    sample = {key: val[good] for key, val in sample.items()}
    return y_true[good], x_true[good], x_pred[good], sample
