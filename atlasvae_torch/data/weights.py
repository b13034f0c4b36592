"""Event reweighting: cross-section, flat, and OoD-matching schemes.

Copy of ``atlasvae/data/weights.py`` in numpy, with the behaviour it keeps
for parity (PARITY.md section 2.1): the ``flat`` branch's second
``get_weights`` call with weight_type '2d', and the 1e4 cap on ratio
weights.  ``weights_factors`` reads the sample file through
``data/hdf5.py``.
"""

import numpy as np

from ..utils.chunks import bin_edges
from . import hdf5


def reweight_sample(bkg_sample, sig_sample, bin_sizes, weight_type="X-S"):
    """Apply one weighting scheme to (background, OoD/signal) in place.

    Schemes:
      None    : unit weights for both samples
      X-S     : cross-section weights; signal normalized to background sum
      flat_m / flat_pt / flat_2d : flatten both samples in (m, pt)
      OoD_m / OoD_pt / OoD_2d    : reweight OoD to match the background
    """
    if weight_type is None or str(weight_type).lower() == "none":
        sig_sample["weights"] = np.ones_like(sig_sample["weights"])
        bkg_sample["weights"] = np.ones_like(bkg_sample["weights"])
    if "flat" in str(weight_type):
        sig_sample["weights"] = get_weights(bkg_sample, sig_sample, bin_sizes, weight_type)
        bkg_sample["weights"] = get_weights(bkg_sample, bkg_sample, bin_sizes, weight_type)
        # kept for parity: the signal is re-derived as a 2d ratio against
        # the freshly flattened background
        sig_sample["weights"] = get_weights(bkg_sample, sig_sample, bin_sizes, weight_type="2d")
    if "OoD" in str(weight_type):
        sig_sample["weights"] = get_weights(bkg_sample, sig_sample, bin_sizes, weight_type)
    if weight_type == "X-S":
        sig_sample["weights"] = sig_sample["weights"] * (
            np.sum(bkg_sample["weights"]) / np.sum(sig_sample["weights"])
        )
    return bkg_sample, sig_sample


def get_weights(bkg_sample, sig_sample, bin_sizes, weight_type, max_val=1e4, density=True):
    """Histogram-ratio weights on the (m, pt) plane."""
    m_size, pt_size = bin_sizes["m"], bin_sizes["pt"]
    m_bkg, pt_bkg, w_bkg = (bkg_sample[k] for k in ("m", "pt", "weights"))
    m_sig, pt_sig, w_sig = (sig_sample[k] for k in ("m", "pt", "weights"))
    m_min, pt_min = np.min(m_sig), np.min(pt_sig)
    m_max, pt_max = np.max(m_sig), np.max(pt_sig)
    # 1D variants collapse the other axis to a single bin
    if "m" in weight_type:
        pt_size = pt_max + 1
    if "pt" in weight_type:
        m_size = m_max + 1
    m_bins = bin_edges(m_max, m_size, m_min)
    pt_bins = bin_edges(pt_max, pt_size, pt_min)
    m_idx = np.clip(np.digitize(m_sig, m_bins, right=False), 1, len(m_bins) - 1) - 1
    pt_idx = np.clip(np.digitize(pt_sig, pt_bins, right=False), 1, len(pt_bins) - 1) - 1
    hist_sig = np.histogram2d(m_sig, pt_sig, bins=[m_bins, pt_bins], density=density)[0]
    if density:
        hist_sig *= len(m_sig)
    hist_sig = np.maximum(hist_sig, np.min(hist_sig[hist_sig != 0]) if density else 1)
    if "flat" in weight_type:
        weights = (1.0 / hist_sig)[m_idx, pt_idx]
        return weights * np.sum(w_sig) / np.sum(weights)
    hist_bkg = np.histogram2d(m_bkg, pt_bkg, bins=[m_bins, pt_bins],
                              weights=w_bkg, density=density)[0]
    if density:
        hist_bkg *= len(m_bkg)
    weights = (hist_bkg / hist_sig)[m_idx, pt_idx]
    return np.minimum(max_val, weights * np.sum(w_bkg) / np.sum(weights))


def weights_factors(jzw, data_file):
    """Cross-section JZW-slice scale factors."""
    jzw = np.asarray(jzw)
    if np.all(jzw == -1) or np.all(jzw == 0):
        with hdf5.File(data_file, "r") as f:
            total = len(f[next(iter(f.keys()))])
        return total / len(jzw)
    with hdf5.File(data_file, "r") as f:
        file_jzw = np.asarray(f["JZW"][:]).astype(np.int64)
    n_jzw = [np.sum(file_jzw == n) for n in range(int(np.max(file_jzw)) + 1)]
    factors = np.ones_like(jzw, dtype=np.float32)
    for n in range(len(n_jzw)):
        count = np.sum(jzw == n)
        if count != 0:
            factors[jzw == n] = n_jzw[n] / count
    return factors
