"""Mass decorrelation: per-(m, pt)-bin CDF flattening of the discriminant.

Re-implements the reference's decorrelation engine
(ref OE-VAE/plots.py:54-85: adaptive ``get_bins``, ``cum_distribution``
empirical-CDF interpolators, ``mass_deco`` 1d/2d flattening).  The
per-cell empirical CDF evaluation is vectorized with sorted
searchsorted + interpolation instead of scipy interp1d objects; cells
are processed host-side (there are O(100) of them, each a vectorized
numpy op over its members).  A copy of ``atlasvae/eval/deco.py``: numpy on
the host.
"""

import numpy as np

from ..utils.chunks import merged_bins


def cum_distribution(reference_values):
    """Empirical CDF of a reference set as (values, cdf) interp tables
    (ref OE-VAE/plots.py:65-67: unique values with a prepended 0, linear
    interpolation, clamped to [0, 1])."""
    if len(reference_values) == 0:  # empty cell -> identity map
        return np.array([0.0, 1.0]), np.array([0.0, 1.0])
    values, counts = np.unique(reference_values, return_counts=True)
    values = np.insert(values, 0, 0.0)
    cdf = np.insert(np.cumsum(counts) / len(reference_values), 0, 0.0)
    return values, cdf


def _apply_cdf(table, x):
    values, cdf = table
    return np.interp(x, values, cdf, left=0.0, right=1.0)


def _bins(values, deco):
    if not deco:
        return np.array([np.min(values), np.max(values)])
    return merged_bins(values, max_bins=100, min_bin_count=2, logspace=True)


def mass_deco(y_true, sample, x_loss, deco="2d"):
    """Flatten the loss inside (m, pt) cells of the *background*, applied
    to everything (ref OE-VAE/plots.py:68-85: CDFs fit on y_true==1 jets,
    then evaluated on the full sample)."""
    x_loss = np.array(x_loss, dtype=np.float64)
    mass_b = sample["m"][y_true == 1]
    pt_b = sample["pt"][y_true == 1]
    loss_b = x_loss[y_true == 1]

    m_bins = _bins(mass_b, deco != "pt")
    pt_bins = [
        _bins(pt_b[(mass_b >= lo) & (mass_b < hi)], deco != "m")
        for lo, hi in zip(m_bins[:-1], m_bins[1:])
    ]
    m_idx_b = np.clip(np.digitize(mass_b, m_bins), 1, len(m_bins) - 1) - 1
    pt_idx_b = [np.clip(np.digitize(pt_b, bins), 1, len(bins) - 1) - 1
                for bins in pt_bins]
    cdf_tables = [
        [cum_distribution(loss_b[(m_idx_b == m) & (pt_idx_b[m] == n)])
         for n in range(int(np.max(pt_idx_b[m])) + 1)]
        for m in range(len(pt_bins))
    ]

    mass, pt = sample["m"], sample["pt"]
    m_idx = np.clip(np.digitize(mass, m_bins), 1, len(m_bins) - 1) - 1
    pt_idx = [np.clip(np.digitize(pt, bins), 1, len(bins) - 1) - 1
              for bins in pt_bins]
    out = x_loss.copy()
    for m in range(len(pt_bins)):
        for n in range(len(cdf_tables[m])):
            sel = (m_idx == m) & (pt_idx[m] == n)
            if np.any(sel):
                out[sel] = _apply_cdf(cdf_tables[m][n], x_loss[sel])
    return out
