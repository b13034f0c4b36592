"""Index-range and binning helpers.  Copies of ``index_ranges``,
``bin_edges``, ``density_weights`` and ``merged_bins`` from
``atlasvae/utils/chunks.py`` (the port imports nothing of the JAX package)."""

import numpy as np


def index_ranges(max_val, n_bins=10, bin_size=None, min_val=0):
    """Split [min_val, max_val) into contiguous (start, stop) tuples:
    ``bin_size`` wins over ``n_bins``; the final range is clipped to
    ``max_val``; an empty range gives no chunks."""
    if max_val <= min_val:
        return []
    if bin_size is None:
        n_bins = max(1, min(int(max_val - min_val), n_bins))
        bin_size = (max_val - min_val) // n_bins
    edges = np.append(np.arange(min_val, max_val, bin_size), max_val)
    edges = edges.astype(np.int64)
    return list(zip(edges[:-1], edges[1:]))


def bin_edges(max_val, bin_size, min_val=0.0):
    """Float bin edges [min_val, min_val+bin_size, ..., max_val]."""
    return np.append(np.arange(min_val, max_val, bin_size), max_val)


def density_weights(values, weights, bins):
    """Divide histogram weights by their bin's width (the per-GeV density
    of the distribution plots).  Out-of-range values clip to the nearest
    edge bin, never wrap to the other end."""
    idx = np.searchsorted(bins, values, side="right")
    widths = np.diff(bins)
    return np.asarray(weights, np.float64) / np.take(
        widths, np.clip(idx - 1, 0, len(widths) - 1))


def merged_bins(values, edges=None, max_bins=100, min_bin_count=2, logspace=True):
    """Adaptive histogram bins with a minimum per-bin occupancy.

    Starts from log- (or lin-) spaced edges and removes interior edges of
    under-populated bins until every bin holds >= min_bin_count entries
    (ref OE-VAE/utils.py:502-513 ``get_bins``).  The reference's loop can
    spin forever when even the fully-merged bin is sparse; here merging
    stops once two edges remain (bug fix noted in SURVEY.md S7).
    """
    values = np.asarray(values)
    if edges is None:
        lo, hi = float(np.min(values)), float(np.max(values))
        if logspace:
            edges = np.logspace(np.log10(max(lo, 1e-12)), np.log10(max(hi, 1e-12)), num=max_bins)
        else:
            edges = np.linspace(lo, hi, num=max_bins)
    edges = np.asarray(edges, dtype=np.float64)
    min_count = max(2, min_bin_count)
    # One digitize; deleting an interior edge merges two bins, which on
    # the count array is a single addition — equivalent to the
    # reference's re-digitize-per-deletion loop at O(bins^2) instead of
    # O(bins^2 * n).
    idx = np.clip(np.digitize(values, edges), 1, len(edges) - 1) - 1
    counts = list(np.bincount(idx, minlength=len(edges) - 1))
    edges = list(edges)
    while len(edges) > 2:
        sparse = [i for i, c in enumerate(counts) if c < min_count]
        if not sparse:
            break
        drop = sparse[-1]
        if drop > 0:  # merge bin `drop` into its left neighbor
            counts[drop - 1] += counts[drop]
            del counts[drop]
            del edges[drop]
        else:  # first bin sparse: merge into the right neighbor
            counts[1] += counts[0]
            del counts[0]
            del edges[1]
    return np.asarray(edges)
