"""Binning helper.  Copy of ``bin_edges`` from ``atlasvae/utils/chunks.py``
(the port imports nothing of the JAX package)."""

import numpy as np


def bin_edges(max_val, bin_size, min_val=0.0):
    """Float bin edges [min_val, min_val+bin_size, ..., max_val]."""
    return np.append(np.arange(min_val, max_val, bin_size), max_val)
