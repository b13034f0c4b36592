"""Gaussian fit of the per-bin significance profile
(ref OE-VAE/utils.py:514-529 ``Gaussian``/``fit_gaussian``; a copy of
``atlasvae/stats/fit.py``, numpy and scipy on the host)."""

import warnings

import numpy as np
from scipy import optimize


def gaussian(x, a, b, c):
    return a * np.exp(-((x - b) ** 2) / (2 * c ** 2))


def fit_gaussian(bins, bin_sigma, bump_range=None):
    """Fit a Gaussian to bin-center vs bin-significance points.

    Returns (A_approx, B_approx, C_approx, height, mean, std) exactly as
    the reference (normalized-coordinates curve_fit after seeding with
    the max/argmax/variance approximations, ref OE-VAE/utils.py:516-529).
    """
    x_val = (np.asarray(bins[:-1]) + np.asarray(bins[1:])) / 2
    y_val = np.asarray(bin_sigma, dtype=np.float64)
    if bump_range is None:
        sel = x_val != 0
    else:
        try:
            sel = np.logical_and(x_val >= bump_range[0], x_val <= bump_range[1])
        except Exception:
            sel = np.full_like(x_val, True, dtype=bool)
    x_val, y_val = x_val[sel], y_val[sel]
    a_approx = np.max(y_val)
    b_approx = x_val[np.argmax(y_val)]
    c_approx = np.sqrt(np.var(x_val))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xn = (x_val - b_approx) / c_approx
        yn = y_val / a_approx
        height, mean, std = optimize.curve_fit(gaussian, xn, yn)[0]
    return a_approx, b_approx, c_approx, height, mean, std
