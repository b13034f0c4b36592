"""The port's log-space incomplete gamma and sigma inversion
(``atlasvae_torch/ops/gammainc.py``) against ``atlasvae.ops.gammainc`` on
the CPU, and against independent truth.

Tolerances:
- port against JAX over the sweep grid of tests/test_gammainc_sweep.py:
  |d log p| / max(|log p|, 1) <= 1e-5 (float32 ulps of two libraries'
  exp/log/lgamma/erfc);
- port against mpmath (dps 40, the long-double oracle where mpmath does not
  converge): < 2e-5, the bar the JAX package is held to;
- sigma_from_log_pval against JAX for log p in [-1e6, 0]: rtol 1e-5 plus
  two float32 ulps of p = exp(log p) carried through dsigma/dp = 1/phi(sigma)
  (near p = 1 the two libraries' exp part by an ulp and 1 - p cancels);
  against scipy.stats.norm.isf: rtol 2e-3 (tests/test_stats.py:50) where
  1 - p keeps its bits in float32 (log p < -1e-3);
- _ndtri and log_erfc against JAX: atol 1e-6 + rtol 1e-6.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from scipy.stats import norm

from atlasvae.ops import gammainc as jax_gammainc
from atlasvae_torch.ops import gammainc
from torch_gaps import assert_close

A_GRID = [1, 2, 3, 5, 10, 30, 100, 200, 399, 400, 401, 500,
          1e3, 3e3, 1e4, 1e5, 1e6]
RATIO_GRID = [0.01, 0.05, 0.1, 0.3, 0.5, 0.8, 0.9, 0.99, 1.0, 1.01,
              1.1, 1.5, 2, 5, 10, 100]


def _grid():
    pairs = list(itertools.product(A_GRID, RATIO_GRID))
    aa = np.array([a for a, _ in pairs], np.float64)
    return aa, aa * np.array([r for _, r in pairs])


def _rel_log_err(ours, true):
    return np.abs(ours - true) / np.maximum(np.abs(true), 1.0)


def _port(fn, *args):
    return fn(*(torch.as_tensor(a) for a in args)).double().numpy()


@pytest.mark.parametrize("name", ["log_gammainc_lower", "log_gammainc_upper"])
def test_log_gammainc_matches_jax_over_the_sweep_grid(name):
    aa, xx = _grid()
    want = np.asarray(jax.jit(getattr(jax_gammainc, name))(aa, xx), np.float64)
    got = _port(getattr(gammainc, name), aa, xx)
    assert np.isfinite(got).all()
    assert _rel_log_err(got, want).max() <= 1e-5


def test_log_gammainc_matches_mpmath():
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 40
    from atlasvae.stats.native import oracle_log_gammainc

    aa, xx = _grid()

    def mp_one(a, x, lower):
        try:
            v = (mpmath.gammainc(a, 0, x, regularized=True) if lower
                 else mpmath.gammainc(a, x, mpmath.inf, regularized=True))
            return -1e30 if v <= 0 else float(mpmath.log(v))
        except Exception:  # hypergeometric non-convergence at extremes
            return None

    for lower, fn in ((True, gammainc.log_gammainc_lower),
                      (False, gammainc.log_gammainc_upper)):
        true = np.array([np.nan if (v := mp_one(a, x, lower)) is None else v
                         for a, x in zip(aa, xx)])
        if np.isnan(true).any():
            true = np.where(np.isnan(true), oracle_log_gammainc(aa, xx, lower=lower), true)
        assert _rel_log_err(_port(fn, aa, xx), true).max() < 2e-5


def test_log_gammainc_edges_match_jax():
    """x <= 0, a <= 0 and the a = 400 switch, broadcasting a scalar a."""
    a = np.array([0.0, 0.0, 1.0, 5.0, 400.0, 400.0, 401.0, 401.0], np.float32)
    x = np.array([0.0, 3.0, 0.0, -1.0, 380.0, 420.0, 380.0, 420.0], np.float32)
    for name in ("log_gammainc_lower", "log_gammainc_upper"):
        want = np.asarray(jax.jit(getattr(jax_gammainc, name))(a, x))
        got = _port(getattr(gammainc, name), a, x)
        assert_close(got, want, name, rtol=1e-5, atol=1e-6)
    got = gammainc.log_gammainc_lower(torch.tensor(7.0), torch.tensor([1.0, 7.0, 30.0]))
    want = jax.jit(jax_gammainc.log_gammainc_lower)(7.0, np.array([1.0, 7.0, 30.0]))
    assert_close(got, want, "scalar a", rtol=1e-5, atol=1e-6)


def test_sigma_from_log_pval_matches_jax_and_scipy():
    log_p = np.concatenate([-np.logspace(-7, 6, 400), [0.0, -60.0, -60.1]]).astype(np.float32)
    want = np.asarray(jax.jit(jax_gammainc.sigma_from_log_pval)(log_p), np.float64)
    got = _port(gammainc.sigma_from_log_pval, log_p)
    p = np.exp(np.maximum(log_p, -60.0)).astype(np.float32)
    pdf = norm.pdf(want)
    ulp_term = np.where(log_p > -60.0, 2 * np.spacing(p).astype(np.float64)
                        / np.maximum(pdf, 1e-300), 0.0)
    gap = np.abs(got - want)
    excess = gap - 1e-5 * np.abs(want) - ulp_term
    assert np.all(excess <= 0), (log_p[np.argmax(excess)], excess.max())
    assert got[log_p == 0.0] == 0.0
    ref = -norm.ppf(np.exp(log_p.astype(np.float64)))
    ok = (log_p > -700) & (log_p < -1e-3)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=2e-3)
    huge = float(gammainc.sigma_from_log_pval(torch.tensor(-1e6)))
    assert 1.4e3 < huge < 1.5e3


def test_ndtri_and_log_erfc_match_jax():
    p = np.concatenate([np.logspace(-30, -1, 200), np.linspace(0.02, 0.98, 97),
                        1 - np.logspace(-7, -2, 50)]).astype(np.float32)
    z = np.linspace(-6, 40, 300).astype(np.float32)
    for name, x in (("_ndtri", p), ("log_erfc", z)):
        assert_close(getattr(gammainc, name)(torch.tensor(x)),
                     jax.jit(getattr(jax_gammainc, name))(x), name, atol=1e-6, rtol=1e-6)
