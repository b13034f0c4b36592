"""The port's mass decorrelation and cut scan (``atlasvae_torch/eval/deco.py``,
``eval/bump.py``, ``utils/chunks.py::merged_bins``) against ``atlasvae`` on
the CPU.

Tolerances: the host code (``merged_bins``, ``cum_distribution``,
``mass_deco`` in its m, pt and 2d forms, ``pad_hist_matrices``) is numpy on
both sides and must be bit-equal.  The cut scan on unit weights: the
best-cut record equal (its threshold, efficiency and metric), its local
sigma within rtol 1e-4; ``bump_hunter``'s loc_sigma and max_sigma within
rtol 1e-4 (the Gaussian fit's optimizer amplifies float32 ulps of the bin
significances).  The drawing paths are held to the JAX package's in
``test_torch_plotting.py``.
"""

import numpy as np
import pytest
import torch

from atlasvae.eval import bump as jax_bump
from atlasvae.eval import deco as jax_deco
from atlasvae.utils.chunks import merged_bins as jax_merged_bins
from atlasvae_torch.eval import bump, deco
from atlasvae_torch.utils.chunks import merged_bins

CPU = torch.device("cpu")


def _eval_sample(seed, n_bkg=15_000, n_sig=2_000):
    """Exponential background mass with a 300 GeV signal bump; the signal
    scores higher (JZW -1 is signal, label 0)."""
    r = np.random.default_rng(seed)
    m_bkg = r.exponential(80, n_bkg) + 30
    m_sig = r.normal(300, 15, n_sig)
    n = n_bkg + n_sig
    sample = {
        "m": np.concatenate([m_bkg, m_sig]).astype(np.float32),
        "pt": r.uniform(450, 1000, n).astype(np.float32),
        "weights": np.ones(n, dtype=np.float32),
        "JZW": np.concatenate([np.zeros(n_bkg), -np.ones(n_sig)]).astype(np.float32),
    }
    y_true = np.where(sample["JZW"] == -1, 0, 1)
    loss = np.where(y_true == 0, r.normal(0.7, 0.12, n), r.normal(0.4, 0.15, n))
    return sample, y_true, np.clip(loss, 0, 1).astype(np.float32)


@pytest.mark.parametrize("case", ["log", "linear", "edges", "sparse"])
def test_merged_bins_equals_jax(case):
    r = np.random.default_rng(1)
    values = r.exponential(50, 3000) + 1
    kwargs = {"log": dict(max_bins=100, min_bin_count=2),
              "linear": dict(max_bins=60, min_bin_count=20, logspace=False),
              "edges": dict(edges=np.arange(0, 400, 5.0), min_bin_count=20),
              "sparse": dict(edges=np.linspace(0, 1000, 50), min_bin_count=5000)}[case]
    got, want = merged_bins(values, **kwargs), jax_merged_bins(values, **kwargs)
    np.testing.assert_array_equal(got, want)
    if case == "sparse":            # merging stops at two edges, not in a loop
        assert len(got) == 2


def test_cum_distribution_equals_jax():
    r = np.random.default_rng(2)
    values = np.round(r.normal(0.5, 0.2, 500), 2)       # ties
    for v in (values, np.array([])):
        for g, w in zip(deco.cum_distribution(v), jax_deco.cum_distribution(v)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", ["m", "pt", "2d"])
def test_mass_deco_equals_jax(form):
    r = np.random.default_rng(3)
    n = 20_000
    sample = {"m": r.uniform(50, 500, n), "pt": r.uniform(450, 1000, n)}
    y = (r.random(n) < 0.8).astype(int)
    loss = sample["m"] / 600 + sample["pt"] / 4000 + r.normal(0, 0.04, n)
    got = deco.mass_deco(y, sample, loss.copy(), deco=form)
    np.testing.assert_array_equal(got, jax_deco.mass_deco(y, sample, loss.copy(), deco=form))
    assert np.all((got >= 0) & (got <= 1))
    assert abs(np.corrcoef(sample["m"][y == 1], got[y == 1])[0, 1]) < (
        0.15 if form != "pt" else 1.0)


def test_pad_hist_matrices_equals_jax():
    hists = [np.arange(n, dtype=np.float64) for n in (40, 70, 33)]
    for g, w in zip(bump.pad_hist_matrices(hists, hists[::-1], 6),
                    jax_bump.pad_hist_matrices(hists, hists[::-1], 6)):
        assert g.shape == (6, 96)
        np.testing.assert_array_equal(g, w)


def test_bump_scan_matches_jax():
    sample, y_true, loss = _eval_sample(5)
    got = bump.bump_scan(y_true, loss, "MAE", sample, "2HDM-Geneva", None, n_cuts=20,
                         npe=10, make_plots=False, device=CPU)
    want = jax_bump.bump_scan(y_true, loss, "MAE", sample, "2HDM-Geneva", None, n_cuts=20,
                              npe=10, make_plots=False)
    assert got == want and got["metric"] == "MAE" and 0 < got["eff"] <= 100
    cut = {k: v[loss > got["loss"]] for k, v in sample.items()}
    loc, max_sigma = bump.bump_hunter(cut, npe=10, device=CPU)
    loc_j, max_j = jax_bump.bump_hunter(cut, npe=10)
    assert loc == pytest.approx(loc_j, rel=1e-4) and loc > 3
    assert max_sigma == pytest.approx(max_j, rel=1e-4)
