"""The port's BumpHunter scan on the card against the same code on the CPU.

Marked ``cuda``: they skip where there is no NVIDIA GPU.  This file imports
nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_stats.py

The scan is plain PyTorch (no kernel of its own), so the card and the CPU
run the same operations in the same order; they part only by the ulps of
the two libraries' exp/log/lgamma/erfc.  Tolerance: log p within rtol 1e-5
/ atol 1e-6 (every window and the minimum), the window choice equal, the
bin significances within rtol 1e-5 / atol 1e-6.  Poisson draws on the card:
the same bits from one seed.
"""

import numpy as np
import pytest
import torch
from torch_gaps import assert_close

from atlasvae_torch.stats import bumphunter as bh

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
WIDTHS = (2, 3, 4, 5, 6)
STEPS = (1, 1, 1, 1, 1)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the statistics' device path runs on the card")
    return torch.device("cuda")


def _weighted(seed, nbins=160, npe=50):
    """A weighted data histogram with a bump and npe integer Poisson
    pseudo-histograms of its background, drawn by numpy."""
    r = np.random.default_rng(seed)
    bkg = 2e4 * np.exp(-np.arange(nbins) / 25.0) * r.uniform(0.9, 1.1, nbins)
    bkg[-10:] = 0.0
    data = r.poisson(bkg) * r.uniform(0.95, 1.05, nbins)
    data[60:63] += 3 * np.sqrt(bkg[60:63])
    pseudo = r.poisson(bkg, (npe, nbins))
    return (np.concatenate([data[None], pseudo]).astype(np.float32),
            bkg.astype(np.float32))


def _range(ref):
    non0 = np.nonzero(ref > 0)[0]
    return int(non0.min()), int(non0.max()) + 1


def _both(fn, *args, **kwargs):
    return [[t.cpu() for t in fn(*args, **kwargs, device=d)] for d in ("cuda", CPU)]


@pytest.mark.parametrize("mode", ["excess", "deficit"])
def test_scan_on_the_card_matches_the_cpu(cuda, mode):
    hists, ref = _weighted(1)
    hinf, hsup = _range(ref)
    got, want = _both(bh.scan_histograms, hists, ref, WIDTHS, STEPS, hinf, hsup, mode)
    assert_close(got[0], want[0], "min_log_pval", rtol=RTOL, atol=ATOL)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert_close(got[3], want[3], "signal_eval", rtol=RTOL, atol=ATOL)
    assert_close(got[4], want[4], "log_pvals", rtol=RTOL, atol=ATOL)
    sig = [bh._bin_significance(torch.tensor(hists[0], device=d), torch.tensor(ref, device=d))
           for d in (cuda, CPU)]
    assert_close(sig[0], sig[1], "bin_significance", rtol=RTOL, atol=ATOL)


def test_batched_scans_on_the_card_match_the_cpu(cuda, monkeypatch):
    rows = [_weighted(seed, npe=0) for seed in range(2, 9)]
    data = np.stack([h[0] for h, _ in rows] + [np.zeros(160, np.float32)])
    bkg = np.stack([r for _, r in rows] + [np.zeros(160, np.float32)])
    got, want = _both(bh.batched_local_sigma, data, bkg, WIDTHS, STEPS)
    for g, w, what in zip(got, want, ("loc_sigma", "min_loc", "min_width", "bin_sigma")):
        assert_close(g, w, what, rtol=RTOL, atol=ATOL)
    assert got[0][-1] == 0.0
    draw = np.random.default_rng(3).poisson(bkg, (40,) + bkg.shape).astype(np.float32)
    monkeypatch.setattr(bh, "_poisson_pseudo",
                        lambda gen, rate, npe: torch.tensor(draw, device=rate.device))
    got, want = _both(bh.batched_bump_sigma, data, bkg, WIDTHS, STEPS, npe=40)
    for g, w, what in zip(got, want, ("local", "global", "t_data")):
        assert_close(g, w, what, rtol=RTOL, atol=ATOL)


def test_first_minimum_on_the_card(cuda):
    ref = np.full(64, 100.0, np.float32)
    hist = ref.copy()
    hist[10:12] += 80
    hist[40:42] += 80
    out = bh.scan_histograms(np.tile(hist, (3, 1)), ref, WIDTHS, STEPS, 0, 64, device=cuda)
    assert (out[1].cpu() == 10).all() and (out[2].cpu() == 2).all()


def test_draws_on_the_card_repeat_with_the_seed(cuda):
    rate = torch.tensor(_weighted(4)[1], device=cuda)
    a, b = (bh._poisson_pseudo(torch.Generator(cuda).manual_seed(7), rate, 1000)
            for _ in range(2))
    assert a.shape == (1000, 160) and a.device.type == "cuda" and torch.equal(a, b)
    assert torch.equal(a, a.round()) and abs(float(a.mean(0).sum() / rate.sum()) - 1) < 1e-3
    hists, ref = _weighted(5, npe=0)
    t = []
    for _ in range(2):
        hunter = bh.BumpHunter1D(width_min=2, width_max=6, npe=200, bins=np.arange(161.0),
                                 seed=11, device=cuda)
        hunter.bump_scan(hists[0], ref, is_hist=True, verbose=False)
        t.append(hunter.t_ar)
    np.testing.assert_array_equal(t[0], t[1])
