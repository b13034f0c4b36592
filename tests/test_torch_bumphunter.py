"""The port's BumpHunter (``atlasvae_torch/stats/bumphunter.py``) against
``atlasvae.stats.bumphunter`` on the CPU, and against the long-double C++
oracle (``atlasvae/stats/native.py::oracle_scan``).

Tolerances:
- ``scan_histograms`` against JAX: window choice (``min_loc``,
  ``min_width``) and ``signal_eval`` equal, log p within rtol 1e-5 / atol
  1e-6, every window's too.  Integer-valued histograms sum exactly; for
  weighted ones the test first asserts, in long double, that no two
  windows' log p lie within 1e-4 of each other's (relative), so that an
  ulp of summation order cannot move the minimum;
- against the oracle: window choice equal, log p within rtol 2e-3 / atol
  2e-3 (tests/test_native_oracle.py's bar: float32 against long double);
- BumpHunter1D, batched_bump_sigma and bump_sigma_sharded on injected
  Poisson draws (the JAX package draws from threefry, the port from a
  torch.Generator): the same bars; global p-values equal; significances
  within rtol 1e-5;
- the port's own draws: the same seed gives the same bits.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atlasvae.stats.bumphunter as jax_bh
from atlasvae.ops.gammainc import sigma_from_log_pval as jax_sigma
from atlasvae.stats.native import oracle_log_gammainc, oracle_scan
from atlasvae_torch.stats import bumphunter as bh
from atlasvae_torch.stats import deprecation
from torch_gaps import assert_close

CPU = torch.device("cpu")
NBINS = 64
WIDTHS = (2, 4)         # steps "half" (1, 2) and "full" (2, 4) differ from 1
RTOL, ATOL = 1e-5, 1e-6


def _steps(kind):
    if kind == "full":
        return WIDTHS
    if kind == "half":
        return tuple(max(1, w // 2) for w in WIDTHS)
    return tuple(kind for _ in WIDTHS)


def _hists(seed, k=21, weighted=False, deficit=False):
    r = np.random.default_rng(seed)
    ref = np.round(r.uniform(40, 400, NBINS) * np.exp(-np.arange(NBINS) / 30))
    ref[:3] = 0.0                                     # an empty low edge
    if weighted:
        ref = ref * r.uniform(0.5, 1.5, NBINS)
    hists = r.poisson(ref, (k, NBINS)).astype(np.float64)
    if weighted:
        hists = hists * r.uniform(0.8, 1.2, (k, NBINS))
    sign = -1 if deficit else 1
    hists[0, 20:23] = np.maximum(hists[0, 20:23] + sign * 60, 0)  # a bump in the data
    hists[5:6, 30:32] = np.maximum(hists[5:6, 30:32] + sign * 25, 0)
    return hists.astype(np.float32), ref.astype(np.float32)


def _range(ref):
    non0 = np.nonzero(ref > 0)[0]
    return int(non0.min()), int(non0.max()) + 1


def _jax_scan(hists, ref, steps, hinf, hsup, mode="excess", sideband="off"):
    use_sb, width = sideband != "off", (2 if sideband == "width 2" else None)
    out = jax_bh.scan_histograms(jnp.asarray(hists), jnp.asarray(ref), WIDTHS, steps,
                                 hinf, hsup, mode, use_sb, width)
    return [np.asarray(t) for t in out]


def _port_scan(hists, ref, steps, hinf, hsup, mode="excess", sideband="off"):
    use_sb, width = sideband != "off", (2 if sideband == "width 2" else None)
    out = bh.scan_histograms(hists, ref, WIDTHS, steps, hinf, hsup, mode, use_sb, width,
                             device=CPU)
    return [t.numpy() for t in out]


def _assert_same_scan(got, want, what):
    assert_close(got[0], want[0], f"{what} min_log_pval", rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{what} min_loc")
    np.testing.assert_array_equal(got[2], want[2], err_msg=f"{what} min_width")
    assert_close(got[3], want[3], f"{what} signal_eval", rtol=RTOL, atol=ATOL)
    assert_close(got[4], want[4], f"{what} log_pvals", rtol=RTOL, atol=ATOL)


def _assert_no_near_ties(hists, ref, steps, hinf, hsup, mode="excess"):
    """No two qualifying windows of any histogram with long-double log p
    within 1e-4 (relative) of each other's at the minimum."""
    ref = ref.astype(np.float64)
    for hist in np.asarray(hists, np.float64):
        nh, nr = [], []
        for w, step in zip(WIDTHS, steps):
            for p in range(hinf, hsup - w + 1, step):
                nh.append(hist[p:p + w].sum())
                nr.append(ref[p:p + w].sum())
        nh, nr = np.array(nh), np.array(nr)
        ok = (nh > nr) & (nr > 0) if mode == "excess" else nh < nr
        a = nh[ok] if mode == "excess" else nh[ok] + 1
        lps = np.sort(oracle_log_gammainc(a, np.maximum(nr[ok], 1e-30),
                                          lower=mode == "excess"))
        assert len(lps) > 1 and lps[1] - lps[0] > 1e-4 * max(abs(lps[0]), 1.0), lps[:2]


# JAX compiles each (mode, steps, sideband) once; every later JAX call here
# reuses one of these at (21, 64)
@pytest.mark.parametrize("mode,steps_kind,sideband", [
    ("excess", 1, "off"), ("deficit", 1, "off"), ("excess", "full", "on"),
    ("deficit", "half", "width 2")])
def test_scan_histograms_matches_jax_and_the_oracle(mode, steps_kind, sideband):
    steps = _steps(steps_kind)
    hists, ref = _hists(11, deficit=mode == "deficit")
    hinf, hsup = _range(ref)
    got = _port_scan(hists, ref, steps, hinf, hsup, mode, sideband)
    _assert_same_scan(got, _jax_scan(hists, ref, steps, hinf, hsup, mode, sideband),
                      f"{mode} steps {steps_kind} sideband {sideband}")
    assert (got[0] < 0).all() and got[0][0] < -20          # the data's bump
    if sideband == "off" and steps_kind == 1:
        ol, oloc, ow = oracle_scan(hists, ref, WIDTHS, mode=mode)
        np.testing.assert_array_equal(got[1], oloc)
        np.testing.assert_array_equal(got[2], ow)
        np.testing.assert_allclose(got[0], ol, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mode", ["excess", "deficit"])
def test_scan_histograms_weighted_matches_jax(mode):
    hists, ref = _hists(12, weighted=True, deficit=mode == "deficit")
    hinf, hsup = _range(ref)
    steps = _steps(1)
    _assert_no_near_ties(hists, ref, steps, hinf, hsup, mode)
    _assert_same_scan(_port_scan(hists, ref, steps, hinf, hsup, mode),
                      _jax_scan(hists, ref, steps, hinf, hsup, mode), f"weighted {mode}")


def test_scan_histograms_batch_of_references_matches_one_at_a_time():
    """(B, K, n) against (B, n) references, each with its own range: the
    same as B calls of the JAX scan."""
    cases = [_hists(seed) for seed in (21, 22, 23)]
    hists = np.stack([h for h, _ in cases])
    refs = np.stack([r for _, r in cases])
    refs[1, 40:] = 0.0                                 # another range per row
    ranges = [_range(r) for r in refs]
    steps = _steps(1)
    got = bh.scan_histograms(hists, refs, WIDTHS, steps, [r[0] for r in ranges],
                             [r[1] for r in ranges], device=CPU)
    for b, (hinf, hsup) in enumerate(ranges):
        want = _jax_scan(hists[b], refs[b], steps, hinf, hsup)
        _assert_same_scan([t[b].numpy() for t in got[:4]] + [got[4][:, b].numpy()], want,
                          f"reference {b}")


def test_first_minimum_on_a_tie():
    """Two identical bumps give identical windows: the first is reported,
    as jnp.argmin does."""
    ref = np.full(NBINS, 100.0, np.float32)
    hist = ref.copy()
    hist[10:12] += 80
    hist[30:32] += 80
    hists = np.tile(hist, (21, 1))
    got = _port_scan(hists, ref, _steps(1), 0, NBINS)
    want = _jax_scan(hists, ref, _steps(1), 0, NBINS)
    assert (got[1] == 10).all() and (want[1] == 10).all()
    assert (got[2] == 2).all() and (want[2] == 2).all()


def test_no_qualifying_window_reports_zero():
    ref = np.full(NBINS, 100.0, np.float32)
    hists = np.tile(ref - 5, (21, 1))
    got = _port_scan(hists, ref, _steps(1), 0, NBINS)
    want = _jax_scan(hists, ref, _steps(1), 0, NBINS)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 0.0).all() and (got[3] == 0.0).all()


def test_bin_significance_matches_jax():
    hists, ref = _hists(13)
    data = hists[0]
    data[10] = 0.0
    got = bh._bin_significance(torch.tensor(data), torch.tensor(ref))
    want = jax_bh._bin_significance(jnp.asarray(data), jnp.asarray(ref))
    assert_close(got, want, "bin_significance", rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ injected draws

def _draws(seed):
    """A stream of numpy Poisson draws, one per _poisson_pseudo call, the
    same on both sides given the same seed."""
    rng = np.random.default_rng(seed)

    def take(rate, npe):
        rate = np.asarray(rate, np.float64)
        return rng.poisson(rate, (npe,) + rate.shape).astype(np.float32)
    return take


@pytest.fixture()
def injected(monkeypatch):
    """Both packages' _poisson_pseudo replaced by the same numpy stream."""
    jax_take, port_take = _draws(5), _draws(5)
    monkeypatch.setattr(jax_bh, "_poisson_pseudo",
                        lambda key, ref, npe: jnp.asarray(jax_take(ref, npe)))
    monkeypatch.setattr(bh, "_poisson_pseudo",
                        lambda gen, rate, npe: torch.as_tensor(port_take(rate.cpu(), npe),
                                                               device=rate.device))


def _hunters(**kwargs):
    args = dict(rang=[0, NBINS], width_min=2, width_max=4, width_step=2, npe=20,
                bins=np.arange(NBINS + 1.0), seed=3, npe_inject=20)
    args.update(kwargs)
    return jax_bh.BumpHunter1D(**args), bh.BumpHunter1D(**args, device=CPU)


def _assert_same_results(port, ref, what):
    assert_close(port.t_ar, ref.t_ar, f"{what} t_ar", rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(port.min_loc_ar, ref.min_loc_ar)
    np.testing.assert_array_equal(port.min_width_ar, ref.min_width_ar)
    assert port.global_Pval == ref.global_Pval
    assert_close(port.significance, ref.significance, f"{what} significance", rtol=RTOL)


@pytest.mark.parametrize("use_sideband", [False, True])
def test_bump_hunter_scan_matches_jax_on_injected_draws(injected, use_sideband):
    hists, ref = _hists(14)
    jh, th = _hunters(use_sideband=use_sideband, scan_step="full" if use_sideband else 1)
    for h in (jh, th):
        h.bump_scan(hists[0], ref, is_hist=True, verbose=False)
    _assert_same_results(th, jh, "bump_scan")
    assert 0 < th.global_Pval < 1 or th.significance > 0
    assert th.signal_eval == pytest.approx(jh.signal_eval, rel=RTOL)
    for g, w in zip(th.res_ar, jh.res_ar):
        assert_close(g, w, "res_ar", rtol=1e-4, atol=1e-7)
    if use_sideband:
        assert th.norm_scale == pytest.approx(jh.norm_scale, rel=1e-6)
    assert th.bump_info(hists[0], is_hist=True, verbose=False) == pytest.approx(
        jh.bump_info(hists[0], is_hist=True, verbose=False), rel=RTOL)
    got, got_range = th.plot_bump(hists[0], ref, is_hist=True)
    want, want_range = jh.plot_bump(hists[0], ref, is_hist=True)
    assert_close(got, want, "plot_bump bin sigma", rtol=RTOL, atol=ATOL)
    assert got_range == want_range
    if use_sideband:
        return
    # do_pseudo=False reuses the cached pseudo-experiments
    for h in (jh, th):
        h.bump_scan(hists[5], ref, is_hist=True, do_pseudo=False, verbose=False)
    _assert_same_results(th, jh, "bump_scan do_pseudo=False")


def test_bump_hunter_multi_channel_matches_jax(injected):
    (h1, r1), (h2, r2) = _hists(15), _hists(16)
    edges = [np.arange(NBINS + 1.0), np.arange(NBINS + 1.0) + 0.5]
    jh, _ = _hunters(bins=list(edges))
    _, th = _hunters(bins=list(edges))
    want = jh.bump_scan([h1[0], h2[0]], [r1, r2], is_hist=True, multi_chan=True,
                        verbose=False)
    got = th.bump_scan([h1[0], h2[0]], [r1, r2], is_hist=True, multi_chan=True,
                       verbose=False)
    assert got == want
    _assert_same_results(th, jh, "multi_chan")
    assert_close(th.signal_eval, jh.signal_eval, "multi signal_eval", rtol=RTOL, atol=ATOL)
    assert th.bump_info(None, verbose=False) == pytest.approx(
        jh.bump_info(None, verbose=False), rel=RTOL)


def test_signal_inject_matches_jax(injected):
    hists, ref = _hists(17)
    sig = np.zeros(NBINS, np.float32)
    sig[24:27] = [6.0, 12.0, 6.0]
    jh, th = _hunters(str_min=0.5, str_step=0.5, sigma_limit=3, npe=21, npe_inject=21)
    for h in (jh, th):
        h.signal_inject(sig, ref, is_hist=True, verbose=False)
    assert len(th.str_ar) >= 2
    np.testing.assert_array_equal(th.str_ar, jh.str_ar)
    assert_close(th.sigma_ar, jh.sigma_ar, "sigma_ar", rtol=RTOL, atol=ATOL)
    _assert_same_results(th, jh, "signal_inject")
    assert th.signal_ratio == jh.signal_ratio
    np.testing.assert_array_equal(th.data_inject, jh.data_inject)


def test_state_dicts_interchange_with_jax(injected):
    hists, ref = _hists(18)
    jh, th = _hunters(flip_sig=False)
    for h in (jh, th):
        h.bump_scan(hists[0], ref, is_hist=True, verbose=False)
    port_state, jax_state = th.save_state(), jh.save_state()
    assert set(port_state) == set(jax_state) and port_state["sig_flip"] is False
    fresh_jax, fresh_port = jax_bh.BumpHunter1D(), bh.BumpHunter1D(device=CPU)
    fresh_jax.load_state(port_state)
    fresh_port.load_state(jax_state)
    assert fresh_port.flip_sig is False and fresh_jax.flip_sig is False
    assert fresh_port.device == CPU
    for key in ("t_ar", "log_Pval_ar", "min_loc_ar", "min_width_ar"):
        assert_close(fresh_port.save_state()[key], fresh_jax.save_state()[key], key,
                     rtol=RTOL, atol=ATOL)
    assert fresh_port.bump_info(hists[0], is_hist=True, verbose=False) == pytest.approx(
        th.bump_info(hists[0], is_hist=True, verbose=False), rel=RTOL)
    fresh_port.reset()
    assert fresh_port.t_ar == [] and fresh_port.global_Pval == 0


def test_legacy_aliases_warn_once(monkeypatch, capsys):
    monkeypatch.setattr(deprecation, "_warned_funcs", set())
    monkeypatch.setattr(deprecation, "_warned_args", set())
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        hunter = bh.BumpHunter1D(Npe=7, useSideBand=False, device=CPU)
        assert hunter.npe == 7
        hunter.Reset()
        hunter.Reset()
        state = hunter.SaveState()
        hunter.LoadState(state)
    names = [str(w.message).split()[0] for w in seen if w.category is FutureWarning]
    assert names.count("BumpHunter1D.Reset") == 1
    assert names.count("BumpHunter1D.SaveState") == 1
    assert sum("Npe" in str(w.message) for w in seen) == 1
    assert sum("useSideBand" in str(w.message) for w in seen) == 1
    assert isinstance(hunter, bh.BumpHunterInterface)


def test_own_draws_repeat_with_the_seed():
    hists, ref = _hists(19)
    runs = []
    for _ in range(2):
        h = bh.BumpHunter1D(rang=[0, NBINS], width_min=2, width_max=4, npe=30,
                            bins=np.arange(NBINS + 1.0), seed=4, device=CPU)
        h.bump_scan(hists[0], ref, is_hist=True, verbose=False)
        runs.append(h.t_ar)
    np.testing.assert_array_equal(runs[0], runs[1])
    gen = lambda: torch.Generator(CPU).manual_seed(9)
    rate = torch.tensor(ref)
    a, b = bh._poisson_pseudo(gen(), rate, 5), bh._poisson_pseudo(gen(), rate, 5)
    assert a.shape == (5, NBINS) and a.dtype == torch.float32 and torch.equal(a, b)


# --------------------------------------------------- batched cut scans

def _cut_matrices(n_cuts=5, n_rows=8):
    rows = [_hists(30 + i, k=1) for i in range(n_cuts)]
    data = np.zeros((n_rows, NBINS), np.float32)
    bkg = np.zeros((n_rows, NBINS), np.float32)
    for i, (h, r) in enumerate(rows):
        data[i], bkg[i] = h[0], r
    return data, bkg


def test_batched_local_sigma_matches_jax():
    data, bkg = _cut_matrices()
    got = bh.batched_local_sigma(data, bkg, WIDTHS, _steps(1), device=CPU)
    want = jax_bh.batched_local_sigma(data, bkg, WIDTHS, _steps(1))
    assert_close(got[0], want[0], "loc_sigma", rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_close(got[3], want[3], "bin_sigma", rtol=RTOL, atol=ATOL)
    assert (got[0][:5] > 3).all() and (got[0][5:] == 0).all()   # padded rows scan nothing


def _jax_global(data, bkg, pseudo, npe):
    """JAX's scan_histograms + sigma_from_log_pval on the given draws, as
    _batched_bump_sigma_jit combines them."""
    hinf, hsup = _range(bkg)
    min_logp = _jax_scan(np.concatenate([data[None], pseudo]), bkg, _steps(1), hinf,
                         hsup)[0]
    s = np.sum(-min_logp[1:] >= -min_logp[0])
    glob = np.log(np.float32(max(s, 1.0)) / npe)
    return (float(jax_sigma(min_logp[0])), float(jax_sigma(jnp.float32(glob))),
            float(-min_logp[0]))


def test_batched_bump_sigma_and_sharded_match_jax_on_injected_draws(monkeypatch, tmp_path):
    data, bkg = _cut_matrices(n_cuts=4, n_rows=4)
    npe = 20
    draw = np.random.default_rng(6).poisson(bkg, (npe,) + bkg.shape).astype(np.float32)
    monkeypatch.setattr(bh, "_poisson_pseudo", lambda gen, rate, n: torch.as_tensor(
        draw if rate.ndim == 2 else draw[:, 0]))
    got = bh.batched_bump_sigma(data, bkg, WIDTHS, _steps(1), npe=npe, device=CPU)
    one = bh.bump_sigma_sharded(data[0], bkg[0], WIDTHS, _steps(1), npe=npe, device=CPU)
    for b in range(4):
        want = _jax_global(data[b], bkg[b], draw[:, b], npe)
        assert_close(torch.stack([g[b] for g in got]), want, f"cut {b}", rtol=RTOL, atol=ATOL)
    assert_close(torch.stack(one), _jax_global(data[0], bkg[0], draw[:, 0], npe), "sharded",
                 rtol=RTOL, atol=ATOL)
    # once refused (ROADMAP Queue 1 item 11), now run: over a mesh of one
    # rank, exactly the scan without one
    from atlasvae_torch.parallel import data_parallel_mesh
    from torch_dist_checks import one_rank_group
    with one_rank_group(tmp_path):
        ranked = bh.bump_sigma_sharded(data[0], bkg[0], WIDTHS, _steps(1), npe=npe,
                                       mesh=data_parallel_mesh(), device=CPU)
    assert [float(t) for t in ranked] == [float(t) for t in one]


def test_scan_launches_do_not_grow_with_the_cuts():
    """The p-values are one call over the stacked tensor: scanning 3 cuts'
    references, or 40 histograms instead of 21, runs as many torch
    operations (kernel launches on the card) as one reference does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def ops(hists, refs):
        Count.n = 0
        with Count():
            bh.scan_histograms(hists, refs, WIDTHS, _steps(1), 3, NBINS, device=CPU)
        return Count.n

    hists, ref = _hists(40, k=40)
    one = ops(hists[None, :21], ref[None])
    assert one == ops(hists[None], ref[None]) == ops(np.stack([hists[:21]] * 3),
                                                      np.stack([ref] * 3))
    assert one < 2000 * len(WIDTHS)
