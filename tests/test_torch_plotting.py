"""The port's drawing functions (``atlasvae_torch/plotting/``, the drawing
methods of ``stats/bumphunter.py``, the drawing paths of ``eval/bump.py``)
against the JAX package's on the same numpy inputs, made from a seed.

Each call is recorded at its saves (``tests/plot_record.py``): both sides
must save the same files, and every plotted array must agree within rtol
1e-5 / atol 1e-6.  Where a ROC feeds a plot, the JAX package's ROC is held
to the port's at ``tests/test_torch_roc.py``'s bars (rates atol 1e-6,
thresholds exact) and then replaced by it, so that what is drawn from it
compares at the plots' bars.  Where another test file holds a number at a
wider bar, the plot of it is held there too: BumpHunter's local p-values
(the tomography) at rtol 1e-4 / atol 1e-7 (``test_torch_bumphunter.py``),
the local sigma of the cut scan and what the Gaussian fit of the bin
significances draws at rtol 1e-4 (``test_torch_deco_bump.py``).
BumpHunter's pseudo-experiments are the same numpy draws on both sides.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atlasvae.eval.bump as jax_eval_bump
import atlasvae.eval.roc as jax_roc
import atlasvae.plotting.bump as jax_bump
import atlasvae.plotting.distributions as jax_dist
import atlasvae.plotting.history as jax_hist
import atlasvae.plotting.performance as jax_perf
import atlasvae.stats.bumphunter as jax_bh
from atlasvae.utils.chunks import density_weights as jax_density_weights
from atlasvae_torch.eval import bump as eval_bump
from atlasvae_torch.eval import roc
from atlasvae_torch.plotting import bump, distributions as dist, history as hist, performance \
    as perf
from atlasvae_torch.stats import bumphunter as bh
from atlasvae_torch.utils.chunks import density_weights
from plot_record import assert_same_plots, recording, roc_from

CPU = torch.device("cpu")
FIT_BAR = (1e-4, 1e-6)          # test_torch_deco_bump.py: local sigma and the Gaussian fit
TOMOGRAPHY_BAR = (1e-4, 1e-7)   # test_torch_bumphunter.py: res_ar


def _sample(seed, n_bkg=2500, n_sig=500):
    """Background and signal jets with lognormal weights; the signal peaks
    at 300 GeV and scores higher (JZW -1 is signal, label 0)."""
    r = np.random.default_rng(seed)
    n = n_bkg + n_sig
    sample = {
        "m": np.concatenate([r.exponential(80, n_bkg) + 30,
                             r.normal(300, 15, n_sig)]).astype(np.float32),
        "pt": r.uniform(450, 1100, n).astype(np.float32),
        "weights": r.lognormal(0, 0.3, n).astype(np.float32),
        "JZW": np.concatenate([r.integers(0, 4, n_bkg), -np.ones(n_sig)]).astype(np.float32),
    }
    y_true = np.where(sample["JZW"] == -1, 0, 1)
    loss = np.where(y_true == 0, r.normal(0.7, 0.12, n), r.normal(0.4, 0.15, n))
    return sample, y_true, np.clip(loss, 0, 1).astype(np.float32)


def _both(tmp_path, draw, write=False):
    """draw(side, out) on each side in its own folder; the two recordings."""
    out = {}
    for side in ("port", "jax"):
        folder = tmp_path / side
        folder.mkdir()
        with recording(folder, write) as records:
            draw(side, folder)
        out[side] = records
        assert sorted(str(p.relative_to(folder)) for p in folder.rglob("*") if p.is_file()) \
            == sorted(name for name in records if not name.startswith("<"))
    return out["port"], out["jax"]


def test_density_weights_equals_jax():
    r = np.random.default_rng(0)
    bins = np.array([0.0, 1.0, 3.0, 7.0, 10.0])
    values = r.uniform(-2, 12, 500)                  # out-of-range values clip to an edge bin
    weights = r.lognormal(0, 0.5, 500).astype(np.float32)
    np.testing.assert_array_equal(density_weights(values, weights, bins),
                                  jax_density_weights(values, weights, bins))


def _history(tmp_path):
    path = tmp_path / "history.pkl"
    with open(path, "wb") as f:
        pickle.dump({"MSE": [3.0, 2.5, 2.2, 2.1], "KLD": [0.5, 0.4, 0.35, 0.3],
                     "Train loss": [4.0, 3.1, 2.7, 2.5], "Valid loss": [4.2, 3.3, 2.9, 2.8]},
                    f)
    return path


def _cases():
    """{name: (draw(side, out, tmp_path), bars or None)}."""
    sample, y_true, loss = _sample(1)
    losses = {"MAE": loss, "KLD": np.clip(loss + np.random.default_rng(2).normal(
        0, 0.1, len(loss)), 0, 1).astype(np.float32)}
    cut = {k: v[loss > 0.6] for k, v in sample.items()}
    mods = {"port": (perf, dist, hist, bump, {"device": CPU}),
            "jax": (jax_perf, jax_dist, jax_hist, jax_bump, {})}
    r = np.random.default_rng(3)
    bins = np.linspace(0, 100, 21)
    data_hist = r.poisson(np.full(20, 100.0)).astype(np.float64)
    bin_sigma = r.normal(0, 1, 20)
    t_stat = r.exponential(2, 101)
    probs = np.clip(r.beta(2, 5, (len(y_true), 1)) + (y_true == 0)[:, None] * 0.3, 0, 1)
    probs = np.hstack([probs, 1 - probs]).astype(np.float32)
    return {
        "plot_distributions": (lambda s, out, tmp: mods[s][1].plot_distributions(
            [sample, cut], "2HDM-Geneva", "m", {"m": 10, "pt": 20}, out, "cut_m.png"), None),
        "sample_distributions": (lambda s, out, tmp: mods[s][1].sample_distributions(
            sample, "OoD-H", out, "train", "X-S", {"m": 10, "pt": 20}), None),
        "plot_history": (lambda s, out, tmp: mods[s][2].plot_history(_history(tmp), out),
                         None),
        "plot_sigma_scan": (lambda s, out, tmp: mods[s][0].plot_sigma_scan(
            np.logspace(-2, 2, 40), np.sin(np.linspace(0, 3, 40)) * 4, "bkg", 1e-2, 100,
            str(out / "BH_sigma.png")), None),
        "plot_bump_result": (lambda s, out, tmp: mods[s][0].plot_bump_result(
            sample["m"], sample["weights"], y_true, np.linspace(30, 500, 48),
            np.sin(np.linspace(0, 6, 47)), 3.2, 4.0, (280.0, 320.0), (0, 800),
            (4.0, 300.0, 20.0, 1.0, 0.1, 0.8), "2HDM", str(out / "bump.png")), None),
        "roc_curves": (lambda s, out, tmp: mods[s][0].roc_curves(
            y_true, losses, sample["weights"], ["MAE", "KLD"], out, **mods[s][4]), None),
        "mass_correlation": (lambda s, out, tmp: mods[s][0].mass_correlation(
            y_true, losses, sample["m"], sample["weights"], ["MAE", "KLD"], "MAE", out,
            **mods[s][4]), None),
        "loss_distributions": (lambda s, out, tmp: mods[s][0].loss_distributions(
            y_true, loss, sample["weights"], "MAE", out, {"metric": "MAE", "loss": 0.6}),
            None),
        "class_distributions": (lambda s, out, tmp: mods[s][0].class_distributions(
            y_true, probs, sample["weights"], out), None),
        "plot_bump_histogram": (lambda s, out, tmp: mods[s][3].plot_bump_histogram(
            data_hist, np.full(20, 100.0), bins, bin_sigma, (30, 50), (0, 100),
            filename=str(out / "bump.png")), None),
        "plot_stat_distribution": (lambda s, out, tmp: mods[s][3].plot_stat_distribution(
            t_stat, 0.3, True,
            str(out / "stat.png")), None),
        "plot_tomography": (lambda s, out, tmp: mods[s][3].plot_tomography(
            bins, [np.linspace(0.01, 1.2, 20), np.linspace(0.3, 0.9, 19)], (2, 3),
            str(out / "tomo.png")), None),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_drawing_function_matches_jax(name, tmp_path, monkeypatch):
    draw, bars = CASES[name]
    rates = roc_from(monkeypatch, roc, jax_roc)
    got, want = _both(tmp_path, lambda side, out: draw(side, out, tmp_path))
    assert got, "nothing was saved"
    assert_same_plots(got, want, bars=bars)
    if name in ("roc_curves", "mass_correlation"):
        assert rates                        # the ROC that fed the plot was held to the port's


def test_mass_distances_match_jax(monkeypatch):
    """The mass-sculpting numbers: the same JSD curves for either class."""
    sample, y_true, loss = _sample(4)
    roc_from(monkeypatch, roc, jax_roc)
    rates = roc.get_rates(y_true, loss, sample["weights"], device=CPU)
    for truth in (1, 0):
        got = perf._mass_distances(y_true, loss, sample["m"], sample["weights"], truth, rates)
        want = jax_perf._mass_distances(y_true, loss, sample["m"], sample["weights"], truth)
        assert len(got[0]) > 50
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- BumpHunter1D's drawings

def _draws(seed):
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


def _bump_hists():
    r = np.random.default_rng(14)
    ref = np.round(r.uniform(40, 400, 64) * np.exp(-np.arange(64) / 30))
    data = r.poisson(ref).astype(np.float64)
    data[20:23] += 60
    return data, ref


METHODS = {
    "plot_bump_file": (lambda h, out: h.plot_bump(*_bump_hists(), is_hist=True,
                                                  filename=str(out / "bump.png")), None),
    "plot_bump_histo": (lambda h, out: h.plot_bump(*_bump_hists(), is_hist=True,
                                                   make_histo=True), None),
    "plot_stat": (lambda h, out: h.plot_stat(show_Pval=True, filename=str(out / "stat.png")),
                  None),
    "plot_tomography": (lambda h, out: h.plot_tomography(None, filename=str(out / "tomo.png")),
                        TOMOGRAPHY_BAR),
    "plot_inject": (lambda h, out: h.plot_inject(filename=str(out / "inject.png")), None),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_bump_hunter_drawing_methods_match_jax(name, injected, tmp_path):
    data, ref = _bump_hists()
    args = dict(rang=[0, 64], width_min=2, width_max=4, width_step=2, npe=20,
                bins=np.arange(65.0), seed=3, npe_inject=20, sigma_limit=3, str_min=0.5,
                str_step=0.5, signal_exp=60)
    hunters = {"jax": jax_bh.BumpHunter1D(**args), "port": bh.BumpHunter1D(**args, device=CPU)}
    for h in hunters.values():
        if name == "plot_inject":
            h.signal_inject(np.exp(-0.5 * ((np.arange(64) - 31) / 2.0) ** 2), ref,
                            is_hist=True, verbose=False)
        else:
            h.bump_scan(data, ref, is_hist=True, verbose=False)
    draw, bar = METHODS[name]
    got, want = _both(tmp_path, lambda side, out: draw(hunters[side], out))
    assert len(got) == 1
    assert_same_plots(got, want, bars={k: bar for k in want} if bar else None)


# --------------------------------------------------- eval/bump.py's drawings

def test_bump_hunter_with_a_filename_matches_jax(injected, tmp_path):
    sample, _, loss = _sample(5, n_bkg=8000, n_sig=1500)
    cut = {k: v[loss > 0.55] for k, v in sample.items()}
    numbers = {}

    def draw(side, out):
        call = eval_bump.bump_hunter if side == "port" else jax_eval_bump.bump_hunter
        kw = {"device": CPU} if side == "port" else {}
        numbers[side] = call(cut, str(out / "BH_best.png"), "2HDM", npe=10, **kw)
    got, want = _both(tmp_path, draw, write=True)
    assert_same_plots(got, want, bars={"BH_best.png": FIT_BAR})
    np.testing.assert_allclose(numbers["port"], numbers["jax"], rtol=FIT_BAR[0])
    assert numbers["port"][0] > 3


def test_bump_scan_with_plots_matches_jax(injected, tmp_path, monkeypatch):
    sample, y_true, loss = _sample(6, n_bkg=8000, n_sig=1500)
    roc_from(monkeypatch, roc, jax_roc)
    best = {}

    def draw(side, out):
        if side == "port":
            best[side] = eval_bump.bump_scan(y_true, loss, "MAE", sample, "2HDM-Geneva", out,
                                             n_cuts=20, npe=10, device=CPU)
        else:
            best[side] = jax_eval_bump.bump_scan(y_true, loss, "MAE", sample, "2HDM-Geneva",
                                                 out, n_cuts=20, npe=10)
    got, want = _both(tmp_path, draw)
    assert sorted(want) == ["BH_best.png", "BH_bkg_supp_m.png", "BH_bkg_supp_pt.png",
                            "BH_sigma.png"]
    assert best["port"] == best["jax"]
    assert_same_plots(got, want, bars={"BH_sigma.png": FIT_BAR, "BH_best.png": FIT_BAR})


def test_generate_cuts_matches_jax(tmp_path, monkeypatch, capsys):
    sample, y_true, loss = _sample(7)
    roc_from(monkeypatch, roc, jax_roc)

    def draw(side, out):
        if side == "port":
            eval_bump.generate_cuts(y_true, sample, loss, "MAE", "2HDM-Geneva", out,
                                    device=CPU)
        else:
            jax_eval_bump.generate_cuts(y_true, sample, loss, "MAE", "2HDM-Geneva", out)
    got, want = _both(tmp_path, draw)
    assert len(want) == 14 and "bkg_suppression/best_gain_m.png" in want
    assert_same_plots(got, want)
    assert capsys.readouterr().out.count("Best MAE cut on gain") == 2
