"""The port's OE-AAE evaluation (``atlasvae_torch/eval/aae_eval.py``) and
figures (``plotting/aae_plots.py``) against ``atlasvae`` on the CPU.

Tolerances: the host code (``aae_loss_mapping``, ``adjust_weights``,
``make_discriminant``, ``smoothing``) is numpy on both sides and bit-equal.
``get_data`` on the JAX package's weights: the discriminants within rtol
1e-5 / atol 1e-5, the VAE evaluation's bar for its metric bank
(``tests/test_torch_results.py``), with and without the mass decorrelation.
The cut scans, with the JAX package's ROC handed the port's rates after
being held to them (``plot_record.roc_from``): the same best cut (threshold
or threshold pair) and efficiencies, and every cut's local sigma within
rtol 1e-5 / atol 1e-6.  The figures: the same files, and every plotted array
within rtol 1e-5 / atol 1e-6, BumpHunter's plots at
``tests/test_torch_plotting.py``'s bar for them (rtol 1e-4 / atol 1e-6),
BumpHunter's pseudo-experiments the same numpy draws on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_gaps import assert_close

import atlasvae.eval.aae_eval as jax_eval
import atlasvae.eval.roc as jax_roc
import atlasvae.plotting.aae_plots as jax_plots
import atlasvae.stats.bumphunter as jax_bh
from atlasvae.models import AAEConfig as JaxAAEConfig, init_aae as jax_init_aae
from atlasvae_torch.eval import aae_eval, roc
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.plotting import aae_plots
from atlasvae_torch.stats import bumphunter as bh
from plot_record import assert_same_plots, recording, roc_from

CPU = torch.device("cpu")
BANK = dict(rtol=1e-5, atol=1e-5)
SIGMA = dict(rtol=1e-5, atol=1e-6)
FIT_BAR = (1e-4, 1e-6)


def _sample(seed, n_bkg=6000, n_sig=1200):
    """Background jets (JZW 0-3) with an exponential mass and signal jets
    (JZW -1) peaking at 300 GeV with lognormal weights; two discriminants
    that score the signal higher."""
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
    x_loss = {name: np.clip(np.where(y_true == 0, r.normal(mu, 0.12, n),
                                     r.normal(0.4, 0.15, n)), 0, 1).astype(np.float32)
              for name, mu in (("Autoencoder", 0.7), ("Discriminator", 0.65))}
    return sample, y_true, x_loss


@pytest.mark.parametrize("values", [[0.0, 0.5, 1.0], [-1.0, -0.25, 0.0], [0.5, 3.0, 40.0],
                                    [-4.0, -1.5, -0.5], [-2.0, 0.3, 5.0]],
                         ids=["unit", "minus_unit", "positive", "negative", "mixed"])
def test_aae_loss_mapping_matches_jax(values):
    x = np.array(values)
    got, want = aae_eval.aae_loss_mapping(x), jax_eval.aae_loss_mapping(x)
    np.testing.assert_array_equal(got, want)
    assert np.all((got >= 0) & (got <= 1))


def test_adjust_weights_matches_jax():
    sample, y_true, _ = _sample(1)
    for factor in (20, 10 ** 0.5):
        got = aae_eval.adjust_weights(sample, y_true, factor=factor)
        assert got == jax_eval.adjust_weights(sample, y_true, factor=factor) and got > 0


@pytest.mark.parametrize("metric", ["MSE", "MAE", "MARE", "KLD", "JSD", "X-S", "other"])
def test_make_discriminant_matches_jax(metric):
    r = np.random.default_rng(2)
    p = r.uniform(0, 1, (300, 6)).astype(np.float32)
    q = np.where(r.random((300, 6)) < 0.1, 0, r.uniform(0, 1, (300, 6))).astype(np.float32)
    if metric == "other":
        for fn in (aae_eval.make_discriminant, jax_eval.make_discriminant):
            with pytest.raises(ValueError):
                fn(p, q, metric)
        return
    got, want = aae_eval.make_discriminant(p, q, metric), jax_eval.make_discriminant(p, q, metric)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def model():
    jparams = jax_init_aae(jax.random.PRNGKey(4), JaxAAEConfig(input_dim=12, ae_layers=(24, 8),
                                                               disc_layers=(24, 3)))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), CPU)


@pytest.mark.parametrize("normal_loss,deco", [("ON", "OFF"), ("OFF", "OFF"), ("ON", "m"),
                                              ("OFF", "2d")])
def test_get_data_matches_jax(model, normal_loss, deco):
    jparams, params = model
    sample, y_true, _ = _sample(3, n_bkg=2500, n_sig=500)
    x_true = np.random.default_rng(3).normal(0, 1, (len(y_true), 12)).astype(np.float32)
    x_true[y_true == 0] += 1.0
    got = aae_eval.get_data(params, sample, y_true, x_true, normal_loss, deco)
    want = jax_eval.get_data(jparams, sample, y_true, x_true, normal_loss, deco)
    assert list(got) == list(want) == ["Autoencoder", "Discriminator", "Auto+Disc"]
    for key in want:
        assert_close(got[key], np.asarray(want[key]), f"{key} ({normal_loss}, {deco})", **BANK)
        if normal_loss == "ON" or deco != "OFF":
            assert np.all((got[key] >= 0) & (got[key] <= 1))


def test_inference_chunks_agree(model):
    _, params = model
    x = np.random.default_rng(5).normal(size=(1000, 12)).astype(np.float32)
    whole = aae_eval.aae_inference(params, x)
    for a, b in zip(aae_eval.aae_inference(params, x, chunk=333), whole):
        np.testing.assert_array_equal(a, b)
    assert whole[0].shape == (1000, 12) and whole[1].shape == (1000, 3)


def _recorded_sigma(monkeypatch):
    """Each package's batched_local_sigma outputs, as numpy, in call order."""
    seen = {"port": [], "jax": []}
    for side, module in (("port", aae_eval), ("jax", jax_eval)):
        real = module.batched_local_sigma

        def wrapped(*args, real=real, side=side, **kwargs):
            out = real(*args, **kwargs)
            seen[side].append([np.asarray(t.cpu() if hasattr(t, "cpu") else t) for t in out])
            return out
        monkeypatch.setattr(module, "batched_local_sigma", wrapped)
    return seen


def _same_sigmas(seen):
    assert len(seen["port"]) == len(seen["jax"]) == 1
    (loc, _, _, bin_sigma), (jloc, _, _, jbin) = seen["port"][0], seen["jax"][0]
    assert np.isfinite(loc).sum() > 3
    assert_close(loc, jloc, "local sigma of every cut", **SIGMA)
    assert_close(bin_sigma, jbin, "bin significances", **SIGMA)


def test_bump_scan_matches_jax(monkeypatch):
    sample, y_true, x_loss = _sample(6)
    roc_from(monkeypatch, roc, jax_roc)
    seen = _recorded_sigma(monkeypatch)
    loss = x_loss["Autoencoder"]
    got = aae_eval.aae_bump_scan(y_true, loss, "Autoencoder", sample, "2HDM", None, n_cuts=8,
                                 make_plots=False, device=CPU)
    want = jax_eval.aae_bump_scan(y_true, loss, "Autoencoder", sample, "2HDM", None, n_cuts=8,
                                  make_plots=False)
    assert got == want and 0 < got["bkg_eff"] < 100 and 0 < got["sig_eff"] <= 100
    _same_sigmas(seen)


def test_bump_scan_2d_matches_jax(monkeypatch):
    sample, y_true, x_loss = _sample(7)
    roc_from(monkeypatch, roc, jax_roc)
    seen = _recorded_sigma(monkeypatch)
    got = aae_eval.aae_bump_scan_2d(y_true, x_loss, sample, "2HDM", None, n_cuts=7,
                                    make_plots=False, device=CPU)
    want = jax_eval.aae_bump_scan_2d(y_true, x_loss, sample, "2HDM", None, n_cuts=7,
                                     make_plots=False)
    assert got == want and set(got["cuts"]) == {"Autoencoder", "Discriminator"}
    assert seen["port"][0][0].shape == (49,)
    _same_sigmas(seen)


# ----------------------------------------------------------------- figures

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


def _both(tmp_path, draw):
    """draw(side, folder) on each side; the two recordings (files created
    empty, every save recorded)."""
    out = {}
    for side in ("port", "jax"):
        folder = tmp_path / side
        folder.mkdir()
        with recording(folder) as out[side]:
            draw(side, folder)
        assert sorted(p.name for p in folder.iterdir()) == sorted(out[side])
    return out["port"], out["jax"]


def test_logit_and_smoothing_match_jax():
    x = np.random.default_rng(8).uniform(-0.1, 1.1, 500)
    np.testing.assert_array_equal(aae_plots._logit(x), jax_plots._logit(x))
    y = np.random.default_rng(9).uniform(0, 1, 500)
    for sort in (True, False):
        for g, w in zip(aae_plots.smoothing(x, y, sort), jax_plots.smoothing(x, y, sort)):
            np.testing.assert_array_equal(g, w)


def test_plot_discriminant_matches_jax(tmp_path):
    sample, y_true, x_loss = _sample(10)

    def draw(side, out):
        module = aae_plots if side == "port" else jax_plots
        for name, best in (("Autoencoder", {"Autoencoder": 0.62}), ("Discriminator", None)):
            module.plot_discriminant(y_true, x_loss[name], sample["weights"], out, "2HDM",
                                     best, name)
    got, want = _both(tmp_path, draw)
    assert sorted(want) == ["discriminant_Autoencoder.png", "discriminant_Discriminator.png"]
    assert_same_plots(got, want)


def test_plot_correlations_and_distances_match_jax(tmp_path, monkeypatch):
    sample, y_true, x_loss = _sample(11)
    roc_from(monkeypatch, roc, jax_roc)
    for var in ("m", "pt"):
        for g, w in zip(aae_plots.get_distance(y_true, sample, x_loss["Autoencoder"], var,
                                               device=CPU),
                        jax_plots.get_distance(y_true, sample, x_loss["Autoencoder"], var)):
            assert len(g) > 20
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)

    def draw(side, out):
        if side == "port":
            aae_plots.plot_correlations(y_true, x_loss, sample, out, device=CPU)
        else:
            jax_plots.plot_correlations(y_true, x_loss, sample, out)
    got, want = _both(tmp_path, draw)
    assert list(want) == ["correlations.png"]
    assert_same_plots(got, want)


def test_bump_scan_with_plots_matches_jax(injected, tmp_path, monkeypatch):
    sample, y_true, x_loss = _sample(6)      # test_bump_scan_matches_jax's: JAX compiles once
    roc_from(monkeypatch, roc, jax_roc)
    best = {}

    def draw(side, out):
        loss = x_loss["Autoencoder"]
        if side == "port":
            best[side] = aae_eval.aae_bump_scan(y_true, loss, "Autoencoder", sample, "2HDM", out,
                                                n_cuts=8, npe=10, device=CPU)
        else:
            monkeypatch.setattr(jax_eval, "bump_hunter", _with_npe(jax_eval.bump_hunter, 10))
            best[side] = jax_eval.aae_bump_scan(y_true, loss, "Autoencoder", sample, "2HDM",
                                                out, n_cuts=8)
    got, want = _both(tmp_path, draw)
    assert sorted(want) == ["BH_best.png", "BH_bkg_supp_m.png", "BH_bkg_supp_pt.png",
                            "BH_sigma.png", "BH_uncut.png"]
    assert best["port"] == best["jax"]
    assert_same_plots(got, want, bars={"BH_sigma.png": FIT_BAR, "BH_best.png": FIT_BAR,
                                       "BH_uncut.png": FIT_BAR})


def test_bump_scan_2d_with_plots_matches_jax(injected, tmp_path, monkeypatch):
    sample, y_true, x_loss = _sample(7)
    roc_from(monkeypatch, roc, jax_roc)
    best = {}

    def draw(side, out):
        if side == "port":
            best[side] = aae_eval.aae_bump_scan_2d(y_true, x_loss, sample, "2HDM", out, n_cuts=7,
                                                   npe=10, device=CPU)
        else:
            monkeypatch.setattr(jax_eval, "bump_hunter", _with_npe(jax_eval.bump_hunter, 10))
            best[side] = jax_eval.aae_bump_scan_2d(y_true, x_loss, sample, "2HDM", out,
                                                   n_cuts=7)
    got, want = _both(tmp_path, draw)
    # BH_best.png only where the best pair keeps 100 background jets
    assert {"BH_bkg_supp_m.png", "BH_bkg_supp_pt.png", "BH_uncut.png",
            "ROC_2d_cuts.png"} <= set(want)
    assert best["port"] == best["jax"]
    assert_same_plots(got, want, bars={"BH_best.png": FIT_BAR, "BH_uncut.png": FIT_BAR})


def _with_npe(bump_hunter, npe):
    """The JAX package's bump_hunter at another npe (its scans call it with
    the default 1,000)."""
    return lambda *args, **kwargs: bump_hunter(*args, **dict(kwargs, npe=npe))
