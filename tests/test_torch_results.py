"""The evaluation half of the VAE CLI (``atlasvae_torch/cli/vae.py::_evaluate``,
``eval/results.py::plot_results``) and the jet-ID report's plots
(``cli/jetid.py::_report_results``) against the JAX package's.

Tolerances: ``_evaluate``'s validation sample, labels and inputs exact;
with JAX's threefry noise put into ``_eval_noise``, its predictions within
1e-5 of their largest magnitude (``test_torch_vae.py``'s reconstruction
bar).  ``plot_results`` on the same inputs: the metric bank, mapped and
decorrelated, within rtol 1e-5 / atol 1e-5 (``test_torch_score.py``); the
best cut's metric equal, its threshold within rtol 1e-5 and its efficiency
(a ROC rate, in percent) within 1e-4; the same files drawn with the same
axes, artists and texts (each printed number within one unit of its last
digit).  The jet-ID report on the same
probabilities: the same files and every plotted array within rtol 1e-5 /
atol 1e-6 once the JAX package's ROC is held to the port's
(``tests/plot_record.py``).
"""

import argparse

import jax
import numpy as np
import pytest
import torch

import atlasvae.data.loader as jax_loader
import atlasvae.eval.roc as jax_roc
from atlasvae.cli import jetid as jax_jetid_cli, vae as jax_vae_cli
from atlasvae.data import HLV_LIST, fit_scaler as jax_fit_scaler, registry as jax_registry
from atlasvae.eval import plot_results as jax_plot_results
from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae_torch.cli import jetid as jetid_cli, vae as vae_cli
from atlasvae_torch.data import fit_scaler, load_data, registry
from atlasvae_torch.eval import plot_results, roc
from atlasvae_torch.interop import params_from_jax
from plot_record import assert_same_plots, assert_same_structure, jax_eval_noise, recording, \
    roc_from
from torch_gaps import assert_close

CPU = torch.device("cpu")
BANK = dict(rtol=1e-5, atol=1e-5)
VALID_CUTS = ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)']


@pytest.fixture(scope="module")
def model():
    params = jax_init_vae(jax.random.PRNGKey(3), JaxVAEConfig())
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _eval_args(parser, n_iter, out):
    args = parser.parse_args(["--plotting", "OFF", "--apply_cuts", "ON", "--n_iter",
                              str(n_iter), "--HLV_scaler_type", "RobustScaler"])
    args.n_valid, args.n_sig = [1000, 4000], 3000
    args.output_dir, args.hist_file = str(out), str(out / "history.pkl")
    return args


@pytest.mark.parametrize("n_iter", [1, 2])
def test_evaluate_predictions_match_jax(n_iter, model, synth_dir, tmp_path, monkeypatch):
    for name in ("QCD-Geneva", "2HDM-Geneva"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
        jax_registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    jparams, params = model
    hlvs = load_data("QCD-Geneva", 1000, VALID_CUTS, device="cpu", verbose=False)["HLVs"]
    seen = {}

    def filtering(*args):
        seen["jax"] = real(*args)
        return seen["jax"]
    real = jax_loader.filtering
    monkeypatch.setattr(jax_loader, "filtering", filtering)
    jax_vae_cli._evaluate(_eval_args(jax_vae_cli.build_parser(), n_iter, tmp_path), jparams,
                          None, jax_fit_scaler(hlvs, scaler_type="RobustScaler",
                                               verbose=False), list(HLV_LIST), VALID_CUTS)
    monkeypatch.setattr(vae_cli, "_eval_noise", jax_eval_noise)
    args = _eval_args(vae_cli.build_parser(), n_iter, tmp_path)
    scaler = fit_scaler(hlvs, scaler_type="RobustScaler", verbose=False)
    *got, wall_ms = vae_cli._valid_predictions(args, params, None, scaler, list(HLV_LIST),
                                               VALID_CUTS, CPU)
    assert set(wall_ms) == {"sample", "scale", "predict", "filtering"}
    y_true, x_true, x_pred, sample = got
    want = seen["jax"]
    np.testing.assert_array_equal(y_true, want[0])
    assert 2000 < len(y_true) and set(np.unique(y_true)) == {0, 1}
    assert_close(x_true, want[1], "x_true", rtol=1e-6, atol=1e-6)
    assert_close(x_pred, want[2], "x_pred", atol=1e-5 * np.abs(want[2]).max())
    assert sorted(sample) == sorted(want[3])
    for key in want[3]:
        np.testing.assert_array_equal(sample[key], want[3][key], err_msg=key)
    # Geneva signal weights are divided by 1e3, as in the JAX CLI
    assert sample["weights"][y_true == 0].max() <= 1e-3
    # --plotting OFF --apply_cuts ON predicts and filters, and draws nothing
    vae_cli._evaluate(args, params, None, scaler, list(HLV_LIST), VALID_CUTS, CPU)
    assert not any(tmp_path.iterdir())


def _results_inputs(seed, n_bkg=3400, n_sig=600):
    """Scaled inputs, predictions near them (the signal reconstructed
    worse), and the sample's kinematics with a 300 GeV signal peak."""
    r = np.random.default_rng(seed)
    n = n_bkg + n_sig
    y_true = np.concatenate([np.ones(n_bkg, int), np.zeros(n_sig, int)])
    x_true = r.normal(0, 1, (n, 12)).astype(np.float32)
    x_pred = (x_true + r.normal(0, 1, (n, 12)) * np.where(y_true == 0, 0.8, 0.4)[:, None]
              ).astype(np.float32)
    sample = {
        "m": np.concatenate([r.exponential(80, n_bkg) + 30,
                             r.normal(300, 15, n_sig)]).astype(np.float32),
        "pt": r.uniform(450, 1100, n).astype(np.float32),
        "weights": r.lognormal(0, 0.3, n).astype(np.float32),
        "JZW": np.concatenate([r.integers(0, 4, n_bkg), -np.ones(n_sig)]).astype(np.float32),
        "HLVs": x_true,
    }
    return y_true, x_true, x_pred, sample


@pytest.mark.parametrize("deco,cuts", [("OFF", "OFF"), ("2d", "OFF"), ("2d", "ON")])
def test_plot_results_matches_jax(deco, cuts, model, tmp_path, monkeypatch):
    jparams, params = model
    y_true, x_true, x_pred, sample = _results_inputs(8)
    roc_from(monkeypatch, roc, jax_roc)
    metrics = ["Latent", "MAE", "KLD", "JSD"]
    out = {}
    for side in ("port", "jax"):
        folder = tmp_path / side
        folder.mkdir()
        with recording(folder) as records:
            if side == "port":
                result = plot_results(y_true, x_true, x_pred, sample, 3, params, metrics,
                                      "MAE", "2HDM-Geneva", folder, cuts, "ON", deco, npe=10,
                                      device=CPU)
            else:
                result = jax_plot_results(y_true, x_true, x_pred, sample, 3, jparams, metrics,
                                          "MAE", "2HDM-Geneva", folder, cuts, "ON", deco,
                                          npe=10)
        out[side] = result, records
    (best, losses), records = out["port"]
    (want_best, want_losses), want_records = out["jax"]
    assert_same_structure(records, want_records)
    assert len(records) == 11 + 14 * (cuts == "ON")
    assert sorted(losses) == sorted(want_losses) == sorted(metrics)
    for key in metrics:
        assert_close(losses[key], np.asarray(want_losses[key]), f"x_losses {key}", **BANK)
    assert best["metric"] == want_best["metric"] == "MAE"
    assert best["loss"] == pytest.approx(want_best["loss"], rel=1e-5)
    assert best["eff"] == pytest.approx(want_best["eff"], abs=1e-4)


def test_plot_results_refuses_a_mesh(model, tmp_path):
    """Once refused (ROADMAP Queue 1 item 11), now run: over a mesh of one
    rank, with the EMD and KSD metrics that the mesh shards, the same
    numbers and the same plots as without it."""
    from atlasvae_torch.parallel import data_parallel_mesh
    from torch_dist_checks import one_rank_group
    _, params = model
    y_true, x_true, x_pred, sample = _results_inputs(8, n_bkg=680, n_sig=120)
    metrics = ["MAE", "EMD", "KSD"]
    out = {}
    with one_rank_group(tmp_path):
        for side, mesh in (("one", None), ("mesh", data_parallel_mesh())):
            folder = tmp_path / side
            folder.mkdir()
            with recording(folder) as records:
                best, losses = plot_results(y_true, x_true, x_pred, sample, 3, params, metrics,
                                            "MAE", "2HDM-Geneva", folder, npe=10, mesh=mesh,
                                            device=CPU)
            out[side] = best, losses, records
    assert_same_structure(out["mesh"][2], out["one"][2])
    assert out["mesh"][0] == out["one"][0]
    for key in metrics:
        np.testing.assert_array_equal(out["mesh"][1][key], out["one"][1][key], err_msg=key)


def test_jetid_report_draws_what_jax_draws(tmp_path, monkeypatch, capsys):
    """--plotting ON --sep_bkg ON on three classes: the merged background's
    ROC curves and class distributions, and each background class's ROC
    curves in its class_0_vs_<k> folder."""
    r = np.random.default_rng(9)
    n = 3000
    labels = r.integers(0, 3, n)
    logits = r.normal(0, 1, (n, 3)) + 1.5 * np.eye(3)[labels]
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    view = {"weights": r.lognormal(0, 0.3, n).astype(np.float32),
            "m": r.uniform(30, 300, n).astype(np.float32)}
    args = argparse.Namespace(sep_bkg="ON", plotting="ON")
    roc_from(monkeypatch, roc, jax_roc)
    out = {}
    for side in ("port", "jax"):
        folder = tmp_path / side
        folder.mkdir()
        with recording(folder) as records:
            if side == "port":
                jetid_cli._report_results(view, labels, probs, labels, args, str(folder), CPU)
            else:
                jax_jetid_cli._report_results(view, labels, probs, labels, args, str(folder),
                                              lambda v: v.upper() == "ON")
        out[side] = records, capsys.readouterr().out.replace(str(folder), "<out>")
    assert sorted(out["jax"][0]) == [
        "bkg_rejection.png", "class_0_vs_1/bkg_rejection.png", "class_0_vs_1/signal_gain.png",
        "class_0_vs_2/bkg_rejection.png", "class_0_vs_2/signal_gain.png", "distributions.png",
        "signal_gain.png"]
    assert_same_plots(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
