"""``atlasvae_torch.cli.aae`` and ``cli/score.py --model_type aae`` end to
end on synthetic files, against the JAX package's CLIs on the same
arguments.

Training: the two CLIs draw their initial weights and their OoD pairing
from different generators, so a ``--plotting OFF`` run is compared on what
it writes: the same files, the same history series and (cycle, epoch)
indices, weights that load in either package.  The evaluation: both CLIs
evaluate the same weights (``--n_epochs 0 --model_in``), with the JAX
package's ROC handed the port's rates and BumpHunter's pseudo-experiments
the same numpy draws on both sides (20 of them, where the CLIs draw 1,000): the same files drawn, with the same
axes, artists and texts (numbers within one unit of the last digit
printed).  Scoring: the three discriminants within rtol 1e-5 / atol 1e-6
of the JAX CLI's, the kinematics and weights exact.  Keras ``.h5`` files:
the port starts from the JAX CLI's ``AAE.h5`` and a reference-style AE-only
``AE.h5``, and its ``--model_out AAE.h5`` is read by the JAX package as the
port's weights.  What the port does not run yet, and an evaluation where
matplotlib cannot be imported, is refused before any data is loaded.
"""

import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atlasvae.eval.aae_eval as jax_eval
import atlasvae.eval.roc as jax_roc
import atlasvae.stats.bumphunter as jax_bh
from atlasvae.cli import aae as jax_aae, score as jax_score
from atlasvae.data import registry as jax_registry, synthetic as jax_synthetic, load_data as jax_load_data, \
    fit_scaler as jax_fit_scaler
from atlasvae.models import AAEConfig as JaxAAEConfig, init_aae as jax_init_aae
from atlasvae.models.aae import ae_apply as jax_ae_apply, \
    discriminator_apply as jax_discriminator_apply
from atlasvae.train.keras_export import export_keras_aae as jax_export_keras_aae
from atlasvae.train.keras_import import load_keras_aae as jax_load_keras_aae
from atlasvae.train.checkpoint import load_pytree as jax_load_pytree, save_pytree as \
    jax_save_pytree
from atlasvae_torch.cli import aae, score
from atlasvae_torch.data import hdf5, registry
from atlasvae_torch.eval import aae_eval, roc
from atlasvae_torch.models import AAEConfig, init_aae
from atlasvae_torch.models.aae import ae_apply, discriminator_apply
from atlasvae_torch.stats import bumphunter as bh
from atlasvae_torch.train.checkpoint import load_pytree
from plot_record import assert_same_structure, recording, roc_from
from test_torch_keras import record_keras_calls, same_leaves

WIDTHS = ["--layers_sizes", "24", "8"]
ARGS = ["--synthetic", "3000", "--n_train", "1000", "--n_valid", "1000", "--n_sig", "1000",
        "--n_OoD", "1000", "--batch_size", "500", "--lamb", "1", "--beta", "1", "--lr", "1e-3",
        "--HLV_scaler_type", "RobustScaler"] + WIDTHS
SERIES = ["QCD-AE Loss", "OoD-AE Loss", "OE Loss", "AE Loss", "Disc Loss", "Disc Accuracy"]


def _fresh_registries(monkeypatch, data_dir):
    """--synthetic files in data_dir, registered for this test only."""
    monkeypatch.setenv("ATLASVAE_DATA_DIR", str(data_dir))
    for reg in (registry, jax_registry):
        monkeypatch.setattr(reg, "_OVERRIDES", dict(reg._OVERRIDES))


def _jax_weights():
    return jax_init_aae(jax.random.PRNGKey(3), JaxAAEConfig(input_dim=12, ae_layers=(24, 8)))


def test_training_run_writes_what_the_jax_cli_writes(tmp_path, monkeypatch):
    """--plotting OFF --apply_cuts OFF trains and ends, and needs no
    matplotlib (the port's run has none)."""
    _fresh_registries(monkeypatch, tmp_path / "data")
    argv = ARGS + ["--n_epochs", "1", "--plotting", "OFF"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        assert aae.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_aae.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    names = {side: sorted(p.name for p in (tmp_path / side).iterdir()) for side in ("port", "jax")}
    assert names["port"] == names["jax"] == ["AAE.npz", "HLV_RobustScaler.pkl", "history.pkl"]
    hist = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "history.pkl", "rb") as f:
            hist[side] = pickle.load(f)
    assert list(hist["port"]) == list(hist["jax"]) == SERIES
    for key in SERIES:
        assert [e[:2] for e in hist["port"][key]] == [e[:2] for e in hist["jax"][key]], key
        assert np.isfinite([e[2] for e in hist["port"][key]]).all()
    # the weights load in either package
    jax_tree = jax_load_pytree(str(tmp_path / "port" / "AAE.npz"), _jax_weights())
    template = init_aae(torch.Generator().manual_seed(0), AAEConfig(input_dim=12,
                                                                    ae_layers=(24, 8)),
                        device="cpu")
    port_tree = load_pytree(str(tmp_path / "jax" / "AAE.npz"), template)
    assert jax.tree.structure(jax_tree) == jax.tree.structure(_jax_weights())
    assert port_tree["discriminator"]["out"]["w"].shape == (100, 3)


@pytest.fixture()
def injected(monkeypatch):
    """Both packages' _poisson_pseudo replaced by the same numpy stream."""
    def draws():
        rng = np.random.default_rng(5)
        return lambda rate, npe: rng.poisson(np.asarray(rate, np.float64),
                                             (npe,) + np.shape(rate)).astype(np.float32)
    jax_take, port_take = draws(), draws()
    monkeypatch.setattr(jax_bh, "_poisson_pseudo",
                        lambda key, ref, npe: jnp.asarray(jax_take(ref, npe)))
    monkeypatch.setattr(bh, "_poisson_pseudo",
                        lambda gen, rate, npe: torch.as_tensor(port_take(rate.cpu(), npe),
                                                               device=rate.device))


@pytest.mark.parametrize("scan_2d", ["OFF", "ON"])
def test_evaluation_draws_the_same_files_as_jax(tmp_path, monkeypatch, injected, scan_2d):
    """Both CLIs evaluate the same weights with the same HLV scaler (raw HLVs
    would saturate the discriminator's softmax, where XLA flushes denormal
    probabilities to 0 and torch keeps them)."""
    _fresh_registries(monkeypatch, tmp_path / "data")
    jax_synthetic.ensure_synthetic_registry(tmp_path / "data", n_events=3000, n_const_max=20)
    scaler = jax_fit_scaler(jax_load_data("QCD-Geneva", 1000, verbose=False)["HLVs"],
                            verbose=False)
    roc_from(monkeypatch, roc, jax_roc)
    # BumpHunter at 20 pseudo-experiments on both sides (the CLIs run 1,000)
    real_hunter, real_numbers = jax_eval.bump_hunter, aae_eval._hunter_numbers
    monkeypatch.setattr(jax_eval, "bump_hunter",
                        lambda *args, **kwargs: real_hunter(*args, **dict(kwargs, npe=20)))
    monkeypatch.setattr(aae_eval, "_hunter_numbers",
                        lambda *args, **kwargs: real_numbers(*args, **dict(kwargs, npe=20)))
    argv = ARGS + ["--n_epochs", "0", "--model_in", "AAE.npz", "--HLV_scaler_in",
                   "HLV_RobustScaler.pkl", "--scan_2d", scan_2d]
    records, files = {}, {}
    for side, main, extra in (("jax", jax_aae.main, []), ("port", aae.main, ["--device", "cpu"])):
        root = tmp_path / side
        root.mkdir()
        jax_save_pytree(str(root / "AAE.npz"), _jax_weights())
        scaler.save(str(root / "HLV_RobustScaler.pkl"))
        with recording(root) as records[side]:
            assert main(argv + ["--output_dir", str(root)] + extra) == 0
        files[side] = sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))
    assert files["port"] == files["jax"]
    want = {"top-Geneva/BH_uncut.png", "top-Geneva/correlations.png",
            "top-Geneva/bkg_rejection.png", "top-Geneva/discriminant_Auto+Disc.png",
            "top-Geneva/ROC_2d_cuts.png" if scan_2d == "ON" else "top-Geneva/BH_sigma.png"}
    assert want <= set(files["port"])
    assert_same_structure(records["port"], records["jax"])


def test_keras_files_in_and_out(tmp_path, monkeypatch, capsys):
    """The JAX CLI trains with --model_out AAE.h5; the port starts from that
    file (--model_in: the same weights bit for bit, the JAX run's outputs on
    the same inputs) and from the reference's AE-only AE.h5 (--AE_weights:
    its 100 AE epochs skipped), and its --model_out AAE.h5 is read by JAX's
    load_keras_aae as the weights the port exported."""
    _fresh_registries(monkeypatch, tmp_path / "data")
    argv = ARGS + ["--n_epochs", "1", "--plotting", "OFF", "--model_out", "AAE.h5"]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    assert jax_aae.main(argv + ["--output_dir", str(jax_root)]) == 0
    jax_weights = jax_load_keras_aae(str(jax_root / "AAE.h5"), _jax_weights())
    port_root.mkdir()
    shutil.copy(jax_root / "AAE.h5", port_root / "jax.h5")
    jax_export_keras_aae(jax_weights, str(port_root / "AE.h5"), include_discriminator=False)
    loads, exports = record_keras_calls(monkeypatch)
    capsys.readouterr()
    assert aae.main(argv + ["--model_in", "jax.h5", "--AE_weights", "AE.h5", "--output_dir",
                            str(port_root), "--device", "cpu"]) == 0
    assert "Loading pre-trained AE file" in capsys.readouterr().out
    with open(port_root / "history.pkl", "rb") as f:
        assert len(pickle.load(f)["QCD-AE Loss"]) == 5        # the AAE phase's (105 with AE's)
    ((_, loaded),) = loads
    same_leaves(loaded, jax_weights)
    x = np.random.default_rng(4).normal(size=(64, 12)).astype(np.float32)
    with torch.no_grad():
        recon = ae_apply(loaded, torch.from_numpy(x))
        probs = discriminator_apply(loaded, recon)
    want = np.asarray(jax_ae_apply(jax_weights, x))
    for got, ref in ((recon, want), (probs, np.asarray(jax_discriminator_apply(jax_weights,
                                                                               want)))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    ((model_out, params),) = exports
    assert model_out == str(port_root / "AAE.h5")
    with open(model_out, "rb") as f:
        assert f.read(4) == b"\x89HDF"
    same_leaves(params, jax_load_keras_aae(model_out, _jax_weights()))


@pytest.mark.parametrize("extra,item", [
    (["--n_devices", "2"], "item 11"),
])
def test_unported_options_refused_before_any_load(tmp_path, extra, item, monkeypatch):
    """Once refused (ROADMAP Queue 1 ``item``), now run: the GAN cycle on
    two CPU ranks writes what the one-device run writes, its loss history
    at the data-parallel bar of tests/test_aae.py:246 (rtol 5e-3, atol
    1e-5)."""
    _fresh_registries(monkeypatch, tmp_path / "data")
    roots = {n: tmp_path / n for n in ("1", extra[1])}
    for n, root in roots.items():
        assert aae.main(ARGS + ["--n_epochs", "1", "--plotting", "OFF", "--apply_cuts", "OFF",
                                "--output_dir", str(root), "--device", "cpu",
                                "--n_devices", n]) == 0
    one, ranked = roots["1"], roots[extra[1]]
    assert sorted(os.listdir(ranked)) == sorted(os.listdir(one))
    with open(one / "history.pkl", "rb") as f, open(ranked / "history.pkl", "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose([v for _, _, v in got[key]], [v for _, _, v in want[key]],
                                   rtol=5e-3, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("extra", [[], ["--plotting", "OFF", "--apply_cuts", "ON"]],
                         ids=["plotting", "apply_cuts"])
def test_evaluation_without_matplotlib_refused_before_any_load(tmp_path, monkeypatch, extra):
    """The JAX CLI's evaluation always draws, --apply_cuts ON alone too."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = ["--bkg_data", "no-such-sample", "--output_dir", str(tmp_path / "out"),
            "--device", "cpu"] + extra
    with pytest.raises(ImportError, match="matplotlib") as refused:
        aae.main(argv)
    assert ("--apply_cuts ON" if extra else "--plotting ON") in str(refused.value)
    assert not (tmp_path / "out").exists()


def test_defaults_to_the_card():
    parsed = aae.build_parser().parse_args([])
    assert parsed.device == "cuda" and parsed.plotting == "ON" and parsed.lr == 1e-6
    assert sorted(set(vars(parsed)) - {"device"}) == sorted(vars(jax_aae.build_parser().parse_args([])))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            aae.main(["--plotting", "OFF", "--bkg_data", "no-such-sample"])


def test_score_aae_matches_the_jax_cli(synth_dir, tmp_path):
    path = str(synth_dir / "synthetic_QCD-Geneva.h5")
    jax_save_pytree(str(tmp_path / "AAE.npz"), _jax_weights())
    jax_fit_scaler(jax_load_data(path, 4000, verbose=False)["HLVs"],
                   scaler_out=tmp_path / "hlv.pkl", verbose=False)
    common = ["--data", path, "--model_in", str(tmp_path / "AAE.npz"), "--model_type", "aae",
              "--HLV_scaler_in", str(tmp_path / "hlv.pkl"), "--n_jets", "3000", "--chunk",
              "1000"] + WIDTHS
    jax_score.main(common + ["--output", str(tmp_path / "jax.h5")])
    score.main(common + ["--output", str(tmp_path / "port.h5"), "--device", "cpu"])
    out = {}
    for name in ("jax", "port"):
        with hdf5.File(tmp_path / f"{name}.h5", "r") as f:
            out[name] = {k: f[k][:] for k in f}
    assert set(out["port"]) == set(out["jax"]) == {
        "score_Autoencoder", "score_Discriminator", "score_Auto+Disc", "m", "pt", "weights"}
    for key, val in out["port"].items():
        assert val.shape == (3000,) and val.dtype == np.float32 and np.isfinite(val).all()
        if key.startswith("score_"):
            np.testing.assert_allclose(val, out["jax"][key], rtol=1e-5, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(val, out["jax"][key])
