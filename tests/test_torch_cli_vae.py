"""``atlasvae_torch.cli.vae`` end to end on the shared synthetic files,
against ``atlasvae.cli.vae`` on the same arguments.

The two CLIs draw their initial weights and latent noise from different
generators, so they are compared on what they write: the same files, the
same history keys and epochs, weights that load in either package.  Keras
``.h5`` files go both ways: the port starts from the JAX CLI's ``model.h5``
and ends with one that the JAX package reads as the port's weights.  The
parts of the JAX CLI the port does not run yet are refused before any data
is loaded.
"""

import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from atlasvae.cli import vae as jax_vae
from atlasvae.data import registry as jax_registry
from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae, \
    vae_apply as jax_vae_apply
from atlasvae.train.keras_import import load_keras_vae as jax_load_keras_vae
from atlasvae.train.checkpoint import load_pytree as jax_load_pytree, save_pytree as \
    jax_save_pytree
from atlasvae_torch.cli import vae
from atlasvae_torch.data import registry
from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
from atlasvae_torch.train.checkpoint import load_pytree, tree_flatten
from plot_record import assert_same_structure, jax_eval_noise, recording
from test_torch_keras import record_keras_calls, same_leaves

ARGS = ["--n_train", "2000", "--n_valid", "1000", "--n_OoD", "3000", "--batch_size", "500",
        "--n_epochs", "2", "--beta", "2", "--lamb", "5", "--OE_type", "MAE",
        "--weight_type", "X-S", "--HLV_scaler_type", "RobustScaler", "--plotting", "OFF"]


# The canonical HLV model, and constituents mode (8 constituents x (px, py,
# pz) through a 24->16/8/4 stack): the extra arguments, the model's widths and
# the scaler file each run writes.
MODES = {
    "canonical": ([], {}, "HLV_RobustScaler.pkl"),
    "constituents": (["--constituents", "ON", "--HLVs", "OFF", "--n_const", "8", "--n_dims", "3",
                      "--const_scaler_type", "RobustScaler", "--FC_layers", "16", "8", "4"],
                     dict(fc_layers=(16, 8, 4), input_dim=24), "const_RobustScaler.pkl"),
}


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request, synth_dir, tmp_path_factory):
    # both packages' registries: a JAX CLI run with --synthetic earlier in
    # the same worker re-registers the JAX names to its own files
    for name in ("QCD-Geneva", "OoD-H"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
        jax_registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    extra_args, widths, scaler = MODES[request.param]
    out = {"widths": widths, "scaler": scaler}
    for side, main, extra in (("port", vae.main, ["--device", "cpu"]),
                              ("jax", jax_vae.main, [])):
        root = tmp_path_factory.mktemp(f"{side}_{request.param}")
        assert main(ARGS + extra_args + ["--output_dir", str(root)] + extra) == 0
        out[side] = root
    return out


def test_writes_the_same_files_and_history_keys(runs):
    hist = {}
    for side in ("port", "jax"):
        root = runs[side]
        assert (root / "model.npz").is_file() and (root / runs["scaler"]).is_file()
        with open(root / "history.pkl", "rb") as f:
            hist[side] = pickle.load(f)
    assert sorted(p.name for p in runs["port"].iterdir()) == \
        sorted(p.name for p in runs["jax"].iterdir())
    assert list(hist["port"]) == list(hist["jax"]) == ["MSE", "KLD", "OE", "Train loss",
                                                       "Valid loss"]
    for key, vals in hist["port"].items():
        assert len(vals) == 2 and np.isfinite(vals).all()
    assert hist["port"]["Train loss"][1] < hist["port"]["Train loss"][0]


def test_weights_load_in_either_package(runs):
    template = init_vae(torch.Generator().manual_seed(0), VAEConfig(**runs["widths"]),
                        device="cpu")
    jax_template = jax_init_vae(jax.random.PRNGKey(0), JaxVAEConfig(**runs["widths"]))
    loaded = {"jax": tree_flatten(load_pytree(str(runs["jax"] / "model.npz"), template)),
              "port": jax.tree_util.tree_leaves(
                  jax_load_pytree(str(runs["port"] / "model.npz"), jax_template))}
    for side, leaves in loaded.items():
        with np.load(runs[side] / "model.npz") as saved:
            assert len(saved.files) == len(leaves)
            for i, leaf in enumerate(leaves):
                np.testing.assert_array_equal(np.asarray(leaf), saved[f"leaf_{i}"])


def test_keras_files_in_and_out(synth_dir, tmp_path, monkeypatch):
    """--model_in the JAX CLI's model.h5 starts the port from the JAX run's
    weights (bit for bit; its forward gives the JAX run's predictions), and
    --model_out model.h5 ends the port's run with a Keras file that JAX's
    load_keras_vae reads as the port's final weights."""
    for name in ("QCD-Geneva", "OoD-H"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
        jax_registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    argv = ARGS + ["--model_out", "model.h5"]     # epoch 2 improves: a checkpoint, then the export
    assert jax_vae.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    (tmp_path / "port").mkdir()
    shutil.copy(tmp_path / "jax" / "model.h5", tmp_path / "port" / "jax.h5")
    loads, exports = record_keras_calls(monkeypatch)
    assert vae.main(argv + ["--model_in", "jax.h5", "--output_dir", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    template = jax_init_vae(jax.random.PRNGKey(0), JaxVAEConfig())
    jax_weights = jax_load_keras_vae(str(tmp_path / "jax" / "model.h5"), template)
    same_leaves(loads[0][1], jax_weights)
    x = np.random.default_rng(3).normal(size=(200, 12)).astype(np.float32)
    want = np.asarray(jax_vae_apply(jax_weights, x, jax.random.PRNGKey(0), sample=False)[0])
    with torch.no_grad():
        got = vae_apply(loads[0][1], torch.from_numpy(x), sample=False)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    ((model_out, params),) = exports
    assert model_out == str(tmp_path / "port" / "model.h5")
    with open(model_out, "rb") as f:
        assert f.read(4) == b"\x89HDF"
    same_leaves(params, jax_load_keras_vae(model_out, template))


@pytest.mark.parametrize("extra,item", [
    (["--n_devices", "2"], "item 11"),
])
def test_unported_options_refused_before_any_load(tmp_path, extra, item, synth_dir,
                                                 monkeypatch):
    """Once refused (ROADMAP Queue 1 ``item``), now run: ``--n_devices 2``
    trains on two CPU ranks over gloo and writes what the one-device run
    writes, its history and weights at the data-parallel bars of
    tests/test_train.py:34-60 (rtol 2e-3, atol 5e-4), the scaler the same."""
    monkeypatch.setenv("ATLASVAE_DATA_DIR", str(synth_dir))     # the ranks' registry
    for name in ("QCD-Geneva", "OoD-H"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    roots = {n: tmp_path / n for n in ("1", extra[1])}
    for n, root in roots.items():
        assert vae.main(ARGS + ["--output_dir", str(root), "--device", "cpu",
                                "--n_devices", n]) == 0
    one, ranked = roots["1"], roots[extra[1]]
    assert sorted(os.listdir(ranked)) == sorted(os.listdir(one))
    with open(one / "history.pkl", "rb") as f, open(ranked / "history.pkl", "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-3, err_msg=key)
    template = init_vae(torch.Generator().manual_seed(0), VAEConfig(), device="cpu")
    for a, b in zip(tree_flatten(load_pytree(str(ranked / "model.npz"), template)),
                    tree_flatten(load_pytree(str(one / "model.npz"), template))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4)
    with open(one / "HLV_RobustScaler.pkl", "rb") as f, \
            open(ranked / "HLV_RobustScaler.pkl", "rb") as g:
        assert f.read() == g.read()


def test_plotting_without_matplotlib_refused_before_any_load(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = ARGS[:-2] + ["--output_dir", str(tmp_path), "--bkg_data", "no-such-sample",
                        "--device", "cpu"]
    with pytest.raises(ImportError, match="matplotlib"):
        vae.main(argv)
    assert not os.path.exists(tmp_path / "plots")


def _fresh_registries(monkeypatch, data_dir):
    """--synthetic files in data_dir, registered for this test only."""
    monkeypatch.setenv("ATLASVAE_DATA_DIR", str(data_dir))
    for reg in (registry, jax_registry):
        monkeypatch.setattr(reg, "_OVERRIDES", dict(reg._OVERRIDES))


def test_default_run_draws_the_same_files_as_jax(tmp_path, monkeypatch):
    _fresh_registries(monkeypatch, tmp_path / "data")
    monkeypatch.setattr(vae, "_eval_noise", jax_eval_noise)
    weights = jax_init_vae(jax.random.PRNGKey(5), JaxVAEConfig())
    argv = ["--synthetic", "3000", "--n_train", "1000", "--n_valid", "1000", "--n_sig", "1000",
            "--n_epochs", "0", "--model_in", "model.npz", "--apply_cuts", "ON", "--npe", "20"]
    records, files = {}, {}
    for side, main, extra in (("jax", jax_vae.main, []), ("port", vae.main, ["--device", "cpu"])):
        root = tmp_path / side
        root.mkdir()
        jax_save_pytree(str(root / "model.npz"), weights)
        with recording(root / "plots", write=side == "port") as records[side]:
            assert main(argv + ["--output_dir", str(root)] + extra) == 0
        files[side] = sorted(str(p.relative_to(root)) for p in (root / "plots").rglob("*.png"))
    assert files["port"] == files["jax"]
    assert len(files["port"]) == 25 and "plots/bkg_suppression/best_gain_m.png" in files["port"]
    assert_same_structure(records["port"], records["jax"])


def test_plotting_run_draws_the_training_distributions(synth_dir, tmp_path):
    """Under --plotting ON both CLIs draw the first training load's m and
    pt distributions, the background beside the reweighted OoD sample.  The
    two packages pair each background jet with an OoD jet of its (m, pt)
    cell drawn from their own generators, so the plots share their
    structure, not their arrays."""
    for name in ("QCD-Geneva", "OoD-H", "2HDM-Geneva"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
        jax_registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    argv = ARGS[:-2] + ["--n_epochs", "1", "--plotting", "ON", "--npe", "10"]
    records = {}
    for side, main, extra in (("jax", jax_vae.main, []), ("port", vae.main, ["--device", "cpu"])):
        with recording(tmp_path / side / "plots") as records[side]:
            assert main(argv + ["--output_dir", str(tmp_path / side)] + extra) == 0
        assert {"train_m.png", "train_pt.png", "BH_sigma.png"} <= set(records[side])
    train = {side: {k: v for k, v in rec.items() if k.startswith("train_")}
             for side, rec in records.items()}
    assert_same_structure(train["port"], train["jax"])
    assert [t for t, _ in train["port"]["train_m.png"][0]["texts"]][-2:] == ["OoD", "QCD"]


def test_defaults_to_the_card():
    assert vae.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            vae.main(["--plotting", "OFF", "--bkg_data", "no-such-sample"])
