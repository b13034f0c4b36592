"""``atlasvae_torch.cli.jetid`` end to end on the shared synthetic files, in
CNN and FCN mode, against ``atlasvae.cli.jetid``.

The two CLIs draw their initial weights from different generators, so the
port trains, and the JAX CLI then predicts with the port's ``model.npz``
(and, in CNN mode, its ``image_scale.pkl``) on the same sample: both print
the same accuracy and AUC lines (2 and 4 decimals) and background
rejections within 1 % (one jet more or less below a threshold), and their
probabilities agree to rtol 2e-5 / atol 2e-5, the whole-model bar of
tests/test_tf_parity.py.  A predict-only run of the port reproduces the
training run's probabilities bit for bit.  What the port does not run yet is
refused before any data is loaded.
"""

import pickle
import shutil

import numpy as np
import pytest
import torch

from atlasvae.cli import jetid as jax_jetid_cli
from atlasvae_torch.cli import jetid as cli
from atlasvae_torch.data import registry

COMMON = ["--n_train", "1500", "--n_valid", "1000", "--batch_size", "500", "--mixed_precision",
          "OFF", "--plotting", "OFF", "--image_size", "12", "--FCN_neurons", "24", "16",
          "--verbose", "0"]
PROB_TOL = 2e-5


def _report(text):
    lines = [l for l in text.splitlines()
             if l.startswith(("VALIDATION", "BACKGROUND REJECTION"))]
    assert len(lines) == 5, text
    return lines[:2], [float(l.split(":")[1]) for l in lines[2:]]


def _results(root, name="valid_results.pkl"):
    with open(root / name, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=["CNN", "FCN"])
def trained(request, synth_dir, tmp_path_factory):
    for name in ("QCD-Geneva", "top-Geneva"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    root = tmp_path_factory.mktemp("port_" + request.param)
    argv = COMMON + ["--NN_type", request.param, "--output_dir", str(root), "--device", "cpu"]
    assert cli.main(argv + ["--n_epochs", "2", "--state_file", "state.npz"]) == 0
    return request.param, root, argv


def test_training_run_writes_its_files(trained):
    mode, root, _ = trained
    files = {"model.npz", "valid_results.pkl", "scaler_RobustScaler.pkl", "state.npz"}
    files |= {"image_scale.pkl"} if mode == "CNN" else {"t_scaler.pkl"}
    assert files <= {p.name for p in root.iterdir()}
    v_view, v_labels, probs = _results(root)
    n = len(v_labels)
    assert 900 < n <= 2 * 2500 and probs.shape == (n, 2) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    assert set(np.unique(v_labels)) == {0, 1}
    assert all(len(v) == n for v in v_view.values())
    assert {"weights", "m", "pt", "JZW", "HLVs", "constituents"} <= set(v_view)
    if mode == "CNN":
        # scaled by the training rows' largest pixel: validation rows may pass 1
        assert v_view["images"].shape == (n, 12, 12) and 0.5 < v_view["images"].max() < 4
    # better than a coin on classes that differ
    assert np.mean(np.argmax(probs, axis=1) == v_labels) > 0.6


def test_predict_only_run_reproduces_the_probabilities(trained, capsys):
    _, root, argv = trained
    assert cli.main(argv + ["--n_epochs", "0", "--model_in", "model.npz", "--results_out",
                            "again.pkl"]) == 0
    first, again = _results(root), _results(root, "again.pkl")
    np.testing.assert_array_equal(again[2], first[2])
    np.testing.assert_array_equal(again[1], first[1])


@pytest.mark.parametrize("flag", [True, False])
def test_cli_leaves_cudnn_tf32_as_it_found_it(trained, monkeypatch, tmp_path, flag):
    """The convolutions run with cuDNN's TF32 off (train/jetid_loop.py holds
    it off around them); the process-wide flag is the caller's before and
    after."""
    from atlasvae_torch.train import jetid_loop
    seen = []

    def apply(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    real = jetid_loop.jetid_apply
    monkeypatch.setattr(jetid_loop, "jetid_apply", apply)
    _, root, argv = trained
    argv = [str(tmp_path) if a == str(root) else a for a in argv]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = flag
    try:
        assert cli.main(argv + ["--n_epochs", "1"]) == 0
        assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert seen and not any(seen)


def test_report_matches_the_jax_cli_on_the_same_weights(trained, tmp_path, capsys):
    mode, root, argv = trained
    capsys.readouterr()
    assert cli.main(argv + ["--n_epochs", "0", "--model_in", "model.npz", "--results_out",
                            "again.pkl"]) == 0
    lines, rejections = _report(capsys.readouterr().out)
    shutil.copy(root / "model.npz", tmp_path / "model.npz")
    if mode == "CNN":
        shutil.copy(root / "image_scale.pkl", tmp_path / "image_scale.pkl")
    jax_argv = [a for a in argv[:-2] if a != str(root)] + [str(tmp_path)]
    assert jax_jetid_cli.main(jax_argv + ["--n_epochs", "0", "--model_in", "model.npz"]) == 0
    jax_lines, jax_rejections = _report(capsys.readouterr().out)
    assert lines == jax_lines
    np.testing.assert_allclose(rejections, jax_rejections, rtol=0.01)
    want, got = _results(tmp_path), _results(root, "again.pkl")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=PROB_TOL, atol=PROB_TOL)


def test_results_in_reevaluates_an_eta_region(trained, capsys):
    """The synthetic files carry no eta: the saved view gets one here, as a
    production sample has it."""
    _, root, argv = trained
    v_view, v_labels, probs = _results(root)
    v_view["eta"] = np.random.default_rng(0).normal(0, 1.2, len(v_labels)).astype(np.float32)
    with open(root / "with_eta.pkl", "wb") as f:
        pickle.dump((v_view, v_labels, probs), f)
    capsys.readouterr()
    assert cli.main(argv + ["--results_in", "with_eta.pkl", "--eta_region", "0.0-1.3",
                            "--bkg_data", "no-such-sample"]) == 0     # nothing is loaded
    out = capsys.readouterr().out
    kept = int(np.sum(np.abs(v_view["eta"]) <= 1.3))
    assert 0 < kept < len(v_labels)
    assert f"valid_cuts kept {kept} jets" in out
    _report(out)
    assert cli.main(argv + ["--results_in", "with_eta.pkl", "--eta_region", "all"]) == 0
    assert "valid_cuts kept" not in capsys.readouterr().out


def test_resume_from_the_state_file_trains_on(trained, capsys):
    _, root, argv = trained
    capsys.readouterr()
    assert cli.main(argv + ["--n_epochs", "1", "--state_file", "state.npz", "--verbose", "1",
                            "--results_out", "resumed.pkl"]) == 0
    out = capsys.readouterr().out
    assert "Resuming full classifier state" in out and "Epoch 1/1" in out
    with pytest.raises(ValueError, match="monitoring 'loss'"):
        cli.main(argv + ["--n_epochs", "1", "--state_file", "state.npz", "--metrics", "val_loss"])


@pytest.mark.parametrize("extra,item", [
    (["--n_folds", "3"], "item 10"),
    (["--vmap_folds", "ON"], "item 10"),
    (["--generator", "ON"], "item 9"),
    (["--feature_removal", "ON"], "item 9"),
    (["--n_devices", "2"], "item 11"),
    (["--n_gpus", "4"], "item 11"),
    (["--plotting", "ON"], "item 6"),
    (["--weight_type", "flattening"], "item 9"),
    (["--model_in", "weights.h5"], "item 10"),
    (["--model_out", "model.h5"], "item 10"),
    (["--mixed_precision", "ON"], "bfloat16"),
    (["--mixed_precision", "AUTO", "--NN_type", "CNN"], "bfloat16"),
])
def test_unported_options_refused_before_any_load(tmp_path, extra, item):
    argv = COMMON + ["--output_dir", str(tmp_path / "out"), "--bkg_data", "no-such-sample",
                     "--device", "cpu"] + extra
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)
    assert not (tmp_path / "out").exists()


def test_mixed_precision_auto_is_float32_for_the_fcn():
    for mode in ("AUTO", "ON", "OFF", "auto"):
        for nn_type in ("CNN", "FCN"):
            assert cli.resolve_compute_dtype(mode, nn_type) == \
                jax_jetid_cli.resolve_compute_dtype(mode, nn_type)
    assert cli.resolve_compute_dtype("AUTO", "FCN") == "float32"


def test_parser_has_the_jax_clis_flags_and_defaults_to_the_card():
    ours = {a.dest: a.default for a in cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_jetid_cli.build_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--plotting", "OFF", "--bkg_data", "no-such-sample"])


def test_no_branch_left_and_cnn_without_constituents_exit(trained):
    _, _, argv = trained
    with pytest.raises(SystemExit, match="no input branches"):
        cli.main(argv + ["--NN_type", "FCN", "--constituents", "OFF", "--scalars", "OFF"])
    with pytest.raises(SystemExit, match="requires --constituents ON"):
        cli.main(argv + ["--NN_type", "CNN", "--constituents", "OFF"])
