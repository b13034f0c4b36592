"""``atlasvae_torch.cli.jetid`` end to end on the shared synthetic files, in
CNN and FCN mode, against ``atlasvae.cli.jetid``.

The two CLIs draw their initial weights from different generators, so the
port trains, and the JAX CLI then predicts with the port's ``model.npz``
(and, in CNN mode, its ``image_scale.pkl``) on the same sample: both print
the same accuracy and AUC lines (2 and 4 decimals) and background
rejections within 1 % (one jet more or less below a threshold), and their
probabilities agree to rtol 2e-5 / atol 2e-5, the whole-model bar of
tests/test_tf_parity.py.  A predict-only run of the port reproduces the
training run's probabilities bit for bit.  ``--plotting ON --sep_bkg ON``
writes the same files as the JAX CLI.  What the port does not run yet, and
``--plotting ON`` where matplotlib cannot be imported, is refused before
any data is loaded.

``CNN-AUTO`` is the CLI at its default precision, bfloat16 compute for the
CNN: the JAX CLI then predicts with ATLASVAE_CONV1=fused, whose block 1
rounds once as K5 does.  What is left between the two is a bf16 rounding
that the two libraries' float32 sums (block 2's 900 taps, the dense layers)
place on either side of a boundary now and then: measured up to 4.3e-4 on a
probability at these widths (mean 4e-7), so probabilities within 1e-3, and a
jet at the decision threshold may change class: accuracy within 0.2 points,
AUC within 1e-3, rejections within 5 % (BF16_REPORT).  The sample-weight
schemes (``--weight_type``)
and the streamed training chunks (``--generator ON``) are held against the
JAX CLI by what each CLI hands its trainer: the same weights, labels and
chunks (inputs through the two packages' scalers: rtol 1e-5 / atol 1e-6).
Keras ``.h5`` files go both ways: the port predicts from the JAX CLI's
``model.h5`` what the JAX run predicted (PROB_TOL), and a port run with
``--model_out model.h5`` leaves a file that the JAX package reads as the
port's weights.
"""

import dataclasses
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from atlasvae.cli import jetid as jax_jetid_cli
from atlasvae.data import registry as jax_registry
from atlasvae.models.jetid import JetIDConfig as JaxJetIDConfig
from atlasvae.train.keras_import import load_keras_jetid as jax_load_keras_jetid
from atlasvae_torch.cli import jetid as cli
from atlasvae_torch.data import registry
from atlasvae_torch.interop import params_to_numpy
from plot_record import assert_same_structure, recording
from test_torch_keras import record_keras_calls, same_leaves

COMMON = ["--n_train", "1500", "--n_valid", "1000", "--batch_size", "500", "--mixed_precision",
          "OFF", "--plotting", "OFF", "--image_size", "12", "--FCN_neurons", "24", "16",
          "--verbose", "0"]
PROB_TOL = 2e-5
BF16_REPORT = dict(prob=1e-3, accuracy=0.2, auc=1e-3, rejection=0.05)


def _report(text):
    lines = [l for l in text.splitlines()
             if l.startswith(("VALIDATION", "BACKGROUND REJECTION"))]
    assert len(lines) == 5, text
    return lines[:2], [float(l.split(":")[1]) for l in lines[2:]]


def _same_report(port, jax_, bf16):
    """Two (lines, rejections) reports: the same lines and rejections within
    1 % in float32; at the BF16_REPORT bars in bfloat16."""
    (lines, rejections), (jax_lines, jax_rejections) = port, jax_
    if not bf16:
        assert lines == jax_lines
        np.testing.assert_allclose(rejections, jax_rejections, rtol=0.01)
        return
    number = lambda line: float(line.split(":")[1].strip(" %"))
    assert abs(number(lines[0]) - number(jax_lines[0])) <= BF16_REPORT["accuracy"]
    assert abs(number(lines[1]) - number(jax_lines[1])) <= BF16_REPORT["auc"]
    np.testing.assert_allclose(rejections, jax_rejections, rtol=BF16_REPORT["rejection"])


def _results(root, name="valid_results.pkl"):
    with open(root / name, "rb") as f:
        return pickle.load(f)


def _argv(mode):
    """COMMON for "CNN"/"FCN" (float32), or at the --mixed_precision after
    the dash: "CNN-AUTO" (bfloat16), "FCN-ON" (bfloat16)."""
    nn_type, _, precision = mode.partition("-")
    argv = list(COMMON)
    argv[argv.index("--mixed_precision") + 1] = precision or "OFF"
    return argv + ["--NN_type", nn_type]


def _register(synth_dir):
    """The shared synthetic files under both packages' names (a JAX CLI run
    with --synthetic earlier in the same worker re-registers the JAX names
    to its own files)."""
    for name in ("QCD-Geneva", "top-Geneva"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
        jax_registry.register_file(name, synth_dir / f"synthetic_{name}.h5")


@pytest.fixture(scope="module", params=["CNN", "FCN", "CNN-AUTO"])
def trained(request, synth_dir, tmp_path_factory):
    _register(synth_dir)
    root = tmp_path_factory.mktemp("port_" + request.param)
    argv = _argv(request.param) + ["--output_dir", str(root), "--device", "cpu"]
    assert cli.main(argv + ["--n_epochs", "2", "--state_file", "state.npz"]) == 0
    return request.param, root, argv


def test_training_run_writes_its_files(trained):
    mode, root, _ = trained
    files = {"model.npz", "valid_results.pkl", "scaler_RobustScaler.pkl", "state.npz"}
    files |= {"image_scale.pkl"} if mode.startswith("CNN") else {"t_scaler.pkl"}
    assert files <= {p.name for p in root.iterdir()}
    v_view, v_labels, probs = _results(root)
    n = len(v_labels)
    assert 900 < n <= 2 * 2500 and probs.shape == (n, 2) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    assert set(np.unique(v_labels)) == {0, 1}
    assert all(len(v) == n for v in v_view.values())
    assert {"weights", "m", "pt", "JZW", "HLVs", "constituents"} <= set(v_view)
    assert probs.dtype == np.float32
    if mode.startswith("CNN"):
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


def test_report_matches_the_jax_cli_on_the_same_weights(trained, tmp_path, capsys, monkeypatch):
    mode, root, argv = trained
    capsys.readouterr()
    assert cli.main(argv + ["--n_epochs", "0", "--model_in", "model.npz", "--results_out",
                            "again.pkl"]) == 0
    lines, rejections = _report(capsys.readouterr().out)
    shutil.copy(root / "model.npz", tmp_path / "model.npz")
    if mode.startswith("CNN"):
        shutil.copy(root / "image_scale.pkl", tmp_path / "image_scale.pkl")
    if mode == "CNN-AUTO":
        monkeypatch.setenv("ATLASVAE_CONV1", "fused")
    jax_argv = [a for a in argv[:-2] if a != str(root)] + [str(tmp_path)]
    assert jax_jetid_cli.main(jax_argv + ["--n_epochs", "0", "--model_in", "model.npz"]) == 0
    _same_report((lines, rejections), _report(capsys.readouterr().out), mode == "CNN-AUTO")
    want, got = _results(tmp_path), _results(root, "again.pkl")
    np.testing.assert_array_equal(got[1], want[1])
    tol = BF16_REPORT["prob"] if mode == "CNN-AUTO" else PROB_TOL
    np.testing.assert_allclose(got[2], want[2], rtol=tol, atol=tol)


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


def test_keras_files_in_and_out(synth_dir, tmp_path, monkeypatch):
    """The FCN: the JAX CLI trains with --model_out model.h5; the port,
    --n_epochs 0 --model_in that file, predicts what the JAX run predicted,
    from the same weights bit for bit; a port run with --model_out model.h5
    leaves a Keras file that JAX's load_keras_jetid reads as the weights the
    port exported."""
    _register(synth_dir)
    argv = _argv("FCN") + ["--n_epochs", "2", "--model_out", "model.h5"]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    assert jax_jetid_cli.main(argv + ["--output_dir", str(jax_root)]) == 0
    port_root.mkdir()
    shutil.copy(jax_root / "model.h5", port_root / "jax.h5")
    loads, exports = record_keras_calls(monkeypatch)
    assert cli.main(_argv("FCN") + ["--n_epochs", "0", "--model_in", "jax.h5", "--output_dir",
                                    str(port_root), "--device", "cpu"]) == 0
    ((path, template, kind, config), loaded), = loads
    assert kind == "jetid" and not exports
    jax_config = JaxJetIDConfig(**dataclasses.asdict(config))
    same_leaves(loaded, jax_load_keras_jetid(path, params_to_numpy(template), jax_config))
    want, got = _results(jax_root), _results(port_root)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=PROB_TOL, atol=PROB_TOL)

    assert cli.main(argv + ["--output_dir", str(port_root), "--device", "cpu"]) == 0
    ((model_out, params),) = exports
    assert model_out == str(port_root / "model.h5")
    with open(model_out, "rb") as f:
        assert f.read(4) == b"\x89HDF"
    same_leaves(params, jax_load_keras_jetid(model_out, params_to_numpy(template), jax_config))


@pytest.mark.parametrize("extra,item", [
    (["--n_devices", "2"], "item 11"),
    (["--n_gpus", "4"], "item 11"),
])
def test_unported_options_refused_before_any_load(synth_dir, tmp_path, monkeypatch, extra,
                                                 item):
    """Once refused (ROADMAP Queue 1 ``item``), now run: the FCN trained on
    N CPU ranks (dropout 0), each stepping its share of a global batch of N
    x --batch_size, writes what one device writes with that batch; its
    weights and probabilities at the data-parallel bars of
    tests/test_jetid.py:293 (rtol 2e-4, atol 2e-6)."""
    monkeypatch.setenv("ATLASVAE_DATA_DIR", str(synth_dir))     # the ranks' registry
    _register(synth_dir)
    n = int(extra[1])
    base = _argv("FCN") + ["--n_epochs", "1", "--dropout", "0", "--device", "cpu"]
    base[base.index("--batch_size") + 1] = str(500 // n)
    runs = {"one": ["--batch_size", "500"], "ranked": extra}
    for tag, more in runs.items():
        assert cli.main(base + more + ["--output_dir", str(tmp_path / tag)]) == 0
    one, ranked = tmp_path / "one", tmp_path / "ranked"
    assert sorted(os.listdir(ranked)) == sorted(os.listdir(one))
    (_, labels, probs), (_, want_labels, want_probs) = _results(ranked), _results(one)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, rtol=2e-4, atol=2e-6)
    with np.load(ranked / "model.npz") as got, np.load(one / "model.npz") as want:
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=2e-6, err_msg=key)


@pytest.fixture(scope="module")
def kfold_runs(synth_dir, tmp_path_factory):
    """--n_folds 3 on the FCN, the folds trained one after another and as
    lanes of one program (--vmap_folds ON): each run's printed text and
    folder."""
    import contextlib
    import io
    _register(synth_dir)
    runs = {}
    for mode in ("OFF", "ON"):
        root = tmp_path_factory.mktemp("kfold_" + mode)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            assert cli.main(_argv("FCN") + ["--n_folds", "3", "--vmap_folds", mode,
                                            "--n_epochs", "2", "--output_dir", str(root),
                                            "--device", "cpu"]) == 0
        runs[mode] = text.getvalue(), root
    return runs


@pytest.mark.parametrize("mode", ["OFF", "ON"])
def test_kfold_run_scores_every_event_with_the_fold_that_held_it_out(kfold_runs, mode):
    text, root = kfold_runs[mode]
    assert {f"model_{f}.npz" for f in (1, 2, 3)} <= {p.name for p in root.iterdir()}
    assert "model.npz" not in {p.name for p in root.iterdir()}
    assert all(f"FOLD {f}/3 ACCURACY" in text for f in (1, 2, 3))
    cv_line = next(l for l in text.splitlines() if l.startswith("3-FOLD CV ACCURACY"))
    v_view, v_labels, probs = _results(root)
    n = len(v_labels)
    assert 2 * 2500 >= n > 2500 and probs.shape == (n, 2) and all(
        len(v) == n for v in v_view.values())
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    accuracy = float(cv_line.split(":")[1].strip(" %"))
    assert accuracy == pytest.approx(100 * np.mean(probs.argmax(axis=1) == v_labels), abs=0.01)
    assert accuracy > 60
    _report(text)


def test_kfold_lanes_equal_the_sequential_folds(kfold_runs):
    (_, seq), (_, lanes) = kfold_runs["OFF"], kfold_runs["ON"]
    for f in (1, 2, 3):
        with np.load(seq / f"model_{f}.npz") as a, np.load(lanes / f"model_{f}.npz") as b:
            assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    assert np.array_equal(_results(seq)[2], _results(lanes)[2])


def test_plotting_without_matplotlib_refused_before_any_load(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = COMMON + ["--plotting", "ON", "--output_dir", str(tmp_path / "out"), "--bkg_data",
                     "no-such-sample", "--device", "cpu"]
    for extra in ([], ["--results_in", "valid_results.pkl"]):
        with pytest.raises(ImportError, match="matplotlib"):
            cli.main(argv + extra)
        assert not (tmp_path / "out").exists()


def test_plotting_run_draws_the_same_files_as_jax(tmp_path, monkeypatch):
    """--plotting ON --sep_bkg ON on --synthetic data, both CLIs predicting
    with the port's weights: the same files, with the same axes, artists
    and texts (the same arrays on the same probabilities are held in
    test_torch_results.py)."""
    monkeypatch.setenv("ATLASVAE_DATA_DIR", str(tmp_path / "data"))
    for reg in (registry, jax_registry):
        monkeypatch.setattr(reg, "_OVERRIDES", dict(reg._OVERRIDES))
    argv = _argv("FCN") + ["--synthetic", "3000"]
    assert cli.main(argv + ["--output_dir", str(tmp_path / "port"), "--n_epochs", "1",
                            "--device", "cpu"]) == 0
    (tmp_path / "jax").mkdir()
    shutil.copy(tmp_path / "port" / "model.npz", tmp_path / "jax" / "model.npz")
    argv[argv.index("--plotting") + 1] = "ON"
    argv += ["--sep_bkg", "ON", "--n_epochs", "0", "--model_in", "model.npz"]
    records = {}
    for side, main, extra in (("jax", jax_jetid_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        with recording(tmp_path / side, write=side == "port") as records[side]:
            assert main(argv + ["--output_dir", str(tmp_path / side)] + extra) == 0
    assert sorted(p.name for p in (tmp_path / "port").glob("*.png")) == \
        sorted(p.name for p in (tmp_path / "jax").glob("*.png")) == \
        ["bkg_rejection.png", "distributions.png", "signal_gain.png"]
    assert_same_structure(records["port"], records["jax"])


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


class _Handed(Exception):
    """Raised by a stand-in trainer once it has what the CLI hands it."""


def _capture(monkeypatch, module, name, seen, stream=False):
    """Replace ``module.name`` by a trainer that records its arguments
    (a streaming trainer's chunks, read once) and stops the CLI."""
    def trainer(params, config, *args, **kwargs):
        seen["config"] = config
        if stream:
            seen["chunks"] = list(args[0]())
            seen["valid"] = args[1:3]
        else:
            seen["args"] = args
        raise _Handed
    monkeypatch.setattr(module, name, trainer)


def _handed(monkeypatch, argv, jax_argv, name, stream=False):
    """What the port's and the JAX CLI hand their trainers for argv."""
    from atlasvae.train import jetid_loop as jax_loop
    from atlasvae_torch.train import jetid_loop
    monkeypatch.setenv("ATLASVAE_HEAP_REUSE", "0")   # the JAX CLI's allocator tuning, off
    seen = {}
    for module, run, args in ((jetid_loop, cli.main, argv), (jax_loop, jax_jetid_cli.main,
                                                               jax_argv)):
        got = {}
        _capture(monkeypatch, module, name, got, stream)
        with pytest.raises(_Handed):
            run(args)
        seen[module] = got
    return seen[jetid_loop], seen[jax_loop]


# --bkg_ratio 1 gives every scheme finite weights; the default 0 divides by
# 0, and both CLIs fall back to unweighted training.  The schemes read the
# jets' pt and labels only, so the FCN (at bf16) stands in for the CNN and
# spares both CLIs the images.
@pytest.mark.parametrize("scheme,ratio", [("flattening", "1"), ("bkg_ratio", "1"),
                                          ("match2class", "1"), ("match2max", "1"),
                                          ("flattening", "0")])
def test_weight_schemes_match_the_jax_cli(synth_dir, tmp_path, monkeypatch, capsys, scheme,
                                          ratio):
    _register(synth_dir)
    argv = _argv("FCN-ON") + ["--weight_type", scheme, "--bkg_ratio", ratio, "--n_epochs", "1"]
    port, jax_ = _handed(monkeypatch, argv + ["--output_dir", str(tmp_path / "port"),
                                              "--device", "cpu"],
                         argv + ["--output_dir", str(tmp_path / "jax")], "train_classifier")
    assert port["config"].compute_dtype == jax_["config"].compute_dtype == "bfloat16"
    # (inputs, labels, valid inputs, valid labels, epochs, batch, lr, patience,
    #  class_weight, sample_weight, ...)
    got, want = port["args"], jax_["args"]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[8] == want[8]
    if ratio == "0":
        assert got[9] is None and want[9] is None
        assert capsys.readouterr().out.count("weight scheme degenerate -> uniform") == 2
    else:
        assert got[9].dtype == want[9].dtype == np.float32
        np.testing.assert_array_equal(got[9], want[9])
        assert 0 < got[9].min() and got[9].max() > 1


def test_weight_type_flattening_trains_at_the_cli_precision(synth_dir, tmp_path, capsys):
    """The reference README's jet-ID example (--weight_type flattening) in
    CNN mode at --mixed_precision AUTO trains and predicts in bf16 (its
    weights are the JAX CLI's, test_weight_schemes_match_the_jax_cli; its
    report on given weights, test_report_matches_the_jax_cli_on_the_same_weights
    [CNN-AUTO])."""
    _register(synth_dir)
    seen = []
    from atlasvae_torch.train import jetid_loop
    real = jetid_loop.jetid_apply

    def apply(params, config, *args, **kwargs):
        seen.append(config.compute_dtype)
        return real(params, config, *args, **kwargs)

    root = tmp_path / "port"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jetid_loop, "jetid_apply", apply)
        assert cli.main(_argv("CNN-AUTO") + ["--weight_type", "flattening", "--bkg_ratio", "1",
                                             "--n_epochs", "2", "--verbose", "1",
                                             "--output_dir", str(root), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Epoch 2/2" in out and "degenerate" not in out
    _report(out)
    assert seen and set(seen) == {"bfloat16"}
    _, v_labels, probs = _results(root)
    assert probs.dtype == np.float32 and np.isfinite(probs).all()
    assert np.mean(np.argmax(probs, axis=1) == v_labels) > 0.6


STREAM = ["--mixed_precision", "ON", "--generator", "ON",
          "--memGB", "0.00012",        # 500 jets of 20 x 3 float32 constituents a chunk
          "--weight_type", "flattening", "--bkg_ratio", "1"]


def test_generator_chunks_match_the_jax_cli(synth_dir, tmp_path, monkeypatch):
    """--generator ON: the same chunks (three of 500 jets), each with its
    labels, scaled inputs and per-chunk flattening weights times the class
    weights, and the same per-epoch validation slice (--n_eval)."""
    _register(synth_dir)
    argv = _argv("FCN") + STREAM + ["--n_epochs", "1", "--n_eval", "300"]
    port, jax_ = _handed(monkeypatch, argv + ["--output_dir", str(tmp_path / "port"),
                                              "--device", "cpu"],
                         argv + ["--output_dir", str(tmp_path / "jax")],
                         "train_classifier_streaming", stream=True)
    assert port["config"].compute_dtype == jax_["config"].compute_dtype == "bfloat16"
    assert len(port["chunks"]) == len(jax_["chunks"]) == 3
    for (inputs, labels, weights), (j_inputs, j_labels, j_weights) in zip(port["chunks"],
                                                                          jax_["chunks"]):
        np.testing.assert_array_equal(labels, j_labels)
        np.testing.assert_array_equal(weights, j_weights)
        assert weights.dtype == np.float32 and np.isfinite(weights).all()
        assert set(inputs) == set(j_inputs) == {"HLVs", "constituents"}
        for key in inputs:
            np.testing.assert_allclose(inputs[key], j_inputs[key], rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    (v_inputs, v_labels), (jv_inputs, jv_labels) = port["valid"], jax_["valid"]
    assert len(v_labels) == 300
    np.testing.assert_array_equal(v_labels, jv_labels)
    for key in jv_inputs:
        np.testing.assert_allclose(v_inputs[key], jv_inputs[key], rtol=1e-5, atol=1e-6)


def test_generator_on_trains_and_matches_the_jax_report(synth_dir, tmp_path, capsys):
    """A streamed bf16 FCN run trains two epochs over its chunks; the JAX
    CLI, predicting with the port's weights on the same validation slice,
    prints the same report."""
    _register(synth_dir)
    argv = _argv("FCN") + STREAM
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    assert cli.main(argv + ["--n_epochs", "2", "--verbose", "1", "--output_dir",
                            str(port_root), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Epoch 2/2" in out
    lines, rejections = _report(out)
    jax_root.mkdir()
    shutil.copy(port_root / "model.npz", jax_root / "model.npz")
    assert jax_jetid_cli.main(argv + ["--n_epochs", "0", "--model_in", "model.npz",
                                      "--output_dir", str(jax_root)]) == 0
    _same_report((lines, rejections), _report(capsys.readouterr().out), bf16=True)
    got, want = _results(port_root), _results(jax_root)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=BF16_REPORT["prob"],
                               atol=BF16_REPORT["prob"])


def test_generator_takes_no_cnn(synth_dir, tmp_path):
    """As in the JAX CLI: generator mode streams no constituent images."""
    _register(synth_dir)
    with pytest.raises(SystemExit, match="no k-fold CV / feature removal / CNN images"):
        cli.main(_argv("CNN-AUTO") + ["--generator", "ON", "--output_dir", str(tmp_path),
                                      "--device", "cpu"])


def test_generator_takes_no_feature_removal(synth_dir, tmp_path):
    """Both CLIs exit on --generator ON --feature_removal ON before any load."""
    _register(synth_dir)
    argv = _argv("FCN") + ["--generator", "ON", "--feature_removal", "ON", "--bkg_data",
                           "no-such-sample"]
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_jetid_cli.main, [])):
        with pytest.raises(SystemExit, match="no k-fold CV / feature removal / CNN images"):
            main(argv + ["--output_dir", str(tmp_path / side)] + extra)


def test_feature_removal_prints_the_ranking_of_every_hlv(synth_dir, tmp_path, capsys):
    """--feature_removal ON retrains without each HLV column (2 epochs here,
    max(2, n_epochs // 4)) and prints every HLV once, largest drop first;
    the run then ends with its report."""
    from atlasvae_torch.data import HLV_LIST
    _register(synth_dir)
    assert cli.main(_argv("FCN") + ["--feature_removal", "ON", "--n_epochs", "2",
                                    "--output_dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    ranking = out.split("FEATURE-ABLATION RANKING (accuracy drop when removed):\n")[1]
    rows = [line.split() for line in ranking.splitlines()[:len(HLV_LIST)]]
    assert sorted(name for name, _, _ in rows) == sorted(HLV_LIST)
    drops = [float(drop) for _, drop, _ in rows]
    assert drops == sorted(drops, reverse=True) and all(unit == "%" for _, _, unit in rows)
    _report(out)
