"""``atlasvae_torch.cli.sweep`` and ``cli/vae.py::run_ensemble``.

* ``--vmap ON`` (the grid as lanes of one ensemble) against ``--vmap OFF``
  (one ``cli.vae`` run a grid point) on the shared synthetic files: the
  same output directories, and in each the same history and weights, bit
  for bit (on the CPU both run the same steps in the same order).
* The grid, the ``--task_id`` pick, the runs' arguments and the vmapped
  groups against ``atlasvae.cli.sweep``'s, with both packages' entry points
  replaced by recorders: equal.
* Keras files: every lane starts from a JAX-exported ``.h5`` and ends with
  a ``model.h5`` that the JAX package reads as that lane's weights.
* What the ensemble does not run is refused before any data is loaded.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from atlasvae.cli import sweep as jax_sweep, vae as jax_vae
from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae.train.keras_export import export_keras_vae as jax_export_keras_vae
from atlasvae.train.keras_import import load_keras_vae as jax_load_keras_vae
from atlasvae_torch.cli import sweep, vae
from atlasvae_torch.data import registry
from test_torch_keras import record_keras_calls, same_leaves

ARGS = ["--n_train", "800", "--n_valid", "400", "--n_OoD", "800", "--batch_size", "200",
        "--n_epochs", "3", "--FC_layers", "16", "8", "4", "--OE_type", "MAE",
        "--plotting", "OFF", "--weight_type", "None", "--HLV_scaler_type", "RobustScaler",
        "--device", "cpu"]
GRID = ["--grid", "beta=0.5,2", "lamb=1,5"]
TAGS = ["beta0.5_lamb1", "beta0.5_lamb5", "beta2_lamb1", "beta2_lamb5"]


def _register(synth_dir):
    for name in ("QCD-Geneva", "OoD-H"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")


def test_vmap_on_equals_vmap_off(synth_dir, tmp_path, capsys):
    _register(synth_dir)
    for mode in ("OFF", "ON"):
        assert sweep.main(["--entry", "vae", "--vmap", mode, "--output_dir",
                           str(tmp_path / mode)] + GRID + ["--"] + ARGS) == 0
    assert "4 configs in one ensemble" in capsys.readouterr().out
    for mode in ("OFF", "ON"):
        assert sorted(p.name for p in (tmp_path / mode).iterdir()) == TAGS
    for tag in TAGS:
        with open(tmp_path / "OFF" / tag / "history.pkl", "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "ON" / tag / "history.pkl", "rb") as f:
            got = pickle.load(f)
        assert got == want and list(got) == ["MSE", "KLD", "OE", "Train loss", "Valid loss"]
        assert len(got["Train loss"]) == 3
        with np.load(tmp_path / "OFF" / tag / "model.npz") as a, \
                np.load(tmp_path / "ON" / tag / "model.npz") as b:
            assert a.files == b.files
            assert all(np.array_equal(a[k], b[k]) for k in a.files), tag


@pytest.mark.parametrize("grid", [{"beta": ["0", "1", "10"]},
                                  {"beta": ["0", "1"], "lamb": ["1", "10"]},
                                  {"beta": ["0.5"], "lamb": ["1", "5"], "seed": ["0", "1", "2"]}])
def test_grid_search_equals_jax(grid):
    assert sweep.grid_search(**grid) == jax_sweep.grid_search(**grid)
    tokens = [f"{k}={','.join(v)}" for k, v in grid.items()]
    assert sweep._parse_grid(tokens) == jax_sweep._parse_grid(tokens) == grid


def _recorded(monkeypatch, argv):
    """The entry calls each package's sweep makes for ``argv``."""
    calls = {}
    for side, module, cli_vae in (("port", sweep, vae), ("jax", jax_sweep, jax_vae)):
        seen = calls.setdefault(side, [])
        monkeypatch.setattr(cli_vae, "main", lambda a, seen=seen: seen.append(("main", a)))
        monkeypatch.setattr(cli_vae, "run_ensemble",
                            lambda *a, seen=seen: seen.append(("run_ensemble",) + a))
        assert module.main(list(argv)) == 0
    return calls["port"], calls["jax"]


@pytest.mark.parametrize("extra", [["--task_id", "0"], ["--task_id", "3"],
                                   ["--task_id", "2", "--vmap", "ON"], []])
def test_runs_and_task_id_equal_jax(monkeypatch, extra):
    """Every grid point, or (--task_id) the one it names, with the same
    arguments and output directory; --vmap ON with --task_id runs that point
    alone, as in the JAX package."""
    port, want = _recorded(monkeypatch, ["--entry", "vae", "--output_dir", "out"] + extra + GRID
                           + ["--", "--n_epochs", "2"])
    assert port == want
    assert len(port) == (1 if extra else 4)
    if extra:
        tag = TAGS[int(extra[1])]
        assert port == [("main", ["--n_epochs", "2", "--beta", tag[4:tag.index("_")], "--lamb",
                                  tag.split("lamb")[1], "--output_dir", f"out/{tag}"])]


def test_vmapped_groups_equal_jax(monkeypatch):
    """Axes outside VMAPPABLE form sequential groups, each one ensemble,
    with the sequential sweep's directory names."""
    port, want = _recorded(monkeypatch, ["--entry", "vae", "--vmap", "ON", "--output_dir", "o",
                                         "--grid", "OE_type=MAE,KLD", "beta=0.5,2", "seed=0,1",
                                         "--", "--n_epochs", "2"])
    assert port == want
    assert [call[1] for call in port] == [["--n_epochs", "2", "--OE_type", "MAE"],
                                          ["--n_epochs", "2", "--OE_type", "KLD"]]
    assert port[0][2:] == (["beta", "seed"], [("0.5", "0"), ("0.5", "1"), ("2", "0"), ("2", "1")],
                           ["o/OE_typeMAE_beta0.5_seed0", "o/OE_typeMAE_beta0.5_seed1",
                            "o/OE_typeMAE_beta2_seed0", "o/OE_typeMAE_beta2_seed1"])


def test_no_vmappable_axis_exits():
    with pytest.raises(SystemExit, match="no grid axis is vmappable"):
        sweep.main(["--vmap", "ON", "--grid", "OE_type=MAE,KLD"])


def test_ensemble_keras_files_in_and_out(synth_dir, tmp_path, monkeypatch):
    """--vmap ON with --model_in a JAX-exported .h5 (each lane's path
    relative to its own folder) and --model_out model.h5: every lane starts
    from those weights bit for bit and ends with a Keras file that JAX's
    load_keras_vae reads as the weights the lane exported."""
    _register(synth_dir)
    template = jax_init_vae(jax.random.PRNGKey(4), JaxVAEConfig(fc_layers=(16, 8, 4),
                                                                input_dim=12))
    jax_export_keras_vae(template, str(tmp_path / "start.h5"))
    loads, exports = record_keras_calls(monkeypatch)
    assert sweep.main(["--entry", "vae", "--vmap", "ON", "--output_dir", str(tmp_path / "out")]
                      + GRID + ["--"] + ARGS + ["--model_in", "../../start.h5", "--model_out",
                                                "model.h5"]) == 0
    assert len(loads) == 8 and len(exports) == 4       # model_in a lane, then model_out
    for (_, loaded) in loads[:4]:
        same_leaves(loaded, template)
    assert [path for path, _ in exports] == [str(tmp_path / "out" / tag / "model.h5")
                                             for tag in TAGS]
    for path, params in exports:
        with open(path, "rb") as f:
            assert f.read(4) == b"\x89HDF"
        same_leaves(params, jax_load_keras_vae(path, template))


@pytest.mark.parametrize("extra,item", [(["--n_devices", "2"], "item 11")])
def test_ensemble_refuses_before_any_load(synth_dir, tmp_path, monkeypatch, extra, item):
    """Once refused (ROADMAP Queue 1 ``item``), now run: the four configs
    sharded over two CPU ranks, two lanes each with no collective, write
    what the one-device ensemble writes (tests/test_ensemble.py:198, rtol
    1e-6)."""
    monkeypatch.setenv("ATLASVAE_DATA_DIR", str(synth_dir))     # the ranks' registry
    _register(synth_dir)
    for tag, more in (("one", []), ("ranked", extra)):
        assert sweep.main(["--vmap", "ON", "--output_dir", str(tmp_path / tag)] + GRID
                          + ["--"] + ARGS + more) == 0
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.train.checkpoint import load_history, load_pytree, tree_flatten
    template = init_vae(torch.Generator().manual_seed(0),
                        VAEConfig(fc_layers=(16, 8, 4), input_dim=12), device="cpu")
    for run in TAGS:
        one, ranked = tmp_path / "one" / run, tmp_path / "ranked" / run
        assert sorted(os.listdir(ranked)) == sorted(os.listdir(one))
        want, got = load_history(str(one / "history.pkl")), load_history(str(ranked /
                                                                              "history.pkl"))
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=f"{run} {key}")
        for a, b in zip(tree_flatten(load_pytree(str(ranked / "model.npz"), template)),
                        tree_flatten(load_pytree(str(one / "model.npz"), template))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
