"""The port imports neither JAX nor the JAX package, nor matplotlib or
sklearn (the machine with the card has neither; the drawing functions
import them in their bodies), and importing it touches no CUDA device,
starts no process group and builds nothing."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import atlasvae_torch
names = [m.name for m in pkgutil.walk_packages(atlasvae_torch.__path__, "atlasvae_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
for name in ("atlasvae_torch.plotting.performance", "atlasvae_torch.cli.jetid",
             "atlasvae_torch.models.jetid", "atlasvae_torch.train.jetid_loop",
             "atlasvae_torch.ops.fused_conv_cuda", "atlasvae_torch.ops.pooling",
             "atlasvae_torch.ops.gammainc", "atlasvae_torch.stats.bumphunter",
             "atlasvae_torch.stats.deprecation", "atlasvae_torch.stats.fit",
             "atlasvae_torch.eval.deco", "atlasvae_torch.eval.bump",
             "atlasvae_torch.models.aae", "atlasvae_torch.train.aae_loop",
             "atlasvae_torch.eval.aae_eval", "atlasvae_torch.plotting.aae_plots",
             "atlasvae_torch.cli.aae", "atlasvae_torch.cli.sweep",
             "atlasvae_torch.train.ensemble", "atlasvae_torch.train.keras_import",
             "atlasvae_torch.train.keras_export", "atlasvae_torch.etl",
             "atlasvae_torch.etl.rootio", "atlasvae_torch.etl.merging",
             "atlasvae_torch.etl.root2h5", "atlasvae_torch.cli.etl",
             "atlasvae_torch.native", "atlasvae_torch.data.lzf",
             "atlasvae_torch.parallel", "atlasvae_torch.parallel.mesh",
             "atlasvae_torch.parallel.multihost", "atlasvae_torch.parallel.tp",
             "atlasvae_torch.utils.profiling", "atlasvae_torch.plotting.extras",
             "atlasvae_torch.plotting.pedagogy"):
    assert name in names, name
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "atlasvae", "matplotlib", "sklearn"))
assert not leaked, leaked
import torch
import torch.distributed as dist
assert not torch.cuda.is_initialized()
assert not dist.is_initialized()          # importing the parallel package starts no group
from atlasvae_torch.ops import cuda_build
assert not cuda_build._LIBS
from atlasvae_torch import native
assert not native._LIBS
print(len(names))
"""


def test_every_module_imports_without_jax_or_atlasvae():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True)
    assert int(out.stdout.strip()) >= 20


_WITHOUT_H5PY = """
import sys, tempfile, os
sys.modules["h5py"] = None                  # as on the machine with the card
import torch
from atlasvae_torch.data import hdf5
from atlasvae_torch.models import VAEConfig, init_vae
from atlasvae_torch.train.checkpoint import tree_flatten
from atlasvae_torch.train.keras_export import export_keras_vae
from atlasvae_torch.train.keras_import import load_params_auto
assert hdf5._h5py is None
params = init_vae(torch.Generator().manual_seed(0), VAEConfig(), device="cpu")
template = init_vae(torch.Generator().manual_seed(1), VAEConfig(), device="cpu")
path = os.path.join(tempfile.mkdtemp(), "model.h5")
export_keras_vae(params, path)
back = load_params_auto(path, template, "vae")
assert all(torch.equal(a, b) for a, b in zip(tree_flatten(back), tree_flatten(params)))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "atlasvae", "h5py")
                and sys.modules[m] is not None)
assert not leaked, leaked
"""


def test_keras_files_without_h5py():
    """keras_import/keras_export import, write and read where h5py is
    missing, through LiteFile."""
    subprocess.run([sys.executable, "-c", _WITHOUT_H5PY], cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=ROOT))


def test_chip_smoke_imports_nothing_of_jax():
    code = ("import sys, chip_smoke; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'atlasvae.')) "
            "or m == 'atlasvae' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=ROOT))


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_ETL_WITHOUT_H5PY = """
import os, sys, tempfile
sys.modules["h5py"] = None                  # as on the machine with the card
import numpy as np
from atlasvae_torch.cli import etl
from atlasvae_torch.data import hdf5
from atlasvae_torch.etl import rootio
assert hdf5._h5py is None
root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
n = 40
data = {key: rng.uniform(0.5, 3.0, n).astype(np.float32) for key in
        ("rljet_m_calo", "rljet_m_comb", "rljet_pt_calo", "rljet_pt_comb", "rljet_ECF3",
         "rljet_C2", "rljet_D2", "rljet_Tau1_wta", "rljet_Tau2_wta", "rljet_Tau3_wta",
         "rljet_Tau32_wta", "rljet_FoxWolfram2", "rljet_PlanarFlow", "rljet_Angularity",
         "rljet_Aplanarity", "rljet_ZCut12", "rljet_Split12", "rljet_Split23", "rljet_KtDR",
         "rljet_Qw", "rljet_eta", "rljet_phi", "weight_mc", "weight_pileup",
         "rljet_topTag_DNN19_qqb_score")}
counts = rng.integers(1, 6, n)
data["rljet_n_constituents"] = counts.astype(np.int32)
for key in ("rljet_assoc_cluster_pt", "rljet_assoc_cluster_eta", "rljet_assoc_cluster_phi"):
    data[key] = [rng.uniform(1, 2e3, c).astype(np.float32) for c in counts]
os.makedirs(os.path.join(root, "in", "user.sim.361024.x"))
rootio.write_tree(os.path.join(root, "in", "user.sim.361024.x", "a.root"), "nominal", data)
out = os.path.join(root, "h5")
assert etl.main(["--tag", "1", "--input_path", os.path.join(root, "in"), "--output_path", out]) == 0
assert etl.main(["--merging", "ON", "--input_path", out]) == 0
with hdf5.File(os.path.join(out, "merging", "merging.h5")) as f:
    assert isinstance(f, hdf5.LiteFile) and len(f["constituents"]) == n
    assert f["constituents"].dtype == np.float16 and f["rljet_n_constituents"].dtype == np.uint8
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "atlasvae", "h5py")
                and sys.modules[m] is not None)
assert not leaked, leaked
"""


def test_etl_runs_without_h5py():
    """cli/etl.py converts and merges where h5py is missing, through
    LiteFile, importing nothing of JAX or the JAX package."""
    subprocess.run([sys.executable, "-c", _ETL_WITHOUT_H5PY], cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=ROOT))


def test_only_the_hdf5_layer_imports_h5py():
    """No module of the port imports h5py, jax or atlasvae, except
    data/hdf5.py's guarded import of h5py."""
    import ast
    package = os.path.join(ROOT, "atlasvae_torch")
    found = []
    for folder, _, files in os.walk(package):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(folder, name)
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.Import):
                    modules = [alias.name for alias in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    modules = [node.module]
                else:
                    continue
                found += [(os.path.relpath(path, ROOT), m) for m in modules
                          if m.split(".")[0] in ("h5py", "jax", "atlasvae")]
    assert found == [(os.path.join("atlasvae_torch", "data", "hdf5.py"), "h5py")]
