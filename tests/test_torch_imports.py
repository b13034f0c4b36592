"""The port imports neither JAX nor the JAX package, nor matplotlib (the
machine with the card has none; the drawing functions import it in their
bodies), and importing it touches no CUDA device and builds nothing."""

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
             "atlasvae_torch.train.keras_export"):
    assert name in names, name
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "atlasvae", "matplotlib"))
assert not leaked, leaked
import torch
assert not torch.cuda.is_initialized()
from atlasvae_torch.ops import cuda_build
assert not cuda_build._LIBS
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
