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
             "atlasvae_torch.train.ensemble"):
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
