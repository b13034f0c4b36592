"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, through the compile helper that
the g++-built host libraries use (``native.compile_libraries``).  Libraries
are keyed on a hash of the sources, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  The build directory defaults to ``build/atlasvae_torch`` beside
the package (``ATLASVAE_TORCH_BUILD_DIR`` overrides it).  Nothing here runs
when the package is imported.
"""

import contextlib
import ctypes
import os
import shutil
from pathlib import Path

import torch

from .. import native  # one compile helper and build directory for g++ and nvcc

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fused_mlp", "fused_vae", "fused_vae_bwd", "emd_sinkhorn", "fused_conv",
           "fused_conv_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _library_path(name):
    return native.keyed_library(name, sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"],
                                NVCC_FLAGS)


def build(names=SOURCES):
    """Compile every stale library among ``names``, one ``nvcc`` each, all
    started together.  Returns {name: (path, seconds, ptxas report)}."""
    return native.compile_libraries({name: (_library_path(name), CSRC / f"{name}.cu")
                                     for name in names}, nvcc_path(), NVCC_FLAGS)


def load(name):
    """The ctypes handle of one kernel library, built on first use."""
    if name not in _LIBS:
        lib_path = _library_path(name)
        if not lib_path.is_file():
            build((name,))
        _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


# K1-K3 take a stack of any depth and any width: a layer wider than 128 runs
# on the layer-wise routes, which keep no layer in shared memory, and a stack
# deeper than the fused bodies' own bound (ops/fused_vae.py::FUSED_MAX_HIDDEN)
# is cut into segments (K1/K2) or runs layer by layer (K3).  The heads are
# bounded: every caller in the port has 1 or 2 (a VAE encoder's mean and
# log-variance, or one output layer).
MAX_HEADS = 4


def check_stack(x, hidden, heads, what):
    """Raise unless ``x`` (B, D0) and the (w, b) pairs of the hidden layers
    and the heads form a stack the dense-stack kernels take.  A direct call
    records no autograd graph: a gradient goes through
    ``ops.fused_vae.FusedEncoder``/``FusedDecoder``, whose backward is K3."""
    tensors = [x] + [t for pair in list(hidden) + list(heads) for t in pair]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{what} records no gradient; differentiate through "
                                  "fused_encoder/fused_decoder (autograd Functions "
                                  "whose backward is the stack_backward kernel)")
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be 2-D, got {tuple(x.shape)}")
    if not 1 <= len(heads) <= MAX_HEADS:
        raise ValueError(f"{what}: 1..{MAX_HEADS} heads, got {len(heads)}")
    width = x.shape[1]
    for i, (w, b) in enumerate(hidden):
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"{what}: layer {i} w {tuple(w.shape)} / b {tuple(b.shape)} "
                             f"does not follow width {width}")
        width = w.shape[1]
    for k, (w, b) in enumerate(heads):
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"{what}: head {k} w {tuple(w.shape)} / b {tuple(b.shape)} "
                             f"does not follow width {width}")


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def on_device(x):
    """A context in which x's card is the current one: a no-op where it is
    already (the common case, and the cheaper one on the host)."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def pointer_array(tensors):
    """A C array of device pointers (``void* const*``) for a kernel call."""
    return (ctypes.c_void_p * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])


def int_array(values):
    return (ctypes.c_int * max(len(values), 1))(*values)
