"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface.  Libraries are keyed on a hash of
the sources, so an edited kernel is rebuilt and an unchanged one is loaded
as it is.  The build directory defaults to ``build/atlasvae_torch`` beside
the package (``ATLASVAE_TORCH_BUILD_DIR`` overrides it).  Nothing here runs
when the package is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fused_mlp", "fused_vae", "fused_vae_bwd", "emd_sinkhorn", "fused_conv",
           "fused_conv_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}


def build_dir():
    default = Path(__file__).resolve().parents[2] / "build" / "atlasvae_torch"
    return Path(os.environ.get("ATLASVAE_TORCH_BUILD_DIR", default))


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _library_path(name):
    digest = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES):
    """Compile every stale library among ``names``, one ``nvcc`` each, all
    started together.  Returns {name: (path, seconds, ptxas report)}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    report = {}
    for name in names:
        lib = _library_path(name)
        if lib.is_file():
            report[name] = (lib, 0.0, "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, start, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        report[name] = (lib, time.perf_counter() - start, log)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def load(name):
    """The ctypes handle of one kernel library, built on first use."""
    if name not in _LIBS:
        lib_path = _library_path(name)
        if not lib_path.is_file():
            build((name,))
        _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


# Widest input/hidden layer whose two 32-row activation buffers and weight
# chunk fit a CTA's 227 KB of shared memory (stack_smem_bytes<32> in
# csrc/dense_stack.cuh); kMaxHidden and kMaxHeads bound the layer counts.
MAX_WIDTH = 750
MAX_HIDDEN = 8
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
    if len(hidden) > MAX_HIDDEN or not 1 <= len(heads) <= MAX_HEADS:
        raise ValueError(f"{what}: at most {MAX_HIDDEN} hidden layers and 1..{MAX_HEADS} "
                         f"heads, got {len(hidden)} and {len(heads)}")
    width = x.shape[1]
    widths = [width]
    for i, (w, b) in enumerate(hidden):
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"{what}: layer {i} w {tuple(w.shape)} / b {tuple(b.shape)} "
                             f"does not follow width {width}")
        width = w.shape[1]
        widths.append(width)
    for k, (w, b) in enumerate(heads):
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"{what}: head {k} w {tuple(w.shape)} / b {tuple(b.shape)} "
                             f"does not follow width {width}")
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"{what}: widths above {MAX_WIDTH} do not fit shared memory")


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def pointer_array(tensors):
    """A C array of device pointers (``void* const*``) for a kernel call."""
    return (ctypes.c_void_p * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])


def int_array(values):
    return (ctypes.c_int * max(len(values), 1))(*values)
