"""Fused dense-stack forward: hand-written CUDA kernel K1 and its plain twin.

Counterpart of ``atlasvae/ops/fused_mlp.py``.  ``fused_mlp_apply`` runs a
whole dense stack (ReLU hidden layers, linear or ReLU final layer) on a CUDA
tensor by the route ``ops.fused_vae.forward_plan`` picks from its shape, as
K2 does: one launch of ``csrc/fused_mlp.cu``'s fused body, every
intermediate activation in shared memory, where no width exceeds 128; else
its layer-wise route, in one C call.  On a CPU tensor it runs
``fused_mlp_plain``, the same function as chained ``x @ w + b`` and ReLU.
Forward only, as the JAX kernel is: it is the decoder wherever grad is off
(scoring, validation losses); a decoder that is trained goes through
``ops.fused_vae.fused_decoder``, whose backward is K3.
"""

import ctypes
import functools

import torch

from . import cuda_build
from .fused_vae import forward_plan, layered_args, shape_array

# Kernel launches made by fused_mlp_apply: its fused body, and its layer-wise
# route (reset and read by chip_smoke.py).
launches = 0
layered_launches = 0


def _check_args(activation, final_activation):
    if activation != "relu" or final_activation not in ("linear", "relu"):
        raise ValueError("fused kernel supports relu hidden + linear/relu final")


def fused_mlp_plain(layers, x, activation="relu", final_activation="linear"):
    """Plain PyTorch version of the kernel: the CPU path and the reference
    the kernel is held against on the card."""
    _check_args(activation, final_activation)
    h = x
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_activation == "relu":
            h = torch.relu(h)
    return h


@functools.cache
def _entries():
    lib = cuda_build.load("fused_mlp")
    fused = lib.atlasvae_fused_mlp_forward
    fused.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p]
    fused.restype = ctypes.c_int
    layers = lib.atlasvae_fused_mlp_forward_layers
    layers.argtypes = fused.argtypes[:-1] + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    layers.restype = ctypes.c_int
    return fused, layers


def fused_mlp_apply(layers, x, activation="relu", final_activation="linear"):
    """Apply a dense stack (list of {'w','b'}, w shaped (in, out)) on a CUDA
    tensor: one fused kernel, or the segments of ``forward_plan``; the plain
    version on a CPU tensor."""
    global launches, layered_launches
    _check_args(activation, final_activation)
    if x.device.type == "cpu":
        return fused_mlp_plain(layers, x, activation, final_activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_apply: unsupported device {x.device}")
    if not layers:
        raise ValueError("fused_mlp_apply: empty stack")
    pairs = [(l["w"], l["b"]) for l in layers]
    cuda_build.check_stack(x, pairs[:-1], pairs[-1:], "fused_mlp_apply")
    widths = (x.shape[1],) + tuple(w.shape[1] for w, _ in pairs)
    plan = forward_plan(x.shape[0], widths[:-1], widths[-1:])
    out = torch.empty((x.shape[0], widths[-1]), device=x.device, dtype=torch.float32)
    dims = shape_array(widths)
    # one C array: the weights, then the biases
    ptrs = cuda_build.pointer_array([w for w, _ in pairs] + [b for _, b in pairs])
    at = ctypes.addressof(ptrs)
    common = (x.data_ptr(), x.shape[0], len(pairs), ctypes.addressof(dims), at,
              at + ctypes.sizeof(ctypes.c_void_p) * len(pairs), out.data_ptr(),
              int(final_activation == "relu"))
    fused, layered = _entries()
    with cuda_build.on_device(x):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "fused":
            err = fused(*common, stream)
        else:
            args, _keep = layered_args(plan, x)   # _keep: the scratch, until the call returns
            err = layered(*common, *args, stream)
    cuda_build.check(err, f"fused_mlp kernel ({plan.route} route)")
    if plan.route == "fused":
        launches += 1
    else:
        layered_launches += 1
    return out
