"""K5 and K6: the jet-ID towers' input conv block and its backward as
hand-written CUDA kernels.

``conv_pool_relu`` launches ``csrc/fused_conv.cu`` and ``conv_pool_relu_backward``
``csrc/fused_conv_bwd.cu`` (plus its launch that adds the per-CTA partial
sums in a fixed order) on contiguous float32 CUDA tensors.  They compute
what ``ops.fused_conv.conv1_pool_relu_plain`` and
``conv1_pool_relu_backward_plain`` compute; ``ops.fused_conv.FusedConv1``
chooses between kernel and plain version by the tensors' device.  Both raise
on anything the kernels do not take and never run another path.
"""

import ctypes
import functools

import torch

from . import cuda_build

# Kernel launches made by conv_pool_relu (K5) and conv_pool_relu_backward
# (K6); reset and read by chip_smoke.py.
launches = 0
backward_launches = 0

MAX_TAPS = 512    # kh * kw * C
MAX_MAPS = 1024

_SHAPE = [ctypes.c_int] * 9


@functools.cache
def _forward_entry():
    fn = cuda_build.load("fused_conv").atlasvae_conv_pool_relu
    fn.argtypes = [ctypes.c_void_p] * 4 + _SHAPE + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_entries():
    lib = cuda_build.load("fused_conv_bwd")
    parts = lib.atlasvae_conv_backward_parts
    parts.argtypes = _SHAPE
    parts.restype = ctypes.c_int
    fn = lib.atlasvae_conv_backward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + _SHAPE \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return parts, fn


def _check(what, x, w, b, pool, g=None):
    """The nine shape integers of a call, or an exception naming what the
    kernel does not take."""
    tensors = {"x": x, "w": w, "b": b} if g is None else {"x": x, "w": w, "b": b, "g": g}
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(f"{what} records no gradient; differentiate through "
                                  "ops.fused_conv.fused_conv1_pool_relu (an autograd "
                                  "Function whose backward is the K6 kernel)")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32, got {t.dtype}, "
                             f"contiguous={t.is_contiguous()}")
    if x.dim() != 4 or w.dim() != 4 or len(pool) != 2:
        raise ValueError(f"{what}: x (N, H, W, C), w (kh, kw, C, M) and a 2-D pool, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, pool {tuple(pool)}")
    n, h, wd, c = x.shape
    kh, kw, cw, m = w.shape
    ph, pw = (int(p) for p in pool)
    if cw != c or b.shape != (m,):
        raise ValueError(f"{what}: w {tuple(w.shape)} / b {tuple(b.shape)} do not follow "
                         f"x {tuple(x.shape)}")
    if n < 1 or h < kh or wd < kw or ph < 1 or pw < 1:
        raise ValueError(f"{what}: empty batch, or the {kh}x{kw} kernel does not fit the "
                         f"{h}x{wd} image")
    if kh * kw * c > MAX_TAPS or m > MAX_MAPS:
        raise ValueError(f"{what}: kh*kw*C = {kh * kw * c} (at most {MAX_TAPS}) and M = {m} "
                         f"(at most {MAX_MAPS}) bound the kernel's weight tile")
    return n, h, wd, c, kh, kw, m, ph, pw


def out_shape(x_shape, w_shape, pool):
    """(N, Ho, Wo, M) of the pooled block: VALID conv, SAME (ceil) pool."""
    hc, wc = x_shape[1] - w_shape[0] + 1, x_shape[2] - w_shape[1] + 1
    return x_shape[0], -(-hc // pool[0]), -(-wc // pool[1]), w_shape[3]


def _raise(err, what, x, w):
    if err == -2:
        raise ValueError(f"{what}: the input rows one pooled row needs ({w.shape[0]} + pool "
                         f"rows of {x.shape[2] * x.shape[3]} floats) exceed a CTA's 227 KB "
                         "of shared memory")
    if err < 0:
        raise ValueError(f"{what}: the kernel refused the shape (code {err})")
    cuda_build.check(err, f"{what} kernel")


def conv_pool_relu(x, w, b, pool):
    """K5: relu(maxpool_SAME(conv2d_VALID(x, w)) + b) -> (N, Ho, Wo, M)."""
    global launches
    shape = _check("conv_pool_relu", x, w, b, pool)
    out = torch.empty(out_shape(x.shape, w.shape, shape[7:]), device=x.device,
                      dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _forward_entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                               *shape, torch.cuda.current_stream().cuda_stream)
    _raise(err, "conv_pool_relu", x, w)
    launches += 1
    return out


@functools.cache
def _n_parts(shape):
    return _backward_entries()[0](*shape)


def conv_pool_relu_backward(x, w, b, g, pool):
    """K6: (dW, db) of ``conv_pool_relu(x, w, b, pool)`` for the gradient
    ``g`` of its output.  The input's gradient is not computed."""
    global backward_launches
    shape = _check("conv_pool_relu_backward", x, w, b, pool, g)
    if tuple(g.shape) != out_shape(x.shape, w.shape, shape[7:]):
        raise ValueError(f"conv_pool_relu_backward: g {tuple(g.shape)} is not the output's "
                         f"shape {out_shape(x.shape, w.shape, shape[7:])}")
    n_parts = _n_parts(shape)
    _raise(min(n_parts, 0), "conv_pool_relu_backward", x, w)
    n_params = w.numel() + b.numel()
    partial = torch.empty((n_parts, n_params), device=x.device, dtype=torch.float32)
    grads = torch.empty(n_params, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _backward_entries()[1](x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                                     partial.data_ptr(), n_parts, grads.data_ptr(), *shape,
                                     torch.cuda.current_stream().cuda_stream)
    _raise(err, "conv_pool_relu_backward", x, w)
    backward_launches += 1
    return grads[:w.numel()].view(w.shape), grads[w.numel():]
