"""K5 and K6: the jet-ID towers' input conv block and its backward as
hand-written CUDA kernels.

Each has two routes, which ``route`` picks from the shape alike for both:
the register route (3x3 taps, one channel, a 2x2 pool, at most 128 maps:
the jet-ID CNN's first block) and the band route (every other shape the
gate takes), where a CTA stages a band of input rows and a tile of weights
in shared memory.  ``conv_pool_relu`` launches ``csrc/fused_conv.cu``;
``conv_pool_relu_backward`` launches ``csrc/fused_conv_bwd.cu``, whose CTAs
write partial sums that a second launch adds in a fixed order.  Both take
contiguous CUDA tensors, all float32 or all bfloat16, and compute what
``ops.fused_conv.conv1_pool_relu_plain`` and
``conv1_pool_relu_backward_plain`` compute: the output, dW and db rounded
once to the tensors' dtype.  In float32, and on the bf16 band route, a
thread sums taps with a chain of FMAs (the register route: four maps' taps
and sums in registers), bf16 widened to float where it is loaded.  The bf16
register route runs on the tensor cores instead (an implicit GEMM on
``mma.sync``, bf16 products summed in float32), so its partial slices are
cut by its own count (``_n_parts``).  ``ops.fused_conv.FusedConv1`` chooses
between kernel and plain version by the tensors' device.  Both raise on
anything the kernels do not take and never run another path: a bfloat16
tensor is never widened to run a float32 kernel.
"""

import ctypes
import functools

import torch

from . import cuda_build

MAX_TAPS = 512    # kh * kw * C
MAX_MAPS = 1024
ROUTES = ("tiles", "bands")
TILE_MAX_MAPS = 128   # kTileMaps in csrc/fused_conv.cuh

_SHAPE = [ctypes.c_int] * 9
# the C entry points' suffix of each form
_FORMS = {torch.float32: "", torch.bfloat16: "_bf16"}

# Kernel launches made by conv_pool_relu (K5, "forward") and
# conv_pool_relu_backward (K6, "backward"), keyed by (dtype, route,
# direction); reset and read by chip_smoke.py.
launches = {(dtype, which, direction): 0 for dtype in _FORMS for which in ROUTES
            for direction in ("forward", "backward")}


@functools.cache
def _forward_entries(form):
    lib = cuda_build.load("fused_conv")
    bands = getattr(lib, "atlasvae_conv_pool_relu" + form)
    tiles = getattr(lib, "atlasvae_conv_pool_relu_tiles" + form)
    bands.argtypes = [ctypes.c_void_p] * 4 + _SHAPE + [ctypes.c_void_p]
    tiles.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bands.restype = tiles.restype = ctypes.c_int
    return tiles, bands


def route(x_shape, w_shape, pool):
    """The route of K5 and K6 for a shape the kernels take: "tiles" for 3x3
    taps on one channel, a 2x2 pool and at most TILE_MAX_MAPS maps, "bands"
    for the rest."""
    kh, kw, c, m = w_shape
    if c == 1 and (kh, kw) == (3, 3) and tuple(pool) == (2, 2) and m <= TILE_MAX_MAPS:
        return "tiles"
    return "bands"


def pick_route(what, x_shape, w_shape, pool, force_route=None):
    """``route``, or ``force_route`` ("tiles" or "bands") where that route
    takes the shape: for tests and timings only.  Raises before anything is
    built or launched."""
    which = route(x_shape, w_shape, pool)
    if force_route == "bands":
        return "bands"
    if force_route == "tiles" and which != "tiles":
        raise ValueError(f"{what}: the register route takes 3x3 taps on one channel, a 2x2 "
                         f"pool and at most {TILE_MAX_MAPS} maps, got w {tuple(w_shape)}, "
                         f"pool {tuple(pool)}")
    if force_route not in (None, *ROUTES):
        raise ValueError(f"{what}: force_route must be one of {ROUTES}, got {force_route!r}")
    return which


@functools.cache
def _backward_entries(form):
    lib = cuda_build.load("fused_conv_bwd")
    tiles_parts = getattr(lib, "atlasvae_conv_backward_tiles_parts" + form)
    bands_parts = lib.atlasvae_conv_backward_parts
    tiles = getattr(lib, "atlasvae_conv_backward_tiles" + form)
    bands = getattr(lib, "atlasvae_conv_backward" + form)
    tiles_parts.argtypes = [ctypes.c_int] * 4
    bands_parts.argtypes = _SHAPE
    tiles.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bands.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + _SHAPE \
        + [ctypes.c_void_p]
    for fn in (tiles_parts, bands_parts, tiles, bands):
        fn.restype = ctypes.c_int
    return tiles_parts, tiles, bands_parts, bands


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
        if t.dtype not in _FORMS or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32 or bfloat16, the dtype "
                             f"of x ({x.dtype}), got {t.dtype}, "
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


def conv_pool_relu(x, w, b, pool, force_route=None):
    """K5: relu(maxpool_SAME(conv2d_VALID(x, w)) + b) -> (N, Ho, Wo, M).
    ``force_route`` ("tiles" or "bands") runs a route other than ``route``
    picks, where it takes the shape: for tests and timings only."""
    shape = _check("conv_pool_relu", x, w, b, pool)
    which = pick_route("conv_pool_relu", x.shape, w.shape, shape[7:], force_route)
    out = torch.empty(out_shape(x.shape, w.shape, shape[7:]), device=x.device, dtype=x.dtype)
    tiles, bands = _forward_entries(_FORMS[x.dtype])
    n, h, wd, _, _, _, m, _, _ = shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "tiles":
            err = tiles(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, wd, m,
                        stream)
        else:
            err = bands(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), *shape, stream)
    _raise(err, f"conv_pool_relu ({which} route)", x, w)
    launches[x.dtype, which, "forward"] += 1
    return out


@functools.cache
def _n_parts(which, shape, form):
    """Partial slices (rows of the scratch buffer, float32 sums) K6 uses on a
    route: the band route cuts them alike in both forms, the register route's
    bf16 form (the tensor-core kernel) cuts its own."""
    tiles_parts, _, bands_parts, _ = _backward_entries(form)
    if which == "tiles":
        n, h, wd, _, _, _, m, _, _ = shape
        return tiles_parts(n, h, wd, m)
    return bands_parts(*shape)


def conv_pool_relu_backward(x, w, b, g, pool, force_route=None):
    """K6: (dW, db) of ``conv_pool_relu(x, w, b, pool)`` for the gradient
    ``g`` of its output, in the dtype of w and b, on the route ``route``
    picks (``force_route`` as for ``conv_pool_relu``).  The input's gradient
    is not computed."""
    what = "conv_pool_relu_backward"
    shape = _check(what, x, w, b, pool, g)
    if tuple(g.shape) != out_shape(x.shape, w.shape, shape[7:]):
        raise ValueError(f"{what}: g {tuple(g.shape)} is not the output's "
                         f"shape {out_shape(x.shape, w.shape, shape[7:])}")
    which = pick_route(what, x.shape, w.shape, shape[7:], force_route)
    n_parts = _n_parts(which, shape, _FORMS[x.dtype])
    _raise(min(n_parts, 0), f"{what} ({which} route)", x, w)
    n_params = w.numel() + b.numel()
    partial = torch.empty((n_parts, n_params), device=x.device, dtype=torch.float32)
    grads = torch.empty(n_params, device=x.device, dtype=x.dtype)
    _, tiles, _, bands = _backward_entries(_FORMS[x.dtype])
    n, h, wd, _, _, _, m, _, _ = shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        pointers = (x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), partial.data_ptr(),
                    n_parts, grads.data_ptr())
        if which == "tiles":
            err = tiles(*pointers, n, h, wd, m, stream)
        else:
            err = bands(*pointers, *shape, stream)
    _raise(err, f"{what} ({which} route)", x, w)
    launches[x.dtype, which, "backward"] += 1
    return grads[:w.numel()].view(w.shape), grads[w.numel():]
