"""The jet-ID towers' input block, relu(maxpool(conv2d(x, w)) + b), as one
differentiable function: kernels K5/K6 on the card, plain PyTorch on the CPU.

Counterpart of ``atlasvae/ops/fused_conv.py``.  x is (N, H, W, C)
channels-last, w (kh, kw, C, M), b (M,); VALID conv, stride 1; max pool with
window == stride and XLA's SAME padding (``ops/pooling.py``); the bias is
added after the pool (adding a per-map constant is monotone, so the pooled
value is the same) and the gradient of a tied window goes to its first
position.  **Input layer only**: the backward gives dW and db and nothing
for x, which is data in the towers.

``conv1_pool_relu_plain`` and ``conv1_pool_relu_backward_plain`` are the plain
versions of K5 and K6 (``F.conv2d`` and ``maxpool_same``; the backward is
autograd through the forward).  The CPU tests use them, ``chip_smoke.py``
holds the kernels against them on the card, and ``FusedConv1`` takes them
only for tensors that lie on the CPU.
"""

import torch
import torch.nn.functional as F

from . import fused_conv_cuda
from .pooling import maxpool_same

MAX_TAPS, MAX_MAPS = fused_conv_cuda.MAX_TAPS, fused_conv_cuda.MAX_MAPS


def supported(x_shape, w_shape, pool):
    """Shapes the fused block takes: a 2-D tower whose kernel fits the image,
    kh*kw*C <= 512 and M <= 1024 (the gate of the JAX package's kernel)."""
    if len(w_shape) != 4 or len(pool) != 2:
        return False
    kh, kw, c, m = w_shape
    return (kh * kw * c <= MAX_TAPS and m <= MAX_MAPS
            and x_shape[1] >= kh and x_shape[2] >= kw)


def conv2d_valid(x, w):
    """Channels-last VALID stride-1 convolution: x (N, H, W, C) or
    (N, D1, D2, D3, C), w (*kernel, C, M) -> (N, *out, M).  The permuted
    views are channels-last tensors to the library, so nothing is copied
    but the weights."""
    rank = w.dim() - 2
    to_first = [0, rank + 1] + list(range(1, rank + 1))
    to_last = [0] + list(range(2, rank + 2)) + [1]
    conv = F.conv2d if rank == 2 else F.conv3d
    z = conv(x.permute(to_first), w.permute([rank + 1, rank] + list(range(rank))))
    return z.permute(to_last)


def conv1_pool_relu_plain(x, w, b, pool):
    """Plain PyTorch version of K5."""
    return torch.relu(maxpool_same(conv2d_valid(x, w), pool) + b)


def conv1_pool_relu_backward_plain(x, w, b, g, pool):
    """Plain PyTorch version of K6: (dW, db) by autograd through the plain
    forward (the ReLU mask on zmax + b, the pool's first-match routing, the
    conv's weight gradient)."""
    with torch.enable_grad():
        w_, b_ = w.detach().requires_grad_(), b.detach().requires_grad_()
        out = conv1_pool_relu_plain(x.detach(), w_, b_, pool)
        return torch.autograd.grad(out, (w_, b_), g)


class FusedConv1(torch.autograd.Function):
    """K5 forward, K6 backward on CUDA tensors; their plain versions on CPU
    tensors.  x gets no gradient, as the JAX custom VJP gives it zeros
    (``atlasvae/ops/fused_conv.py:315``)."""

    @staticmethod
    def forward(ctx, x, w, b, pool):
        ctx.save_for_backward(x, w, b)
        ctx.pool = pool
        if x.device.type == "cpu":
            return conv1_pool_relu_plain(x, w, b, pool)
        return fused_conv_cuda.conv_pool_relu(x, w, b, pool)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        if x.device.type == "cpu":
            dw, db = conv1_pool_relu_backward_plain(x, w, b, g, ctx.pool)
        else:
            dw, db = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g.contiguous(), ctx.pool)
        return None, dw, db, None


def fused_conv1_pool_relu(x, w, b, pool=(2, 2)):
    """relu(maxpool(conv2d(x, w)) + b) -> (N, ceil(Hc/ph), ceil(Wc/pw), M),
    differentiable in w and b."""
    return FusedConv1.apply(x, w, b, tuple(int(p) for p in pool))
