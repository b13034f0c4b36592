"""Channels-last max pooling, window == stride, SAME padding as XLA pads it.

Counterpart of ``atlasvae/ops/pooling.py`` and of the ``reduce_window`` call
of the jet-ID towers: a torch op, not a hand-written kernel (the JAX package
computes it outside any Pallas kernel too).  ``F.max_pool2d`` pads both
sides alike and only reaches the high-side case with ``ceil_mode``; XLA puts
``total_pad // 2`` on the low side, which shifts the window grouping once a
pool of 3 or more meets a size that is not its multiple.  So the padding is
done here, with -inf, and the windows are read as strided views.

Values equal ``-reduce_window(-z, inf, min)``; the gradient goes to the
**first** position of a window that equals its maximum, in row-major window
order, as XLA's select-and-scatter routes it.  Jet images are mostly zeros,
so whole windows tie: the rule is written out here (a later position takes
over only where it is strictly larger) and not left to a library's argmax.
"""

import itertools
import math

import torch


def same_pad_lo(size, pool):
    """(low-side padding, output size) of XLA's SAME window == stride pool."""
    out = -(-size // pool)
    total = max(out * pool - size, 0)
    return total // 2, out


def _padded(z, pool):
    """``z`` (N, *spatial, M) padded with -inf to whole windows, XLA's way,
    and the (low, high) pads per spatial axis."""
    if z.dim() != len(pool) + 2:
        raise ValueError(f"maxpool_same: input of {z.dim()} dims for a pool of rank {len(pool)}")
    pads = []
    for axis, p in enumerate(pool):
        lo, out = same_pad_lo(z.shape[axis + 1], p)
        pads.append((lo, out * p - z.shape[axis + 1] - lo))
    if any(lo or hi for lo, hi in pads):
        flat = [0, 0] + [v for lo, hi in reversed(pads) for v in (lo, hi)]
        z = torch.nn.functional.pad(z, flat, value=-math.inf)
    return z, pads


def _positions(pool):
    """The window's positions in row-major order, each as the strided slice
    that picks it out of every window of a padded (N, *spatial, M) tensor."""
    for offsets in itertools.product(*(range(p) for p in pool)):
        yield (slice(None),) + tuple(slice(o, None, p) for o, p in zip(offsets, pool)) \
            + (slice(None),)


class _MaxPoolSame(torch.autograd.Function):
    """One elementwise pass per window position over channels-last views:
    a later position takes over only where it is strictly larger, so
    ``first`` holds the rank of the first position that reaches the max."""

    @staticmethod
    def forward(ctx, z, pool):
        padded, pads = _padded(z, pool)
        values = first = None
        for rank, position in enumerate(_positions(pool)):
            cand = padded[position]
            if values is None:
                values = cand.clone()
                first = torch.zeros(cand.shape, dtype=torch.uint8 if math.prod(pool) < 256
                                    else torch.int32, device=z.device)
                continue
            larger = cand > values
            values = torch.where(larger, cand, values)
            first.masked_fill_(larger, rank)
        ctx.save_for_backward(first)
        ctx.pool, ctx.pads, ctx.padded_shape = pool, pads, padded.shape
        return values

    @staticmethod
    def backward(ctx, g):
        (first,) = ctx.saved_tensors
        gz = torch.empty(ctx.padded_shape, dtype=g.dtype, device=g.device)
        for rank, position in enumerate(_positions(ctx.pool)):
            gz[position] = torch.where(first == rank, g, 0.0)
        crop = [slice(None)] + [slice(lo, size - hi) for (lo, hi), size
                                in zip(ctx.pads, ctx.padded_shape[1:-1])] + [slice(None)]
        return gz[tuple(crop)], None


def maxpool_same(z, pool):
    """Max pool of ``z`` (N, *spatial, M) over ``pool`` (one window per
    spatial axis, equal to its stride), SAME (ceil) output size."""
    return _MaxPoolSame.apply(z, tuple(int(p) for p in pool))
