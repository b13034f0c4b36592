"""Channels-last max pooling, window == stride, SAME padding as XLA pads it.

Counterpart of ``atlasvae/ops/pooling.py`` and of the ``reduce_window`` call
of the jet-ID towers: a torch op, not a hand-written kernel (the JAX package
computes it outside any Pallas kernel too).  ``F.max_pool2d`` pads both
sides alike and only reaches the high-side case with ``ceil_mode``; XLA puts
``total_pad // 2`` on the low side, which shifts the window grouping once a
pool of 3 or more meets a size that is not its multiple.  So the padding is
done here, with -inf, and the windows are read as strided views.

Values equal ``-reduce_window(-z, inf, min)``: a NaN anywhere in a window
is the window's value.  The gradient goes to the **first** position of a
window that equals its maximum, in row-major window order, as the JAX
package's ``maxpool_same`` routes it (``hit = z == y``), so a NaN window
routes nothing.  Jet images are mostly zeros, so whole windows tie: the rule
is written out here and not left to a library's argmax.
"""

import itertools
import math

import torch


def same_pad_lo(size, pool):
    """(low-side padding, output size) of XLA's SAME window == stride pool."""
    out = -(-size // pool)
    total = max(out * pool - size, 0)
    return total // 2, out


def _padded(z, pool, fill=-math.inf):
    """``z`` (N, *spatial, M) padded with ``fill`` to whole windows, XLA's
    way, and the (low, high) pads per spatial axis."""
    if z.dim() != len(pool) + 2:
        raise ValueError(f"maxpool_same: input of {z.dim()} dims for a pool of rank {len(pool)}")
    pads = []
    for axis, p in enumerate(pool):
        lo, out = same_pad_lo(z.shape[axis + 1], p)
        pads.append((lo, out * p - z.shape[axis + 1] - lo))
    if any(lo or hi for lo, hi in pads):
        flat = [0, 0] + [v for lo, hi in reversed(pads) for v in (lo, hi)]
        z = torch.nn.functional.pad(z, flat, value=fill)
    return z, pads


def _positions(pool):
    """The window's positions in row-major order, each as the strided slice
    that picks it out of every window of a padded (N, *spatial, M) tensor."""
    for offsets in itertools.product(*(range(p) for p in pool)):
        yield (slice(None),) + tuple(slice(o, None, p) for o, p in zip(offsets, pool)) \
            + (slice(None),)


class _MaxPoolSame(torch.autograd.Function):
    """One elementwise pass per window position over channels-last views:
    ``torch.maximum`` keeps a NaN and, on a tie, the earlier value.  The
    backward walks the positions again and routes ``g`` to the first that
    equals the window's value; the input is padded with NaN there, which
    equals nothing, so a padding cell never takes it (in the forward it is
    -inf, which a window of real -inf values ties)."""

    @staticmethod
    def forward(ctx, z, pool):
        padded, pads = _padded(z, pool)
        values = None
        for position in _positions(pool):
            cand = padded[position]
            values = cand.clone() if values is None else torch.maximum(values, cand)
        ctx.save_for_backward(z, values)
        ctx.pool, ctx.pads = pool, pads
        return values

    @staticmethod
    def backward(ctx, g):
        z, values = ctx.saved_tensors
        padded, _ = _padded(z, ctx.pool, fill=math.nan)
        gz = torch.empty(padded.shape, dtype=g.dtype, device=g.device)
        taken = None
        for position in _positions(ctx.pool):
            hit = padded[position] == values
            if taken is None:
                taken = hit
            else:
                hit &= ~taken
                taken |= hit
            gz[position] = torch.where(hit, g, 0.0)
        crop = [slice(None)] + [slice(lo, size - hi) for (lo, hi), size
                                in zip(ctx.pads, padded.shape[1:-1])] + [slice(None)]
        return gz[tuple(crop)], None


def maxpool_same(z, pool):
    """Max pool of ``z`` (N, *spatial, M) over ``pool`` (one window per
    spatial axis, equal to its stride), SAME (ceil) output size."""
    return _MaxPoolSame.apply(z, tuple(int(p) for p in pool))
