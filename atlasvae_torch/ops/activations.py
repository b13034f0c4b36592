"""ReLU with the JAX package's gradient, for every autograd site of the port.

``torch.relu`` keeps a NaN input as ``jax.nn.relu`` does, but its backward
passes the gradient wherever the input is not <= 0, so at a NaN input it
passes it; ``jax.nn.relu``'s custom JVP selects the gradient where the input
is > 0 and gives 0 elsewhere, at NaN and at 0 alike (a selection, so a
non-finite gradient there gives 0 too).  The training step's guard zeroes
each non-finite gradient element, so where the two rules part the port
would update weights that the reference leaves alone.

``leaky_relu0`` is the JAX table's ``"leaky_relu"``, ``jax.nn.leaky_relu(x,
0.0)`` = ``where(x >= 0, x, 0.0 * x)`` (``atlasvae/models/mlp.py:56``): its
values are ``torch.relu``'s for every input but -inf, where 0 x -inf makes
a NaN; its gradient is ``g`` where ``x >= 0`` and ``0 * g`` elsewhere (so
1 at exactly 0, and NaN where ``g`` is not finite).

Both keep ``torch.relu``'s forward values bit for bit on finite inputs and
run one elementwise kernel each way.
"""

import torch


class _Relu(torch.autograd.Function):
    """relu(x); the gradient ``g`` where the output is > 0 (exactly where the
    input is: a NaN, 0 and every negative input give an output that is
    not), else 0."""

    @staticmethod
    def forward(ctx, x):
        y = torch.relu(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0, g, 0.0)


class _LeakyRelu0(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, x, x * 0.0 + 0.0)   # + 0.0: -0.0 to torch.relu's 0.0

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * 0.0)


def relu(x):
    """``jax.nn.relu``: values as ``torch.relu``, gradient selected where
    x > 0."""
    return _Relu.apply(x)


def leaky_relu0(x):
    """``jax.nn.leaky_relu(x, 0.0)``, values and gradient."""
    return _LeakyRelu0.apply(x)
