"""atlasvae_torch.ops.pooling.maxpool_same against the JAX package's pool.

Same numpy inputs through ``atlasvae.ops.pooling.maxpool_same`` (equal, bit
for bit, to XLA's reduce_window chain and its select-and-scatter gradient,
tests/test_pooling.py) and through the port.  Tolerance: none.  A max is a
selection, and its gradient a routing of the cotangent: values and
gradients are compared with assert_array_equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atlasvae.ops.pooling import maxpool_same as jax_pool
from atlasvae_torch.ops.pooling import maxpool_same, same_pad_lo

CASES = [
    ((4, 14, 14, 5), (2, 2)),      # the tower shape family
    ((3, 13, 10, 7), (3, 3)),      # ceil edges + SAME low-side pad (13 % 3 = 1)
    ((2, 9, 9, 4), (4, 4)),        # wide window, low pad 1
    ((2, 7, 11, 3), (2, 3)),       # asymmetric window
    ((2, 6, 6, 5, 2), (2, 2, 3)),  # rank 3 (the 3-D towers' pool)
    ((3, 10, 4), (4,)),            # rank 1
]


def _both(rng, z, pool):
    """(values, gradient) from JAX and from the port, for one random
    cotangent: every output has its own, so a routing difference shows."""
    ref, vjp = jax.vjp(lambda z: jax_pool(z, pool), z)
    cot = rng.normal(size=ref.shape).astype(np.float32)
    g_ref = np.asarray(vjp(jnp.asarray(cot))[0])
    tz = torch.tensor(z, requires_grad=True)
    out = maxpool_same(tz, pool)
    out.backward(torch.tensor(cot))
    return np.asarray(ref), g_ref, out.detach().numpy(), tz.grad.numpy()


@pytest.mark.parametrize("shape,pool", CASES)
def test_maxpool_values_and_grads_equal_jax(rng, shape, pool):
    z = rng.normal(size=shape).astype(np.float32)
    ref, g_ref, got, g_got = _both(rng, z, pool)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(g_got, g_ref)


@pytest.mark.parametrize("shape,pool", CASES)
def test_maxpool_ties_route_to_the_first_match(rng, shape, pool):
    """Values rounded to integers in [-1, 1]: most windows tie, also across
    the low-side padding."""
    z = np.round(rng.normal(size=shape) * 0.7).astype(np.float32)
    ref, g_ref, got, g_got = _both(rng, z, pool)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(g_got, g_ref)


def test_maxpool_constructed_ties():
    z = np.ones((1, 6, 6, 2), np.float32)           # every window all tied
    z[0, 2:4, 2:4, 0] = 3.0                          # one higher tied block
    cot = np.arange(1, 19, dtype=np.float32).reshape(1, 3, 3, 2)
    g_ref = np.asarray(jax.grad(lambda z: jnp.sum(jax_pool(z, (2, 2)) * cot))(z))
    tz = torch.tensor(z, requires_grad=True)
    (maxpool_same(tz, (2, 2)) * torch.tensor(cot)).sum().backward()
    np.testing.assert_array_equal(tz.grad.numpy(), g_ref)
    # each window's cotangent lands on exactly one element: its first
    assert np.count_nonzero(tz.grad.numpy()) == 18
    assert tz.grad[0, 0, 0, 0] == 1.0 and tz.grad[0, 0, 1, 0] == 0.0
    # a sparse image: windows of zeros beside single lit pixels
    z2 = np.zeros((1, 5, 5, 1), np.float32)
    z2[0, 0, 1, 0] = z2[0, 2, 3, 0] = 5.0
    z2[0, 3:, 3:, 0] = -2.0
    z2[0, 4, 4, 0] = -1.0        # the largest of a negative window beside the padding
    cot2 = np.arange(1, 5, dtype=np.float32).reshape(1, 2, 2, 1)
    g2 = np.asarray(jax.grad(lambda z: jnp.sum(jax_pool(z, (3, 3)) * cot2))(z2))
    t2 = torch.tensor(z2, requires_grad=True)
    (maxpool_same(t2, (3, 3)) * torch.tensor(cot2)).sum().backward()
    np.testing.assert_array_equal(t2.grad.numpy(), g2)
    assert t2.grad[0, 4, 4, 0] == 4.0


def test_same_pad_lo_is_xlas():
    from atlasvae.ops.fused_conv import _pool_pad_lo
    for size in range(1, 40):
        for pool in range(1, 7):
            assert same_pad_lo(size, pool) == _pool_pad_lo(size, pool)


def test_maxpool_rejects_a_rank_mismatch():
    with pytest.raises(ValueError, match="rank"):
        maxpool_same(torch.zeros((2, 4, 4, 3)), (2, 2, 2))


@pytest.mark.parametrize("shape,pool", CASES[:4])
def test_maxpool_bf16_ties_route_to_the_first_match(rng, shape, pool):
    """bfloat16 values in quarter steps: most windows tie, also beside the
    -inf low-side padding; values and the routed gradient (a bf16 buffer)
    equal the JAX pool's in bf16, bit for bit."""
    z = (np.round(rng.normal(size=shape) * 3) / 4).astype(jnp.bfloat16)
    ref, vjp = jax.vjp(lambda z: jax_pool(z, pool), jnp.asarray(z))
    cot = rng.normal(size=ref.shape).astype(jnp.bfloat16)
    g_ref = np.asarray(vjp(jnp.asarray(cot))[0], np.float32)
    tz = torch.from_numpy(z.astype(np.float32)).bfloat16().requires_grad_()
    out = maxpool_same(tz, pool)
    out.backward(torch.from_numpy(cot.astype(np.float32)).bfloat16())
    assert out.dtype == tz.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(tz.grad.float().numpy(), g_ref)
    # each window's cotangent lands on one element only
    assert int((tz.grad != 0).sum()) <= int((out != 0).numel())
