"""The plain versions of K5 and K6 (atlasvae_torch.ops.fused_conv) against
the JAX package's fused conv block.

Same numpy inputs through ``atlasvae.ops.fused_conv.fused_conv1_pool_relu``
(the Pallas kernel in interpret mode, as tests/test_fused_conv.py runs it on
the CPU), through the unfused XLA chain, and through the port's
``fused_conv1_pool_relu``, which on CPU tensors runs the plain versions
(``F.conv2d`` + ``maxpool_same``; autograd through them for the backward).

Tolerances.  Forward: atol 2e-6 + rtol 2e-6.  The JAX kernel equals the XLA
chain bit for bit because both sum the taps the same way; the port's
convolution is another library's and sums them in its own order: measured
up to 5e-7 at outputs of magnitude 4.  dW, db: 2e-4 (rtol and atol), the bar
tests/test_fused_conv.py holds the JAX kernel to against the chain; measured
2e-7 of each leaf's largest value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atlasvae.ops import fused_conv as jax_fused
from atlasvae_torch.ops import fused_conv, fused_conv_cuda
from atlasvae_torch.utils.bf16 import ulp as bf16_ulp, ulps_apart as bf16_ulps_apart

FWD_TOL = 2e-6
GRAD_TOL = 2e-4

SHAPES = [
    # (N, H, W, C, kh, kw, M, pool): the five of tests/test_fused_conv.py
    (5, 16, 16, 1, 3, 3, 10, (2, 2)),
    (3, 13, 11, 2, 3, 2, 7, (3, 3)),
    (4, 10, 10, 1, 2, 2, 5, (3, 3)),
    (2, 12, 9, 1, 3, 3, 130, (2, 2)),
    (3, 9, 9, 1, 3, 3, 4, (4, 4)),
]


def _xla_chain(x, w, b, pool):
    z = jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    win = (1,) + tuple(pool) + (1,)
    return jax.nn.relu(-jax.lax.reduce_window(-z, jnp.inf, jax.lax.min, win, win, "SAME"))


def _inputs(rng, shape, sparse):
    n, h, wd, c, kh, kw, m, _ = shape
    x = rng.normal(size=(n, h, wd, c)).astype(np.float32)
    if sparse:   # a jet image: a few lit pixels, whole pool windows tie at 0
        x = np.abs(x) * (rng.random(x.shape) < 0.08)
    w = (rng.normal(size=(kh, kw, c, m)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(m,)) * 0.1).astype(np.float32)
    return x.astype(np.float32), w, b


def _port(x, w, b, pool):
    """(out, dW, db) of sum(out ** 2) through the port's autograd Function."""
    tw, tb = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = fused_conv.fused_conv1_pool_relu(tx, tw, tb, pool)
    (out ** 2).sum().backward()
    return out.detach().numpy(), tw.grad.numpy(), tb.grad.numpy(), tx.grad


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_the_pallas_kernel_and_the_xla_chain(rng, shape, sparse):
    pool = shape[-1]
    x, w, b = _inputs(rng, shape, sparse)
    out, dw, db, dx = _port(x, w, b, pool)
    assert dx is None   # the input layer gets no gradient
    for fn in (jax_fused.fused_conv1_pool_relu, _xla_chain):
        ref = np.asarray(fn(x, w, b, pool))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=FWD_TOL, atol=FWD_TOL)
        gw, gb = jax.grad(lambda w, b: jnp.sum(fn(x, w, b, pool) ** 2), argnums=(0, 1))(w, b)
        np.testing.assert_allclose(dw, np.asarray(gw), rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(db, np.asarray(gb), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_backward_plain_is_the_functions_backward(rng, shape):
    pool = shape[-1]
    x, w, b = _inputs(rng, shape, True)
    _, dw, db, _ = _port(x, w, b, pool)
    tx, tw, tb = (torch.tensor(a) for a in (x, w, b))
    out = fused_conv.conv1_pool_relu_plain(tx, tw, tb, pool)
    dw2, db2 = fused_conv.conv1_pool_relu_backward_plain(tx, tw, tb, 2 * out, pool)
    np.testing.assert_array_equal(dw2.numpy(), dw)
    np.testing.assert_array_equal(db2.numpy(), db)


def test_tied_windows_route_db_through_the_first_match(rng):
    """An all-zero image: every conv output is 0, every window ties, the
    output is relu(b) and db counts each pooled pixel once where b > 0."""
    x = np.zeros((2, 8, 8, 1), np.float32)
    w = rng.normal(size=(3, 3, 1, 6)).astype(np.float32)
    b = np.array([0.5, -0.5, 0.25, 0.0, 1.0, -1.0], np.float32)
    tw, tb = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    out = fused_conv.fused_conv1_pool_relu(torch.tensor(x), tw, tb, (2, 2))
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy()[0, 0, 0], np.maximum(b, 0))
    np.testing.assert_array_equal(tb.grad.numpy(), 2 * 9 * (b > 0))
    np.testing.assert_array_equal(tw.grad.numpy(), np.zeros_like(w))
    gb = jax.grad(lambda b: jnp.sum(jax_fused.fused_conv1_pool_relu(x, w, b, (2, 2))))(b)
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(gb))


def test_supported_gate_equals_jax():
    grid = [((8, h, wd, c), (kh, kw, c, m), pool)
            for h, wd in ((64, 64), (2, 2), (3, 9))
            for c in (1, 2, 57, 64)
            for kh, kw in ((3, 3), (2, 5))
            for m in (4, 100, 1024, 1025)
            for pool in ((2, 2), (3, 3), (2, 2, 2))]
    grid.append(((8, 16, 16, 4, 1), (3, 3, 3, 1, 10), (2, 2, 2)))   # a 3-D tower
    for x_shape, w_shape, pool in grid:
        assert fused_conv.supported(x_shape, w_shape, pool) == \
            jax_fused.supported(x_shape, w_shape, pool), (x_shape, w_shape, pool)
    assert fused_conv.supported((8, 64, 64, 1), (3, 3, 1, 100), (2, 2))
    assert not fused_conv.supported((8, 64, 64, 64), (3, 3, 64, 100), (2, 2))


def test_a_cuda_tensor_never_takes_the_plain_version():
    """The Function picks by device: anything but a CPU tensor goes to the
    kernel wrapper, which raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    x = torch.zeros((1, 8, 8, 1), device="meta")
    w = torch.zeros((3, 3, 1, 4), device="meta")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        fused_conv.fused_conv1_pool_relu(x, w, torch.zeros(4, device="meta"), (2, 2))


# chip_smoke.py's CONV_SHAPES (name, N, H, W, C, kh, kw, M, pool) and the
# route K5 takes at each: the jet-ID block's shapes on the register route,
# the odd ones on the band route
CHIP_CONV_ROUTES = {
    "jetid train batch": "tiles", "jetid predict chunk": "tiles", "ragged batch": "tiles",
    "reference tower": "tiles", "5x16x16 10 maps": "tiles", "two channels pool 3": "bands",
    "pool 3 low pad": "bands", "130 maps": "bands", "pool 4": "bands",
    "odd 15x15 100 maps": "tiles", "one map": "tiles", "7 maps odd H": "tiles",
    "128 maps": "tiles", "jetid large batch": "tiles",
}


def test_route_choice_takes_each_chip_smoke_shape():
    import chip_smoke
    assert {shape[0] for shape in chip_smoke.CONV_SHAPES} == set(CHIP_CONV_ROUTES)
    for name, n, h, wd, c, kh, kw, m, pool in chip_smoke.CONV_SHAPES:
        assert fused_conv.supported((n, h, wd, c), (kh, kw, c, m), pool)
        assert fused_conv_cuda.route((n, h, wd, c), (kh, kw, c, m), pool) == \
            CHIP_CONV_ROUTES[name], name
    # the register route's edges: one more map, another pool, another kernel
    assert fused_conv_cuda.route((8, 16, 16, 1), (3, 3, 1, 128), (2, 2)) == "tiles"
    assert fused_conv_cuda.route((8, 16, 16, 1), (3, 3, 1, 129), (2, 2)) == "bands"
    assert fused_conv_cuda.route((8, 16, 16, 1), (3, 3, 1, 100), (3, 3)) == "bands"
    assert fused_conv_cuda.route((8, 16, 16, 1), (2, 3, 1, 100), (2, 2)) == "bands"


@pytest.mark.parametrize("name", sorted(CHIP_CONV_ROUTES))
def test_backward_route_choice_takes_each_chip_smoke_shape(name):
    """K6 takes K5's route at each chip_smoke.py shape; "bands" may be forced
    anywhere, "tiles" only where the register route takes the shape, and an
    unknown name is refused."""
    import chip_smoke
    n, h, wd, c, kh, kw, m, pool = next(s[1:] for s in chip_smoke.CONV_SHAPES if s[0] == name)
    x_shape, w_shape = (n, h, wd, c), (kh, kw, c, m)
    what = "conv_pool_relu_backward"
    assert fused_conv_cuda.pick_route(what, x_shape, w_shape, pool) == CHIP_CONV_ROUTES[name]
    assert fused_conv_cuda.pick_route(what, x_shape, w_shape, pool, "bands") == "bands"
    if CHIP_CONV_ROUTES[name] == "tiles":
        assert fused_conv_cuda.pick_route(what, x_shape, w_shape, pool, "tiles") == "tiles"
    else:
        with pytest.raises(ValueError, match=f"{what}: the register route takes"):
            fused_conv_cuda.pick_route(what, x_shape, w_shape, pool, "tiles")
    with pytest.raises(ValueError, match="force_route must be one of"):
        fused_conv_cuda.pick_route(what, x_shape, w_shape, pool, "fast")


@pytest.mark.parametrize("force_route", [None, "tiles", "bands", "fast"])
def test_cuda_wrappers_refuse_cpu_tensors_before_launching(force_route):
    """Whatever route is asked for, K5's and K6's wrappers refuse a CPU
    tensor before anything is built or launched."""
    x, w, b = torch.zeros((2, 16, 16, 1)), torch.zeros((3, 3, 1, 8)), torch.zeros(8)
    counts = lambda: dict(fused_conv_cuda.launches)
    before = counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_conv_cuda.conv_pool_relu(x, w, b, (2, 2), force_route=force_route)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_conv_cuda.conv_pool_relu_backward(x, w, b, torch.zeros((2, 7, 7, 8)), (2, 2),
                                                force_route=force_route)
    assert counts() == before == dict.fromkeys(before, 0)
    assert not fused_conv_cuda._backward_entries.cache_info().currsize


# bfloat16: the plain versions follow K5/K6's rounding points, as the Pallas
# kernel does (f32 accumulation, one rounding of the output; f32 sums of dW
# and db cast back to the parameters' dtype).  Each output is the Pallas
# kernel's or one bf16 ulp from it (both round one float32 value, summed in
# other orders), or within FWD_TOL where the ReLU's input is 0 to float32
# rounding; dW and db within one bf16 ulp of the kernel's plus GRAD_TOL of the
# leaf's largest value.  Against the XLA chain, which rounds after the conv
# and after the bias: rtol/atol 1e-2, tests/test_fused_conv.py's bf16 bar.
# The cases the card adds for K5/K6's bf16 mma tiles, on small images (JAX
# compiles the interpreted kernel once a shape, about 2 s here at these
# sizes and three times that at 16x16): odd Hc and Wc (the SAME pool's high
# pad) with M = 7, M = 1, and M = 128, the register route's limit.
BF16_SHAPES = SHAPES[:2] + [
    (3, 5, 7, 1, 3, 3, 7, (2, 2)),
    (3, 6, 4, 1, 3, 3, 1, (2, 2)),
    (2, 4, 6, 1, 3, 3, 128, (2, 2)),
]
BF16_CHAIN_TOL = 1e-2


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_plain_versions_match_the_pallas_kernel(rng, shape, sparse):
    pool = shape[-1]
    x, w, b = (np.asarray(a, jnp.bfloat16) for a in _inputs(rng, shape, sparse))
    tx, tw, tb = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in (x, w, b))
    tw.requires_grad_()
    tb.requires_grad_()
    out = fused_conv.fused_conv1_pool_relu(tx, tw, tb, pool)
    (out.float() ** 2).sum().backward()
    assert out.dtype == tw.grad.dtype == tb.grad.dtype == torch.bfloat16

    ref = jax_fused.fused_conv1_pool_relu(x, w, b, pool)
    assert ref.dtype == jnp.bfloat16
    ref_t = torch.from_numpy(np.asarray(ref, np.float32)).bfloat16()
    gap = (out.float() - ref_t.float()).abs()
    assert bool(((bf16_ulps_apart(out, ref_t) <= 1) | (gap <= FWD_TOL)).all()), float(gap.max())
    chain = np.asarray(_xla_chain(x, w, b, pool), np.float32)
    np.testing.assert_allclose(out.float().detach().numpy(), chain, rtol=BF16_CHAIN_TOL,
                               atol=BF16_CHAIN_TOL)

    loss = lambda w, b: jnp.sum(jax_fused.fused_conv1_pool_relu(x, w, b, pool)
                                .astype(jnp.float32) ** 2)
    for got, want in zip((tw.grad, tb.grad), jax.grad(loss, argnums=(0, 1))(w, b)):
        assert want.dtype == jnp.bfloat16
        want = torch.from_numpy(np.asarray(want, np.float32))
        bar = GRAD_TOL * float(want.abs().max()) + bf16_ulp(want)
        assert bool(((got.float() - want).abs() <= bar).all())


def test_bf16_float32_path_is_unchanged(rng):
    """float32 inputs take no cast: the plain forward is relu(pool(conv) + b)
    as it was, bit for bit."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(rng, SHAPES[0], True))
    want = torch.relu(fused_conv.maxpool_same(fused_conv.conv2d_valid(x, w), (2, 2)) + b)
    assert torch.equal(fused_conv.conv1_pool_relu_plain(x, w, b, (2, 2)), want)
