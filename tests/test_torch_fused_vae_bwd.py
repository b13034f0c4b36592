"""Port K3 (atlasvae_torch.ops.fused_vae.stack_backward) and the autograd
Functions around K2/K3 against the JAX package.

On the CPU the port runs the kernels' plain versions; the JAX side runs
``_stack_bwd`` and the ``fused_encoder``/``fused_decoder`` custom VJPs with
their Pallas kernels in interpret mode.  Inputs come from a numpy seed; the
head gradients have the scale of a mean loss's (N(0, 1) / B).  Tolerance:
atol 1e-5, rtol 1e-5 -- float32 sums over 300 rows taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae.ops import fused_vae as jax_fused_vae
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.ops import fused_vae

TOL = dict(atol=1e-5, rtol=1e-5)
B = 300

STACKS = {
    "encoder": ((12, 80, 40, 20), (10, 10), False),   # canonical encoder
    "decoder": ((10, 20, 40, 80), (12,), True),        # canonical decoder, dz
    "odd": ((13, 17, 9), (5, 5), False),               # odd widths
    "odd_dx": ((13, 17, 9), (5, 5), True),
    "heads_only": ((7,), (3,), True),
    # constituents mode (100 constituents x (px, py, pz)): the layer-wise route
    "const_encoder": ((300, 256, 128, 64), (32, 32), False),
    "const_decoder": ((32, 64, 128, 256), (300,), True),
}


def _stack(rng, dims, head_dims):
    def pair(k, n):
        return ((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))
    hidden = [pair(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    return hidden, [pair(dims[-1], n) for n in head_dims]


@pytest.mark.parametrize("case", sorted(STACKS))
def test_stack_backward_plain_matches_jax(rng, case):
    dims, head_dims, want_dx = STACKS[case]
    hidden, heads = _stack(rng, dims, head_dims)
    x = rng.normal(size=(B, dims[0])).astype(np.float32)
    grads = [(rng.normal(size=(B, n)) / B).astype(np.float32) for n in head_dims]
    j = lambda pairs: [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs]
    want_dw, want_db, want_dx_ = jax_fused_vae._stack_bwd(
        jnp.asarray(x), j(hidden), j(heads), [jnp.asarray(g) for g in grads], want_dx)
    t = lambda pairs: [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in pairs]
    before = fused_vae.backward_launches
    dws, dbs, dx = fused_vae.stack_backward(torch.from_numpy(x), t(hidden), t(heads),
                                            [torch.from_numpy(g) for g in grads], want_dx)
    assert fused_vae.backward_launches == before
    assert len(dws) == len(dbs) == len(hidden) + len(heads)
    for got, want in zip(dws + dbs, list(want_dw) + list(want_db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if want_dx:
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx_), **TOL)
    else:
        assert dx is None and want_dx_ is None


@pytest.fixture(scope="module")
def model():
    params = jax_init_vae(jax.random.PRNGKey(9), JaxVAEConfig())
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _torch_leaves(tree):
    from atlasvae_torch.train.checkpoint import tree_flatten
    return tree_flatten(tree)


def test_fused_encoder_gradients_match_jax(rng, model):
    jparams, params = model
    x = rng.normal(size=(B, 12)).astype(np.float32)
    cot = [(rng.normal(size=(B, 10)) / B).astype(np.float32) for _ in range(2)]
    outs, vjp = jax.vjp(jax_fused_vae.fused_encoder, jparams["encoder"], jnp.asarray(x))
    want_params, want_x = vjp(tuple(jnp.asarray(c) for c in cot))
    enc = params["encoder"]
    leaves = _torch_leaves(enc)
    for leaf in leaves:
        leaf.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    mean, logvar = fused_vae.fused_encoder(enc, xt)
    for got, want in zip((mean, logvar), outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got = torch.autograd.grad((mean, logvar), leaves + [xt],
                              [torch.from_numpy(c) for c in cot])
    for g, w in zip(got[:-1], _leaves(want_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the encoder's input gets a zero cotangent, as the JAX custom VJP gives
    assert not np.asarray(want_x).any()
    assert not got[-1].any()


def test_fused_decoder_gradients_match_jax(rng, model):
    jparams, params = model
    z = rng.normal(size=(B, 10)).astype(np.float32)
    cot = (rng.normal(size=(B, 12)) / B).astype(np.float32)
    out, vjp = jax.vjp(jax_fused_vae.fused_decoder, jparams["decoder"], jnp.asarray(z))
    want_params, want_z = vjp(jnp.asarray(cot))
    dec = params["decoder"]
    leaves = _torch_leaves(dec)
    for leaf in leaves:
        leaf.requires_grad_()
    zt = torch.from_numpy(z).requires_grad_()
    recon = fused_vae.fused_decoder(dec, zt)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(out), **TOL)
    got = torch.autograd.grad(recon, leaves + [zt], torch.from_numpy(cot))
    for g, w in zip(got[:-1], _leaves(want_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want_z), **TOL)


def test_direct_stack_forward_with_grad_still_refused():
    x = torch.zeros(3, 4, requires_grad=True)
    hidden = [(torch.zeros(4, 2), torch.zeros(2))]
    heads = [(torch.zeros(2, 1), torch.zeros(1))]
    from atlasvae_torch.ops import cuda_build
    with pytest.raises(NotImplementedError, match="records no gradient"):
        cuda_build.check_stack(x, hidden, heads, "stack_forward")
    # inside the autograd Function the same tensors pass: grad mode is off there
    out = fused_vae.FusedDecoder.apply(x, hidden[0][0], hidden[0][1], heads[0][0], heads[0][1])
    assert out.shape == (3, 1) and out.requires_grad


def test_stack_backward_runs_plain_version_on_cpu():
    # a CPU tensor goes to the plain twin; the argument checks of the CUDA
    # branch are held in tests/test_torch_cuda_kernels.py
    x = torch.zeros(4, 3)
    hidden, heads = [], [(torch.zeros(3, 2), torch.zeros(2))]
    dws, dbs, dx = fused_vae.stack_backward(x, hidden, heads, [torch.ones(4, 2)], True)
    assert dws[0].shape == (3, 2) and dbs[0].tolist() == [4.0, 4.0]
    assert dx.shape == (4, 3) and not dx.any()


@pytest.mark.parametrize("dims,head_dims,route", [
    ((12, 80, 40, 20), (10, 10), "fused"),            # canonical encoder
    ((10, 20, 40, 80), (12,), "fused"),               # canonical decoder
    ((5,), (3,), "fused"),
    ((128, 128, 128), (64, 64), "fused"),             # 128 wide and the tile fits
    ((130, 33, 9), (5, 6), "layers"),                 # a layer wider than 128
    ((12, 80), (129,), "layers"),                     # heads wider than 128 together
    ((128,) * 9, (16, 16), "layers"),                 # fits no CTA: "too wide" before
    ((300, 256, 128, 64), (32, 32), "layers"),        # constituents encoder
    ((32, 64, 128, 256), (300,), "layers"),           # constituents decoder
])
@pytest.mark.parametrize("batch", [1, 10_000, 1_000_003])
def test_backward_route_follows_the_shape(dims, head_dims, route, batch):
    for want_dx in (False, True):
        plan = fused_vae.backward_plan(batch, dims, head_dims, want_dx)
        assert plan.route == route
        n_params = sum(k * n + n for k, n in zip(dims, dims[1:])) + \
            sum(dims[-1] * n + n for n in head_dims)
        if route == "fused":
            assert plan.n_parts == min(-(-batch // fused_vae.FUSED_ROWS), fused_vae.FUSED_MAX_PARTS)
            assert plan.partial_floats == plan.n_parts * n_params and plan.act_floats == 0
            continue
        n_hidden = len(dims) - 1
        assert len(plan.row_tiles) == 2 * n_hidden + 1
        assert len(plan.splits) == n_hidden + len(head_dims)
        assert plan.act_floats == batch * sum(dims[1:])
        layers = list(zip(dims, dims[1:])) + [(dims[-1], n) for n in head_dims]
        for (tile, splits, rows), (k, n) in zip(plan.splits, layers):
            bm, bn = fused_vae.GEMM_TILES[tile]
            assert splits * -(-k // bm) * -(-n // bn) <= fused_vae.SPLIT_CTAS or splits == 1
            assert (splits - 1) * rows < batch <= splits * rows and rows % fused_vae.GEMM_CHUNK == 0
        assert plan.partial_floats == sum(s * (k * n + n)
                                          for (_, s, _), (k, n) in zip(plan.splits, layers))


def test_backward_scratch_at_a_million_rows():
    """What one K3 call allocates at 1,000,003 rows of the constituents-mode
    encoder: the hidden activations (1.8 GB, the one round trip through
    device memory the layer-wise route takes) and the split slices."""
    batch = 1_000_003
    plan = fused_vae.backward_plan(batch, (312, 256, 128, 64), (32, 32), False)
    assert plan.route == "layers"
    assert plan.act_floats == batch * 448
    # 128 x 128 tiles where the product is wide enough, 64 x 64 for the heads
    assert plan.splits == ((0, 44, 22728), (0, 132, 7576), (1, 264, 3792), (4, 264, 3792),
                           (4, 264, 3792))
    assert plan.partial_floats == 44 * 80_128 + 132 * 32_896 + 264 * 8_256 + 2 * 264 * 2_080
    assert plan.scratch_bytes == 4 * (448_001_344 + plan.partial_floats) == 1_836_588_288
    # the canonical encoder keeps the fused body: 264 slices of its parameters
    canonical = fused_vae.backward_plan(batch, (12, 80, 40, 20), (10, 10), False)
    assert canonical.route == "fused" and canonical.scratch_bytes == 4 * 264 * 5_520
