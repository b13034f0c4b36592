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
from relu_ties import single_flip_allowance

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
    # deeper than the fused body takes (9 hidden layers): the layer-wise route
    "deep_dx": ((12,) + (24,) * 9, (10,), True),
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
    # 128 wide: three 129 x 128 weight blocks (207 KB) and the tile do not
    # fit the fused body's CTA, which keeps every weight on chip
    ((128, 128, 128), (64, 64), "layers"),
    ((130, 33, 9), (5, 6), "layers"),                 # a layer wider than 128
    ((12, 80), (129,), "layers"),                     # heads wider than 128 together
    ((128,) * 9, (16, 16), "layers"),                 # fits no CTA: "too wide" before
    ((300, 256, 128, 64), (32, 32), "layers"),        # constituents encoder
    ((32, 64, 128, 256), (300,), "layers"),           # constituents decoder
    # deeper than FUSED_MAX_HIDDEN (8): the layer-wise route, narrow or mixed
    ((12,) + (64,) * 9, (10, 10), "layers"),
    ((12,) + (64,) * 12, (10, 10), "layers"),
    ((12,) + (64,) * 16, (10,), "layers"),
    ((300,) + (128,) * 9, (32, 32), "layers"),
    ((32,) + (64,) * 10 + (256,) * 2 + (64,) * 4, (300,), "layers"),
    ((2048, 512, 64), (32, 32), "layers"),            # wider than the old 1024 bound
    ((12,) + (16,) * 8, (10, 10), "fused"),           # 8 hidden layers: the fused body's bound
    ((12, 100), (60, 40), "fused"),                   # 750 blocks of 4 x 4: two a thread
])
@pytest.mark.parametrize("batch", [1, 10_000, 1_000_003])
def test_backward_route_follows_the_shape(dims, head_dims, route, batch):
    for want_dx in (False, True):
        plan = fused_vae.backward_plan(batch, dims, head_dims, want_dx)
        assert plan.route == route
        n_params = sum(k * n + n for k, n in zip(dims, dims[1:])) + \
            sum(dims[-1] * n + n for n in head_dims)
        if route == "fused":
            blocks = sum(-(-(k + 1) // 4) * -(-n // 4) for k, n in
                         zip(dims, dims[1:] + (sum(head_dims),)))
            assert plan.n_blocks == blocks
            assert plan.n_parts == min(-(-batch // fused_vae.FUSED_MIN_ROWS),
                                       fused_vae.FUSED_MAX_PARTS)
            assert plan.partial_floats == plan.n_parts * 16 * blocks and plan.act_floats == 0
            assert 16 * blocks >= n_params
            continue
        n_hidden = len(dims) - 1
        head_total = sum(head_dims)
        # row products: the recompute of each hidden layer, the heads'
        # gradient, the gradient through each hidden layer; each the tile K2
        # gives the same product
        products = list(zip(dims, dims[1:])) + [(head_total, dims[-1])] + \
            [(dims[i + 1], dims[i]) for i in range(n_hidden)]
        assert plan.row_tiles == tuple(fused_vae._forward_tile(batch, k, n) for k, n in products)
        # weight gradients: each hidden layer, then the heads together
        layers = list(zip(dims, dims[1:])) + [(dims[-1], head_total)]
        assert len(plan.splits) == n_hidden + 1
        for (tile, splits, rows), (m, n) in zip(plan.splits, layers):
            cols = fused_vae.FORWARD_TILE_COLS[tile]
            tiles = -(-m // fused_vae.ROW_TILE_ROWS) * -(-n // cols)
            assert splits * tiles <= fused_vae.CARD_SMS or splits == 1
            assert (splits - 1) * rows < batch <= splits * rows
            assert rows % fused_vae.ROW_STAGE_K == 0
            assert splits == 1 or rows >= fused_vae.SPLIT_MIN_ROWS
        assert plan.act_floats == sum(-(-batch * n // 4) * 4 for n in dims[1:])
        assert plan.chain_width == max(dims[1:-1], default=0)
        assert plan.partial_floats == sum(s * (m + 1) * n for (_, s, _), (m, n)
                                          in zip(plan.splits, layers) if s > 1)
        # the split weights: every recompute (with its column norms), the
        # heads' gradient where a hidden layer or dx follows, and every
        # hidden layer's but the input one's unless dx is wanted
        need = [True] * n_hidden + [n_hidden > 0 or want_dx] + \
            [i > 0 or want_dx for i in range(n_hidden)]
        cols = [fused_vae.FORWARD_TILE_COLS[t] for t in plan.row_tiles]
        assert plan.wsplit_floats == sum(
            fused_vae.split_floats(k, n, t) + (-(-n // c) * c if i < n_hidden else 0)
            for i, ((k, n), t, c, r) in enumerate(zip(products, plan.row_tiles, cols, need)) if r)


def test_backward_plan_takes_a_layer_past_the_old_grid_bound():
    """The layer-wise route's launches are persistent (a CTA an SM walking
    its tiles), so no layer is refused for its tiles: a 65,536 x 16,384
    layer, whose weight gradient has 65,536 CTA tiles of 128 x 128, more
    than CUDA's grid y took, is planned as one split written in place (no
    slices), its weights split twice (recompute and dx: 2 x 2 x 2^30 floats
    and the recompute's 16,384 column norms)."""
    for batch in (1000, 10_000):
        plan = fused_vae.backward_plan(batch, (65_536, 16_384), (8,), True)
        assert plan.route == "layers"
        # the heads' 16,384 x 8 gradient: 128 tiles, one split too
        assert plan.splits == ((0, 1, -(-batch // 32) * 32), (1, 1, -(-batch // 32) * 32))
        assert plan.partial_floats == 0
        assert plan.act_floats == batch * 16_384
        assert plan.wsplit_floats == 2 * (2 * 65_536 * 16_384) + 16_384 + \
            fused_vae.split_floats(8, 16_384, plan.row_tiles[1])
    # the layer alone, as the stack's head (no ReLU): one split, in place
    heads_only = fused_vae.backward_plan(1000, (65_536,), (16_384,), True)
    assert heads_only.splits == ((0, 1, 1024),) and heads_only.partial_floats == 0
    assert heads_only.wsplit_floats == 2 * 65_536 * 16_384 and heads_only.act_floats == 0
    # the widest input the data gives (255 constituents of 4 components):
    # 16 tiles of 128 x 128, 8 splits of the batch fill 128 of the 132 SMs
    assert fused_vae.backward_plan(10_000, (1020, 256), (8,), True).splits[0] == (0, 8, 1280)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        fused_vae.backward_plan(2 ** 31, (300, 256), (8,), True)


@pytest.mark.parametrize("batch", [1, 31, 32, 33, 255, 257, 10_000, 22_741, 1_000_003])
@pytest.mark.parametrize("m,n", [(300, 256), (256, 128), (128, 64), (64, 64), (32, 64),
                                 (64, 10), (765, 256), (2048, 512), (65_536, 16_384)])
def test_weight_gradient_split_covers_the_batch_in_whole_stages(batch, m, n):
    tile, splits, rows = fused_vae._dw_split(batch, m, n)
    cols = fused_vae.FORWARD_TILE_COLS[tile]
    # the column tile pads n least, on a tie the wider
    assert -(-n // cols) * cols == min(-(-n // c) * c for c in fused_vae.FORWARD_TILE_COLS)
    assert cols == 128 or -(-n // 128) * 128 > -(-n // 64) * 64
    tiles = -(-m // fused_vae.ROW_TILE_ROWS) * -(-n // cols)
    assert rows % fused_vae.ROW_STAGE_K == 0 and (splits - 1) * rows < batch <= splits * rows
    assert splits == 1 or (splits * tiles <= fused_vae.CARD_SMS and rows >= fused_vae.SPLIT_MIN_ROWS)
    # one split only where the tiles fill the card or the batch is short
    assert splits > 1 or tiles * 2 > fused_vae.CARD_SMS or batch < 2 * fused_vae.SPLIT_MIN_ROWS


def test_backward_scratch_at_a_million_rows():
    """What one K3 call allocates at 1,000,003 rows of the constituents-mode
    encoder: the hidden activations (1.8 GB, the one round trip through
    device memory the layer-wise route takes), the weight gradients' split
    slices and the split weights."""
    batch = 1_000_003
    plan = fused_vae.backward_plan(batch, (312, 256, 128, 64), (32, 32), False)
    assert plan.route == "layers"
    assert plan.act_floats == batch * 448   # each buffer a multiple of 4 floats already
    # 128 x 128 tiles where the product is wide enough, 128 x 64 for the last
    # layer and the heads (64 columns together); splits of whole stages that
    # fill the card's 132 SMs
    assert plan.splits == ((0, 22, 45_472), (0, 66, 15_168), (1, 132, 7584), (1, 132, 7584))
    assert plan.partial_floats == 22 * 313 * 256 + 66 * 257 * 128 + 132 * 129 * 64 + 132 * 65 * 64
    assert plan.row_tiles == (0, 0, 1, 1, 0, 0, 0)
    # recompute 312 -> 256, 256 -> 128 (128 wide), 128 -> 64 (64), each with
    # its column norms; the heads' 64 -> 64 and the hidden layers' but the
    # input one's (no dx)
    assert plan.wsplit_floats == (2 * 256 * 320 + 256) + (2 * 128 * 256 + 128) + \
        (2 * 64 * 128 + 64) + 2 * 64 * 64 + 2 * 256 * 128 + 2 * 128 * 64
    # a re-decided ReLU input's row is rebuilt through the layers below it:
    # two rows of the widest (256) for each CTA of 132 SMs
    assert plan.chain_width == 256
    assert plan.scratch_bytes == 4 * (448_001_344 + 5_572_864 + 336_320 + 132 * 2 * 256) \
        == 1_815_912_448
    # the canonical encoder keeps the fused body: 132 slices of its 375 blocks
    # of 4 x 4 (5,520 parameters)
    canonical = fused_vae.backward_plan(batch, (12, 80, 40, 20), (10, 10), False)
    assert canonical.route == "fused" and canonical.n_blocks == 375
    assert canonical.scratch_bytes == 4 * 132 * 16 * 375


@pytest.mark.parametrize("dims", [(300, 256, 128, 64), (13, 17, 9), (7,) + (24,) * 9])
def test_stack_recompute_runs_its_plain_version_on_cpu(rng, dims):
    """On a CPU tensor the recompute alone is its plain version: the hidden
    activations of stack_backward_plain's forward, each relu(a W + b)."""
    hidden, _ = _stack(rng, dims, (3,))
    x = rng.normal(size=(B, dims[0])).astype(np.float32)
    t = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in hidden]
    before = fused_vae.recompute_launches
    got = fused_vae.stack_recompute(torch.from_numpy(x), t)
    assert fused_vae.recompute_launches == before and len(got) == len(hidden)
    a = x.astype(np.float64)
    for act, (w, b) in zip(got, hidden):
        a = np.maximum(a @ w + b, 0.0)
        np.testing.assert_allclose(act.numpy(), a, **TOL)


def _flipped_backward(x, hidden, heads, grads, row, layer, unit):
    """stack_backward_plain in float64 with one hidden unit's ReLU mask
    flipped in one row: what another float32 order of that tie's sum gives."""
    d = lambda t: t.double()
    acts, masks = [d(x)], []
    for w, b in hidden:
        z = acts[-1] @ d(w) + d(b)
        masks.append((z > 0).double())
        acts.append(torch.relu(z))
    masks[layer][row, unit] = 1.0 - masks[layer][row, unit]
    acts[layer + 1][row, unit] = 0.0 if masks[layer][row, unit] == 0 else \
        (acts[layer][row] @ d(hidden[layer][0][:, unit]) + d(hidden[layer][1][unit]))
    n = len(hidden)
    dws, dbs = [None] * (n + len(heads)), [None] * (n + len(heads))
    g = sum(d(gk) @ d(w).T for gk, (w, _) in zip(grads, heads))
    for k, gk in enumerate(grads):
        dws[n + k], dbs[n + k] = acts[-1].T @ d(gk), d(gk).sum(dim=0)
    for i in range(n - 1, -1, -1):
        g = g * masks[i]
        dws[i], dbs[i] = acts[i].T @ g, g.sum(dim=0)
        g = g @ d(hidden[i][0]).T
    return dws, dbs, g


def _as_torch(hidden, heads):
    t = lambda pairs: [tuple(map(torch.from_numpy, p)) for p in pairs]
    return t(hidden), t(heads)


def _tie_at(x, hidden, row, layer, unit):
    """Moves x[row, 0] so that the ReLU input of ``unit`` at hidden ``layer``
    is 0 in float64 (bisection over [-8, 8]; False where it keeps its sign
    there), then rounds it to float32: a tie to float32 rounding."""
    d = lambda t: t.double()

    def z(v):
        a = d(x[row]).clone()
        a[0] = v
        for i in range(layer):
            a = torch.relu(a @ d(hidden[i][0]) + d(hidden[i][1]))
        return float(a @ d(hidden[layer][0][:, unit]) + d(hidden[layer][1][unit]))

    lo, hi = -8.0, 8.0
    if (z(lo) > 0) == (z(hi) > 0):
        return False
    lo_sign = z(lo) > 0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if (z(mid) > 0) == lo_sign else (lo, mid)
    x[row, 0] = (lo + hi) / 2
    return True


def test_single_flip_allowance_covers_a_flipped_tie(rng):
    """A first-layer ReLU input made 0 to float32 rounding (row 2, unit 1):
    the gradients with that unit's mask flipped stay within the allowance of
    the plain version's, and the allowance is 0 wherever the flip cannot
    reach (the other columns of dW_0 and db_0, the other rows of dW_1)."""
    hidden, heads = _as_torch(*_stack(rng, (6, 5, 4), (3,)))
    x = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=(9, 3)).astype(np.float32))]
    b0 = hidden[0][1].clone()
    b0[1] = -(x[2].double() @ hidden[0][0][:, 1].double()).float()
    hidden[0] = (hidden[0][0], b0)
    plain = fused_vae.stack_backward_plain(x, hidden, heads, grads, True)
    flipped = _flipped_backward(x, hidden, heads, grads, 2, 0, 1)
    dws, dbs, dx, n_ties = single_flip_allowance(x, hidden, heads, grads, True)
    assert n_ties == 1
    for got, want, allow in zip(flipped[0] + flipped[1] + [flipped[2]],
                                plain[0] + plain[1] + [plain[2]], dws + dbs + [dx]):
        assert bool(((got - want.double()).abs() <= allow + 1e-5 * float(want.abs().max())).all())
    assert bool(dws[0][:, 1].gt(0).all()) and dbs[0][1] > 0
    assert not dws[0][:, [0, 2, 3, 4]].any() and not dbs[0][[0, 2, 3, 4]].any()
    assert not dws[1][[0, 2, 3, 4]].any() and not dx[[0, 1, 3, 4, 5, 6, 7, 8]].any()


def test_single_flip_allowance_is_zero_without_ties(rng):
    hidden, heads = _as_torch(*_stack(rng, (12, 80, 40, 20), (10, 10)))
    x = torch.from_numpy(rng.normal(size=(50, 12)).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=(50, 10)).astype(np.float32)) for _ in range(2)]
    dws, dbs, dx, n_ties = single_flip_allowance(x, hidden, heads, grads, False)
    assert n_ties == 0 and dx is None and not any(a.any() for a in dws + dbs)


def test_single_flip_allowance_is_the_largest_flip_not_the_sum(rng):
    """Two ties of one unit, in rows 2 and 5: every element's allowance is
    the larger of the two flips' moves (each against the float64 plain
    version), not their sum."""
    hidden, heads = _as_torch(*_stack(rng, (6, 5, 4), (3,)))
    x = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=(9, 3)).astype(np.float32))]
    assert _tie_at(x, hidden, 2, 0, 1) and _tie_at(x, hidden, 5, 0, 1)
    d = lambda pairs: [(w.double(), b.double()) for w, b in pairs]
    plain = fused_vae.stack_backward_plain(x.double(), d(hidden), d(heads),
                                           [g.double() for g in grads], True)
    moves = [_flipped_backward(x, hidden, heads, grads, row, 0, 1) for row in (2, 5)]
    dws, dbs, dx, n_ties = single_flip_allowance(x, hidden, heads, grads, True)
    assert n_ties == 2
    for i, (want, allow) in enumerate(zip(plain[0] + plain[1] + [plain[2]], dws + dbs + [dx])):
        one, two = (((m[0] + m[1] + [m[2]])[i] - want).abs() for m in moves)
        torch.testing.assert_close(allow, torch.maximum(one, two), rtol=1e-9, atol=1e-15)
        both = (one > 1e-12) & (two > 1e-12)
        assert bool((allow[both] < (one + two)[both]).all())
        if i == 0:
            assert bool(both.any())   # dW_0's tied column: both flips reach it


def test_single_flip_allowance_does_not_cover_dropped_rows(rng):
    """40 ties at the top hidden layer of 2,000 rows (a top-layer flip moves
    every lower dW densely): a dW_0 that lacks its last 3% of rows still
    fails the card tests' check, its bar (3e-4 of the leaf's largest value)
    plus the allowance."""
    hidden, heads = _as_torch(*_stack(rng, (6, 8, 5), (3,)))
    batch = 2000
    x = torch.from_numpy(rng.normal(size=(batch, 6)).astype(np.float32))
    grads = [torch.from_numpy((rng.normal(size=(batch, 3)) / batch).astype(np.float32))]
    for unit in range(5):   # the first top-layer unit that crosses 0 in 40 rows
        trial, tied = x.clone(), 0
        for row in range(batch):
            tied += _tie_at(trial, hidden, row, 1, unit)
            if tied == 40:
                break
        if tied == 40:
            break
    x = trial
    dws, _, _, n_ties = single_flip_allowance(x, hidden, heads, grads, False)
    assert tied == 40 and n_ties >= 40
    plain = fused_vae.stack_backward_plain(x, hidden, heads, grads, False)[0][0]
    cut = [g.clone() for g in grads]
    cut[0][batch - batch * 3 // 100:] = 0
    faulty = fused_vae.stack_backward_plain(x, hidden, heads, cut, False)[0][0]
    bar = 3e-4 * float(plain.abs().max())
    assert bool(((faulty - plain).abs().double() > dws[0] + bar).any())


def test_fused_layout_of_the_canonical_stacks():
    """The fused body's layout (plan_fused_bwd), counted by hand: the
    encoder's weights 16 x 84 + 84 x 44 + 44 x 20 + 20 x 20 floats, a tile
    row 16 + 84 + 44 + 24 (activations and ones columns) + 20 (heads) + 20 +
    40 + 80 (hidden gradients); the decoder with dx adds its 12-float stage."""
    enc = (16 * 84 + 84 * 44 + 44 * 20 + 20 * 20 + 128 * (168 + 20 + 140)) * 4
    assert fused_vae._fused_layout((12, 80, 40, 20), (10, 10), False) == (375, enc)
    dec = (12 * 20 + 24 * 44 + 44 * 84 + 80 * 12
           + 128 * (12 + 24 + 44 + 84 + 12 + 140 + 12)) * 4
    assert fused_vae._fused_layout((10, 20, 40, 80), (12,), True) == (358, dec)


@pytest.mark.parametrize("want_dx", [False, True])
def test_fused_route_at_the_envelope_edge(want_dx):
    """The widest 3-hidden-layer stack of equal widths that the fused body
    takes stays on it, and one column more takes the layer-wise route: the
    route follows the C plan's shared memory and block bounds exactly."""
    def route(w):
        return fused_vae.backward_plan(10_000, (12, w, w, w), (w // 2, w - w // 2), want_dx).route
    widest = max(w for w in range(8, 129) if route(w) == "fused")
    assert widest < 128 and route(widest + 1) == "layers"
    dims, heads = (12, widest, widest, widest), (widest // 2, widest - widest // 2)
    blocks, smem = fused_vae._fused_layout(dims, heads, want_dx)
    assert blocks <= fused_vae.FUSED_MAX_BLOCKS and smem <= fused_vae.MAX_SMEM
    w = widest + 1
    blocks, smem = fused_vae._fused_layout((12, w, w, w), (w // 2, w - w // 2), want_dx)
    assert blocks > fused_vae.FUSED_MAX_BLOCKS or smem > fused_vae.MAX_SMEM
