"""Port K2 (atlasvae_torch.ops.fused_vae) against the JAX encoder.

On the CPU the port runs the kernel's plain version; the JAX side runs
``encode(impl="pallas")`` (Pallas interpret mode) and ``impl="xla"``.
Tolerance atol 1e-5, as tests/test_fused_vae.py holds the Pallas encoder.
The wrapper's argument checks are plain Python and run here too.
"""

import jax
import numpy as np
import pytest
import torch

from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae, encode
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.ops import cuda_build, fused_vae

ATOL = 1e-5


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("fc_layers,input_dim", [((80, 40, 20, 10), 12),   # canonical
                                                 ((32, 16, 8), 40)])        # narrow wide-input
def test_encoder_plain_matches_jax(rng, impl, fc_layers, input_dim):
    params = jax_init_vae(jax.random.PRNGKey(5), JaxVAEConfig(fc_layers, input_dim))
    x = rng.normal(size=(300, input_dim)).astype(np.float32)
    want_mean, want_logvar = encode(params, x, impl=impl)
    ported = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    before = fused_vae.launches
    mean, logvar = fused_vae.fused_encoder(ported["encoder"], torch.from_numpy(x))
    assert fused_vae.launches == before
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(want_logvar), atol=ATOL)


def test_stack_forward_heads_only_and_three_heads(rng):
    x = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))
    heads = [(torch.randn(5, n), torch.randn(n)) for n in (1, 2, 3)]
    outs = fused_vae.stack_forward(x, [], heads)
    for out, (w, b) in zip(outs, heads):
        torch.testing.assert_close(out, x @ w + b, atol=0, rtol=0)


def _stack(dims, heads):
    hidden = [(torch.zeros(dims[i], dims[i + 1]), torch.zeros(dims[i + 1]))
              for i in range(len(dims) - 1)]
    return hidden, [(torch.zeros(dims[-1], n), torch.zeros(n)) for n in heads]


def test_check_stack_accepts_kernel_shapes():
    hidden, heads = _stack((312, 256, 128, 64), (32, 32))
    cuda_build.check_stack(torch.zeros(3, 312), hidden, heads, "k")


@pytest.mark.parametrize("dims", [(12,) + (64,) * 9,          # 9 hidden layers
                                  (12,) + (64,) * 16,         # 16
                                  (1025, 256, 64),            # wider than 1024
                                  (32, 2048, 128)])
def test_check_stack_accepts_any_depth_and_width(dims):
    """No depth or width bound reaches a caller: K1-K3 cut a deep or wide
    stack into what their kernels take (forward_plan, backward_plan)."""
    hidden, heads = _stack(dims, (8, 8))
    cuda_build.check_stack(torch.zeros(3, dims[0]), hidden, heads, "stack_forward")


@pytest.mark.parametrize("case,error", [
    ("width", ValueError), ("head", ValueError), ("dtype", ValueError),
    ("layout", ValueError), ("heads", ValueError),
    ("grad", NotImplementedError),
])
def test_check_stack_rejects(case, error):
    hidden, heads = _stack((12, 8, 4), (2,))
    x = torch.zeros(3, 12)
    if case == "width":
        x = torch.zeros(3, 11)
    elif case == "head":
        heads = [(torch.zeros(5, 2), torch.zeros(2))]
    elif case == "dtype":
        x = x.double()
    elif case == "layout":
        x = torch.zeros(12, 3).t()
    elif case == "heads":
        heads = heads * (cuda_build.MAX_HEADS + 1)
    elif case == "grad":
        x.requires_grad_()
    with pytest.raises(error):
        cuda_build.check_stack(x, hidden, heads, "stack_forward")


# K1/K2's route: forward_plan cuts a stack into fused segments (runs of
# layers no wider than 128, the heads counted as one layer of their summed
# width, as many as fit one CTA of the fused body) and row segments (one
# wider layer each)
F, R = fused_vae.FUSED_SEGMENT, fused_vae.ROW_SEGMENT


@pytest.mark.parametrize("dims,head_dims,segments", [
    ((12, 80, 40, 20), (10, 10), [(F, 0, 4)]),               # canonical encoder
    ((10, 20, 40, 80), (12,), [(F, 0, 4)]),                  # canonical decoder
    ((5,), (3,), [(F, 0, 1)]),                               # heads only
    # 128 wide: each 128 x 128 layer's fragments take 128 KB of a CTA's 227
    ((128, 128, 128), (64, 64), [(F, 0, 1), (F, 1, 2), (F, 2, 3)]),
    ((128, 64), (32, 32), [(F, 0, 2)]),                      # the constituents encoder's tail
    ((32, 64), (128,), [(F, 0, 2)]),                         # the constituents decoder's head
    ((1, 13, 33, 127), (128,), [(F, 0, 3), (F, 3, 4)]),      # odd widths; 128 x 128 heads apart
    ((300, 256, 128, 64), (32, 32), [(R, 0, 1), (R, 1, 2), (F, 2, 4)]),   # constituents encoder
    ((312, 256, 128, 64), (32, 32), [(R, 0, 1), (R, 1, 2), (F, 2, 4)]),
    ((32, 64, 128, 256), (300,), [(F, 0, 2), (R, 2, 3), (R, 3, 4)]),      # constituents decoder
    ((32, 64, 128, 256), (312,), [(F, 0, 2), (R, 2, 3), (R, 3, 4)]),
    ((129, 64), (8,), [(R, 0, 1), (F, 1, 2)]),
    ((130, 33, 9), (5, 6), [(R, 0, 1), (F, 1, 3)]),
    ((301, 130, 33), (5, 5), [(R, 0, 1), (R, 1, 2), (F, 2, 3)]),
    ((32, 313), (5,), [(R, 0, 1), (R, 1, 2)]),
    ((12, 80), (100, 29), [(F, 0, 1), (R, 1, 2)]),           # heads wider than 128 together
    ((200,), (3,), [(R, 0, 1)]),
    # deeper than one fused launch takes: at most FUSED_MAX_HIDDEN = 8 hidden
    # layers and the layer after them, and no more than fit a CTA (four 64 x 64
    # layers, the 12 x 64 one and a 64-wide head: 209,152 bytes)
    ((12,) + (32,) * 8, (10, 10), [(F, 0, 9)]),                          # 8: one launch
    ((12,) + (32,) * 9, (10, 10), [(F, 0, 9), (F, 9, 10)]),              # 9
    ((12,) + (64,) * 8, (10, 10), [(F, 0, 5), (F, 5, 9)]),
    ((12,) + (64,) * 9, (10, 10), [(F, 0, 5), (F, 5, 10)]),
    ((12,) + (64,) * 12, (10, 10), [(F, 0, 5), (F, 5, 9), (F, 9, 13)]),  # 12
    ((12,) + (64,) * 16, (10, 10),                                      # 16
     [(F, 0, 5), (F, 5, 9), (F, 9, 13), (F, 13, 17)]),
    ((12,) + (64,) * 17, (10,), [(F, 0, 5), (F, 5, 9), (F, 9, 13), (F, 13, 18)]),
    ((12,) + (64,) * 18, (10,),
     [(F, 0, 5), (F, 5, 9), (F, 9, 13), (F, 13, 17), (F, 17, 19)]),
    ((300,) + (128,) * 9, (32, 32),                                      # mixed, 9
     [(R, 0, 1)] + [(F, l, l + 1) for l in range(1, 10)]),
    ((300,) + (128,) * 12, (32, 32),                                     # mixed, 12
     [(R, 0, 1)] + [(F, l, l + 1) for l in range(1, 13)]),
    ((32,) + (64,) * 10 + (256,) * 2 + (64,) * 4, (300,),                # mixed, 16
     [(F, 0, 5), (F, 5, 9), (F, 9, 10), (R, 10, 11), (R, 11, 12), (R, 12, 13), (F, 13, 16),
      (R, 16, 17)]),
])
@pytest.mark.parametrize("batch", [1, 10_000, 1_000_003])
def test_forward_plan_follows_the_shape(dims, head_dims, segments, batch):
    plan = fused_vae.forward_plan(batch, dims, head_dims)
    assert [(s.kind, s.first, s.last) for s in plan.segments] == segments
    assert plan.route == ("fused" if segments == [(F, 0, len(dims))] else "layers")
    widths = dims + (sum(head_dims),)
    # every layer once and in order; each segment's widths on its side of 128
    assert plan.segments[0].first == 0 and plan.segments[-1].last == len(dims)
    assert all(a.last == b.first for a, b in zip(plan.segments, plan.segments[1:]))
    need, wsplit = [0, 0], 0
    for i, seg in enumerate(plan.segments):
        span = widths[seg.first:seg.last + 1]
        if seg.kind == F:
            assert max(span) <= fused_vae.FUSED_MAX_WIDTH
            # at most FUSED_MAX_HIDDEN hidden layers and their head a launch,
            # as many as fit a CTA: one layer more would not, where the run
            # of narrow layers goes on
            assert seg.last - seg.first - 1 <= fused_vae.FUSED_MAX_HIDDEN
            heads = tuple(head_dims) if seg.last == len(dims) else (widths[seg.last],)
            assert fused_vae.forward_smem(span[:-1], heads) is not None
            more = widths[seg.first:seg.last + 2]
            if seg.last < len(dims) and max(more) <= fused_vae.FUSED_MAX_WIDTH:
                heads = tuple(head_dims) if seg.last + 1 == len(dims) else (more[-1],)
                assert fused_vae.forward_smem(more[:-1], heads) is None
        else:
            assert seg.last == seg.first + 1 and max(span) > fused_vae.FUSED_MAX_WIDTH
            assert seg.tile == fused_vae._forward_tile(batch, widths[seg.first], widths[seg.last])
            wsplit += fused_vae.split_floats(widths[seg.first], widths[seg.last], seg.tile)
        # ping-pong: each segment but the last writes the other buffer
        if seg is plan.segments[-1]:
            assert seg.out == -1
        else:
            assert seg.out == i % 2
            need[seg.out] = max(need[seg.out], batch * widths[seg.last])
    assert all(f >= n and f % 4 == 0 and f - n < 4 for f, n in zip(plan.buf_floats, need))
    # the row segments' split weights follow the buffers in the same allocation
    assert plan.wsplit_floats == wsplit
    assert plan.scratch_bytes == 4 * (sum(plan.buf_floats) + plan.wsplit_floats)


@pytest.mark.parametrize("dims,head_dims,smem", [
    # the canonical encoder: B fragments (2x10 + 10x5 + 5x3 + 3x3 tiles of
    # 128 floats) 12,032 floats and bias 168, then eight warps' x (16 x 12)
    # and stage (16 x 20), 4,096 floats, over which every layer's W (5,360
    # floats) is staged at the start: 17,560 floats
    ((12, 80, 40, 20), (10, 10), 70_240),
    ((10, 20, 40, 80), (12,), 67_872),                   # the canonical decoder
    ((128, 64), (32, 32), 197_120),                      # the constituents encoder's tail
    ((32, 64), (128,), 164_608),                         # its decoder's head
    ((128,), (128,), 197_120),                           # the widest layer: 4 warps' buffers
    ((5,), (3,), 4_640),
    ((3, 1, 7), (2, 2, 2, 2), 7_264),                    # leaves of 3, 7 and 8 floats
    ((12,) + (20,) * 8, (20,), 57_184),                  # 8 hidden layers
    ((12,) + (64,) * 4, (64,), 209_152),                 # the most 64 x 64 layers that fit
    ((12,) + (64,) * 5, (64,), None),                    # 258,560 bytes: too much
    ((128, 128), (64, 64), None),                        # two 128 x 128 layers' fragments
    ((12,) + (20,) * 9, (20,), None),                    # 9 hidden layers
    ((129, 64), (8,), None),                             # wider than 128
    ((12, 80), (100, 29), None),
])
def test_forward_smem_mirrors_the_plan(dims, head_dims, smem):
    """forward_smem mirrors csrc/dense_stack.cuh::plan_dense_stack: a CTA's
    shared memory, or None where the fused body does not take the stack."""
    assert fused_vae.forward_smem(dims, head_dims) == smem


def _canonical_grid(batch, sms=132):
    """The fused body's persistent grid for the canonical encoder on an H100
    (launch_dense_stack): CTAs of eight warps, a 16-row block each, as many
    as the rows need, at most ctas_per_sm on each SM: the smaller of what
    an SM's 233,472 bytes hold (1 KB reserved a CTA) and what the T = 10
    instance's registers allow (stack_ctas: 2)."""
    ctas_per_sm = min(233_472 // (fused_vae.forward_smem((12, 80, 40, 20), (10, 10)) + 1024), 2)
    return min(-(-(-(-batch // 16)) // 8), ctas_per_sm * sms)


@pytest.mark.parametrize("batch,grid", [(1, 1), (32, 1), (128, 1), (129, 2), (10_000, 79),
                                        (33_792, 264), (65_536, 264), (1_000_003, 264)])
def test_fused_grid_is_persistent(batch, grid):
    """The canonical encoder's grid: a CTA of eight warps a 16-row block each
    (10,000 rows: 625 blocks, 79 CTAs), at most two CTAs on each of 132 SMs."""
    assert _canonical_grid(batch) == grid


# a row segment's column tile (csrc/gemm_wgmma.cuh: 128 rows a CTA, one CTA
# an SM): the widths of the tile's first cases at the scoring chunk, k = 300
@pytest.mark.parametrize("batch,k,n,cols", [
    (65_536, 300, 312, 128), (65_536, 300, 300, 128), (65_536, 300, 256, 128),
    (65_536, 300, 128, 128), (65_536, 300, 201, 128), (65_536, 300, 130, 64),
    (65_536, 300, 64, 64), (65_536, 300, 33, 64), (65_536, 300, 32, 64), (65_536, 300, 10, 64),
    # one CTA either way: the narrower tile
    (1, 300, 256, 64), (7, 765, 312, 64),
])
def test_forward_tile_pads_least(batch, k, n, cols):
    """A row segment's column tile costs least in whole rounds of tiles: at
    65,536 rows (512 row tiles, 3.9 rounds a 128-wide column tile) 312 and
    300 columns take three 128-wide tiles, 130 columns (one 128-wide tile
    and 2 columns) three 64-wide ones; at a tile's rows the narrower tile."""
    assert fused_vae.FORWARD_TILE_COLS[fused_vae._forward_tile(batch, k, n)] == cols


def _waves(batch, n, cols):
    return -(-(-(-batch // fused_vae.ROW_TILE_ROWS) * -(-n // cols)) // fused_vae.CARD_SMS)


@pytest.mark.parametrize("batch,k,n,cols,waves", [
    # const_train and etl (10,000 rows): 300 -> 256 takes 316 tiles of 64
    # columns, 2.4 rounds of 132 (128 columns: 158 tiles, 1.2 rounds of twice
    # the work), 256 -> 128 one round of 79 tiles; the decoder's 128 -> 256
    # (4 stages) 158 tiles of 128 columns, its 256 -> 300 395 of 64
    (10_000, 300, 256, 64, 3), (10_000, 256, 128, 128, 1),
    (10_000, 128, 256, 128, 2), (10_000, 256, 300, 64, 3),
    (10_000, 1200, 256, 64, 3),                          # const_1200
    # emd_slice (65,536 rows) at 100 and 255 constituents
    (65_536, 300, 256, 128, 8), (65_536, 765, 256, 128, 8), (65_536, 256, 128, 128, 4),
    (65_536, 128, 256, 128, 8), (65_536, 256, 300, 128, 12), (65_536, 256, 765, 128, 24),
    # 1,000,003 rows
    (1_000_003, 312, 256, 128, 119), (1_000_003, 256, 128, 128, 60),
    (1_000_003, 256, 312, 128, 178),
])
def test_forward_tile_at_the_main_path_batches(batch, k, n, cols, waves):
    """The column tile, and the rounds of 132 tiles (one persistent CTA an
    SM) it takes, at the three batch sizes the main paths run."""
    assert fused_vae.FORWARD_TILE_COLS[fused_vae._forward_tile(batch, k, n)] == cols
    assert _waves(batch, n, cols) == waves


@pytest.mark.parametrize("k,n,cols,floats", [
    (765, 256, 128, 393_216),        # emd_slice255's input layer: 1.57 MB, k padded to 768
    (300, 256, 64, 163_840),         # const_train's: k padded to 320
    (256, 765, 128, 393_216),        # the 765-wide head: n padded to 768
    (1200, 256, 64, 622_592),
    (2048, 512, 64, 2_097_152),
    (1, 1, 64, 4_096),               # one stage of one 64-wide tile
    (33, 129, 128, 32_768),
])
def test_forward_split_weight_floats(k, n, cols, floats):
    """The scratch of a row product's split weights: hi and lo TF32 words of
    W^T, n rounded up to whole column tiles, k to whole 32-deep stages."""
    tile = fused_vae.FORWARD_TILE_COLS.index(cols)
    assert fused_vae.split_floats(k, n, tile) == floats
    assert floats == 2 * -(-n // cols) * cols * -(-k // 32) * 32


def test_forward_scratch_at_a_million_rows():
    """What one K2/K1 call allocates at 1,000,003 rows of the constituents
    stacks: the two hidden activations that pass through device memory
    (1.5 GB) and the wide layers' split weights; the canonical stacks
    allocate nothing."""
    batch = 1_000_003
    enc = fused_vae.forward_plan(batch, (312, 256, 128, 64), (32, 32))
    assert enc.buf_floats == (256_000_768, 128_000_384)
    # 312 -> 256: 2 x 256 x 320; 256 -> 128: 2 x 128 x 256
    assert enc.wsplit_floats == 163_840 + 65_536
    assert enc.scratch_bytes == 1_536_922_112
    dec = fused_vae.forward_plan(batch, (32, 64, 128, 256), (312,))
    assert dec.buf_floats == (128_000_384, 256_000_768)
    # 128 -> 256: 2 x 256 x 128; 256 -> 312: 2 x 384 x 256
    assert dec.wsplit_floats == 65_536 + 196_608
    assert fused_vae.forward_plan(batch, (12, 80, 40, 20), (10, 10)).scratch_bytes == 0


@pytest.mark.parametrize("batch,dims,head_dims,floats", [
    (10_000, (300, 256, 128, 64), (32, 32), 163_840 + 65_536),      # const_train, etl
    (65_536, (300, 256, 128, 64), (32, 32), 2 * 256 * 320 + 65_536),
    (65_536, (765, 256, 128, 64), (32, 32), 393_216 + 65_536),      # emd_slice255
    (65_536, (32, 64, 128, 256), (765,), 65_536 + 393_216),
    (10_000, (12, 80, 40, 20), (10, 10), 0),                        # fused: none
])
def test_forward_split_weights_at_the_main_path_batches(batch, dims, head_dims, floats):
    """The split weights one call allocates beside its activation buffers."""
    plan = fused_vae.forward_plan(batch, dims, head_dims)
    assert plan.wsplit_floats == floats
    assert plan.scratch_bytes == 4 * (sum(plan.buf_floats) + floats)


def walk_plan(plan, x, layers, n_heads, final_relu):
    """The plan's segments in plain PyTorch: ``layers`` are the stack's
    (w, b) pairs, the last ``n_heads`` its heads; activations pass through
    two buffers of the plan's sizes.  Returns the head outputs."""
    n_hidden = len(layers) - n_heads
    bufs = [torch.full((f,), float("nan")) for f in plan.buf_floats]
    h = x
    for seg in plan.segments:
        for l in range(seg.first, seg.last):
            if l < n_hidden:
                h = torch.relu(h @ layers[l][0] + layers[l][1])
            else:
                outs = [h @ w + b for w, b in layers[n_hidden:]]
                return tuple(torch.relu(o) if final_relu else o for o in outs)
        buf = bufs[seg.out]
        buf[:h.numel()] = h.reshape(-1)
        h = buf[:h.numel()].view(h.shape)
    raise AssertionError("the plan never reached the heads")


@pytest.mark.parametrize("role", ["encoder", "decoder", "deep_narrow", "deep_mixed"])
def test_plan_walk_matches_plain_and_jax(rng, role):
    """At a small constituents-shaped stack (the widths of 100 constituents,
    37 rows), and at stacks deeper than one fused launch takes (12 narrow
    hidden layers; a 300-wide input and 9 more), the plain walk of K2's plan
    equals the port's plain version and the JAX kernel (Pallas interpret
    mode) to atol 1e-5."""
    from atlasvae.ops.fused_vae import _stack_fwd as jax_stack_fwd

    dims, head_dims = {"encoder": ((300, 256, 128, 64), (32, 32)),
                       "decoder": ((32, 64, 128, 256), (300,)),
                       "deep_narrow": ((12,) + (64,) * 12, (10, 10)),
                       "deep_mixed": ((300,) + (128,) * 9, (32, 32))}[role]
    pairs = [((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
              rng.normal(size=n).astype(np.float32))
             for k, n in list(zip(dims, dims[1:])) + [(dims[-1], n) for n in head_dims]]
    x = rng.normal(size=(37, dims[0])).astype(np.float32)
    t_pairs = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in pairs]
    n_hidden = len(dims) - 1
    plan = fused_vae.forward_plan(37, dims, head_dims)
    assert plan.route == "layers"
    got = walk_plan(plan, torch.from_numpy(x), t_pairs, len(head_dims), False)
    want = jax_stack_fwd(x, pairs[:n_hidden], pairs[n_hidden:])
    plain = fused_vae.stack_forward(torch.from_numpy(x), t_pairs[:n_hidden], t_pairs[n_hidden:])
    assert len(got) == len(want) == len(plain) == len(head_dims)
    for g, w, p, n in zip(got, want, plain, head_dims):
        assert g.shape == (37, n)
        torch.testing.assert_close(g, p, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
