"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no NVIDIA GPU (a CUDA kernel has
no CPU mode).  This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: atol 1e-5, rtol 1e-5 -- K1/K2 take each product in 3xTF32 on
the tensor cores (good to about 2^-22 of itself) and sum in a fixed order,
cuBLAS in its own blocked order in full float32.
The backward kernel's dW/db sum over every row of the batch: atol 1e-5
times the leaf's largest value up to 1,000 rows, and 3e-4 times it (the
bar of tests/test_fused_vae.py) over tens of thousands of rows.  Only at
the 2048-wide stack (``wide_2048``), where a first-layer ReLU input can sit
at 0 to float32 rounding (45 of 5.1 million at 10,000 rows) and flip between
the kernel's recompute and cuBLAS's, may an element go beyond its bar, and
then by no more than the largest move of one such flip at that element
(tests/relu_ties.py).  The
Sinkhorn EMD kernel: rtol 2e-5, atol 1e-6, the bar the JAX package holds
its two forms of that function to (tests/test_emd.py); where the EMD is
small beside the jets' total pt (a cloud against a permuted copy of itself)
the atol is 1e-5 of the total pt, which is what float32 gives either form.
The fused conv block (K5): atol 1e-5 + rtol 1e-5 against the plain version,
whose convolution runs in full float32 (cuDNN's TF32 is turned off here);
its backward (K6): dW and db within 2e-4 of each leaf's largest value, the
bar of tests/test_fused_conv.py, and the same bits on a second call.  Their
bf16 forms: each output equal to the plain version's or one bf16 ulp from it
(both round one float32 value once, summed in other orders), or within 1e-5
where the ReLU's input is 0 to float32 rounding; dW and db within one bf16
ulp of the plain value plus 2e-4 of the leaf's largest value.
"""

import numpy as np
import pytest
import torch
from nonfinite_stacks import NEAR_MAX, plant_inside, route_stack
from relu_ties import single_flip_allowance
from torch_gaps import assert_close

from atlasvae_torch.losses import get_losses
from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
from atlasvae_torch.ops import emd, emd_cuda, fused_conv, fused_conv_cuda, fused_mlp, fused_vae
from atlasvae_torch.train import train_model
from atlasvae_torch.train.checkpoint import tree_flatten, tree_map
from atlasvae_torch.utils.bf16 import ulp as bf16_ulp, ulps_apart as bf16_ulps_apart

pytestmark = pytest.mark.cuda

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stack(gen, dims, head_dims, device):
    def pair(k, n):
        w = torch.randn((k, n), generator=gen) / k ** 0.5
        return w.to(device), torch.randn((n,), generator=gen).to(device)
    hidden = [pair(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    heads = [pair(dims[-1], n) for n in head_dims]
    return hidden, heads


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


def _k2_counts():
    return fused_vae.launches, fused_vae.layered_launches


def _k1_counts():
    return fused_mlp.launches, fused_mlp.layered_launches


def _counted(route, before):
    """The (fused body, layer-wise route) counts after one call on ``route``."""
    return before[0] + (route == "fused"), before[1] + (route == "layers")


# batches that end mid-warp (16 rows) and mid-CTA (64), and at 65,539 and
# 300,007 rows many 16-row blocks for each warp of the persistent grid
FORWARD_BATCHES = [1, 7, 129, 1000, 10_007, 65_539, 300_007]


@pytest.mark.parametrize("batch", FORWARD_BATCHES)
# each stack with the route forward_plan must give it: the fused body where
# every width is at most 128 and the stack's weights fit one CTA, else the
# layer-wise route (a wide layer, or fused segments that each fit)
@pytest.mark.parametrize("dims,head_dims,route", [
    ((12, 80, 40, 20), (10, 10), "fused"),      # canonical encoder
    ((5,), (3,), "fused"),                      # heads only
    ((3, 1, 7), (2, 2, 2, 2), "fused"),         # four heads, width 1
    ((130, 33, 9), (5, 6), "layers"),           # width > 128
    ((312, 256, 128, 64), (32, 32), "layers"),  # constituents-mode encoder
    ((10, 20, 40, 80), (12,), "fused"),         # canonical decoder (training forward)
    ((128, 64), (32, 32), "fused"),             # the constituents encoder's fused tail
    ((1, 13, 33, 127), (128,), "layers"),       # widths 1, 13 (4-byte copies), 33, 127;
                                                # the 127 x 128 heads a segment apart
    ((13, 128, 33), (1, 5, 13, 7), "fused"),    # four odd heads, 128 wide
    ((128,) * 9, (32, 32), "layers"),           # 8 hidden layers of 128: a segment each
])
def test_stack_forward_matches_plain(cuda, batch, dims, head_dims, route):
    gen = torch.Generator().manual_seed(batch * 1000 + len(dims))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    assert fused_vae.forward_plan(batch, tuple(dims), tuple(head_dims)).route == route
    before = _k2_counts()
    got = fused_vae.stack_forward(x, hidden, heads)
    assert _k2_counts() == _counted(route, before)
    _close(got, fused_vae.stack_forward_plain(x, hidden, heads))
    again = fused_vae.stack_forward(x, hidden, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("batch", [1, 127, 128, 1001, 10_007, 65_539, 300_007])
@pytest.mark.parametrize("dims,route", [((10, 20, 40, 80, 12), "fused"), ((7, 3), "fused"),
                                        ((32, 256, 313, 5), "layers"),
                                        ((1, 13, 33, 127, 128), "layers"),   # odd widths, 128 out
                                        ((32, 64, 128), "fused"),   # the constituents decoder's head
                                        ((128,) * 10, "layers")])   # 8 hidden layers of 128
@pytest.mark.parametrize("final", ["linear", "relu"])
def test_fused_mlp_matches_plain(cuda, batch, dims, route, final):
    gen = torch.Generator().manual_seed(batch * 100 + len(dims))
    hidden, heads = _stack(gen, dims[:-1], dims[-1:], cuda)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    assert fused_vae.forward_plan(batch, dims[:-1], dims[-1:]).route == route
    before = _k1_counts()
    got = fused_mlp.fused_mlp_apply(layers, x, final_activation=final)
    assert _k1_counts() == _counted(route, before)
    _close([got], [fused_mlp.fused_mlp_plain(layers, x, final_activation=final)])
    assert torch.equal(got, fused_mlp.fused_mlp_apply(layers, x, final_activation=final))


# K1/K2's layer-wise route: the constituents-mode stacks (300 wide in
# training, 312 in the parity phase, 765 and 1020 at 255 constituents of 3
# and 4 components, the widest the data counts), an odd stack whose widths
# turn off the 16-byte copies and stores, and wide heads that are one product
WIDE_FORWARD = {
    "const_encoder": ((300, 256, 128, 64), (32, 32)),
    "const_encoder_312": ((312, 256, 128, 64), (32, 32)),
    "const_encoder_765": ((765, 256, 128, 64), (32, 32)),
    "const_encoder_1020": ((1020, 256, 128, 64), (32, 32)),
    "const_decoder": ((32, 64, 128, 256), (300,)),
    "const_decoder_312": ((32, 64, 128, 256), (312,)),
    "const_decoder_765": ((32, 64, 128, 256), (765,)),
    "const_decoder_1020": ((32, 64, 128, 256), (1020,)),
    "odd": ((301, 130, 33), (5, 5)),
    "wide_heads": ((12, 80), (129, 67, 5)),
    # any depth and width: 12 narrow hidden layers (two fused segments), a
    # 300-wide input and 9 hidden layers of 128, 400 constituents x 3, 2048 wide
    "deep_12_narrow": ((12,) + (64,) * 12, (10, 10)),
    "deep_10_const": ((300,) + (128,) * 9, (32, 32)),
    "const_1200": ((1200, 256, 128, 64), (32, 32)),
    "wide_2048": ((2048, 512, 64), (32, 32)),
}


@pytest.mark.parametrize("batch", [1, 7, 129, 1000, 10_007])
@pytest.mark.parametrize("name", sorted(WIDE_FORWARD))
def test_stack_forward_layered_route_matches_plain(cuda, name, batch):
    dims, head_dims = WIDE_FORWARD[name]
    gen = torch.Generator().manual_seed(batch + len(name))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    assert fused_vae.forward_plan(batch, dims, head_dims).route == "layers"
    before = _k2_counts()
    got = fused_vae.stack_forward(x, hidden, heads)
    assert _k2_counts() == _counted("layers", before)
    _close(got, fused_vae.stack_forward_plain(x, hidden, heads))
    again = fused_vae.stack_forward(x, hidden, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("batch", [1, 7, 129, 1000, 10_007])
@pytest.mark.parametrize("final", ["linear", "relu"])
@pytest.mark.parametrize("name", sorted(WIDE_FORWARD))
def test_fused_mlp_layered_route_matches_plain(cuda, name, final, batch):
    dims, head_dims = WIDE_FORWARD[name]
    widths = dims + head_dims[:1]
    gen = torch.Generator().manual_seed(batch * 3 + len(name))
    hidden, heads = _stack(gen, widths[:-1], widths[-1:], cuda)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    x = torch.randn((batch, widths[0]), generator=gen).to(cuda)
    assert fused_vae.forward_plan(batch, widths[:-1], widths[-1:]).route == "layers"
    before = _k1_counts()
    got = fused_mlp.fused_mlp_apply(layers, x, final_activation=final)
    assert _k1_counts() == _counted("layers", before)
    _close([got], [fused_mlp.fused_mlp_plain(layers, x, final_activation=final)])
    assert torch.equal(got, fused_mlp.fused_mlp_apply(layers, x, final_activation=final))


# The row product's edges (csrc/gemm_wgmma.cuh): a head of width 1, k = 1
# (the 4-byte copy route: a pitch that is no multiple of 16 bytes), 765 and
# 1,020 wide on each operand (input, hidden, head; 765 copies by 4 bytes,
# 1,020 by TMA), W^T padded along k (33 and 301 deep, stages of 32), at
# batches around the two 64-row warpgroups of a 128-row tile
ROW_EDGES = {
    "head_width_1": ((200,), (1,)),
    "k_1": ((1,), (200,)),
    "k_1_hidden": ((1, 200), (5,)),
    "input_765": ((765, 64), (8,)),
    "hidden_765": ((32, 765, 64), (8,)),
    "head_765": ((32, 64), (765,)),
    "input_1020": ((1020, 64), (8,)),
    "hidden_1020": ((32, 1020, 64), (8,)),
    "head_1020": ((32, 64), (1020,)),
    "k_padded": ((33, 129), (3, 4)),
    "k_padded_301": ((301, 200), (7,)),
}
ROW_EDGE_BATCHES = [1, 63, 64, 65, 127, 128, 129, 10_007]


@pytest.mark.parametrize("batch", ROW_EDGE_BATCHES)
@pytest.mark.parametrize("name", sorted(ROW_EDGES))
def test_stack_forward_row_product_edges_match_plain(cuda, name, batch):
    dims, head_dims = ROW_EDGES[name]
    gen = torch.Generator().manual_seed(batch * 7 + len(name))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    plan = fused_vae.forward_plan(batch, dims, head_dims)
    assert plan.route == "layers" and plan.wsplit_floats > 0
    before = _k2_counts()
    got = fused_vae.stack_forward(x, hidden, heads)
    assert _k2_counts() == _counted("layers", before)
    _close(got, fused_vae.stack_forward_plain(x, hidden, heads))
    again = fused_vae.stack_forward(x, hidden, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("batch", ROW_EDGE_BATCHES)
@pytest.mark.parametrize("name", sorted(ROW_EDGES))
def test_fused_mlp_row_product_edges_match_plain(cuda, name, batch):
    dims, head_dims = ROW_EDGES[name]
    widths = dims + head_dims[-1:]
    gen = torch.Generator().manual_seed(batch * 11 + len(name))
    hidden, heads = _stack(gen, widths[:-1], widths[-1:], cuda)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    x = torch.randn((batch, widths[0]), generator=gen).to(cuda)
    before = _k1_counts()
    got = fused_mlp.fused_mlp_apply(layers, x, final_activation="relu")
    assert _k1_counts() == _counted("layers", before)
    _close([got], [fused_mlp.fused_mlp_plain(layers, x, final_activation="relu")])
    assert torch.equal(got, fused_mlp.fused_mlp_apply(layers, x, final_activation="relu"))


def test_row_product_reads_a_misaligned_input(cuda):
    """A 300-wide input whose rows start 4 bytes past a 16-byte boundary (a
    column slice): the row product copies it by 4 bytes, not by TMA."""
    gen = torch.Generator().manual_seed(3)
    hidden, heads = _stack(gen, (300, 256, 64), (32, 32), cuda)
    wide = torch.randn((1000, 301), generator=gen).to(cuda)
    x = torch.as_strided(wide, (1000, 300), (300, 1), 1)   # contiguous rows, offset 1 float
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got = fused_vae.stack_forward(x, hidden, heads)
    _close(got, fused_vae.stack_forward_plain(x.clone(), hidden, heads))


def test_canonical_forward_stays_one_fused_launch(cuda):
    """The canonical encoder and decoder keep the fused body: one launch a
    call, the layer-wise route never, at the scoring chunk as at one row."""
    gen = torch.Generator().manual_seed(8)
    params = init_vae(gen, VAEConfig(), device=cuda)
    enc, dec = params["encoder"], params["decoder"]
    hidden = [(l["w"], l["b"]) for l in enc["hidden"]]
    heads = [(enc["mean"]["w"], enc["mean"]["b"]), (enc["logvar"]["w"], enc["logvar"]["b"])]
    layers = dec["hidden"] + [dec["out"]]
    for batch in (1, 65_536):
        x = torch.randn((batch, 12), generator=gen).to(cuda)
        z = torch.randn((batch, 10), generator=gen).to(cuda)
        k1, k2 = _k1_counts(), _k2_counts()
        fused_vae.stack_forward(x, hidden, heads)
        fused_mlp.fused_mlp_apply(layers, z)
        assert _k2_counts() == (k2[0] + 1, k2[1]) and _k1_counts() == (k1[0] + 1, k1[1])


def test_vae_apply_on_cuda_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    params = init_vae(gen, VAEConfig(), device="cpu")
    x = torch.randn((777, 12), generator=gen)
    noise = torch.randn((777, 10), generator=gen)
    want = vae_apply(params, x, noise=noise)
    on_card = tree_map(lambda t: t.to(cuda), params)
    with torch.inference_mode():
        got = vae_apply(on_card, x.to(cuda), noise=noise.to(cuda))
    # the same model in float64, so that a failure says which side left it,
    # and the CPU side once more in this process
    f64 = vae_apply(tree_map(lambda t: t.double(), params), x.double(), noise=noise.double())
    again = all(torch.equal(a, b) for a, b in zip(want, vae_apply(params, x, noise=noise)))
    assert len(got) == len(want)
    for i, (g, w, r) in enumerate(zip(got, want, f64)):
        card_gap = float((g.cpu().double() - r).abs().max())
        cpu_gap = float((w.double() - r).abs().max())
        assert_close(g, w, f"vae_apply output {i} (card against float64 {card_gap:.3g}, "
                     f"CPU against float64 {cpu_gap:.3g}; float32 matmul precision "
                     f"{torch.get_float32_matmul_precision()!r}, CPU capability "
                     f"{torch.backends.cpu.get_cpu_capability()!r}, "
                     f"{torch.get_num_threads()} threads; the CPU again the same bits: "
                     f"{again})", rtol=RTOL, atol=ATOL)


def test_kernels_refuse_autograd_and_bad_input(cuda):
    gen = torch.Generator().manual_seed(4)
    hidden, heads = _stack(gen, (6, 4), (2,), cuda)
    x = torch.randn((9, 6), generator=gen).to(cuda)
    with pytest.raises(NotImplementedError, match="records no gradient"):
        fused_vae.stack_forward(x.requires_grad_(), hidden, heads)
    with pytest.raises(ValueError):
        fused_vae.stack_forward(x.detach().double(), hidden, heads)
    with pytest.raises(ValueError):
        fused_vae.stack_forward(x.detach()[:, :5], hidden, heads)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_apply(layers, x.detach().t())


def _close_grads(got, want, scale_tol, tie_inputs=None):
    """dW/db within scale_tol of each leaf's largest value, dx within ATOL +
    RTOL |ref|.  Given ``tie_inputs`` (x, hidden, heads, grads, want_dx), an
    element may go beyond its bar by the largest move of one flipped ReLU tie
    there (relu_ties.single_flip_allowance), 0 where no tie reaches."""
    dws, dbs, dx = got
    if tie_inputs is None:
        for g, w in zip(dws + dbs, want[0] + want[1]):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=0, atol=scale_tol * float(w.abs().max()))
        if want[2] is None:
            assert dx is None
        else:
            torch.testing.assert_close(dx, want[2], atol=ATOL, rtol=RTOL)
        return
    a_dws, a_dbs, a_dx, _ = single_flip_allowance(*tie_inputs)
    for i, (g, w, a) in enumerate(zip(dws + dbs, want[0] + want[1], a_dws + a_dbs)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert_close(g, w, f"leaf {i}", atol=a.cpu().numpy() + scale_tol * float(w.abs().max()))
    if want[2] is None:
        assert dx is None
    else:
        assert_close(dx, want[2], "dx", rtol=RTOL, atol=a_dx.cpu().numpy() + ATOL)


def _k3_counts():
    return fused_vae.backward_launches, fused_vae.layered_backward_launches


def _check_stack_backward(cuda, batch, dims, head_dims, want_dx, scale_tol, seed, ties=False):
    """One K3 call against its plain version, on the route backward_plan
    names (one launch counted there, none on the other), and the same bits on
    a second call (split or per-CTA partials summed in a fixed order).
    ``ties``: beyond the bar by one flipped ReLU tie's move (_close_grads)."""
    gen = torch.Generator().manual_seed(seed)
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    grads = [(torch.randn((batch, n), generator=gen) / batch).to(cuda) for n in head_dims]
    route = fused_vae.backward_plan(batch, tuple(dims), tuple(head_dims), want_dx).route
    before = _k3_counts()
    got = fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    assert _k3_counts() == (before[0] + (route == "fused"), before[1] + (route == "layers"))
    _close_grads(got, fused_vae.stack_backward_plain(x, hidden, heads, grads, want_dx), scale_tol,
                 (x, hidden, heads, grads, want_dx) if ties else None)
    again = fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    for a, b in zip(got[0] + got[1] + [got[2]] * want_dx, again[0] + again[1] + [again[2]] * want_dx):
        assert torch.equal(a, b)
    return route


@pytest.mark.parametrize("batch", [1, 7, 65, 1000])
@pytest.mark.parametrize("dims,head_dims,want_dx", [
    ((12, 80, 40, 20), (10, 10), False),   # canonical encoder
    ((10, 20, 40, 80), (12,), True),       # canonical decoder, dz
    ((5,), (3,), True),                    # heads only
    ((3, 1, 7), (2, 2, 2, 2), True),       # four heads, width 1
    ((13, 17, 9), (5, 5), False),          # odd widths
    ((130, 33, 9), (5, 6), True),          # wider than 128: the layer-wise route
    ((12, 100), (60, 40), True),           # 750 dW/db blocks: two a thread of the fused body
])
def test_stack_backward_matches_plain(cuda, batch, dims, head_dims, want_dx):
    route = _check_stack_backward(cuda, batch, dims, head_dims, want_dx, 1e-5,
                                  batch * 10 + len(dims))
    assert route == ("layers" if max(dims) > 128 else "fused")


# the constituents-mode stacks (100 constituents x (px, py, pz) in training,
# 312 wide in the parity phase, 765 and 1020 at 255 constituents), and a
# stack whose fused tile does not fit
WIDE_STACKS = {
    "const_encoder": ((300, 256, 128, 64), (32, 32), False),
    "const_decoder": ((32, 64, 128, 256), (300,), True),
    "const_encoder_312": ((312, 256, 128, 64), (32, 32), False),
    "const_decoder_312": ((32, 64, 128, 256), (312,), True),
    "const_encoder_765": ((765, 256, 128, 64), (32, 32), False),
    "const_decoder_1020": ((32, 64, 128, 256), (1020,), True),
    "eight_hidden_128": ((128,) * 9, (16, 16), True),
    # any depth and width (WIDE_FORWARD's four)
    "deep_12_narrow": ((12,) + (64,) * 12, (10, 10), True),
    "deep_10_const": ((300,) + (128,) * 9, (32, 32), False),
    "const_1200": ((1200, 256, 128, 64), (32, 32), False),
    "wide_2048": ((2048, 512, 64), (32, 32), True),
    # odd head widths: the heads' gradients as k segments of 4-byte copies,
    # their weight gradients as column segments
    "odd_heads": ((300, 256, 128, 64), (5, 27), True),
    "four_odd_heads": ((129, 33, 9), (1, 5, 13, 7), True),
}


@pytest.mark.parametrize("batch", [1, 65, 1000, 10_000])
@pytest.mark.parametrize("name", sorted(WIDE_STACKS))
def test_stack_backward_layered_route_matches_plain(cuda, name, batch):
    dims, head_dims, want_dx = WIDE_STACKS[name]
    tol = 1e-5 if batch <= 1000 else 3e-4
    assert _check_stack_backward(cuda, batch, dims, head_dims, want_dx, tol, batch,
                                 ties=name == "wide_2048") == "layers"


def test_stack_backward_layered_ragged_split_edges(cuda):
    """A batch that is no multiple of a chunk or of a split: each weight
    gradient's last split is short and ends mid-chunk."""
    batch = 22_741
    dims, head_dims, _ = WIDE_STACKS["const_encoder"]
    plan = fused_vae.backward_plan(batch, dims, head_dims, True)
    assert all(batch % rows and batch % rows % fused_vae.ROW_STAGE_K
               for _, _, rows in plan.splits)
    assert _check_stack_backward(cuda, batch, dims, head_dims, True, 3e-4, 17) == "layers"


@pytest.mark.parametrize("width", [765, 1020])
def test_stack_backward_reads_misaligned_inputs(cuda, width):
    """An input and a head gradient whose rows start 4 bytes past a 16-byte
    boundary, at the widest inputs the data gives (255 constituents of 3 and
    of 4 components; 765 wide is also a pitch of no whole 16 bytes): the
    recompute and the weight gradients copy them by 4 bytes, not by TMA or
    16-byte copies."""
    gen = torch.Generator().manual_seed(width)
    batch, dims, head_dims = 1000, (width, 256, 64), (32, 32)
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    wide = torch.randn((batch * width + 1,), generator=gen).to(cuda)
    x = torch.as_strided(wide, (batch, width), (width, 1), 1)
    spare = (torch.randn((batch * 32 + 1,), generator=gen) / batch).to(cuda)
    grads = [torch.as_strided(spare, (batch, 32), (32, 1), 1),
             (torch.randn((batch, 32), generator=gen) / batch).to(cuda)]
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 and grads[0].data_ptr() % 16 == 4
    got = fused_vae.stack_backward(x, hidden, heads, grads, True)
    _close_grads(got, fused_vae.stack_backward_plain(x.clone(), hidden, heads,
                                                     [g.clone() for g in grads], True), 1e-5)


def test_stack_backward_takes_a_layer_past_the_old_grid_bound(cuda):
    """A 65,536 -> 16,384 layer at 1,000 rows (a batch that ends mid-stage),
    the stack's one layer (a head: no ReLU), with dx: its weight gradient
    has 65,536 tiles of 128 x 128 (more than CUDA's grid y took) and dx's
    row product 8 x 512; the persistent launches walk them all."""
    dims, head_dims = (65_536,), (16_384,)
    plan = fused_vae.backward_plan(1000, dims, head_dims, True)
    assert plan.route == "layers" and plan.splits == ((0, 1, 1024),) and plan.partial_floats == 0
    assert _check_stack_backward(cuda, 1000, dims, head_dims, True, 1e-5, 65) == "layers"
    torch.cuda.empty_cache()


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("dims,head_dims,want_dx", [
    ((12, 80, 80), (20, 20), False),       # two heads: the heads' gradient as k segments
    ((300, 256, 64), (32, 32), True),
    ((10, 20, 30), (12,), True),
])
def test_stack_backward_propagates_non_finite_head_gradients(cuda, bad, dims, head_dims, want_dx):
    """A NaN or inf in one head gradient (a loss that overflowed) leaves every
    gradient non-finite where the plain version's f32 sums do (the training
    step's guard then zeroes them), and the rest within its bar.  On the
    layer-wise route the GPU's own NaN (inf - inf in g W^T) once split into
    TF32 words as -0.0 and vanished."""
    gen = torch.Generator().manual_seed(len(dims) + int(bad != bad))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((1000, dims[0]), generator=gen).to(cuda)
    grads = [(torch.randn((1000, n), generator=gen) / 1000).to(cuda) for n in head_dims]
    grads[-1][7, 3] = bad
    got = fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    want = fused_vae.stack_backward_plain(x, hidden, heads, grads, want_dx)
    for g, w in zip(got[0] + got[1] + [got[2]] * want_dx, want[0] + want[1] + [want[2]] * want_dx):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        ok = torch.isfinite(w)
        if bool(ok.any()):
            torch.testing.assert_close(g[ok], w[ok], rtol=0, atol=1e-5 * float(w[ok].abs().max()))


def test_stack_backward_rejects_bad_head_gradients(cuda):
    gen = torch.Generator().manual_seed(5)
    hidden, heads = _stack(gen, (6, 4), (2, 3), cuda)
    x = torch.randn((9, 6), generator=gen).to(cuda)
    good = [torch.randn((9, 2), generator=gen).to(cuda),
            torch.randn((9, 3), generator=gen).to(cuda)]
    wide = torch.randn((9, 6), generator=gen).to(cuda)
    before = _k3_counts()
    for grads in (good[:1],                                 # one gradient for two heads
                  [good[0], good[1][:8].contiguous()],     # wrong shape
                  [good[0], good[1].double()],             # float64
                  [good[0], wide[:, :3]],                  # not contiguous
                  [good[0], good[1].cpu()]):               # another device
        with pytest.raises(ValueError):
            fused_vae.stack_backward(x, hidden, heads, grads, True)
    with pytest.raises(ValueError, match="empty batch"):
        fused_vae.stack_backward(x[:0], hidden, heads, [g[:0] for g in good], True)
    assert _k3_counts() == before


@pytest.mark.parametrize("batch", [64 * 264 * 2 + 5, 32 * 264 + 33, 128 * 132 * 12 + 7])
def test_stack_backward_many_tiles_per_cta(cuda, batch):
    """The fused body at 2 and 12 tiles of 128 rows a CTA (its 132 CTAs), and
    the layer-wise route at a 200-wide input; the same bits on a second call."""
    dims, head_dims = ((12, 80, 40, 20), (10, 10)) if batch > 20000 else \
        ((200, 64, 16), (8, 8))
    gen = torch.Generator().manual_seed(batch)
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    grads = [(torch.randn((batch, n), generator=gen) / batch).to(cuda) for n in head_dims]
    got = fused_vae.stack_backward(x, hidden, heads, grads, True)
    _close_grads(got, fused_vae.stack_backward_plain(x, hidden, heads, grads, True), 3e-4)
    again = fused_vae.stack_backward(x, hidden, heads, grads, True)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1] + [got[2]],
                                                 again[0] + again[1] + [again[2]]))


def test_fused_autograd_on_cuda_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(6)
    params = init_vae(gen, VAEConfig(), device="cpu")
    x = torch.randn((513, 12), generator=gen)
    w = torch.rand(513, generator=gen)
    noise = (torch.randn((513, 10), generator=gen), torch.randn((513, 10), generator=gen))
    grads = {}
    for device in ("cpu", cuda):
        p = tree_map(lambda t: t.to(device).requires_grad_(), params)
        loss = get_losses(p, x.to(device), (x + 1).to(device), w.to(device), w.to(device),
                          None, "MAE", 2.0, 5.0, 1.0,
                          noise=tuple(n.to(device) for n in noise))[3].sum()
        before = (fused_vae.launches, fused_vae.backward_launches)
        grads[str(device)] = [g.cpu() for g in torch.autograd.grad(loss, tree_flatten(p))]
        if device == cuda:
            assert fused_vae.backward_launches == before[1] + 4   # 2 encoders, 2 decoders
    for g, want in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(g, want, rtol=0, atol=3e-4 * float(want.abs().max()))


def test_train_model_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    n, batch = 3000, 1000
    load = ({"HLVs": rng.normal(size=(n, 12)).astype(np.float32),
             "weights": np.ones(n, np.float32)},
            {"HLVs": rng.normal(1.5, 1, size=(n, 12)).astype(np.float32),
             "weights": np.ones(n, np.float32)})
    noise = {}

    def source(phase, epoch, load_idx, n_batches, rows):
        key = (phase, epoch)
        if key not in noise:
            noise[key] = tuple(rng.standard_normal((n_batches, rows, 10)).astype(np.float32)
                               for _ in range(2))
        return noise[key]

    params = init_vae(torch.Generator().manual_seed(8), VAEConfig(), device="cpu")
    hists = {}
    for device in ("cpu", cuda):
        _, hists[str(device)] = train_model(tree_map(lambda t: t.to(device), params),
                                            [load], [load], "MAE", 2, batch, 2.0, 5.0, 1.0,
                                            noise_source=source)
    for key, want in hists["cpu"].items():
        np.testing.assert_allclose(hists[str(cuda)][key], want, rtol=1e-4)


def _clouds(gen, batch, n, device):
    """Jet pairs in (pt, y, phi) with zero-padded tails of differing length,
    some phi near the +-pi seam and a few jets with no pt at all."""
    out = []
    for frac in (0.6, 0.55):
        jets = torch.zeros((batch, n, 3))
        jets[..., 0] = torch.rand((batch, n), generator=gen) * 1.9 + 0.1
        jets[..., 1] = torch.randn((batch, n), generator=gen) * 0.5
        jets[..., 2] = torch.randn((batch, n), generator=gen) * 1.5
        live = torch.randint(max(1, int(n * frac) - 3), n + 1, (batch, 1), generator=gen)
        jets[torch.arange(n)[None, :] >= live] = 0.0
        out.append(jets)
    out[0][::97, :, 0] = 0.0
    out[1][::61, :, 0] *= -1.0
    return [t.to(device).contiguous() for t in out]


@pytest.mark.parametrize("batch,n,n_iters", [(8192, 100, 100), (1000, 20, 100), (7, 128, 100),
                                             (3, 1, 100), (50, 33, 25), (50, 16, 3),
                                             (2064, 255, 100)])
def test_emd_sinkhorn_matches_plain(cuda, batch, n, n_iters):
    gen = torch.Generator().manual_seed(batch + n)
    p, q = _clouds(gen, batch, n, cuda)
    before = _route_counts()
    got = emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, 0.01)
    assert _route_counts() == _launched_on(before, emd_cuda.route(n)[0])
    want = emd._sinkhorn_emd(p, q, 1.0, n_iters, 0.01)
    assert got.shape == (batch,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
    again = emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, 0.01)
    assert torch.equal(got, again)          # every sum in a fixed order
    # the dispatcher takes the kernel for CUDA tensors, and R enters the cost
    assert torch.equal(emd._emd_batch(p, q, 1.0, n_iters, 0.01), got)
    torch.testing.assert_close(emd_cuda.emd_sinkhorn(p, q, 0.8, n_iters, 0.01),
                               emd._sinkhorn_emd(p, q, 0.8, n_iters, 0.01),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["permuted", "far"])
@pytest.mark.parametrize("batch,n", [(512, 100), (64, 233)])
def test_emd_sinkhorn_small_emd_beside_large_pt(cuda, batch, n, kind):
    """Few iterations on a cloud against itself in the reverse order (true
    EMD 0) and against a far copy of equal total pt.  The float32 rounding
    of transport * min(sum p, sum q) is a few 1e-6 of the total pt however
    small the transport, in the kernel and in the plain version alike (the
    plain version moves as much when both clouds are permuted together), so
    a permuted copy is held to rtol on the EMD plus 1e-5 of the total pt,
    against the plain version and against the plain version in float64."""
    gen = torch.Generator().manual_seed(n)
    p, _ = _clouds(gen, batch, n, cuda)
    q = p.flip(1).contiguous()
    if kind == "far":
        q[..., 1] += 0.8
        q[..., 2] -= 0.6
    got = emd_cuda.emd_sinkhorn(p, q, 1.0, 20, 0.01)
    want = emd._sinkhorn_emd(p, q, 1.0, 20, 0.01)
    exact = emd._sinkhorn_emd(p.double(), q.double(), 1.0, 20, 0.01)
    assert torch.equal(got, emd_cuda.emd_sinkhorn(p, q, 1.0, 20, 0.01))
    if kind == "far":
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
        return
    mass = p[..., 0].sum(1)
    assert bool(((got - want).abs() <= 2e-5 * want.abs() + 1e-5 * mass).all())
    assert bool(((got - exact).abs() <= 2e-5 * exact.abs() + 1e-5 * mass).all())
    # the same yardstick for the plain version: it is no closer in kind
    assert bool(((want - exact).abs() <= 2e-5 * exact.abs() + 1e-5 * mass).all())


# K4's three routes at the widths around their edges: the register route's
# tiles (8, 16, 20, 32 packed a warp or less a pair; 64, 112, 128 several
# warps), the cluster route's clusters of 2 (129), 4 (233, 255) and 8
# (CLUSTER_MAX), which take every n up to CLUSTER_MAX, and the wide route,
# which takes every n
EMD_WIDTHS = [1, 20, 32, 33, 100, 128, 129, 233, 255, emd_cuda.CLUSTER_MAX,
              emd_cuda.CLUSTER_MAX + 1, 400]
EMD_ROUTE_CASES = [(n, which) for n in EMD_WIDTHS for which in emd_cuda.ROUTES
                   if which == "wide" or n <= emd_cuda.TILES[-1]
                   or (which == "cluster" and n <= emd_cuda.CLUSTER_MAX)]


def _route_counts():
    return emd_cuda.launches, emd_cuda.cluster_launches, emd_cuda.wide_launches


def _launched_on(before, which):
    """The route counts after one launch on route ``which``."""
    return tuple(b + (which == r) for b, r in zip(before, emd_cuda.ROUTES))


@pytest.mark.parametrize("kind", ["near", "permuted", "far"])
@pytest.mark.parametrize("n,which", EMD_ROUTE_CASES)
def test_emd_sinkhorn_routes_match_plain(cuda, n, which, kind):
    """Each route at each width, on a ragged batch (the packed tiles' last
    CTA half full): the near clouds at 100 iterations, rtol 2e-5 / atol 1e-6;
    a permuted copy (true EMD 0) and a far copy at 20 iterations, the bars of
    test_emd_sinkhorn_small_emd_beside_large_pt; the same bits on a second
    call; one launch counted on the route, none on the others."""
    gen = torch.Generator().manual_seed(31 * n + len(kind))
    p, q = _clouds(gen, 67, n, cuda)
    n_iters = 100
    if kind != "near":
        q = p.flip(1).contiguous()
        n_iters = 20
    if kind == "far":
        q[..., 1] += 0.8
        q[..., 2] -= 0.6
    before = _route_counts()
    got = emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, 0.01, force_route=which)
    assert _route_counts() == _launched_on(before, which)
    want = emd._sinkhorn_emd(p, q, 1.0, n_iters, 0.01)
    assert got.shape == (67,) and bool(torch.isfinite(got).all())
    assert torch.equal(got, emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, 0.01, force_route=which))
    if kind != "permuted":
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
        return
    mass = torch.minimum(p[..., 0].clamp_min(0).sum(1), q[..., 0].clamp_min(0).sum(1))
    assert bool(((got - want).abs() <= 2e-5 * want.abs() + 1e-5 * mass).all())


def test_emd_sinkhorn_takes_the_route_of_its_width(cuda):
    """Without force_route every width runs the route ``route`` names (the
    register route to 128, the cluster route to CLUSTER_MAX, the wide route
    above), and the register and cluster routes refuse a jet wider than they
    take."""
    gen = torch.Generator().manual_seed(5)
    for n in EMD_WIDTHS:
        p, q = _clouds(gen, 3, n, cuda)
        before = _route_counts()
        emd_cuda.emd_sinkhorn(p, q, 1.0, 5, 0.01)
        which = emd_cuda.route(n)[0]
        assert which == ("tiles" if n <= 128 else "cluster" if n <= emd_cuda.CLUSTER_MAX
                         else "wide")
        assert _route_counts() == _launched_on(before, which)
    wide = _clouds(gen, 3, emd_cuda.TILES[-1] + 1, cuda)
    wider = _clouds(gen, 3, emd_cuda.CLUSTER_MAX + 1, cuda)
    before = _route_counts()
    with pytest.raises(ValueError, match="register route takes at most"):
        emd_cuda.emd_sinkhorn(*wide, force_route="tiles")
    with pytest.raises(ValueError, match=f"cluster route takes at most {emd_cuda.CLUSTER_MAX}"):
        emd_cuda.emd_sinkhorn(*wider, force_route="cluster")
    with pytest.raises(ValueError, match="force_route"):
        emd_cuda.emd_sinkhorn(*wide, force_route="fast")
    assert _route_counts() == before


def test_emd_sinkhorn_rejects_bad_input(cuda):
    gen = torch.Generator().manual_seed(9)
    p, q = _clouds(gen, 4, 6, cuda)
    before = _route_counts()
    wide = torch.zeros((4, 6, 4), device=cuda)
    for bad_p, bad_q in ((p.double(), q.double()),               # float64
                         (p, q[:, :5].contiguous()),             # other n
                         (p[:3], q),                             # other batch
                         (wide[:, :, :3], q),                    # not contiguous
                         (p, q.cpu()),                           # another device
                         (p[:0], q[:0]),                         # empty batch
                         (p[:, :, 0], q[:, :, 0])):              # not (B, n, 3)
        with pytest.raises(ValueError):
            emd_cuda.emd_sinkhorn(bad_p, bad_q)
    big = torch.zeros((1, emd_cuda.CLUSTER_MAX + 1, 3), device=cuda)
    with pytest.raises(ValueError, match=f"at most {emd_cuda.CLUSTER_MAX}"):
        emd_cuda.emd_sinkhorn(big, big, force_route="cluster")
    with pytest.raises(ValueError, match="out of range"):
        emd_cuda.emd_sinkhorn(p, q, eps_final=0.0)
    with pytest.raises(NotImplementedError, match="no gradient"):
        emd_cuda.emd_sinkhorn(p.clone().requires_grad_(), q)
    assert _route_counts() == before
    # a jet wider than the cluster route takes runs on the wide route
    p, q = _clouds(gen, 2, emd_cuda.CLUSTER_MAX + 1, cuda)
    torch.testing.assert_close(emd_cuda.emd_sinkhorn(p, q), emd._sinkhorn_emd(p, q, 1.0, 100, 0.01),
                               rtol=2e-5, atol=1e-6)


CONV_SHAPES = [
    # (N, H, W, C, kh, kw, M, pool)
    (5, 16, 16, 1, 3, 3, 10, (2, 2)),     # the shapes of tests/test_fused_conv.py
    (3, 13, 11, 2, 3, 2, 7, (3, 3)),      # two channels, pool 3 with a low pad
    (4, 10, 10, 1, 2, 2, 5, (3, 3)),
    (2, 12, 9, 1, 3, 3, 130, (2, 2)),
    (3, 9, 9, 1, 3, 3, 4, (4, 4)),
    (1037, 16, 16, 1, 3, 3, 100, (2, 2)),  # the jet-ID tower, a ragged batch
    (9, 64, 64, 1, 3, 3, 100, (2, 2)),    # the reference's default image: bands of rows
    (3, 12, 12, 50, 3, 3, 70, (2, 2)),    # 450 taps: several tiles of maps
    (2, 7, 40, 3, 2, 5, 1024, (1, 3)),    # the most maps the gate admits
    (3, 15, 17, 1, 3, 3, 8, (2, 2)),      # odd Hc, Wc and W: the high pad, no 8-byte loads
    (4, 16, 16, 1, 3, 3, 3, (2, 2)),      # one partly live group of four maps
    (6, 16, 16, 1, 3, 3, 126, (2, 2)),    # M % 4 != 0: scalar loads of g
    (5, 14, 15, 1, 3, 3, 128, (2, 2)),    # the register route's widest
    # the bf16 register route's mma tiles (16 maps by four pooled pixels):
    (37, 15, 15, 1, 3, 3, 100, (2, 2)),   # odd image, SAME high pad, a ragged last group
    (6, 16, 16, 1, 3, 3, 1, (2, 2)),      # M = 1: one live map of a tile
    (7, 13, 16, 1, 3, 3, 7, (2, 2)),      # M = 7, odd H only
    (11, 16, 16, 1, 3, 3, 128, (2, 2)),   # M = 128, eight full tiles
]
GRAD_TOL = 2e-4


def _conv_case(shape, device, sparse, seed=0):
    n, h, wd, c, kh, kw, m, _ = shape
    gen = torch.Generator().manual_seed(seed + n + 7 * m)
    x = torch.randn((n, h, wd, c), generator=gen)
    if sparse:   # jet images: a few lit pixels, so whole pool windows tie at 0
        x = x.abs() * (torch.rand(x.shape, generator=gen) < 0.08)
    w = torch.randn((kh, kw, c, m), generator=gen) * 0.3
    b = torch.randn((m,), generator=gen) * 0.1
    return x.to(device), w.to(device), b.to(device), gen


def _conv_route(shape):
    n, h, wd, c, kh, kw, m, pool = shape
    return fused_conv_cuda.route((n, h, wd, c), (kh, kw, c, m), pool)


# K5's and K6's band routes take every shape, their register routes the
# jet-ID block's
CONV_ROUTE_CASES = [(shape, which) for shape in CONV_SHAPES for which in fused_conv_cuda.ROUTES
                    if which == "bands" or _conv_route(shape) == "tiles"]


def _conv_counts(dtype=torch.float32, direction="forward"):
    return tuple(fused_conv_cuda.launches[dtype, which, direction]
                 for which in fused_conv_cuda.ROUTES)


def _conv_backward_counts():
    return _conv_counts(direction="backward")


def _grads_close(got, want):
    """dW and db within GRAD_TOL of each leaf's largest value."""
    for got_leaf, want_leaf in zip(got, want):
        assert got_leaf.shape == want_leaf.shape
        scale = float(want_leaf.abs().max())
        assert float((got_leaf - want_leaf).abs().max()) <= GRAD_TOL * scale + 1e-12


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("shape,which", CONV_ROUTE_CASES)
def test_conv_pool_relu_matches_plain(cuda, shape, which, sparse):
    """Each route of K5 and of K6 at each shape it takes, the same bits on a
    second call and one launch counted on that route only."""
    x, w, b, gen = _conv_case(shape, cuda, sparse)
    pool = shape[-1]
    before = _conv_counts()
    got = fused_conv_cuda.conv_pool_relu(x, w, b, pool, force_route=which)
    assert _conv_counts() == (before[0] + (which == "tiles"), before[1] + (which == "bands"))
    want = fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    _close([got], [want])
    assert torch.equal(got, fused_conv_cuda.conv_pool_relu(x, w, b, pool, force_route=which))

    g = (torch.randn(want.shape, generator=gen) / shape[0]).to(cuda)
    before = _conv_backward_counts()
    dw, db = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool, force_route=which)
    assert _conv_backward_counts() == (before[0] + (which == "tiles"),
                                       before[1] + (which == "bands"))
    _grads_close((dw, db), fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, pool))
    again = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool, force_route=which)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


def test_fused_conv1_function_on_cuda_matches_cpu(cuda):
    shape = (64, 16, 16, 2, 3, 3, 12, (2, 2))
    x, w, b, _ = _conv_case(shape, "cpu", sparse=True)
    grads = {}
    for device in ("cpu", cuda):
        leaves = [t.to(device).requires_grad_() for t in (w, b)]
        out = fused_conv.fused_conv1_pool_relu(x.to(device), *leaves, shape[-1])
        grads[str(device)] = [out.detach().cpu()] + \
            [t.cpu() for t in torch.autograd.grad((out ** 2).sum(), leaves)]
    out_cpu, dw_cpu, db_cpu = grads["cpu"]
    out_dev, dw_dev, db_dev = grads[str(cuda)]
    _close([out_dev], [out_cpu])
    for got_leaf, want_leaf in ((dw_dev, dw_cpu), (db_dev, db_cpu)):
        assert float((got_leaf - want_leaf).abs().max()) <= GRAD_TOL * float(want_leaf.abs().max())


def test_conv_pool_relu_takes_the_route_of_its_shape(cuda):
    """Without force_route every shape runs the route ``route`` names, K5
    and K6 alike; K5's two routes give the same bits where both take the
    shape (one chain of FMAs a conv pixel, the same first-match rule), and
    K6's agree within the gate (their sums run in other orders)."""
    for shape in CONV_SHAPES:
        x, w, b, gen = _conv_case(shape, cuda, sparse=True)
        pool = shape[-1]
        before = _conv_counts()
        got = fused_conv_cuda.conv_pool_relu(x, w, b, pool)
        which = _conv_route(shape)
        assert _conv_counts() == (before[0] + (which == "tiles"), before[1] + (which == "bands"))
        g = (torch.randn(got.shape, generator=gen) / shape[0]).to(cuda)
        before = _conv_backward_counts()
        grads = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool)
        assert _conv_backward_counts() == (before[0] + (which == "tiles"),
                                           before[1] + (which == "bands"))
        if which == "tiles":
            assert torch.equal(got, fused_conv_cuda.conv_pool_relu(x, w, b, pool,
                                                                   force_route="bands"))
            _grads_close(grads, fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool,
                                                                        force_route="bands"))
    x, w, b, _ = _conv_case(CONV_SHAPES[1], cuda, sparse=False)
    g = torch.zeros(fused_conv_cuda.out_shape(x.shape, w.shape, CONV_SHAPES[1][-1]), device=cuda)
    before = _conv_counts() + _conv_backward_counts()
    with pytest.raises(ValueError, match="register route takes"):
        fused_conv_cuda.conv_pool_relu(x, w, b, CONV_SHAPES[1][-1], force_route="tiles")
    with pytest.raises(ValueError, match="force_route"):
        fused_conv_cuda.conv_pool_relu(x, w, b, CONV_SHAPES[1][-1], force_route="fast")
    with pytest.raises(ValueError, match="register route takes"):
        fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, CONV_SHAPES[1][-1],
                                                force_route="tiles")
    with pytest.raises(ValueError, match="force_route"):
        fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, CONV_SHAPES[1][-1],
                                                force_route="fast")
    assert _conv_counts() + _conv_backward_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", fused_conv_cuda.ROUTES)
def test_conv_backward_routes_tied_windows_to_the_first_match(cuda, which, dtype):
    """Windows that tie: w all ones sums each 3x3 sub-patch, and three of
    four 4x4 images light two pixels that several positions of their one
    window see alike.  dW must take the first position in row order, db
    count each window once, as the plain version does, bit for bit (integer
    sums, exact in bf16 too: the bf16 register route picks the first
    position by another formula than the FMA routes).  Sparse
    images whose windows tie at 0 too: an all-zero image gives db the
    window count where b > 0 and dW 0."""
    x = torch.zeros((4, 4, 4, 1))
    x[0, 0, 0] = x[0, 3, 3] = 1     # positions (0, 0) and (1, 1) tie
    x[1, 0, 3] = x[1, 3, 0] = 1     # (0, 1) and (1, 0)
    x[2, 1, 1] = x[2, 2, 2] = 1     # all four
    x[3, 1, 3] = x[3, 3, 1] = 1     # (1, 1) alone is largest: a later position takes over
    w, b = torch.ones((3, 3, 1, 8)), torch.tensor([0.5, -0.5, 0.25, 0.0, 1.0, -1.0, 2.0, 0.1])
    g = torch.ones((4, 1, 1, 8))
    x, w, b, g = (t.to(dtype) for t in (x, w, b, g))
    want = fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, (2, 2))
    args = [t.to(cuda) for t in (x, w, b, g)]
    got = fused_conv_cuda.conv_pool_relu_backward(*args, (2, 2), force_route=which)
    assert all(torch.equal(a.cpu(), r) for a, r in zip(got, want))
    assert torch.equal(want[0][:, :, 0, 0].float(),
                       torch.tensor([[1.0, 0, 2], [0, 1, 0], [1, 0, 1]]))
    zero = torch.zeros((3, 16, 16, 1), device=cuda, dtype=dtype)
    dw, db = fused_conv_cuda.conv_pool_relu_backward(
        zero, args[1], args[2], torch.ones((3, 7, 7, 8), device=cuda, dtype=dtype), (2, 2),
        force_route=which)
    assert torch.equal(db.cpu().float(), 3 * 49 * (b > 0).float())
    assert not dw.any()


def test_conv_kernels_refuse_bad_input(cuda):
    x, w, b, _ = _conv_case((4, 16, 16, 1, 3, 3, 10, (2, 2)), cuda, sparse=False)
    pool = (2, 2)
    g = torch.zeros((4, 7, 7, 10), device=cuda)
    with pytest.raises(NotImplementedError, match="records no gradient"):
        fused_conv_cuda.conv_pool_relu(x, w.clone().requires_grad_(), b, pool)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_conv_cuda.conv_pool_relu(x.double(), w, b, pool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_conv_cuda.conv_pool_relu(x, w.cpu(), b, pool)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv_cuda.conv_pool_relu(x.permute(0, 2, 1, 3), w, b, pool)
    with pytest.raises(ValueError, match="at most 512"):
        fused_conv_cuda.conv_pool_relu(torch.zeros((2, 8, 8, 64), device=cuda),
                                       torch.zeros((3, 3, 64, 4), device=cuda), b[:4], pool)
    with pytest.raises(ValueError, match="does not fit"):
        fused_conv_cuda.conv_pool_relu(x[:, :2].contiguous(), w, b, pool)
    with pytest.raises(ValueError, match="2-D pool"):
        fused_conv_cuda.conv_pool_relu(x, w, b, (2, 2, 2))
    with pytest.raises(ValueError, match="not the output's shape"):
        fused_conv_cuda.conv_pool_relu_backward(x, w, b, g[:, :6].contiguous(), pool)
    with pytest.raises(ValueError, match="shared memory"):   # the band route stages rows
        wide = torch.zeros((1, 4, 40000, 1), device=cuda)
        fused_conv_cuda.conv_pool_relu(wide, w, b, pool, force_route="bands")
    with pytest.raises(ValueError, match="shared memory"):
        fused_conv_cuda.conv_pool_relu_backward(wide, w, b, torch.zeros((1, 1, 19999, 10),
                                                                        device=cuda),
                                                pool, force_route="bands")
    # the register routes keep no row in shared memory: the same image runs
    torch.testing.assert_close(fused_conv_cuda.conv_pool_relu(wide, w, b, pool),
                               fused_conv.conv1_pool_relu_plain(wide, w, b, pool))
    g_wide = torch.randn((1, 1, 19999, 10), device=cuda)
    _grads_close(fused_conv_cuda.conv_pool_relu_backward(wide, w, b, g_wide, pool),
                 fused_conv.conv1_pool_relu_backward_plain(wide, w, b, g_wide, pool))


def _bf16_counts():
    return _conv_counts(torch.bfloat16) + _conv_counts(torch.bfloat16, "backward")


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("shape,which", CONV_ROUTE_CASES)
def test_conv_pool_relu_bf16_matches_plain(cuda, shape, which, sparse):
    """Each route of K5's and K6's bf16 forms at each shape it takes: bf16
    out, dW and db, within one bf16 ulp of the plain version, the same bits
    on a second call, one launch counted on that route's bf16 counter and
    none on the float32 ones."""
    x, w, b, gen = _conv_case(shape, cuda, sparse)
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    pool = shape[-1]
    before, before_f32 = _bf16_counts(), _conv_counts() + _conv_backward_counts()
    got = fused_conv_cuda.conv_pool_relu(x, w, b, pool, force_route=which)
    want = fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    assert got.dtype == want.dtype == torch.bfloat16
    gap = (got.float() - want.float()).abs()
    assert bool(((bf16_ulps_apart(got, want) <= 1) | (gap <= ATOL)).all()), float(gap.max())
    assert torch.equal(got, fused_conv_cuda.conv_pool_relu(x, w, b, pool, force_route=which))
    g = (torch.randn(want.shape, generator=gen) / shape[0]).to(cuda).bfloat16()
    dw, db = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool, force_route=which)
    for got_leaf, want_leaf in zip((dw, db), fused_conv.conv1_pool_relu_backward_plain(
            x, w, b, g, pool)):
        assert got_leaf.dtype == want_leaf.dtype == torch.bfloat16
        bar = GRAD_TOL * float(want_leaf.float().abs().max()) + bf16_ulp(want_leaf) + 1e-12
        assert bool(((got_leaf.float() - want_leaf.float()).abs() <= bar).all())
    again = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool, force_route=which)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    tiles = which == "tiles"
    assert _bf16_counts() == (before[0] + 2 * tiles, before[1] + 2 * (not tiles),
                              before[2] + 2 * tiles, before[3] + 2 * (not tiles))
    assert _conv_counts() + _conv_backward_counts() == before_f32


def test_conv_kernels_refuse_mixed_and_other_dtypes(cuda):
    """x, w, b and g in one dtype, float32 or bfloat16; nothing is widened
    or narrowed to run another form, and nothing is launched."""
    x, w, b, _ = _conv_case((4, 16, 16, 1, 3, 3, 8, (2, 2)), cuda, sparse=False)
    g = torch.zeros((4, 7, 7, 8), device=cuda)
    before = _bf16_counts() + _conv_counts() + _conv_backward_counts()
    with pytest.raises(ValueError, match="the dtype of x"):
        fused_conv_cuda.conv_pool_relu(x.bfloat16(), w, b, (2, 2))
    with pytest.raises(ValueError, match="the dtype of x"):
        fused_conv_cuda.conv_pool_relu(x, w, b.bfloat16(), (2, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_conv_cuda.conv_pool_relu(x.half(), w.half(), b.half(), (2, 2))
    with pytest.raises(ValueError, match="the dtype of x"):
        fused_conv_cuda.conv_pool_relu_backward(x.bfloat16(), w.bfloat16(), b.bfloat16(), g,
                                                (2, 2))
    assert _bf16_counts() + _conv_counts() + _conv_backward_counts() == before


def test_fused_conv1_function_bf16_on_cuda_matches_cpu(cuda):
    """The autograd Function in bf16: K5/K6's bf16 forms on the card, the
    plain versions on the CPU, w and b cast from float32 leaves whose
    gradients come back float32."""
    shape = (64, 16, 16, 1, 3, 3, 12, (2, 2))
    x, w, b, _ = _conv_case(shape, "cpu", sparse=True)
    results = {}
    for device in ("cpu", cuda):
        leaves = [t.to(device).requires_grad_() for t in (w, b)]
        out = fused_conv.fused_conv1_pool_relu(x.to(device).bfloat16(),
                                               *(t.bfloat16() for t in leaves), shape[-1])
        assert out.dtype == torch.bfloat16
        grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
        assert all(g.dtype == torch.float32 for g in grads)
        results[str(device)] = [out.detach().cpu()] + [g.cpu() for g in grads]
    out_cpu, dw_cpu, db_cpu = results["cpu"]
    out_dev, dw_dev, db_dev = results[str(cuda)]
    gap = (out_dev.float() - out_cpu.float()).abs()
    assert bool(((bf16_ulps_apart(out_dev, out_cpu) <= 1) | (gap <= ATOL)).all())
    for got_leaf, want_leaf in ((dw_dev, dw_cpu), (db_dev, db_cpu)):
        assert float((got_leaf - want_leaf).abs().max()) <= \
            2 ** -7 * float(want_leaf.abs().max()) + GRAD_TOL * float(want_leaf.abs().max())


def test_train_classifier_holds_cudnn_float32_with_the_flag_on(cuda, monkeypatch):
    """A library caller that leaves cuDNN's process-wide TF32 flag at its
    default (True): train_classifier still runs every convolution in float32,
    so the first step's gradients match the plain CPU path at the CLI's bars
    (3e-3 of a tower leaf's largest value, 3e-4 of a dense leaf's), and the
    flag is True again afterwards."""
    from atlasvae_torch.models import JetIDConfig, init_jetid
    from atlasvae_torch.train import jetid_loop
    config = JetIDConfig(n_classes=2, scalars=("HLVs",), scalar_dims=(6,), nn_type="CNN",
                         images=("images",), image_shapes=((16, 16),), cnn_maps=(24, 16),
                         fcn_neurons=(32, 16), branch_neurons=(32,), dropout=0.0, l2=1e-7)
    rng = np.random.default_rng(11)
    n = 512
    labels = rng.integers(0, 2, n)
    images = np.abs(rng.normal(size=(n, 16, 16))) * (rng.random((n, 16, 16)) < 0.12)
    inputs = {"HLVs": rng.normal(size=(n, 6)).astype(np.float32),
              "images": images.astype(np.float32)}
    first_grads, seen = {}, []
    real_clip, real_apply = jetid_loop.clip_gradients, jetid_loop.jetid_apply

    def clip(flat):
        first_grads.setdefault(flat.device.type, flat.detach().cpu().clone())
        return real_clip(flat)

    def apply(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_apply(*args, **kwargs)

    monkeypatch.setattr(jetid_loop, "clip_gradients", clip)
    monkeypatch.setattr(jetid_loop, "jetid_apply", apply)
    init = init_jetid(torch.Generator().manual_seed(3), config, device="cpu")
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for device in ("cpu", cuda):
            jetid_loop.train_classifier(tree_map(lambda t: t.to(device), init), config, inputs,
                                        labels, inputs, labels, epochs=1, batch_size=n,
                                        verbose=False)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert seen and not any(seen)
    sizes = [t.numel() for t in tree_flatten(init)]
    towers = [key == "towers" for key in sorted(init) for _ in tree_flatten(init[key])]
    leaves = zip(first_grads["cuda"].split(sizes), first_grads["cpu"].split(sizes), towers)
    for i, (got, want, tower) in enumerate(leaves):
        tol = 3e-3 if tower else 3e-4
        gap = (got - want).abs()
        at = int(gap.argmax())
        assert float(gap[at]) <= tol * float(want.abs().max()), \
            f"leaf {i} ({'tower' if tower else 'dense'}): gap {float(gap[at])} at {at} over " \
            f"{tol} * {float(want.abs().max())}"


def test_bf16_training_sums_in_float32_with_the_flag_on(cuda, monkeypatch):
    """bfloat16 compute on the card: cuBLAS's reduced-precision bf16 sums
    stay off inside train_classifier and predict_classifier though the
    process-wide flag is on (and on again afterwards), K5/K6 run their bf16
    forms, the master weights stay float32, and the probabilities come back
    float32 and within 1e-2 of the plain CPU path (chip_smoke.py's bf16 bar)."""
    from atlasvae_torch.models import JetIDConfig, init_jetid
    from atlasvae_torch.train import jetid_loop
    config = JetIDConfig(n_classes=2, scalars=("HLVs",), scalar_dims=(6,), nn_type="CNN",
                         images=("images",), image_shapes=((16, 16),), cnn_maps=(24, 16),
                         fcn_neurons=(32, 16), branch_neurons=(32,), dropout=0.0, l2=1e-7,
                         compute_dtype="bfloat16")
    rng = np.random.default_rng(12)
    n = 512
    labels = rng.integers(0, 2, n)
    images = np.abs(rng.normal(size=(n, 16, 16))) * (rng.random((n, 16, 16)) < 0.12)
    inputs = {"HLVs": rng.normal(size=(n, 6)).astype(np.float32),
              "images": images.astype(np.float32)}
    seen, real_apply = [], jetid_loop.jetid_apply

    def apply(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
        return real_apply(*args, **kwargs)

    monkeypatch.setattr(jetid_loop, "jetid_apply", apply)
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    before = _bf16_counts()
    try:
        init = init_jetid(torch.Generator().manual_seed(3), config, device="cpu")
        probs = {}
        for device in ("cpu", cuda):
            best, _ = jetid_loop.train_classifier(tree_map(lambda t: t.to(device), init), config,
                                                  inputs, labels, inputs, labels, epochs=1,
                                                  batch_size=256, verbose=False)
            assert all(t.dtype == torch.float32 for t in tree_flatten(best))
            probs[device] = jetid_loop.predict_classifier(tree_map(lambda t: t.to(device), init),
                                                          config, inputs)
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = flag
    assert seen and not any(seen)
    after = _bf16_counts()
    assert after[0] > before[0] and after[2] > before[2]
    assert probs[cuda].dtype == np.float32
    np.testing.assert_allclose(probs[cuda], probs["cpu"], atol=1e-2, rtol=0)


# ---- NaN and inf: every route of K1-K6 on planted non-finite inputs ----
#
# Each kernel against its plain version on the same inputs with NaN, +inf or
# -inf planted in x (and in a head gradient for K3, in g for K6): the same
# elements finite, the same NaN, the same signed infs and the finite values
# at the bars above, on every route.

NONFINITE = {"nan": float("nan"), "inf": float("inf"), "-inf": float("-inf")}


def _same_nonfinite(got, want, close):
    got, want = got.float(), want.float()
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w), f"{int((fin_g != fin_w).sum())} elements finite on one side"
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    assert not bool((nan_w & ~nan_g).any()), "a NaN of the plain version's is not NaN"
    assert torch.equal(nan_g, nan_w), f"{int((nan_g != nan_w).sum())} NaN apart"
    infs = ~fin_w & ~nan_w & ~nan_g
    assert torch.equal(got[infs], want[infs]), "infs of other signs"
    if bool(fin_w.any()):
        assert bool(close(got[fin_w], want[fin_w]).all()), "finite values past their bar"


def _dense_close(g, w):
    return (g - w).abs() <= ATOL + RTOL * w.abs()


def _leaf_close(tol, bf16=False):
    def close(g, w):
        return (g - w).abs() <= tol * float(w.abs().max()) + 1e-12 + \
            (bf16_ulp(w) if bf16 else 0.0)
    return close


# (kernel, dims, head_dims, route, batch, inside): the canonical decoder and
# encoder on the fused body, the constituents-mode decoder and encoder on the
# layer-wise route; inside: the values made inside the stack
# (tests/nonfinite_stacks.py), at a batch whose plan has a row segment after a
# row segment (K2: const_train's, 300 -> 256 on 64-column tiles, then 256 ->
# 128 on 128) or after a fused one (K1: 32 -> 64 -> 128 fused, then 128 ->
# 256), and at 1,000 rows (every row segment on 64 columns); every batch ends
# mid-tile
NONFINITE_FORWARD = [("fused_mlp", (10, 20, 40, 80), (12,), "fused", 1000, False),
                     ("fused_mlp", (32, 64, 128, 256), (300,), "layers", 1000, False),
                     ("stack_forward", (12, 80, 40, 20), (10, 10), "fused", 1000, False),
                     ("stack_forward", (300, 256, 128, 64), (32, 32), "layers", 1000, False),
                     ("fused_mlp", (32, 64, 128, 256), (300,), "layers", 9_999, True),
                     ("fused_mlp", (32, 64, 128, 256), (300,), "layers", 1000, True),
                     ("stack_forward", (300, 256, 128, 64), (32, 32), "layers", 9_999, True),
                     ("stack_forward", (300, 256, 128, 64), (32, 32), "layers", 1000, True)]


@pytest.mark.parametrize("plant", sorted(NONFINITE))
@pytest.mark.parametrize("kernel,dims,head_dims,route,batch,inside", NONFINITE_FORWARD)
def test_stack_forward_carries_non_finite_inputs(cuda, kernel, dims, head_dims, route, batch,
                                                 inside, plant):
    """K1 and K2: a plant in one element of a row, and a row all plant (the
    next layer's inf - inf); or (inside) the plant made inside the stack
    and NEAR_MAX carried as a finite value: every product after the first
    takes them as a ReLU output."""
    gen = torch.Generator().manual_seed(len(dims) + len(plant))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    if inside:
        route_stack(hidden, heads)
        rows = (7, 130, batch // 2, batch // 2 + 1, batch - 2, batch - 1)
        near = plant_inside(x, (plant,), rows)
    else:
        x[7, 3] = x[500, dims[0] - 1] = NONFINITE[plant]
        x[batch - 1, :] = NONFINITE[plant]
    plan = fused_vae.forward_plan(batch, dims, head_dims)
    assert plan.route == route
    if inside:   # the boundary under test: a row segment, then one on 128 columns past 1,000
        first = (1, 1) if kernel == "stack_forward" else (0, 0)
        assert [(g.kind, g.tile) for g in plan.segments[:2]] == [first, (1, int(batch <= 1000))]
    if kernel == "fused_mlp":
        layers = [{"w": w, "b": b} for w, b in hidden + heads]
        got, want = [fused_mlp.fused_mlp_apply(layers, x)], [fused_mlp.fused_mlp_plain(layers, x)]
    else:
        got = fused_vae.stack_forward(x, hidden, heads)
        want = fused_vae.stack_forward_plain(x, hidden, heads)
    for g, w in zip(got, want):
        assert inside and plant == "-inf" or not bool(torch.isfinite(w).all())
        if inside:   # NEAR_MAX came through: the outputs' largest finite value is it
            assert bool(torch.isfinite(w[list(near)]).all())
            assert float(w[list(near)].abs().max()) == NEAR_MAX
        _same_nonfinite(g, w, _dense_close)


@pytest.mark.parametrize("plant", sorted(NONFINITE))
@pytest.mark.parametrize("where", ["x", "g"])
@pytest.mark.parametrize("dims,head_dims,want_dx,route", [
    ((12, 80, 40, 20), (10, 10), False, "fused"),
    ((10, 20, 40, 80), (12,), True, "fused"),
    ((300, 256, 128, 64), (32, 32), False, "layers"),
    ((32, 64, 128, 256), (300,), True, "layers"),
])
def test_stack_backward_carries_non_finite_inputs(cuda, dims, head_dims, want_dx, route, where,
                                                  plant):
    """K3: a plant in x or in a head gradient; under a ReLU that is off a
    non-finite gradient gives 0 (the mask selects, as jax.nn.relu's
    gradient does)."""
    gen = torch.Generator().manual_seed(len(dims) + len(where) + len(plant))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    batch = 1000
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    grads = [(torch.randn((batch, n), generator=gen) / batch).to(cuda) for n in head_dims]
    if where == "x":
        x[77, 3] = NONFINITE[plant]
    else:
        grads[-1][123, 1] = NONFINITE[plant]
    assert fused_vae.backward_plan(batch, dims, head_dims, want_dx).route == route
    got = fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    want = fused_vae.stack_backward_plain(x, hidden, heads, grads, want_dx)
    outs = lambda r: r[0] + r[1] + ([r[2]] if want_dx else [])
    assert any(not bool(torch.isfinite(w).all()) for w in outs(want))
    for g, w in zip(outs(got), outs(want)):
        _same_nonfinite(g, w, _leaf_close(1e-5))   # 1e-5 of the leaf's largest, up to 1,000 rows


@pytest.mark.parametrize("n,which", [(100, "tiles"), (255, "cluster"), (400, "wide")])
def test_emd_sinkhorn_carries_non_finite_inputs(cuda, n, which):
    """K4 on each route: a NaN pt, a NaN phi, a +inf pt (NaN EMDs, as the
    plain version's), and a -inf pt (a dead constituent: a finite EMD)."""
    gen = torch.Generator().manual_seed(n)
    p, q = _clouds(gen, 40, n, cuda)
    for j, (col, value) in enumerate(((0, float("nan")), (2, float("nan")), (0, float("inf")),
                                      (0, float("-inf"))), start=1):
        p[5 * j, 0, col] = value
    before = _route_counts()
    got = emd_cuda.emd_sinkhorn(p, q, 1.0, 20, 0.01)
    assert _launched_on(before, which)
    want = emd._sinkhorn_emd(p, q, 1.0, 20, 0.01)
    assert int((~torch.isfinite(want)).sum()) == 3
    _same_nonfinite(got, want, lambda g, w: (g - w).abs() <= 1e-6 + 2e-5 * w.abs())


@pytest.mark.parametrize("plant", sorted(NONFINITE))
@pytest.mark.parametrize("where", ["x", "g"])
@pytest.mark.parametrize("which", fused_conv_cuda.ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_carry_non_finite_inputs(cuda, dtype, which, where, plant):
    """K5 and K6 on each route, float32 and bf16, at the jet-ID block's
    shape: a plant in a pixel of x (K6: its taps at the window's other
    positions take the NaN of the plain version's dense product) or in g
    under a ReLU that is on."""
    shape = (37, 16, 16, 1, 3, 3, 100, (2, 2))
    x, w, b, gen = _conv_case(shape, cuda, sparse=True, seed=len(plant))
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    pool = shape[-1]
    bf16 = dtype == torch.bfloat16
    lit = fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    g = (torch.randn(lit.shape, generator=gen) / 37).to(cuda).to(dtype)
    if where == "x":
        x[3, 8, 7, 0] = NONFINITE[plant]
    else:
        g[(3,) + tuple(int(i) for i in torch.unravel_index(lit[3].float().argmax(),
                                                           lit[3].shape))] = NONFINITE[plant]
    got = fused_conv_cuda.conv_pool_relu(x, w, b, pool, force_route=which)
    want = fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    fwd_close = (lambda g_, w_: (bf16_ulps_apart(g_.to(dtype), w_.to(dtype)) <= 1)
                 | ((g_ - w_).abs() <= ATOL)) if bf16 else _dense_close
    _same_nonfinite(got, want, fwd_close)
    got = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool, force_route=which)
    want = fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, pool)
    assert any(not bool(torch.isfinite(t).all()) for t in want)
    for got_leaf, want_leaf in zip(got, want):
        _same_nonfinite(got_leaf, want_leaf, _leaf_close(GRAD_TOL, bf16))
