"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no NVIDIA GPU (a CUDA kernel has
no CPU mode).  This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: atol 1e-5, rtol 1e-5 -- the kernel sums each dot product in
order with FMAs, cuBLAS in its own blocked order; both in full float32.
The backward kernel's dW/db sum over every row of the batch: atol 1e-5
times the leaf's largest value up to 1,000 rows, and 3e-4 times it (the
bar of tests/test_fused_vae.py) over tens of thousands of rows.  The
Sinkhorn EMD kernel: rtol 2e-5, atol 1e-6, the bar the JAX package holds
its two forms of that function to (tests/test_emd.py); where the EMD is
small beside the jets' total pt (a cloud against a permuted copy of itself)
the atol is 1e-5 of the total pt, which is what float32 gives either form.
The fused conv block (K5): atol 1e-5 + rtol 1e-5 against the plain version,
whose convolution runs in full float32 (cuDNN's TF32 is turned off here);
its backward (K6): dW and db within 2e-4 of each leaf's largest value, the
bar of tests/test_fused_conv.py, and the same bits on a second call.
"""

import numpy as np
import pytest
import torch

from atlasvae_torch.losses import get_losses
from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
from atlasvae_torch.ops import emd, emd_cuda, fused_conv, fused_conv_cuda, fused_mlp, fused_vae
from atlasvae_torch.train import train_model
from atlasvae_torch.train.checkpoint import tree_flatten, tree_map

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


@pytest.mark.parametrize("batch", [1, 7, 129, 1000])
@pytest.mark.parametrize("dims,head_dims", [
    ((12, 80, 40, 20), (10, 10)),      # canonical encoder
    ((5,), (3,)),                      # heads only
    ((3, 1, 7), (2, 2, 2, 2)),         # four heads, width 1
    ((130, 33, 9), (5, 6)),            # 32-row tiles (width > 128)
    ((312, 256, 128, 64), (32, 32)),   # constituents-mode encoder
    ((10, 20, 40, 80), (12,)),         # canonical decoder (training forward)
])
def test_stack_forward_matches_plain(cuda, batch, dims, head_dims):
    gen = torch.Generator().manual_seed(batch * 1000 + len(dims))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    before = fused_vae.launches
    got = fused_vae.stack_forward(x, hidden, heads)
    assert fused_vae.launches == before + 1
    _close(got, fused_vae.stack_forward_plain(x, hidden, heads))


@pytest.mark.parametrize("batch", [1, 127, 128, 1001])
@pytest.mark.parametrize("dims", [(10, 20, 40, 80, 12), (7, 3), (32, 256, 313, 5)])
@pytest.mark.parametrize("final", ["linear", "relu"])
def test_fused_mlp_matches_plain(cuda, batch, dims, final):
    gen = torch.Generator().manual_seed(batch * 100 + len(dims))
    hidden, heads = _stack(gen, dims[:-1], dims[-1:], cuda)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    before = fused_mlp.launches
    got = fused_mlp.fused_mlp_apply(layers, x, final_activation=final)
    assert fused_mlp.launches == before + 1
    _close([got], [fused_mlp.fused_mlp_plain(layers, x, final_activation=final)])


def test_vae_apply_on_cuda_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    params = init_vae(gen, VAEConfig(), device="cpu")
    x = torch.randn((777, 12), generator=gen)
    noise = torch.randn((777, 10), generator=gen)
    want = vae_apply(params, x, noise=noise)
    on_card = tree_map(lambda t: t.to(cuda), params)
    with torch.inference_mode():
        got = vae_apply(on_card, x.to(cuda), noise=noise.to(cuda))
    _close([g.cpu() for g in got], want)


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


def _close_grads(got, want, scale_tol):
    dws, dbs, dx = got
    for g, w in zip(dws + dbs, want[0] + want[1]):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=scale_tol * float(w.abs().max()))
    if want[2] is None:
        assert dx is None
    else:
        torch.testing.assert_close(dx, want[2], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("batch", [1, 7, 65, 1000])
@pytest.mark.parametrize("dims,head_dims,want_dx", [
    ((12, 80, 40, 20), (10, 10), False),   # canonical encoder
    ((10, 20, 40, 80), (12,), True),       # canonical decoder, dz
    ((5,), (3,), True),                    # heads only
    ((3, 1, 7), (2, 2, 2, 2), True),       # four heads, width 1
    ((13, 17, 9), (5, 5), False),          # odd widths
    ((130, 33, 9), (5, 6), True),          # 32-row tiles (width > 128)
])
def test_stack_backward_matches_plain(cuda, batch, dims, head_dims, want_dx):
    gen = torch.Generator().manual_seed(batch * 10 + len(dims))
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    grads = [(torch.randn((batch, n), generator=gen) / batch).to(cuda) for n in head_dims]
    before = fused_vae.backward_launches
    got = fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    assert fused_vae.backward_launches == before + 1
    _close_grads(got, fused_vae.stack_backward_plain(x, hidden, heads, grads, want_dx), 1e-5)
    again = fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    for a, b in zip(got[0] + got[1], again[0] + again[1]):
        assert torch.equal(a, b)   # per-CTA partials summed in a fixed order


def test_stack_backward_rejects_bad_head_gradients(cuda):
    gen = torch.Generator().manual_seed(5)
    hidden, heads = _stack(gen, (6, 4), (2, 3), cuda)
    x = torch.randn((9, 6), generator=gen).to(cuda)
    good = [torch.randn((9, 2), generator=gen).to(cuda),
            torch.randn((9, 3), generator=gen).to(cuda)]
    wide = torch.randn((9, 6), generator=gen).to(cuda)
    before = fused_vae.backward_launches
    for grads in (good[:1],                                 # one gradient for two heads
                  [good[0], good[1][:8].contiguous()],     # wrong shape
                  [good[0], good[1].double()],             # float64
                  [good[0], wide[:, :3]],                  # not contiguous
                  [good[0], good[1].cpu()]):               # another device
        with pytest.raises(ValueError):
            fused_vae.stack_backward(x, hidden, heads, grads, True)
    with pytest.raises(ValueError, match="empty batch"):
        fused_vae.stack_backward(x[:0], hidden, heads, [g[:0] for g in good], True)
    assert fused_vae.backward_launches == before


@pytest.mark.parametrize("batch", [64 * 264 * 2 + 5, 32 * 264 + 33])
def test_stack_backward_many_tiles_per_cta(cuda, batch):
    dims, head_dims = ((12, 80, 40, 20), (10, 10)) if batch > 20000 else \
        ((200, 64, 16), (8, 8))
    gen = torch.Generator().manual_seed(batch)
    hidden, heads = _stack(gen, dims, head_dims, cuda)
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    grads = [(torch.randn((batch, n), generator=gen) / batch).to(cuda) for n in head_dims]
    got = fused_vae.stack_backward(x, hidden, heads, grads, True)
    _close_grads(got, fused_vae.stack_backward_plain(x, hidden, heads, grads, True), 3e-4)


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
                                             (3, 1, 100), (50, 33, 25), (50, 16, 3)])
def test_emd_sinkhorn_matches_plain(cuda, batch, n, n_iters):
    gen = torch.Generator().manual_seed(batch + n)
    p, q = _clouds(gen, batch, n, cuda)
    before = emd_cuda.launches
    got = emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, 0.01)
    assert emd_cuda.launches == before + 1
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
@pytest.mark.parametrize("batch,n", [(512, 100), (64, emd_cuda.MAX_CONST)])
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


def test_emd_sinkhorn_rejects_bad_input(cuda):
    gen = torch.Generator().manual_seed(9)
    p, q = _clouds(gen, 4, 6, cuda)
    before = emd_cuda.launches
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
    big = torch.zeros((1, emd_cuda.MAX_CONST + 1, 3), device=cuda)
    with pytest.raises(ValueError, match=f"at most {emd_cuda.MAX_CONST}"):
        emd_cuda.emd_sinkhorn(big, big)
    with pytest.raises(ValueError, match="out of range"):
        emd_cuda.emd_sinkhorn(p, q, eps_final=0.0)
    with pytest.raises(NotImplementedError, match="no gradient"):
        emd_cuda.emd_sinkhorn(p.clone().requires_grad_(), q)
    assert emd_cuda.launches == before
    # the widest jet the kernel takes still runs
    p, q = _clouds(gen, 2, emd_cuda.MAX_CONST, cuda)
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


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_pool_relu_matches_plain(cuda, shape, sparse):
    x, w, b, gen = _conv_case(shape, cuda, sparse)
    pool = shape[-1]
    before = fused_conv_cuda.launches
    got = fused_conv_cuda.conv_pool_relu(x, w, b, pool)
    assert fused_conv_cuda.launches == before + 1
    want = fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    _close([got], [want])

    g = (torch.randn(want.shape, generator=gen) / shape[0]).to(cuda)
    before = fused_conv_cuda.backward_launches
    dw, db = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool)
    assert fused_conv_cuda.backward_launches == before + 1
    dw_want, db_want = fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, pool)
    for got_leaf, want_leaf in ((dw, dw_want), (db, db_want)):
        assert got_leaf.shape == want_leaf.shape
        scale = float(want_leaf.abs().max())
        assert float((got_leaf - want_leaf).abs().max()) <= GRAD_TOL * scale + 1e-12
    again = fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool)
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
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros((1, 4, 40000, 1), device=cuda)
        fused_conv_cuda.conv_pool_relu(wide, w, b, pool)
