"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no NVIDIA GPU (a CUDA kernel has
no CPU mode).  This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: atol 1e-5, rtol 1e-5 -- the kernel sums each dot product in
order with FMAs, cuBLAS in its own blocked order; both in full float32.
The backward kernel's dW/db sum over every row of the batch: atol 1e-5
times the leaf's largest value up to 1,000 rows, and 3e-4 times it (the
bar of tests/test_fused_vae.py) over tens of thousands of rows.
"""

import numpy as np
import pytest
import torch

from atlasvae_torch.losses import get_losses
from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
from atlasvae_torch.ops import fused_mlp, fused_vae
from atlasvae_torch.train import train_model
from atlasvae_torch.train.checkpoint import tree_flatten, tree_map

pytestmark = pytest.mark.cuda

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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
