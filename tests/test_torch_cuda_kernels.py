"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no NVIDIA GPU (a CUDA kernel has
no CPU mode).  This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: atol 1e-5, rtol 1e-5 -- the kernel sums each dot product in
order with FMAs, cuBLAS in its own blocked order; both in full float32.
"""

import pytest
import torch

from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
from atlasvae_torch.ops import fused_mlp, fused_vae
from atlasvae_torch.train.checkpoint import tree_map

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
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_vae.stack_forward(x.requires_grad_(), hidden, heads)
    with pytest.raises(ValueError):
        fused_vae.stack_forward(x.detach().double(), hidden, heads)
    with pytest.raises(ValueError):
        fused_vae.stack_forward(x.detach()[:, :5], hidden, heads)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_apply(layers, x.detach().t())
