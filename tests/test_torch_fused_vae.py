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


@pytest.mark.parametrize("case,error", [
    ("width", ValueError), ("head", ValueError), ("dtype", ValueError),
    ("layout", ValueError), ("too_wide", ValueError), ("heads", ValueError),
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
    elif case == "too_wide":
        hidden, heads = _stack((cuda_build.MAX_WIDTH + 1, 4), (2,))
        x = torch.zeros(3, cuda_build.MAX_WIDTH + 1)
    elif case == "heads":
        heads = heads * (cuda_build.MAX_HEADS + 1)
    elif case == "grad":
        x.requires_grad_()
    with pytest.raises(error):
        cuda_build.check_stack(x, hidden, heads, "stack_forward")
