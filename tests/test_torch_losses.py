"""The port's loss bank against ``atlasvae.losses`` on the same weights,
inputs and injected latent noise (numpy seed), for all five OE types with
beta, lambda and margin not zero.

Tolerances: the sum of each per-sample loss vector over the batch (what
a training step takes the gradient of) at rtol 1e-6, the bar of
tests/test_models_losses.py:69; each per-sample value at rtol 1e-5 with
atol 1e-5 times the vector's largest value, because the VAE forward's
float32 matrix products round in another order than XLA's, sigma =
exp(logvar / 2) magnifies the encoder's rounding in the reconstruction
(measured up to 5e-6 relative on single samples, 1.4e-5 once squared by
MSE) and a sigmoid gap near 1e-18 turns that into a large relative change
of a vanishing value; the
gradient of the summed total at rtol 1e-5 per leaf, with atol 1e-5 times
the leaf's largest value for entries that cancel to near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlasvae.losses import get_losses as jax_get_losses, reconstruction_loss as jax_recon
from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.losses import get_losses, reconstruction_loss
from atlasvae_torch.train.checkpoint import tree_flatten

OE_TYPES = ["KLD", "MSE", "MAE", "MSE-margin", "MAE-margin"]
HYPER = dict(beta=2.0, lamb=5.0, margin=1.0)
N = 64


@pytest.fixture(scope="module")
def model():
    params = jax_init_vae(jax.random.PRNGKey(2), JaxVAEConfig())
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _inputs(rng):
    x = rng.normal(size=(N, 12)).astype(np.float32)
    ood = (rng.normal(size=(N, 12)) + 0.7).astype(np.float32)
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    w_ood = rng.uniform(0.5, 1.5, N).astype(np.float32)
    noise = tuple(rng.standard_normal((N, 10)).astype(np.float32) for _ in range(2))
    return x, ood, w, w_ood, noise


@pytest.mark.parametrize("oe_type", OE_TYPES)
def test_get_losses_matches_jax(rng, model, oe_type):
    jparams, params = model
    x, ood, w, w_ood, noise = _inputs(rng)
    want = jax_get_losses(jparams, jnp.asarray(x), jnp.asarray(ood), jnp.asarray(w),
                          jnp.asarray(w_ood), jax.random.PRNGKey(0), oe_type,
                          noise=tuple(jnp.asarray(n) for n in noise), **HYPER)
    t = torch.from_numpy
    got = get_losses(params, t(x), t(ood), t(w), t(w_ood), None, oe_type,
                     noise=tuple(t(n) for n in noise), **HYPER)
    for g, v in zip(got, want):
        assert g.shape == (N,)
        v = np.asarray(v)
        np.testing.assert_allclose(g.numpy(), v, rtol=1e-5, atol=1e-5 * np.abs(v).max())
        np.testing.assert_allclose(g.double().sum().item(), np.asarray(v, np.float64).sum(),
                                   rtol=1e-6)


@pytest.mark.parametrize("oe_type", OE_TYPES)
def test_total_loss_gradient_matches_jax(rng, model, oe_type):
    jparams, params = model
    x, ood, w, w_ood, noise = _inputs(rng)

    def total(p):
        return jax_get_losses(p, jnp.asarray(x), jnp.asarray(ood), jnp.asarray(w),
                              jnp.asarray(w_ood), jax.random.PRNGKey(0), oe_type,
                              noise=tuple(jnp.asarray(n) for n in noise), **HYPER)[3].sum()

    want = jax.tree_util.tree_leaves(jax.grad(total)(jparams))
    leaves = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_()
    t = torch.from_numpy
    loss = get_losses(params, t(x), t(ood), t(w), t(w_ood), None, oe_type,
                      noise=tuple(t(n) for n in noise), **HYPER)[3].sum()
    got = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for g, v in zip(got, want):
        v = np.asarray(v)
        np.testing.assert_allclose(g.numpy(), v, rtol=1e-5, atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("oe_type", OE_TYPES)
def test_reconstruction_loss_matches_jax(rng, oe_type):
    x = rng.normal(size=(20, 12)).astype(np.float32)
    y = rng.normal(size=(20, 12)).astype(np.float32)
    np.testing.assert_allclose(
        reconstruction_loss(torch.from_numpy(x), torch.from_numpy(y), oe_type).numpy(),
        np.asarray(jax_recon(jnp.asarray(x), jnp.asarray(y), oe_type)), rtol=1e-6)


def test_losses_draw_noise_from_the_generator(model):
    _, params = model
    x = torch.randn(8, 12, generator=torch.Generator().manual_seed(1))
    w = torch.ones(8)
    runs = [get_losses(params, x, x + 1, w, w, torch.Generator().manual_seed(4), "MAE",
                       **HYPER) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise"):
        get_losses(params, x, x, w, w, None, "MAE", **HYPER)
