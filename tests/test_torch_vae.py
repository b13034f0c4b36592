"""The port's VAE model, KLD and checkpoint format against the JAX package.

Same weights (carried across with interop.params_from_jax) and the same
injected latent noise on both sides.  Tolerances: encoder outputs and KLD
atol and rtol 1e-5 (float32 matmuls summed in different orders by XLA and
torch on the CPU); the reconstruction rtol 1e-5 and atol 1e-5 times its
largest magnitude, because sigma = exp(logvar / 2) scales the encoder's
rounding differences before the decoder sees them; clip_values exact;
checkpoints bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlasvae.losses import kld_loss as jax_kld_loss
from atlasvae.models import (VAEConfig as JaxVAEConfig, init_vae as jax_init_vae,
                             vae_apply as jax_vae_apply, clip_values as jax_clip_values)
from atlasvae.train.checkpoint import save_weights as jax_save_weights, \
    load_pytree as jax_load_pytree
from atlasvae_torch.interop import params_from_jax, params_to_numpy
from atlasvae_torch.losses import kld_loss
from atlasvae_torch.models import VAEConfig, init_vae, vae_apply, clip_values, reparameterize
from atlasvae_torch.train.checkpoint import (load_pytree, save_pytree, tree_flatten,
                                             tree_unflatten)

TOL = dict(atol=1e-5, rtol=1e-5)
DEEP_FC_LAYERS = (80, 80, 60, 60, 40, 40, 30, 20, 20, 10)


def _pair(fc_layers, input_dim, seed=0):
    params = jax_init_vae(jax.random.PRNGKey(seed), JaxVAEConfig(fc_layers, input_dim))
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("fc_layers,input_dim", [((80, 40, 20, 10), 12),
                                                 ((256, 128, 64, 32), 312),
                                                 # --FC_layers of 10 entries: 9 hidden
                                                 # layers each side
                                                 (DEEP_FC_LAYERS, 12)])
def test_vae_apply_matches_jax_with_same_noise(rng, fc_layers, input_dim):
    jparams, params = _pair(fc_layers, input_dim)
    x = rng.normal(size=(200, input_dim)).astype(np.float32)
    noise = rng.normal(size=(200, fc_layers[-1])).astype(np.float32)
    want = jax_vae_apply(jparams, x, jax.random.PRNGKey(0), noise=noise)
    got = vae_apply(params, torch.from_numpy(x), noise=torch.from_numpy(noise))
    recon = np.asarray(want[0])
    np.testing.assert_allclose(got[0].numpy(), recon, rtol=1e-5,
                               atol=1e-5 * np.abs(recon).max())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_vae_apply_without_sampling_decodes_the_mean(rng):
    jparams, params = _pair((80, 40, 20, 10), 12, seed=2)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    want = jax_vae_apply(jparams, x, jax.random.PRNGKey(0), sample=False)[0]
    got = vae_apply(params, torch.from_numpy(x), sample=False)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_values_matches_jax_exactly():
    x = np.array([np.inf, -np.inf, np.nan, 2e6, -2e6, 1e6, -1e6, 3.5, -0.0, 0.0],
                 np.float32)
    got = clip_values(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_clip_values(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:5], [0, 0, 0, 1e6, -1e6])


def test_kld_loss_matches_jax(rng):
    mean = rng.normal(size=(64, 10)).astype(np.float32)
    logvar = rng.normal(scale=3.0, size=(64, 10)).astype(np.float32)
    logvar[0, 0] = 40.0  # exp overflows the 1e6 clip
    got = kld_loss(torch.from_numpy(mean), torch.from_numpy(logvar)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_kld_loss(mean, logvar)), **TOL)


def test_reparameterize_needs_noise_or_generator():
    z = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="Generator"):
        reparameterize(z, z)
    a = reparameterize(z, z, generator=torch.Generator().manual_seed(1))
    b = reparameterize(z, z, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_init_vae_tree_and_statistics():
    jparams = jax_init_vae(jax.random.PRNGKey(0), JaxVAEConfig((256, 128, 64, 32), 312))
    params = init_vae(torch.Generator().manual_seed(0),
                      VAEConfig((256, 128, 64, 32), 312), device="cpu")
    shapes = [tuple(l.shape) for l in tree_flatten(params)]
    assert shapes == [tuple(l.shape) for l in jax.tree_util.tree_flatten(jparams)[0]]
    w0 = params["encoder"]["hidden"][0]["w"]
    assert abs(float(w0.std()) - np.sqrt(2 / 312)) < 0.05 * np.sqrt(2 / 312)   # he_normal
    b0 = params["encoder"]["hidden"][0]["b"]
    assert abs(float(b0.std()) - 1.0) < 0.2                                    # N(0, 1) bias
    head = params["encoder"]["mean"]
    limit = np.sqrt(6 / (64 + 32))                                             # glorot_uniform
    assert float(head["w"].abs().max()) <= limit and float(head["w"].abs().max()) > 0.9 * limit
    assert torch.equal(head["b"], torch.zeros(32))


def test_tree_flatten_order_is_jax_order():
    jparams = jax_init_vae(jax.random.PRNGKey(1), JaxVAEConfig())
    leaves, _ = jax.tree_util.tree_flatten(jparams)
    ported = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    for got, want in zip(tree_flatten(ported), leaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tree_unflatten(ported, tree_flatten(ported))["decoder"]["out"]["w"] is \
        ported["decoder"]["out"]["w"]
    with pytest.raises(ValueError):
        tree_unflatten(ported, tree_flatten(ported) + [torch.zeros(1)])


def test_checkpoint_round_trips_with_jax(tmp_path):
    jparams = jax_init_vae(jax.random.PRNGKey(3), JaxVAEConfig())
    jax_save_weights(jparams, tmp_path / "jax.npz")
    template = init_vae(torch.Generator().manual_seed(9), VAEConfig(), device="cpu")
    loaded = load_pytree(tmp_path / "jax.npz", template)
    back = params_to_numpy(loaded)
    for got, want in zip(tree_flatten(back), jax.tree_util.tree_flatten(jparams)[0]):
        np.testing.assert_array_equal(got, np.asarray(want))
    save_pytree(tmp_path / "port.npz", loaded)
    again = jax_load_pytree(tmp_path / "port.npz", jparams)
    for got, want in zip(jax.tree_util.tree_flatten(again)[0],
                         jax.tree_util.tree_flatten(jparams)[0]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_load_pytree_rejects_wrong_shapes(tmp_path):
    save_pytree(tmp_path / "small.npz", init_vae(torch.Generator().manual_seed(0),
                                                  VAEConfig((8, 4), 12), device="cpu"))
    template = init_vae(torch.Generator().manual_seed(0), VAEConfig((8, 4), 13), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_pytree(tmp_path / "small.npz", template)
