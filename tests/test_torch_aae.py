"""The port's OE-AAE model and GAN cycle (``atlasvae_torch/models/aae.py``,
``train/aae_loop.py``) against ``atlasvae`` on the CPU.

The JAX package initialises the weights and ``interop.params_from_jax``
carries them across.  Tolerances:

* ``ae_apply`` and ``discriminator_apply``: within 1e-6 of the output's
  largest magnitude (float32 products summed in another order: measured
  up to 2.5e-7 of it over five seeds).  rtol 1e-6 of each value cannot hold where the last
  dense layer cancels to a small output (an output of 0.0084 parted by
  1.5e-7, 1.8e-5 of itself), as ``tests/test_torch_vae.py`` found for the
  VAE's reconstruction (its bar: 1e-5 of the largest magnitude);
* one ``GanAdam`` step against ``make_gan_optimizer`` under ``jax.jit``
  times lr, added: bit-equal, the moments and the parameters, at the
  shared count's first step and later ones;
* the 1-cycle schedule (100 AE, 5 Disc, 5 AAE epochs, 2 or 3 batches an
  epoch, 220 or 330 shared-counter steps) against ``train_aae`` at the
  sizes of ``tests/test_reference_aae_trajectory.py``: every history
  series within 1e-6 relative (measured 1.3-2.1e-7 at lr 1e-6 and up to
  3.4e-7 at lr 1e-3 with a padded tail: float32 products and reductions in
  another order), Disc Accuracy and the (cycle, epoch) indices exact.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_gaps import assert_close

from atlasvae.models import AAEConfig as JaxAAEConfig, init_aae as jax_init_aae, \
    ae_apply as jax_ae_apply, discriminator_apply as jax_disc_apply
from atlasvae.train import aae_loop as jax_loop
from atlasvae.train.checkpoint import load_pytree as jax_load_pytree
from atlasvae_torch.interop import params_from_jax, params_to_numpy
from atlasvae_torch.models import AAEConfig, init_aae, ae_apply, discriminator_apply
from atlasvae_torch.train import aae_loop
from atlasvae_torch.train.checkpoint import load_pytree, save_pytree, tree_flatten
from atlasvae_torch.train.keras_export import export_keras_aae

CPU = torch.device("cpu")
SERIES_RTOL = 1e-6
WIDTHS = dict(input_dim=12, ae_layers=(32, 16), disc_layers=(100, 100, 3))


def _params(seed=0, **widths):
    jparams = jax_init_aae(jax.random.PRNGKey(seed), JaxAAEConfig(**(widths or WIDTHS)))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), CPU)


def test_init_has_the_jax_tree_and_keras_inits(tmp_path):
    jparams, _ = _params()
    params = init_aae(torch.Generator().manual_seed(0), AAEConfig(**WIDTHS), device=CPU)
    path = str(tmp_path / "AAE.npz")
    save_pytree(path, params)
    loaded = jax_load_pytree(path, jparams)           # the same leaves, in the same order
    assert jax.tree.structure(loaded) == jax.tree.structure(jparams)
    for got, want in zip(tree_flatten(params), jax.tree.leaves(jparams)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    for part in ("encoder", "decoder", "discriminator"):
        for layer in params[part]["hidden"] + [params[part]["out"]]:
            fan_in, fan_out = layer["w"].shape
            assert layer["w"].abs().max() <= np.sqrt(6 / (fan_in + fan_out))
            assert not layer["b"].any()
    assert [l["w"].shape[1] for l in params["decoder"]["hidden"]] == [32]
    assert params["discriminator"]["out"]["w"].shape == (100, 3)


def test_forward_matches_jax():
    jparams, params = _params(3)
    x = np.random.default_rng(0).normal(size=(500, 12)).astype(np.float32)
    recon = ae_apply(params, torch.from_numpy(x))
    probs = discriminator_apply(params, torch.from_numpy(x))
    for got, want, what in ((recon, jax_ae_apply(jparams, x), "reconstruction"),
                            (probs, jax_disc_apply(jparams, x), "probabilities")):
        want = np.asarray(want)
        assert_close(got, want, what, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert (recon >= 0).all() and torch.allclose(probs.sum(1), torch.ones(500))


def _jax_step(count, m, v, g, p, lr):
    """One jitted make_gan_optimizer update of subtree 'a', times lr, added."""
    opt = jax_loop.make_gan_optimizer()
    state = {"count": jnp.asarray(count, jnp.int32), "mu": {"a": m, "b": jnp.zeros(2)},
             "nu": {"a": v, "b": jnp.zeros(2)}}

    @jax.jit
    def step(p, g, state):
        upd, state = opt.update({"a": g}, state, ("a",))
        return optax.apply_updates({"a": p}, {"a": upd["a"] * lr})["a"], state
    p, state = step(p, g, state)
    return [np.asarray(a) for a in (p, state["mu"]["a"], state["nu"]["a"])]


@pytest.mark.parametrize("count", [0, 3, 219, 5000])
def test_gan_adam_step_is_bit_equal_to_jax(count):
    """Moments fma(b1, m, (1-b1) g) and fma(b2, v, (1-b2) g g), alpha in
    float32, sqrt correctly rounded, p = fma(u, lr, p): XLA's order."""
    rng = np.random.default_rng(count)
    n = 20_011
    p = rng.normal(0, 0.1, n).astype(np.float32)
    m = rng.normal(0, 1e-3, n).astype(np.float32) * (count > 0)
    v = np.abs(rng.normal(0, 1e-6, n)).astype(np.float32) * (count > 0)
    g = (rng.normal(0, 1e-2, n) * np.exp(rng.normal(0, 3, n))).astype(np.float32)
    lr = 1e-3
    want_p, want_m, want_v = _jax_step(count, m, v, g, p, lr)
    adam = aae_loop.GanAdam({"a": n, "b": 2}, CPU)
    adam.count = count
    adam.mu["a"], adam.nu["a"] = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    got_p = torch.from_numpy(p.copy())
    adam.step("a", got_p, torch.from_numpy(g), lr)
    assert adam.count == count + 1
    for got, want, what in ((adam.mu["a"], want_m, "mu"), (adam.nu["a"], want_v, "nu"),
                            (got_p, want_p, "params")):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def test_gan_adam_count_is_shared_and_the_frozen_subtree_passes_through():
    """Three AE steps, then the Disc subtree's first step runs at t = 4 with
    its own fresh moments: its update equals JAX's, and the AE moments are
    the same bits before and after it."""
    adam = aae_loop.GanAdam({"ae": 3, "disc": 3}, CPU)
    ae, disc = torch.zeros(3), torch.zeros(3)
    for _ in range(3):
        adam.step("ae", ae, torch.ones(3), 1.0)
    ae_moments = [t.clone() for t in (adam.mu["ae"], adam.nu["ae"])]
    assert not adam.mu["disc"].any() and not adam.nu["disc"].any()
    adam.step("disc", disc, torch.ones(3), 1.0)
    assert adam.count == 4
    for got, want in zip((adam.mu["ae"], adam.nu["ae"]), ae_moments):
        assert torch.equal(got, want)
    opt = jax_loop.make_gan_optimizer()
    state = opt.init({"encoder": jnp.zeros(3), "decoder": jnp.zeros(3),
                      "discriminator": jnp.zeros(3)})
    for _ in range(3):
        _, state = opt.update({"encoder": jnp.ones(3), "decoder": jnp.ones(3)}, state,
                              jax_loop.AE_KEYS)
    upd, _ = opt.update({"discriminator": jnp.ones(3)}, state, jax_loop.DISC_KEYS)
    np.testing.assert_allclose(disc.numpy(), np.asarray(upd["discriminator"]), rtol=1e-6)
    assert float(aae_loop.GanAdam.alpha(4)) == pytest.approx(
        np.sqrt(1 - 0.999 ** 4) / (1 - 0.9 ** 4), rel=1e-4)


def _batches(n_batches=2, batch=32, dim=12, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0, 1, (n_batches, batch, dim)), rng.normal(2, 1, (n_batches, batch, dim)),
              rng.uniform(0.5, 1.5, (n_batches, batch)), rng.uniform(0.5, 1.5, (n_batches, batch)))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in arrays)


@pytest.mark.parametrize("phase", ["ae", "disc", "aae"])
def test_each_phase_leaves_the_other_subtree_and_its_moments_alone(phase):
    _, params = _params()
    ae, disc = aae_loop.gan_states(params, CPU)
    adam = ae.adam
    fns = dict(zip(("ae", "disc", "aae"), aae_loop.make_aae_step_fns(1.0, 1.0, lr=1e-3)))
    before = {"ae": ae.flat.clone(), "disc": disc.flat.clone()}
    out = fns[phase](ae, disc, np.array([1, 0]), _batches())
    trained, frozen = ("disc", "ae") if phase == "disc" else ("ae", "disc")
    state = {"ae": ae, "disc": disc}
    assert torch.equal(state[frozen].flat, before[frozen])
    assert not torch.equal(state[trained].flat, before[trained])
    assert not adam.mu[frozen].any() and not adam.nu[frozen].any()
    assert adam.count == 2
    metrics = out[0] if phase == "aae" else out
    assert metrics.shape == (2, {"ae": 4, "disc": 2, "aae": 6}[phase])
    if phase == "aae":
        assert out[1].shape == (2,) and 0 <= out[1][1] <= 1


def _exact_weights(rng, n, batch):
    """Non-uniform weights whose every batch's float32 sum is exact (pairs
    1 + d, 1 - d with d in {0, 1/4, 1/2}), as in the reference head-to-head."""
    w = np.empty(n, np.float32)
    for s in range(0, n, batch):
        d = rng.choice([0.0, 0.25, 0.5], size=batch // 2)
        pair = np.stack([1.0 + d, 1.0 - d], 1).ravel().astype(np.float32)
        w[s:s + batch] = rng.permutation(pair)[:min(batch, n - s)]
    return w


def _sample(n, batch, seed=5, dim=12):
    rng = np.random.default_rng(seed)
    bkg_x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    ood_x = rng.normal(1.2, 1, (n, dim)).astype(np.float32)
    return {"bkg": {"HLVs": bkg_x, "weights": _exact_weights(rng, n, batch)},
            "OoD": {"HLVs": ood_x, "weights": _exact_weights(rng, n, batch)}}


@pytest.mark.parametrize("n,lr", [(256, 1e-6), (300, 1e-3)], ids=["reference", "padded"])
def test_one_cycle_trajectory_matches_jax(tmp_path, capsys, n, lr):
    """The ROADMAP's gate: the full 1-cycle schedule, every history series."""
    jparams, params = _params()
    sample = _sample(n, 128)
    kwargs = dict(n_cycles=1, batch_size=128, lamb=0.3, beta=0.5, lr=lr, seed=17,
                  feature_key="HLVs")
    os.makedirs(tmp_path / "jax")
    _, want = jax_loop.train_aae(jparams, [sample], output_dir=str(tmp_path / "jax"), **kwargs)
    got_params, got = aae_loop.train_aae(params, [sample], output_dir=str(tmp_path), **kwargs)
    assert list(got) == list(want)
    assert len(got["QCD-AE Loss"]) == 105 and len(got["Disc Loss"]) == 10
    for key in want:
        assert [e[:2] for e in got[key]] == [e[:2] for e in want[key]], key
        values = [e[2] for e in got[key]]
        assert all(type(v) is float for v in values), key
        want_values = [e[2] for e in want[key]]
        if key == "Disc Accuracy":
            assert values == want_values
        else:
            assert_close(values, want_values, key, rtol=SERIES_RTOL)
    # what the run writes, read by the JAX package
    with open(tmp_path / "history.pkl", "rb") as f:
        assert pickle.load(f) == got
    saved = jax_load_pytree(str(tmp_path / "AAE.npz"), jparams)
    for a, b in zip(jax.tree.leaves(saved), tree_flatten(params_to_numpy(got_params))):
        np.testing.assert_array_equal(a, b)
    assert "*** CYCLE 1/1 ***" in capsys.readouterr().out


def test_ae_weights_cache_round_trip(tmp_path, capsys):
    """The first run trains the 100 AE epochs and writes the AE subtree (a
    JAX-readable npz); a second run loads it and skips them, as JAX's does."""
    jparams, params = _params(**dict(WIDTHS, disc_layers=(16, 3)))
    sample = _sample(128, 64)
    kwargs = dict(batch_size=64, lamb=1.0, beta=1.0, lr=1e-3, feature_key="HLVs",
                  ae_weights="AE.npz", hist_file="", model_out="")
    trained, first = aae_loop.train_aae(params, [sample], 1, output_dir=str(tmp_path), **kwargs)
    assert "Saving pre-trained AE file" in capsys.readouterr().out
    cached = jax_load_pytree(str(tmp_path / "AE.npz"),
                             jax_loop._subtree(jparams, jax_loop.AE_KEYS))
    assert len(first["QCD-AE Loss"]) == 105
    _, again = aae_loop.train_aae(params, [sample], 2, output_dir=str(tmp_path), **kwargs)
    out = capsys.readouterr().out
    assert "Loading pre-trained AE file" in out and "TRAINING AUTOENCODER" not in out
    _, jax_again = jax_loop.train_aae(jparams, [sample], 2, output_dir=str(tmp_path), **kwargs)
    for key in jax_again:
        assert [e[:2] for e in again[key]] == [e[:2] for e in jax_again[key]], key
    assert len(again["QCD-AE Loss"]) == 10            # AAE epochs only
    assert jax.tree.structure(cached) == jax.tree.structure(
        jax_loop._subtree(jparams, jax_loop.AE_KEYS))
    # the same AE as the reference's AE-only Keras file: the same history
    ae = load_pytree(str(tmp_path / "AE.npz"), aae_loop._subtree(params, aae_loop.AE_KEYS))
    export_keras_aae({**params, **ae}, str(tmp_path / "AE.h5"), include_discriminator=False)
    _, keras_again = aae_loop.train_aae(params, [sample], 2, output_dir=str(tmp_path),
                                        **dict(kwargs, ae_weights="AE.h5"))
    assert keras_again == again


def test_first_cycle_gate_and_refusals(tmp_path):
    _, params = _params()
    sample = _sample(64, 64)
    for part in ("bkg", "OoD"):
        sample[part]["HLVs"] = sample[part]["HLVs"] * 1e4      # MAE far above 100
    with pytest.raises(RuntimeError, match=">= 100"):
        aae_loop.train_aae(params, [sample], 1, 64, str(tmp_path), ae_weights="AE.npz",
                           feature_key="HLVs")
    assert not (tmp_path / "AE.npz").exists()
    with open(tmp_path / "AE.h5", "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
    with pytest.raises(OSError):                  # a broken Keras file: no fallback
        aae_loop.train_aae(params, [sample], 1, 64, str(tmp_path), ae_weights="AE.h5",
                           feature_key="HLVs")
    # once refused (ROADMAP Queue 1 item 11), now run: the cycle over a mesh
    # of one rank keeps the history of the cycle without one, at the data-
    # parallel bar of tests/test_aae.py:246
    from atlasvae_torch.parallel import data_parallel_mesh
    from torch_dist_checks import one_rank_group
    kwargs = dict(lamb=1.0, beta=1.0, lr=1e-3, feature_key="HLVs", hist_file="", model_out="")
    _, one = aae_loop.train_aae(params, [_sample(64, 64)], 1, 32, str(tmp_path), **kwargs)
    with one_rank_group(tmp_path):
        _, ranked = aae_loop.train_aae(params, [_sample(64, 64)], 1, 32, str(tmp_path),
                                       mesh=data_parallel_mesh(), **kwargs)
    assert set(one) == set(ranked)
    for key in one:
        assert_close(np.asarray([v for _, _, v in ranked[key]]),
                     np.asarray([v for _, _, v in one[key]]), key, rtol=5e-3, atol=1e-5)
