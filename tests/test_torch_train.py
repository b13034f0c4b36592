"""The port's training step, loop and checkpoints against ``atlasvae.train``.

Same weights, loads and injected latent noise on both sides (numpy
seeds).  Tolerances:

* one Adam update against ``optax.adam(1.0)`` times lr: rtol 1e-6 (the
  port follows XLA's evaluation order; its float32 bias corrections can
  differ from XLA's ``powf`` by one ulp);
* 5-epoch loss trajectories of ``train_model``: 1e-6 relative on every
  history key of every epoch, the bar of tests/test_reference_parity.py
  (measured: 2.2e-7 at most);
* parameters after 3 JAX steps carried across and 2 more steps on each
  side: rtol 1e-6 with atol 1e-6 times the leaf's largest value;
* packing, clipping, checkpoint decisions and resume: exact.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae.train import checkpoint as jax_checkpoint
from atlasvae.train.loop import train_model as jax_train_model, \
    model_checkpoint as jax_model_checkpoint
from atlasvae.train.step import batch_load as jax_batch_load, clip_gradients as jax_clip, \
    make_vae_step_fns as jax_make_step_fns
from atlasvae_torch.interop import params_from_jax, params_to_numpy, adam_state_from_jax
from atlasvae_torch.train import (train_model, model_checkpoint, batch_load, clip_gradients,
                                  make_vae_step_fns, TrainState, LoadCache, load_history)
from atlasvae_torch.train.checkpoint import tree_flatten
from atlasvae_torch.train.step import to_device

CPU = torch.device("cpu")
LATENT = 8
CFG = JaxVAEConfig(fc_layers=(32, 16, LATENT), input_dim=12)
HYPER = dict(beta=2.0, lamb=5.0, margin=1.0)


def _jax_params(seed=0):
    return jax_init_vae(jax.random.PRNGKey(seed), CFG)


def _to_port(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _toy_load(n, seed=0, unit_weights=False):
    rng = np.random.default_rng(seed)
    weights = lambda: np.ones(n, np.float32) if unit_weights else \
        rng.uniform(0.5, 1.5, n).astype(np.float32)
    bkg = {"HLVs": rng.normal(0, 1, (n, 12)).astype(np.float32), "weights": weights()}
    ood = {"HLVs": rng.normal(1.5, 1, (n, 12)).astype(np.float32), "weights": weights()}
    return bkg, ood


def _noise_source(seed=123):
    """One standard-normal draw per (phase, epoch, load), shaped as asked."""
    rng = np.random.default_rng(seed)
    cache = {}

    def source(phase, epoch, load_idx, n_batches, batch):
        key = (phase, epoch, load_idx, n_batches, batch)
        if key not in cache:
            cache[key] = tuple(rng.standard_normal((n_batches, batch, LATENT))
                               .astype(np.float32) for _ in range(2))
        return cache[key]
    return source


def test_adam_update_matches_optax(rng):
    jparams = _jax_params(1)
    opt = optax.adam(1.0)
    opt_state = opt.init(jparams)

    @jax.jit
    def step(p, s, g, lr):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, jax.tree.map(lambda a: a * lr, u)), s

    state = TrainState(_to_port(jparams))
    lr = np.float32(1e-3)
    for _ in range(6):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape) * 10 ** rng.uniform(-5, 2),
                                  jnp.float32), jparams)
        jparams, opt_state = step(jparams, opt_state, grads, lr)
        flat = torch.cat([torch.from_numpy(np.asarray(g)).reshape(-1)
                          for g in jax.tree_util.tree_leaves(grads)])
        state.adam.step(state.flat, flat, lr)
    assert state.adam.count == int(opt_state[0].count)
    for got, want in zip(tree_flatten(state.params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    for got, want in ((state.adam.mu, opt_state[0].mu), (state.adam.nu, opt_state[0].nu)):
        want = np.concatenate([np.asarray(a).ravel() for a in jax.tree_util.tree_leaves(want)])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_clip_gradients_guard():
    values = [1.0, np.inf, -np.inf, np.nan, 2e6, -2e6, -3.5]
    got = clip_gradients(torch.tensor(values)).numpy()
    np.testing.assert_array_equal(got, [1.0, 0.0, 0.0, 0.0, 1e6, -1e6, -3.5])
    np.testing.assert_array_equal(got, np.asarray(jax_clip(jnp.asarray(values, jnp.float32))))


@pytest.mark.parametrize("n,batch,n_devices", [(1003, 250, 1), (1000, 250, 1), (7, 3, 4),
                                               (0, 5, 1)])
def test_batch_load_matches_jax(rng, n, batch, n_devices):
    args = (rng.normal(size=(n, 12)), rng.normal(size=(n, 12)), rng.uniform(size=n),
            rng.uniform(size=n))
    got = batch_load(*args, batch, n_devices)
    want = jax_batch_load(*args, batch, n_devices)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[-1].sum() == n


@pytest.mark.parametrize("hist,lr,count", [
    ([5.0, 4.0], 1e-3, 0),                 # improves: saves, count 0
    ([5.0, 5.0], 1e-3, 1),                 # plateau: count 1 -> 2
    ([5.0, 4.0, 4.0, 4.0, 4.0], 1e-3, 2),  # third epoch without gain: lr halved
    ([5.0, 5.0], 5e-5, 2),                 # below min_lr at patience: terminate
    ([5.0, 4.0, 3.9995], 1e-3, 1),         # gain under min_delta: counts
])
def test_model_checkpoint_matches_jax(tmp_path, hist, lr, count):
    jparams = _jax_params(3)
    out_j, out_t = tmp_path / "jax.npz", tmp_path / "port.npz"
    want = jax_model_checkpoint(jparams, lr, {"Train loss": hist}, str(out_j), count)
    got = model_checkpoint(_to_port(jparams), lr, {"Train loss": hist}, str(out_t), count)
    assert got == want
    assert out_t.exists() == out_j.exists()


@pytest.fixture(scope="module")
def trajectories():
    """train_model of both packages: same weights, loads, noise; 5 epochs
    of 8 batches, in the setup of tests/test_reference_parity.py (unit
    sample weights).  Adam's per-element normalization turns the rounding
    of a gradient element that is small against its leaf into an update
    error of order lr times its relative error, so the trajectories part
    at a rate that depends on the data: with weights drawn from U(0.5, 1.5)
    one seed parts to 3e-5 by epoch 5 while its per-step gradients agree
    to 4e-7 of each leaf's scale."""
    out = {}
    for case, n in (("exact", 4000), ("padded", 3900)):
        bkg, ood = _toy_load(n, unit_weights=True)
        jparams = _jax_params()
        kw = dict(oe_type="MAE", n_epochs=5, batch_size=500, lr=1e-3, **HYPER)
        _, want = jax_train_model(jparams, [(bkg, ood)], [(bkg, ood)],
                                  noise_source=_noise_source(), **kw)
        _, got = train_model(_to_port(jparams), [(bkg, ood)], [(bkg, ood)],
                             noise_source=_noise_source(), **kw)
        out[case] = got, want
    return out


@pytest.mark.parametrize("case", ["exact", "padded"])
def test_five_epoch_trajectory_matches_jax(trajectories, case):
    got, want = trajectories[case]
    assert list(got) == list(want) == ["MSE", "KLD", "OE", "Train loss", "Valid loss"]
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == (5,)
        rel = np.abs(g - w) / np.abs(w)
        assert rel.max() < 1e-6, f"{key}: rel diff {rel}"
    assert got["Train loss"][-1] < got["Train loss"][0]


def test_resume_from_state_file_is_bit_exact(tmp_path):
    bkg, ood = _toy_load(600, seed=4)
    kw = dict(oe_type="MAE", batch_size=200, lr=1e-3, seed=7, **HYPER)
    params = _to_port(_jax_params(5))
    straight, hist = train_model(params, [(bkg, ood)], [(bkg, ood)], n_epochs=4,
                                 hist_file=str(tmp_path / "straight.pkl"), **kw)
    state, hist_file = str(tmp_path / "state.npz"), str(tmp_path / "history.pkl")
    train_model(params, [(bkg, ood)], [(bkg, ood)], n_epochs=2, state_file=state,
                hist_file=hist_file, **kw)
    resumed, hist2 = train_model(params, [(bkg, ood)], [(bkg, ood)], n_epochs=2,
                                 state_file=state, hist_file=hist_file, **kw)
    assert hist2 == hist
    for a, b in zip(tree_flatten(straight), tree_flatten(resumed)):
        assert torch.equal(a, b)


def test_state_file_termination_marker_is_not_resumed_past(tmp_path):
    bkg, ood = _toy_load(200, seed=9)
    state = str(tmp_path / "state.npz")
    params, _ = train_model(_to_port(_jax_params()), [(bkg, ood)], [(bkg, ood)], "MAE", 1,
                            100, state_file=state, **HYPER)
    with np.load(state) as data:
        leaves = dict(data)
    # leaf order: adam_count, adam_mu, adam_nu, count, generator, lr, params...
    assert leaves["leaf_3"] == 0
    leaves["leaf_3"] = np.asarray(-1)
    np.savez(state, **leaves)
    again, hist = train_model(_to_port(_jax_params()), [(bkg, ood)], [(bkg, ood)], "MAE", 3,
                              100, state_file=state, **HYPER)
    assert hist["Train loss"] == []
    for a, b in zip(tree_flatten(params), tree_flatten(again)):
        assert torch.equal(a, b)


def test_history_pickle_is_read_by_jax(tmp_path):
    bkg, ood = _toy_load(300, seed=6)
    path = str(tmp_path / "history.pkl")
    _, hist = train_model(_to_port(_jax_params()), [(bkg, ood)], [(bkg, ood)], "MAE", 2,
                          150, hist_file=path, **HYPER)
    read = jax_checkpoint.load_history(path)
    assert read == hist == load_history(path)
    assert all(type(v) is float for vals in read.values() for v in vals)
    with open(path, "rb") as f:
        assert pickle.load(f) == hist


def _carry_across_and_step(rng, jparams, latent):
    """3 JAX steps, the parameters and Adam state carried across, then two
    more steps on each side; returns (the port's state, JAX's parameters)."""
    n_batches, batch = 5, 128
    bkg, ood = _toy_load(n_batches * batch, seed=8)
    batches = jax_batch_load(bkg["HLVs"], ood["HLVs"], bkg["weights"], ood["weights"], batch)
    noise = tuple(rng.standard_normal((n_batches, batch, latent)).astype(np.float32)
                  for _ in range(2))
    opt = optax.adam(1.0)
    jax_step, _ = jax_make_step_fns(opt, "MAE", external_noise=True, **HYPER)
    lr = np.float32(1e-3)
    key = jax.random.PRNGKey(0)
    first = lambda a: a[:3]
    rest = lambda a: a[3:]
    jparams, opt_state, _ = jax_step(jparams, opt.init(jparams), lr, key,
                                     *map(first, batches), *map(first, noise))
    # carry params and Adam state across, then two more steps on each side
    state = TrainState(params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
                       adam_state_from_jax(jax.tree.map(np.asarray, opt_state), "cpu"))
    assert state.adam.count == 3
    want, _, _ = jax_step(jparams, opt_state, lr, key, *map(rest, batches), *map(rest, noise))
    port_step, _ = make_vae_step_fns("MAE", **HYPER)
    port_step(state, lr, None, to_device(map(rest, batches), CPU),
              to_device(map(rest, noise), CPU))
    return state, want


def _assert_params_match(state, want):
    for got, w in zip(tree_flatten(state.params), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


def test_adam_state_carries_across_from_jax(rng):
    state, want = _carry_across_and_step(rng, _jax_params(2), LATENT)
    _assert_params_match(state, want)
    assert params_to_numpy(state.detached())["encoder"]["mean"]["w"].shape == (16, LATENT)


def test_deep_stack_train_steps_match_jax(rng):
    """--FC_layers of 10 entries (9 hidden layers a side, deeper than one
    fused launch takes on the card): the same steps as above, the same bar."""
    deep = JaxVAEConfig(fc_layers=(80, 80, 60, 60, 40, 40, 30, 20, 20, 10), input_dim=12)
    state, want = _carry_across_and_step(rng, jax_init_vae(jax.random.PRNGKey(2), deep), 10)
    assert len(state.params["encoder"]["hidden"]) == len(state.params["decoder"]["hidden"]) == 9
    _assert_params_match(state, want)


def test_train_state_leaves_are_views_of_one_tensor():
    state = TrainState(_to_port(_jax_params()))
    assert sum(v.numel() for v in state.leaves) == state.flat.numel()
    with torch.no_grad():
        state.flat.zero_()
    assert all(not v.any() for v in state.leaves)
    assert all(v.requires_grad and v.is_leaf for v in state.leaves)


def test_load_cache_identity_and_budget():
    bkg, ood = _toy_load(10)
    calls = []

    def build():
        calls.append(1)
        return batch_load(bkg["HLVs"], ood["HLVs"], bkg["weights"], ood["weights"], 4)

    cache = LoadCache(CPU)
    first = cache.get((bkg, ood), (4, 1), build)
    assert cache.get((bkg, ood), (4, 1), build) is first and len(calls) == 1
    cache.get((dict(bkg), ood), (4, 1), build)       # another object: rebuilt
    assert len(calls) == 2
    tiny = LoadCache(CPU, budget_bytes=16)            # over budget: never kept
    tiny.get((bkg, ood), (4, 1), build)
    tiny.get((bkg, ood), (4, 1), build)
    assert len(calls) == 4 and all(isinstance(b, torch.Tensor) for b in first)
