"""``atlasvae_torch.train.ensemble`` against the port's sequential runs and
against the JAX package.

* Each lane of ``train_ensemble`` equals the port's ``train_model`` for its
  config bit for bit: the same steps on the same batches, its own Adam and
  its own generator (or injected noise), accumulated in the same order.
* Each lane against the JAX package's ``train_model(noise_source=...)`` from
  the same weights (``interop``) and noise: the bars of
  tests/test_torch_train.py, 1e-6 relative on every history key of every
  epoch, and the final parameters within 1e-6 relative plus 1e-6 of each
  leaf's largest value (the five-epoch setup there, unit sample weights).
* A JAX ensemble's stacked weights and per-lane Adam state carried into
  lanes (``interop.lanes_from_jax``): two more steps on each side within the
  parameter bar above.
* A lane at lr 0 or stopped by the plateau schedule keeps its parameters bit
  for bit; lanes that differ only in their seed differ; a state-file resume
  is bit-exact.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae.train.ensemble import (init_ensemble_opt_state,
                                     stack_trees as jax_stack_trees)
from atlasvae.train.loop import train_model as jax_train_model
from atlasvae.train.step import batch_load as jax_batch_load, \
    make_vae_step_fns as jax_make_step_fns
from atlasvae_torch.interop import lanes_from_jax, params_from_jax
from atlasvae_torch.models import VAEConfig, init_vae
from atlasvae_torch.train import make_vae_step_fns, train_model
from atlasvae_torch.train.checkpoint import tree_flatten
from atlasvae_torch.train.ensemble import stack_trees, train_ensemble, tree_slice
from atlasvae_torch.train.step import to_device

LATENT = 4
CFG = VAEConfig(fc_layers=(16, 8, LATENT), input_dim=12)
CONFIGS = [  # (beta, lamb, margin, lr, seed)
    (2.0, 5.0, 1.0, 1e-3, 0),
    (0.5, 1.0, 2.0, 3e-3, 1),
    (4.0, 0.0, 0.5, 1e-3, 2),
]
REL = 1e-6


def _samples(seed, n=600, unit_weights=False):
    rng = np.random.default_rng(seed)

    def side(mu, rows):
        w = np.ones(rows, np.float32) if unit_weights else \
            rng.uniform(0.5, 2.0, rows).astype(np.float32)
        return {"HLVs": rng.normal(mu, 1.0, (rows, 12)).astype(np.float32), "weights": w}
    return [(side(0.0, n), side(0.7, n))], [(side(0.0, n // 3), side(0.7, n // 3))]


def _noise_source(seed):
    """One standard-normal draw per (phase, epoch, load, shape), kept."""
    rng = np.random.default_rng(seed)
    cache = {}

    def source(phase, epoch, load_idx, n_batches, batch):
        key = (phase, epoch, load_idx, n_batches, batch)
        if key not in cache:
            cache[key] = tuple(rng.standard_normal((n_batches, batch, LATENT))
                               .astype(np.float32) for _ in range(2))
        return cache[key]
    return source


def _init(seed):
    return init_vae(torch.Generator().manual_seed(int(seed)), CFG, device="cpu")


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a), tree_flatten(b)))


@pytest.mark.parametrize("noise", ["generator", "injected"])
@pytest.mark.parametrize("oe_type", ["MAE", "KLD"])
def test_lanes_equal_sequential_train_model(oe_type, noise):
    train_s, valid_s = _samples(11)
    sources = [_noise_source(50 + g) if noise == "injected" else None
               for g in range(len(CONFIGS))]
    sequential = []
    for (beta, lamb, margin, lr, seed), source in zip(CONFIGS, sources):
        sequential.append(train_model(_init(100 + seed), train_s, valid_s, oe_type, n_epochs=5,
                                      batch_size=200, beta=beta, lamb=lamb, margin=margin,
                                      lr=lr, seed=seed, noise_source=source))
    beta, lamb, margin, lr, seeds = map(np.asarray, zip(*CONFIGS))
    params, histories = train_ensemble(
        stack_trees([_init(100 + s) for s in seeds]), (beta, lamb, margin), train_s, valid_s,
        oe_type, n_epochs=5, batch_size=200, lr=lr, seeds=seeds, noise_sources=sources)
    for g, (want_params, want_history) in enumerate(sequential):
        assert histories[g] == want_history, f"config {g}"
        assert _equal_trees(tree_slice(params, g), want_params), f"config {g}"


@pytest.mark.parametrize("oe_type", ["MAE", "KLD"])
def test_lanes_match_jax_train_model(oe_type):
    """Each lane against the JAX package's sequential run of its config."""
    bkg, ood = _samples(4, n=4000, unit_weights=True)[0][0]
    loads = [(bkg, ood)]
    jcfg = JaxVAEConfig(fc_layers=CFG.fc_layers, input_dim=12)
    jparams = [jax_init_vae(jax.random.PRNGKey(100 + s), jcfg) for *_, s in CONFIGS]
    beta, lamb, margin, lr, seeds = map(np.asarray, zip(*CONFIGS))
    params, histories = train_ensemble(
        stack_trees([params_from_jax(jax.tree.map(np.asarray, p), "cpu") for p in jparams]),
        (beta, lamb, margin), loads, loads, oe_type, n_epochs=5, batch_size=500, lr=lr,
        seeds=seeds, noise_sources=[_noise_source(70 + g) for g in range(len(CONFIGS))])
    for g, (b, l, m, r, _) in enumerate(CONFIGS):
        want_params, want = jax_train_model(jparams[g], loads, loads, oe_type, n_epochs=5,
                                            batch_size=500, beta=b, lamb=l, margin=m, lr=r,
                                            noise_source=_noise_source(70 + g))
        assert list(histories[g]) == list(want)
        for key in want:
            rel = np.abs(np.asarray(histories[g][key]) - want[key]) / np.abs(want[key])
            assert rel.max() < REL, f"config {g} {key}: rel diff {rel}"
        for got, w in zip(tree_flatten(tree_slice(params, g)), jax.tree_util.tree_leaves(
                want_params)):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=REL, atol=REL * np.abs(w).max())


def test_lanes_from_jax_carry_each_lanes_adam_state(rng):
    """Three steps of a JAX ensemble (vmapped over lanes, per-lane Adam
    state), carried across, then two more steps on each side."""
    jcfg = JaxVAEConfig(fc_layers=CFG.fc_layers, input_dim=12)
    n_batches, batch = 5, 128
    (bkg, ood), = _samples(8, n=n_batches * batch)[0]
    batches = jax_batch_load(bkg["HLVs"], ood["HLVs"], bkg["weights"], ood["weights"], batch)
    noise = tuple(rng.standard_normal((2, n_batches, batch, LATENT)).astype(np.float32)
                  for _ in range(2))
    hyper = tuple(np.asarray(h, np.float32) for h in ((2.0, 0.5), (5.0, 1.0), (1.0, 2.0)))
    lrs = np.asarray([1e-3, 3e-3], np.float32)
    opt = optax.adam(1.0)
    raw, _ = jax_make_step_fns(opt, "MAE", hyper_traced=True, jit=False, external_noise=True)
    step = jax.jit(jax.vmap(raw, in_axes=(0, 0, 0, 0, 0) + (None,) * 5 + (0, 0)))
    stacked = jax_stack_trees([jax_init_vae(jax.random.PRNGKey(s), jcfg) for s in (3, 4)])
    keys = np.stack([np.asarray(jax.random.PRNGKey(0))] * 2)
    first, rest = slice(0, 3), slice(3, None)
    jparams, opt_state, _ = step(stacked, init_ensemble_opt_state(opt, stacked), lrs, hyper,
                                 keys, *(b[first] for b in batches),
                                 *(n[:, first] for n in noise))
    lanes = lanes_from_jax(jax.tree.map(np.asarray, jparams),
                           jax.tree.map(np.asarray, opt_state), "cpu")
    assert [lane.adam.count for lane in lanes] == [3, 3]
    want, _, _ = step(jparams, opt_state, lrs, hyper, keys, *(b[rest] for b in batches),
                      *(n[:, rest] for n in noise))
    for g, lane in enumerate(lanes):
        port_step, _ = make_vae_step_fns("MAE", *(float(h[g]) for h in hyper))
        port_step(lane, float(lrs[g]), None, to_device([b[rest] for b in batches], "cpu"),
                  to_device([n[g, rest] for n in noise], "cpu"))
        for got, w in zip(tree_flatten(lane.params), jax.tree_util.tree_leaves(want)):
            w = np.asarray(w[g])
            np.testing.assert_allclose(got.detach().numpy(), w, rtol=REL,
                                       atol=REL * np.abs(w).max())


def test_lr_zero_lane_keeps_its_parameters():
    train_s, valid_s = _samples(3, n=240)
    start = stack_trees([_init(0), _init(1)])
    hyper = tuple(np.full(2, v, np.float32) for v in (1.0, 1.0, 1.0))
    params, _ = train_ensemble(start, hyper, train_s, valid_s, "MAE", n_epochs=2,
                               batch_size=80, lr=[0.0, 1e-3])
    assert _equal_trees(tree_slice(params, 0), tree_slice(start, 0))
    assert not _equal_trees(tree_slice(params, 1), tree_slice(start, 1))


def test_stopped_lane_takes_no_further_step(tmp_path, capsys):
    """Lane 0 starts below the schedule's minimum lr at lr 0 and sees the
    same noise every epoch: its train loss never improves, the plateau
    controller stops it after epoch 4, and it stays as it was while lane 1
    trains on."""
    train_s, valid_s = _samples(5, n=240)
    draws = _noise_source(9)
    same_every_epoch = lambda phase, epoch, load_idx, n, b: draws(phase, 0, load_idx, n, b)
    start = stack_trees([_init(0), _init(1)])
    hyper = tuple(np.full(2, v, np.float32) for v in (1.0, 1.0, 1.0))
    outs = [str(tmp_path / f"model_{g}.npz") for g in range(2)]
    params, histories = train_ensemble(start, hyper, train_s, valid_s, "MAE", n_epochs=7,
                                       batch_size=80, lr=[0.0, 1e-3], model_outs=outs,
                                       noise_sources=[same_every_epoch, None])
    assert len(histories[0]["Train loss"]) == 4 and len(histories[1]["Train loss"]) == 7
    assert len(set(histories[0]["Train loss"])) == 1
    assert "cfg0: [stopped]" in capsys.readouterr().out
    assert _equal_trees(tree_slice(params, 0), tree_slice(start, 0))
    assert not (tmp_path / "model_0.npz").exists() and (tmp_path / "model_1.npz").exists()


def test_seed_lanes_differ():
    train_s, valid_s = _samples(5, n=300)
    hyper = tuple(np.full(2, v, np.float32) for v in (2.0, 5.0, 1.0))
    _, hist = train_ensemble(stack_trees([_init(0)] * 2), hyper, train_s, valid_s, "MAE",
                             n_epochs=2, batch_size=100, seeds=[0, 123])
    assert hist[0]["Train loss"] != hist[1]["Train loss"]


def test_state_file_resume_is_bit_exact(tmp_path):
    """2 + 3 epochs through the state file against 5 straight epochs."""
    train_s, valid_s = _samples(3)
    hyper = tuple(np.linspace(0.5, 2.0, 3).astype(np.float32) for _ in range(3))
    fresh = lambda: stack_trees([_init(s) for s in range(3)])
    hist_files = [str(tmp_path / f"h{g}.pkl") for g in range(3)]
    kw = dict(oe_type="MAE", batch_size=200, lr=[1e-3, 2e-3, 3e-3])
    p_ref, h_ref = train_ensemble(fresh(), hyper, train_s, valid_s, n_epochs=5, **kw)
    state = str(tmp_path / "state.npz")
    train_ensemble(fresh(), hyper, train_s, valid_s, n_epochs=2, state_file=state,
                   hist_files=hist_files, **kw)
    p_res, h_res = train_ensemble(fresh(), hyper, train_s, valid_s, n_epochs=3,
                                  state_file=state, hist_files=hist_files, **kw)
    assert h_res == h_ref
    assert _equal_trees(p_res, p_ref)


def test_mesh_is_refused(tmp_path):
    """Once refused (ROADMAP Queue 1 item 11), now run: two lanes over a
    config mesh of one rank equal the unsharded lanes bit for bit."""
    from atlasvae_torch.parallel import config_mesh
    from torch_dist_checks import one_rank_group
    train_s, valid_s = _samples(3, n=60)
    hyper = ([1.0, 2.0], [1.0, 0.5], [1.0, 1.0])
    params, hist = train_ensemble(stack_trees([_init(0), _init(1)]), hyper, train_s, valid_s,
                                  n_epochs=2)
    with one_rank_group(tmp_path):
        ranked, ranked_hist = train_ensemble(stack_trees([_init(0), _init(1)]), hyper, train_s,
                                             valid_s, n_epochs=2, mesh=config_mesh())
    assert ranked_hist == hist
    assert _equal_trees(ranked, params)
