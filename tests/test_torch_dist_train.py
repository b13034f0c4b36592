"""Data and tensor parallelism of the port's training steps, on CPU ranks
over gloo (``atlasvae_torch.parallel``), against the port's single-device
steps at the JAX package's data-parallel bars (tests/test_train.py:34-60:
metrics rtol 2e-3, parameters atol 5e-4), and against the JAX package's own
data-parallel runs on its CPU devices: the VAE step with injected noise,
the jet-ID epoch and the AAE's phases and cycle.

One world of 2 ranks and one of 4 run every check of this file
(``tests/torch_dist_checks.py``); each test reads its check's results."""

import jax
import numpy as np
import pytest

from torch_dist_checks import LR, injected_noise, run_world, toy_load
from torch_gaps import assert_close

from atlasvae.models import VAEConfig
from atlasvae.parallel import data_parallel_mesh
from atlasvae.train.step import batch_load, make_optimizer, make_vae_step_fns

CHECKS = {2: ("vae_dp", "sharded_load", "jetid_dp", "aae_dp", "live_stream"),
          4: ("vae_dp", "tp")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from atlasvae_torch.data import ensure_synthetic_registry
    root = tmp_path_factory.mktemp("dist_train")
    data_dir = str(root / "synth")
    ensure_synthetic_registry(data_dir, n_events=4000, n_const_max=30)
    return {2: run_world(2, root, CHECKS[2], data_dir=data_dir),
            4: run_world(4, root, CHECKS[4])}


def _close_runs(got, want, what, rtol_metrics=2e-3, atol_params=5e-4):
    """(metrics, valid metrics, params) of a DP run against a single run:
    the epoch's summed metrics at rtol, every parameter at atol."""
    assert_close(got[0][:, :4].sum(0), want[0][:, :4].sum(0), f"{what} metrics",
                 rtol=rtol_metrics)
    assert_close(got[1].sum(0), want[1].sum(0), f"{what} valid", rtol=rtol_metrics)
    for i, (a, b) in enumerate(zip(got[2], want[2])):
        assert_close(a, b, f"{what} leaf {i}", atol=atol_params)


@pytest.mark.parametrize("n", [2, 4])
def test_vae_dp_step_matches_single_device(worlds, n):
    for rank, res in worlds[n].items():
        out = res["vae_dp"]
        _close_runs(out["dp"], out["single"], f"rank {rank}/{n}")
        _close_runs(out["dp_noise"], out["single_noise"], f"rank {rank}/{n} injected noise")
        for a, b in zip(out["dp"][2], worlds[n][0]["vae_dp"]["dp"][2]):
            np.testing.assert_array_equal(a, b)      # every rank holds the same weights


@pytest.mark.parametrize("n", [2, 4])
def test_live_dp_step_commits_only_its_host_shard_range(worlds, n):
    """Each rank steps only its host_shard_range rows of every batch
    (tests/test_multihost_live.py:34-61)."""
    rows = 64 // n
    for rank, res in worlds[n].items():
        out = res["vae_dp"]
        assert out["shard"] == (rows * rank, rows * (rank + 1))
        _close_runs(out["live"], out["single"], f"live rank {rank}/{n}")


def test_vae_dp_step_matches_jax_dp_step(worlds):
    """The port's 2-rank DP step against JAX's DP step over its 8 CPU
    devices, both fed the same injected noise and the same weights."""
    from atlasvae_torch.train.checkpoint import tree_flatten, tree_unflatten
    from atlasvae.models import init_vae
    from torch_dist_checks import _vae_params
    template = init_vae(jax.random.PRNGKey(0), VAEConfig(fc_layers=(16, 8), input_dim=6))
    params = tree_unflatten(template, [np.asarray(t) for t in tree_flatten(_vae_params())])
    opt = make_optimizer()
    bkg, ood = toy_load()
    batches = batch_load(bkg["HLVs"], ood["HLVs"], bkg["weights"], ood["weights"], 64,
                         n_devices=8)
    step, _ = make_vae_step_fns(opt, "KLD", 1.0, 1.0, 1.0, mesh=data_parallel_mesh(8),
                                external_noise=True)
    p, _, m = step(params, opt.init(params), np.float32(LR), jax.random.PRNGKey(7), *batches,
                   *injected_noise())
    got = worlds[2][0]["vae_dp"]["dp_noise"]
    assert_close(got[0][:, :4].sum(0), np.asarray(m)[:, :4].sum(0), "metrics", rtol=2e-3)
    for i, (a, b) in enumerate(zip(got[2], tree_flatten(p))):
        assert_close(a, np.asarray(b), f"leaf {i}", atol=5e-4)


def test_sharded_load_train_model_matches_single_device(worlds):
    """train_model over the mesh: each rank's cached load holds its rows
    alone, rank 0 alone writes the history, and the histories and weights
    are the single-device run's (tests/test_train.py:202)."""
    for rank, res in worlds[2].items():
        out = res["sharded_load"]
        assert out["cached_rows"] == 32
        assert out["wrote_history"] == (rank == 0)
        (h1, p1), (hn, pn) = out["single"], out["dp"]
        assert set(h1) == set(hn)
        for key in h1:
            assert_close(np.asarray(hn[key]), np.asarray(h1[key]), f"history {key}", rtol=2e-3)
        for i, (a, b) in enumerate(zip(pn, p1)):
            assert_close(a, b, f"leaf {i}", atol=5e-4)


def test_tp_matches_single_device(worlds):
    """The data x model step over a (2, 2) mesh reproduces the one-device
    step, twice, and shards the hidden kernels over 'model'
    (tests/test_train.py:324)."""
    for rank, res in worlds[4].items():
        out = res["tp"]
        (l_tp, p_tp), (l_1, p_1) = out["tp"], out["single"]
        assert_close(np.asarray(l_tp), np.asarray(l_1), f"rank {rank} loss", rtol=1e-5)
        for i, (a, b) in enumerate(zip(p_tp, p_1)):
            assert_close(a, b, f"rank {rank} leaf {i}", atol=1e-5)
        assert out["placements"] == "(Replicate(), Shard(dim=1))"
        assert out["specs"] == "(Replicate(), Replicate())"


@pytest.mark.parametrize("nn_type", ["FCN", "CNN"])
def test_jetid_dp_matches_single_device(worlds, nn_type):
    """An epoch over the 2-rank data mesh reproduces the single-device
    epoch, dropout 0 (tests/test_jetid.py:293, its bars)."""
    for rank, res in worlds[2].items():
        runs = res["jetid_dp"][nn_type]
        (m1, v1, p1), (mn, vn, pn) = runs["single"], runs["dp"]
        assert_close(mn, m1, f"rank {rank} metrics", rtol=2e-5, atol=2e-6)
        for i, (a, b) in enumerate(zip(pn, p1)):
            assert_close(a, b, f"rank {rank} leaf {i}", rtol=2e-4, atol=2e-6)
        assert_close(vn, v1, f"rank {rank} valid", rtol=2e-5, atol=2e-6)


def _jax_params(template, port_params):
    """The port's parameter tree as a JAX tree of ``template``'s layout."""
    from atlasvae_torch.train.checkpoint import tree_flatten, tree_unflatten
    return tree_unflatten(template, [np.asarray(t) for t in tree_flatten(port_params)])


@pytest.mark.parametrize("nn_type", ["FCN", "CNN"])
def test_jetid_dp_matches_jax_dp(worlds, nn_type):
    """The port's 2-rank epoch against the JAX package's data-parallel epoch
    over 2 of its CPU devices, from the same weights on the same batches
    (dropout 0), at tests/test_jetid.py:293's bars."""
    from atlasvae.models import JetIDConfig, init_jetid
    from atlasvae.parallel.mesh import make_mesh
    from atlasvae.train.jetid_loop import _pack, make_jetid_step_fns
    from atlasvae_torch.train.checkpoint import tree_flatten
    from torch_dist_checks import _jetid_case, jetid_arrays
    kw, inputs, y = jetid_arrays(nn_type)
    cfg = JetIDConfig(**kw)
    params = _jax_params(init_jetid(jax.random.PRNGKey(0), cfg), _jetid_case(nn_type)[1])
    opt = make_optimizer()
    batches = _pack(inputs, y, np.ones(len(y), np.float32), 64)
    train, evaluate = make_jetid_step_fns(opt, cfg, mesh=make_mesh((("data", 2),),
                                                                    jax.devices()[:2]))
    p, _, m = train(params, opt.init(params), np.float32(LR), jax.random.PRNGKey(3), *batches)
    v = np.asarray(evaluate(p, *batches))
    for rank, res in worlds[2].items():
        mn, vn, pn = res["jetid_dp"][nn_type]["dp"]
        assert_close(mn, np.asarray(m), f"rank {rank} metrics", rtol=2e-5, atol=2e-6)
        for i, (a, b) in enumerate(zip(pn, tree_flatten(p))):
            assert_close(a, np.asarray(b), f"rank {rank} leaf {i}", rtol=2e-4, atol=2e-6)
        assert_close(vn, v, f"rank {rank} valid", rtol=2e-5, atol=2e-6)


def test_aae_dp_phases_and_cycle_match_jax_dp(worlds, tmp_path):
    """Each GAN phase-epoch over 2 ranks against the JAX package's over 2 of
    its CPU devices, from the same weights and a fresh shared Adam: metrics,
    both subtrees and every Adam moment (tests/test_aae.py:211's bars);
    then the full cycle's history (tests/test_aae.py:246's bars)."""
    from atlasvae.models import AAEConfig, init_aae
    from atlasvae.parallel.mesh import make_mesh
    from atlasvae.train.aae_loop import AE_KEYS, DISC_KEYS, make_aae_step_fns, \
        make_gan_optimizer, train_aae
    from atlasvae_torch.train.checkpoint import tree_flatten
    from torch_dist_checks import AAE_PERM, AAE_WIDTHS, _aae_case
    port_params, batches = _aae_case()
    params = _jax_params(init_aae(jax.random.PRNGKey(0), AAEConfig(**AAE_WIDTHS)), port_params)
    mesh = make_mesh((("data", 2),), jax.devices()[:2])
    opt = make_gan_optimizer()

    def flat(tree, keys):
        return np.concatenate([np.asarray(leaf).ravel()
                               for leaf in tree_flatten({k: tree[k] for k in keys})])

    fns = make_aae_step_fns(opt, lamb=1.0, beta=1.0, lr=LR, mesh=mesh)
    for phase, fn in zip(("AE", "Disc", "AAE"), fns):
        p, state, metrics = fn(params, opt.init(params), np.asarray(AAE_PERM), *batches)
        want = [np.asarray(x) for x in (metrics if isinstance(metrics, tuple) else (metrics,))]
        want += [flat(p, AE_KEYS), flat(p, DISC_KEYS)]
        want += [flat(state[m], keys) for m in ("mu", "nu") for keys in (AE_KEYS, DISC_KEYS)]
        for rank, res in worlds[2].items():
            got = res["aae_dp"]["phases"][phase]["dp"]
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                assert_close(a, b, f"rank {rank} {phase} output {i}", rtol=1e-4, atol=1e-6)
    bkg, ood = toy_load(n=256, dim=8)
    _, hist = train_aae(params, [(bkg, ood)], n_cycles=1, batch_size=64,
                        output_dir=str(tmp_path), lamb=1.0, beta=1.0, lr=LR, mesh=mesh)
    for rank, res in worlds[2].items():
        got = res["aae_dp"]["cycle"]["dp"][0]
        assert set(got) == set(hist)
        for key in hist:
            assert_close(np.asarray(got[key]), np.asarray([v for _, _, v in hist[key]]),
                         f"rank {rank} history {key!r}", rtol=5e-3, atol=1e-5)


def test_aae_dp_phases_match_single_device(worlds):
    """Every GAN phase-epoch over the mesh equals the single-device one:
    metrics, both subtrees and every Adam moment (tests/test_aae.py:211)."""
    for rank, res in worlds[2].items():
        for phase, runs in res["aae_dp"]["phases"].items():
            for i, (a, b) in enumerate(zip(runs["dp"], runs["single"])):
                assert_close(a, b, f"rank {rank} {phase} output {i}", rtol=1e-4, atol=1e-6)


def test_train_aae_dp_full_cycle(worlds):
    """The full cycle over the mesh reproduces the single-device history
    (tests/test_aae.py:246); rank 0 alone writes its files."""
    for rank, res in worlds[2].items():
        (h1, files1), (hn, filesn) = res["aae_dp"]["cycle"]["single"], \
            res["aae_dp"]["cycle"]["dp"]
        assert set(h1) == set(hn)
        for key in h1:
            assert_close(np.asarray(hn[key]), np.asarray(h1[key]), f"history {key!r}",
                         rtol=5e-3, atol=1e-5)
        assert filesn == (files1 if rank == 0 else [])


def test_streaming_epoch_matches_single_device(worlds):
    """Two ranks each stream their host shard through their own
    BatchGenerator for a multi-load epoch (tests/test_multihost_live.py:64);
    the loss and weights match one device stepping the same global
    batches."""
    losses = set()
    for rank, res in worlds[2].items():
        out = res["live_stream"]
        assert out["loads"] >= 2 and out["shard"] == (1024 * rank, 1024 * (rank + 1))
        assert_close(out["dp"][0], out["single"][0], f"rank {rank} loss", rtol=2e-5)
        for i, (a, b) in enumerate(zip(out["dp"][1], out["single"][1])):
            assert_close(a, b, f"rank {rank} leaf {i}", atol=5e-5)
        losses.add(float(out["dp"][0]))
    assert len(losses) == 1

