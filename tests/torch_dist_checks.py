"""The ranks of the port's distributed CPU tests.

``run_world(n, tmp_path, checks)`` starts n CPU ranks of one gloo group
(``atlasvae_torch.parallel.multihost.run_ranks``), one thread each, runs
each named check on every rank and returns {rank: {check: result}},
numpy arrays and plain values that the test process compares, with the JAX
package too.  A check computes both sides, the data-parallel run and the
single-device run it is held to, inside the rank, so the two differ in
nothing but the sharding.  The ranks import neither JAX nor the JAX package.

Not collected by pytest (no test_ prefix).
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")
LR = 1e-3


def run_world(n, tmp_path, checks, **options):
    """Every rank's results of ``checks`` (names of functions here)."""
    from atlasvae_torch.parallel.multihost import run_ranks
    out = os.path.join(str(tmp_path), f"world{n}")
    os.makedirs(out, exist_ok=True)
    run_ranks(_checks, (out, tuple(checks), options), n, "cpu", threads=1,
              timeout=datetime.timedelta(seconds=300))
    results = {}
    for rank in range(n):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:   # written by _checks
            results[rank] = pickle.load(f)
    return results


def _checks(out, checks, options):
    rank, n = dist.get_rank(), dist.get_world_size()
    results = {name: globals()[name](rank, n, out, **options) for name in checks}
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _np(tree):
    from atlasvae_torch.train.checkpoint import tree_flatten
    return [np.asarray(leaf.detach().cpu().full_tensor() if hasattr(leaf, "full_tensor")
                       else leaf.detach().cpu()) for leaf in tree_flatten(tree)]


def _vae_params(dim=6):
    from atlasvae_torch.models import VAEConfig, init_vae
    return init_vae(torch.Generator().manual_seed(0), VAEConfig(fc_layers=(16, 8), input_dim=dim),
                    device=CPU)


def toy_load(n=256, dim=6, seed=0):
    """tests/test_train.py's toy (bkg, OoD) load."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    ood = rng.normal(3, 1, (n, dim)).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    return {"HLVs": x, "weights": w}, {"HLVs": ood, "weights": w}


def injected_noise(n_batches=4, batch=64, latent=8, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n_batches, batch, latent)).astype(np.float32)
                 for _ in range(2))


def _vae_batches(n_devices):
    from atlasvae_torch.train.step import batch_load
    bkg, ood = toy_load()
    return batch_load(bkg["HLVs"], ood["HLVs"], bkg["weights"], ood["weights"], 64,
                      n_devices=n_devices)


def _vae_step(batches, mesh=None, noise=None, rows=None):
    """One load's steps (KLD OE, beta = lamb = margin = 1) from the seed-0
    model with the seed-7 generator: (metrics, valid metrics, params)."""
    from atlasvae_torch.parallel.mesh import shard_batch
    from atlasvae_torch.train.step import TrainState, make_vae_step_fns, to_device
    train_on_load, valid_losses = make_vae_step_fns("KLD", 1.0, 1.0, 1.0, mesh=mesh)
    state = TrainState(_vae_params())
    cut = (lambda t: t) if mesh is None else \
        (lambda t: shard_batch(mesh, t) if rows is None else tuple(b[:, rows] for b in t))
    batches = to_device(cut(batches), CPU)
    noise = None if noise is None else to_device(cut(noise), CPU)
    metrics = train_on_load(state, LR, torch.Generator().manual_seed(7), batches, noise)
    valid = valid_losses(state.params, torch.Generator().manual_seed(8), batches, noise)
    return metrics.numpy(), valid.numpy(), _np(state.params)


def vae_dp(rank, n, out, **_):
    """The DP step against the single-device step, drawn noise and injected
    noise; and the DP step on the rows ``host_shard_range`` gives this rank
    (tests/test_multihost_live.py)."""
    from atlasvae_torch.parallel.mesh import data_parallel_mesh
    from atlasvae_torch.parallel.multihost import host_shard_range
    mesh = data_parallel_mesh()
    batches = _vae_batches(n)
    noise = injected_noise()
    lo, hi = host_shard_range(batches[0].shape[1])
    return {"single": _vae_step(batches), "dp": _vae_step(batches, mesh),
            "single_noise": _vae_step(batches, noise=noise),
            "dp_noise": _vae_step(batches, mesh, noise),
            "live": _vae_step(batches, mesh, rows=slice(lo, hi)), "shard": (lo, hi)}


def sharded_load(rank, n, out, **_):
    """train_model over the mesh (``LoadCache.get(..., mesh)`` keeps this
    rank's rows) against train_model on one device: histories and weights,
    and the rows a rank's cached load holds."""
    from atlasvae_torch.parallel.mesh import data_parallel_mesh
    from atlasvae_torch.train.loop import features, train_model
    from atlasvae_torch.train.step import LoadCache, batch_load
    mesh = data_parallel_mesh()
    load = toy_load()
    kw = dict(oe_type="MAE", n_epochs=2, batch_size=64, beta=0.5, lamb=2.0, margin=1.0, lr=LR,
              seed=7)
    p1, h1 = train_model(_vae_params(), [load], [load], **kw)
    hist = os.path.join(out, "history.pkl") if rank == 0 else os.path.join(out, f"h{rank}.pkl")
    pn, hn = train_model(_vae_params(), [load], [load], mesh=mesh, hist_file=hist, **kw)
    bkg, ood = load
    cached = LoadCache(CPU).get((bkg, ood), (64, n), lambda: batch_load(
        features(bkg), features(ood), bkg["weights"], ood["weights"], 64, n), mesh)
    return {"single": (h1, _np(p1)), "dp": (hn, _np(pn)), "cached_rows": cached[0].shape[1],
            "wrote_history": os.path.isfile(hist)}


def tp(rank, n, out, **_):
    """The data x model step on a 2 x 2 mesh against the single-device
    step, twice (the second from the DTensors the first returned)."""
    from atlasvae_torch.parallel.mesh import make_mesh
    from atlasvae_torch.parallel.tp import make_tp_train_step, tp_param_shardings
    from atlasvae_torch.train.step import TrainState, batch_load, make_vae_step_fns, to_device
    mesh = make_mesh((("data", 2), ("model", 2)))
    bkg, ood = toy_load()
    args = [torch.from_numpy(a) for a in (bkg["HLVs"], ood["HLVs"], bkg["weights"],
                                           ood["weights"])]
    step = make_tp_train_step(mesh, oe_type="MAE", beta=2.0, lamb=5.0, margin=1.0, lr=LR)
    gen = torch.Generator().manual_seed(3)
    p, adam, l1 = step(_vae_params(), None, gen, *args)
    placements = str(p["encoder"]["hidden"][0]["w"].placements)
    p, adam, l2 = step(p, adam, gen, *args)
    train_on_load, _ = make_vae_step_fns("MAE", 2.0, 5.0, 1.0)
    state = TrainState(_vae_params())
    batches = to_device(batch_load(bkg["HLVs"], ood["HLVs"], bkg["weights"], ood["weights"],
                                   256), CPU)
    gen = torch.Generator().manual_seed(3)
    m = [train_on_load(state, LR, gen, batches)[0, 3] for _ in range(2)]
    return {"tp": ([float(l1), float(l2)], _np(p)), "single": ([float(x) for x in m],
                                                              _np(state.params)),
            "placements": placements,
            "specs": str(tp_param_shardings(mesh, _vae_params())["decoder"]["out"]["w"])}


def jetid_arrays(nn_type):
    """tests/test_jetid.py:293's configuration keywords, inputs and labels."""
    rng = np.random.default_rng(11)
    n, dim = 512, 6
    y = rng.integers(0, 2, n).astype(np.int64)
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    x[:, 1] += (1.5 * (1 - 2 * y)).astype(np.float32)
    inputs = {"s": x}
    kw = dict(n_classes=2, scalars=("s",), scalar_dims=(dim,), nn_type=nn_type,
              fcn_neurons=(16, 8), dropout=0.0, l2=1e-4)
    if nn_type == "CNN":
        inputs["img"] = rng.normal(size=(n, 12, 10)).astype(np.float32)
        kw.update(images=("img",), image_shapes=((12, 10),), branch_neurons=(8,),
                  cnn_maps=(4, 4), cnn_kernels=((3, 3), (3, 3)), cnn_pools=((2, 2), (2, 2)))
    return kw, inputs, y


def _jetid_case(nn_type):
    from atlasvae_torch.models import JetIDConfig, init_jetid
    kw, inputs, y = jetid_arrays(nn_type)
    cfg = JetIDConfig(**kw)
    return cfg, init_jetid(torch.Generator().manual_seed(0), cfg, device=CPU), inputs, y


def jetid_dp(rank, n, out, **_):
    """One epoch of 8 batches, FCN and CNN, DP against one device (dropout
    0), and the DP validation triples (tests/test_jetid.py:293)."""
    from atlasvae_torch.parallel.mesh import data_parallel_mesh, shard_batch
    from atlasvae_torch.train.jetid_loop import _packed_arrays, _unflatten, eval_epoch, \
        train_epoch
    from atlasvae_torch.train.step import TrainState, to_device
    mesh = data_parallel_mesh()
    res = {}
    for nn_type in ("FCN", "CNN"):
        cfg, params, inputs, y = _jetid_case(nn_type)
        host = _packed_arrays(inputs, y, np.ones(len(y), np.float32), 64)
        runs = {}
        for name, m in (("single", None), ("dp", mesh)):
            batches = _unflatten(inputs, to_device(host if m is None else shard_batch(m, host),
                                                   CPU))
            state = TrainState(params)
            metrics = train_epoch(state, cfg, LR, torch.Generator().manual_seed(3), *batches, m)
            valid = eval_epoch(state.params, cfg, *batches, m)
            runs[name] = (metrics.numpy(), valid.numpy(), _np(state.params))
        res[nn_type] = runs
    return res


AAE_WIDTHS = dict(input_dim=8, ae_layers=(16, 8), disc_layers=(16, 3))
AAE_PERM = [2, 0, 3, 1]


def _aae_case():
    from atlasvae_torch.models import AAEConfig, init_aae
    cfg = AAEConfig(**AAE_WIDTHS)
    rng = np.random.default_rng(11)
    n, nb, bs = 128, 4, 32
    arrays = (rng.normal(0, 1, (n, 8)).astype(np.float32),
              rng.normal(2.5, 1, (n, 8)).astype(np.float32),
              rng.uniform(0.2, 3.0, n).astype(np.float32),
              rng.uniform(0.2, 3.0, n).astype(np.float32))
    batches = tuple(a.reshape((nb, bs) + a.shape[1:]) for a in arrays)
    return init_aae(torch.Generator().manual_seed(0), cfg, device=CPU), batches


def aae_dp(rank, n, out, **_):
    """Each GAN phase-epoch DP against one device from the same state, with
    non-uniform weights (tests/test_aae.py:211); then train_aae's full cycle
    (tests/test_aae.py:246)."""
    from atlasvae_torch.parallel.mesh import data_parallel_mesh, shard_batch
    from atlasvae_torch.train.aae_loop import gan_states, make_aae_step_fns, train_aae
    mesh = data_parallel_mesh()
    params, batches = _aae_case()
    perm = AAE_PERM
    phases = {}
    for phase in range(3):
        runs = {}
        for name, m in (("single", None), ("dp", mesh)):
            fns = make_aae_step_fns(lamb=1.0, beta=1.0, lr=LR, mesh=m)
            ae, disc = gan_states(params, CPU)
            local = tuple(torch.from_numpy(np.ascontiguousarray(b)) for b in
                          (batches if m is None else shard_batch(m, batches)))
            got = fns[phase](ae, disc, perm, local)
            metrics = [t.numpy() for t in (got if isinstance(got, tuple) else (got,))]
            adam = ae.adam
            runs[name] = metrics + [ae.flat.numpy().copy(), disc.flat.numpy().copy()] + \
                [adam.mu[k].numpy().copy() for k in ("ae", "disc")] + \
                [adam.nu[k].numpy().copy() for k in ("ae", "disc")]
        phases[("AE", "Disc", "AAE")[phase]] = runs
    bkg, ood = toy_load(n=256, dim=8)
    cycles = {}
    for name, m in (("single", None), ("dp", mesh)):
        folder = os.path.join(out, f"aae_{name}_{rank}")
        os.makedirs(folder, exist_ok=True)
        _, hist = train_aae(params, [(bkg, ood)], n_cycles=1, batch_size=64, output_dir=folder,
                            lamb=1.0, beta=1.0, lr=LR, mesh=m)
        cycles[name] = ({k: [v for _, _, v in series] for k, series in hist.items()},
                        sorted(os.listdir(folder)))
    return {"phases": phases, "cycle": cycles}


def live_stream(rank, n, out, data_dir=None, **_):
    """Each rank streams its host_shard_range of the event axis through its
    own BatchGenerator and steps its row block of every global batch; the
    single-device run steps the same global batches, every host's loads
    rebuilt and laid side by side (tests/mh_stream_worker.py)."""
    from atlasvae_torch.data import BatchGenerator, HLV_LIST, ensure_synthetic_registry, \
        load_data
    from atlasvae_torch.parallel.mesh import data_parallel_mesh
    from atlasvae_torch.parallel.multihost import host_shard_range
    from atlasvae_torch.train.loop import features
    from atlasvae_torch.train.step import TrainState, batch_load, make_vae_step_fns, to_device
    from atlasvae_torch.models import VAEConfig, init_vae
    ensure_synthetic_registry(data_dir, n_events=4000, n_const_max=30)
    n_train, n_ood, batch = 2048, 1500, 128
    n_const, n_dims = 20, 3
    mem_gb = 512 * n_const * n_dims * 4 / 1e9
    b_local = batch // n
    ood_sample = load_data("OoD-H", n_ood, (), n_const, n_dims, "OFF", "ON", list(HLV_LIST),
                           device="cpu")

    def make_gen(lo, hi):
        return BatchGenerator("QCD-Geneva", "OoD-H", n_const, n_dims, [lo, hi], ood_sample,
                              "X-S", (), "OFF", "ON", list(HLV_LIST), {"m": 10, "pt": 20},
                              None, None, is_train=True, mem_gb=mem_gb)

    def pack(gen, i):
        bkg, ood = gen[i]
        return batch_load(features(bkg), features(ood), bkg["weights"], ood["weights"],
                          b_local)

    lo, hi = host_shard_range(n_train)
    mine = make_gen(lo, hi)
    params0 = init_vae(torch.Generator().manual_seed(0),
                       VAEConfig(fc_layers=(16, 8), input_dim=len(HLV_LIST)), device=CPU)
    mesh = data_parallel_mesh()
    gens = [make_gen(*host_shard_range(n_train, n, h)) for h in range(n)]
    runs = {}
    for name, m in (("dp", mesh), ("single", None)):
        train_on_load, _ = make_vae_step_fns("KLD", 1.0, 1.0, 1.0, mesh=m)
        state = TrainState(params0)
        gen = torch.Generator().manual_seed(7)
        metrics = []
        for i in range(len(mine)):
            if m is None:
                per_host = [pack(g, i) for g in gens]
                host = tuple(np.concatenate([ph[j] for ph in per_host], axis=1)
                             for j in range(5))
            else:
                host = pack(mine, i)
            metrics.append(train_on_load(state, LR, gen, to_device(host, CPU)).numpy())
        metrics = np.concatenate(metrics)
        runs[name] = (metrics[:, 3].sum() / metrics[:, 4].sum(), _np(state.params))
    return {"loads": len(mine), "shard": (lo, hi), **runs}


def ensemble(rank, n, out, **_):
    """G = 4 configurations over a 2-rank config mesh against the unsharded
    ensemble (tests/test_ensemble.py:198), and G = 3 refused."""
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.parallel.mesh import config_mesh
    from atlasvae_torch.train.ensemble import stack_trees, train_ensemble
    rng = np.random.default_rng(7)
    cfg = VAEConfig(fc_layers=(16, 8), input_dim=12)
    loads = [tuple({"HLVs": rng.normal(mu, 1, (300, 12)).astype(np.float32),
                    "weights": np.ones(300, np.float32)} for mu in (0, 3)) for _ in range(2)]
    g = 4
    hyper = tuple(np.linspace(0.5, 4.0, g).astype(np.float32) for _ in range(3))

    def run(mesh, count=g):
        stacked = stack_trees([init_vae(torch.Generator().manual_seed(s), cfg, device=CPU)
                               for s in range(count)])
        return train_ensemble(stacked, tuple(h[:count] for h in hyper), loads[:1], loads[1:],
                              "MAE", n_epochs=3, batch_size=100, lr=[LR] * count, mesh=mesh)

    p1, h1 = run(None)
    mesh = config_mesh()
    pn, hn = run(mesh)
    try:
        run(mesh, 3)
        refused = None
    except ValueError as err:
        refused = str(err)
    return {"single": (h1, _np(p1)), "sharded": (hn, _np(pn)), "refused": refused}


def emd_inputs():
    """{jets: (clouds p, clouds q)}, 16 jets (divisible) and 13 (padded)."""
    rng = np.random.default_rng(2)
    return {jets: tuple(np.abs(rng.normal(1, 0.5, (jets, 8, 3))).astype(np.float32)
                        for _ in range(2)) for jets in (16, 13)}


def emd_ks(rank, n, out, **_):
    """EMD and KSD with the jet axis over the mesh against one device, jet
    counts divisible and padded (tests/test_emd.py:151)."""
    from atlasvae_torch.ops.emd import emd_pairs, ks_pairs
    from atlasvae_torch.parallel.mesh import data_parallel_mesh
    mesh = data_parallel_mesh()
    res = {}
    for jets, (a, b) in emd_inputs().items():
        res[jets] = {"emd": (emd_pairs(a, b, n_iters=20, device=CPU),
                             emd_pairs(a, b, n_iters=20, device=CPU, mesh=mesh)),
                     "ks": (ks_pairs(a[:, :, 0], b[:, :, 0], device=CPU),
                            ks_pairs(a[:, :, 0], b[:, :, 0], device=CPU, mesh=mesh))}
    return res


def bump(rank, n, out, **_):
    """bump_sigma_sharded over the mesh against one device, and npe = 161
    refused (tests/test_stats.py:184)."""
    from atlasvae_torch.parallel.mesh import data_parallel_mesh
    from atlasvae_torch.stats.bumphunter import bump_sigma_sharded
    mesh = data_parallel_mesh()
    rng = np.random.default_rng(3)
    edges = np.linspace(0, 400, 41)
    bkg = np.histogram(rng.exponential(80, 50_000) + 20, bins=edges)[0].astype(float)
    data = bkg + np.histogram(rng.normal(250, 10, 1500), bins=edges)[0].astype(float)
    kw = dict(widths=(2, 3, 4), scan_steps=(1, 1, 1), npe=160, seed=5, device=CPU)
    one = [float(t) for t in bump_sigma_sharded(data, bkg, **kw)]
    sharded = [float(t) for t in bump_sigma_sharded(data, bkg, mesh=mesh, **kw)]
    try:
        bump_sigma_sharded(data, bkg, widths=(2,), scan_steps=(1,), npe=161, mesh=mesh,
                           device=CPU)
        refused = None
    except ValueError as err:
        refused = str(err)
    return {"one": one, "sharded": sharded, "refused": refused}


def one_rank_group(tmp_path):
    """A gloo group of this process alone, for a mesh of one rank in the
    test process; a context manager that destroys the group on exit."""
    import contextlib

    @contextlib.contextmanager
    def group():
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/one_rank_group",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()
    return group()
