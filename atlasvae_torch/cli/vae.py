"""OE-VAE entry point on PyTorch/CUDA: train, evaluate, bump-hunt.

Counterpart of ``atlasvae/cli/vae.py``: the same flag names and 'ON'/'OFF'
string booleans, the same path wiring, sample selection, scaler fit, OoD
load and train/valid ``BatchGenerator``s, ``train_model``, then the
evaluation (``_evaluate``: predictions on the validation sample, then
``eval/results.py::plot_results``), plus ``--device`` (default ``cuda``).
``--model_in`` takes a native npz or a Keras ``.h5`` (trained by the
reference or exported here), told apart by the file's signature; after
training, ``model_out`` is reloaded, and a ``--model_out model.h5`` run
replaces its npz checkpoint with the Keras export
(``train/keras_export.py``).  Keras files go through h5py where it is
installed and through ``data/hdf5.py``'s ``LiteFile`` where it is not (the
machine with the card).

    python -m atlasvae_torch.cli.vae --n_train 1e5 --n_valid 5e4 --n_OoD 2e5 \\
        --batch_size 1e4 --n_epochs 3 --lr 1e-3 --beta 2 --lamb 5 --OE_type MAE \\
        --weight_type X-S --HLV_scaler_type RobustScaler --output_dir out

``--plotting ON``, the default, draws with matplotlib: where matplotlib
cannot be imported it is refused before any data is loaded (pass
``--plotting OFF``).  Under ``--plotting ON`` the training generator also
draws the first load's ``train`` distributions; the JAX package draws them
whatever ``--plotting`` says.  ``--apply_cuts ON`` with ``--plotting OFF``
predicts and filters the validation sample and draws nothing, as in the
JAX package.

``run_ensemble`` trains a same-shape hyper-parameter grid (beta, lamb,
margin, lr, seed) as lanes of one ensemble over one data preparation
(``train/ensemble.py``); ``cli/sweep.py --vmap ON`` drives it.

``--n_devices N`` above 1 (0: every visible card; 1 under ``--device
cpu``) trains data-parallel over N ranks (``parallel/multihost.py``:
``launch`` starts them, unless the program already runs inside a group,
as under torchrun): each rank prepares the same data, steps its rows of
every batch and evaluates (the EMD/KSD metrics sharded over the ranks);
rank 0 alone prints, writes files and draws.  The ensemble shards its
configurations over the N ranks instead, where N divides them.
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from ..parallel.mesh import barrier, is_writer
from ..parallel.multihost import cli_ranks, launch

_HOST = "cpu"  # data preparation runs on the host; the device gets packed batches
_EVAL_CHUNK = 10_000               # rows per prediction call in _evaluate
EVAL_METRICS = ["Latent", "MAE", "KLD", "JSD"]
EVAL_LOSS = "MAE"                  # the discriminant that is decorrelated and scanned


def build_parser():
    parser = ArgumentParser()
    parser.add_argument("--n_train", default=1e6, type=float)
    parser.add_argument("--n_valid", default=1e6, type=float)
    parser.add_argument("--n_OoD", default=10e6, type=float)
    parser.add_argument("--n_sig", default=1e6, type=float)
    parser.add_argument("--n_const", default=20, type=int)
    parser.add_argument("--n_dims", default=3, type=int)
    parser.add_argument("--memGB", default=30, type=float,
                        help="host-memory chunk budget per load")
    parser.add_argument("--batch_size", default=1e4, type=float)
    parser.add_argument("--n_epochs", default=100, type=int)
    parser.add_argument("--FC_layers", default=[80, 40, 20, 10], type=int, nargs="+")
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--beta", default=0, type=float)
    parser.add_argument("--lamb", default=0, type=float)
    parser.add_argument("--margin", default=1, type=float)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--n_iter", default=1, type=int)
    parser.add_argument("--OE_type", default="KLD")
    parser.add_argument("--weight_type", default="X-S")
    parser.add_argument("--model_in", default="")
    parser.add_argument("--model_out", default="model.npz")
    parser.add_argument("--const_scaler_type", default="")
    parser.add_argument("--const_scaler_in", default="")
    parser.add_argument("--const_scaler_out", default="")
    parser.add_argument("--HLV_scaler_type", default="")
    parser.add_argument("--HLV_scaler_in", default="")
    parser.add_argument("--HLV_scaler_out", default="")
    parser.add_argument("--hist_file", default="history.pkl")
    parser.add_argument("--state_file", default="",
                        help="full-train-state checkpoint (params + Adam state + lr "
                             "schedule + generator state): resumes bit for bit")
    parser.add_argument("--output_dir", default="outputs")
    parser.add_argument("--plotting", default="ON")
    parser.add_argument("--apply_cuts", default="OFF")
    parser.add_argument("--normal_losses", default="ON")
    parser.add_argument("--decorrelation", default="OFF")
    parser.add_argument("--slurm_id", default=0, type=int)
    parser.add_argument("--constituents", default="OFF")
    parser.add_argument("--HLVs", default="ON")
    parser.add_argument("--n_devices", default=0, type=int,
                        help="data-parallel ranks, one a card (0 = all cards; 1 under "
                             "--device cpu)")
    parser.add_argument("--synthetic", default=0, type=float,
                        help="generate synthetic datasets with N events each")
    parser.add_argument("--bkg_data", default="QCD-Geneva")
    parser.add_argument("--OoD_data", default="OoD-H")
    parser.add_argument("--sig_data", default="2HDM-Geneva")
    parser.add_argument("--npe", default=1000, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    return parser


def _on(v):
    return v.upper() == "ON" if isinstance(v, str) else bool(v)


def _check_supported(args):
    """Refuse drawing, before any data is loaded, where matplotlib cannot be
    imported."""
    if _on(args.plotting):
        from ..plotting.backend import require_matplotlib
        require_matplotlib("--plotting ON")


def _wire_paths(args):
    """Path wiring + int coercion."""
    for key in ["n_train", "n_valid", "n_OoD", "n_sig", "batch_size"]:
        setattr(args, key, int(getattr(args, key)))
    if args.const_scaler_out == "":
        args.const_scaler_out = "const_" + args.const_scaler_type + ".pkl"
    if args.HLV_scaler_out == "":
        args.HLV_scaler_out = "HLV_" + args.HLV_scaler_type + ".pkl"
    out_root = args.output_dir
    for key in ["model_in", "model_out", "const_scaler_in", "const_scaler_out",
                "HLV_scaler_in", "HLV_scaler_out", "hist_file"]:
        setattr(args, key, out_root + "/" + getattr(args, key))
    args.output_dir = out_root + "/plots"
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    return out_root


def _load_model_in(args, params, out_root):
    """The pre-trained weights ``--model_in`` names, loaded into ``params``
    (an npz, or a Keras .h5 trained by the reference or exported here, told
    apart by the file's signature); ``params`` unchanged when the flag was
    empty."""
    from ..train.keras_import import load_params_auto
    if args.model_in != out_root + "/" and os.path.isfile(args.model_in):
        print("\nLoading pre-trained weights from: " + args.model_in)
        return load_params_auto(args.model_in, params, "vae")
    return params


def _reload_model_out(args, params, mesh=None):
    """After training: the weights ``model_out`` holds (the best epoch's),
    then, for a ``model.h5`` run, the Keras export in place of the npz
    checkpoint, written by rank 0 once every rank has read the file."""
    from ..train.keras_export import maybe_export_keras
    from ..train.keras_import import load_params_auto
    barrier(mesh)
    if os.path.isfile(args.model_out):
        params = load_params_auto(args.model_out, params, "vae")
        barrier(mesh)
        if is_writer(mesh) and maybe_export_keras(params, args.model_out, "vae"):
            print("Keras-compatible weights exported to " + args.model_out)
    return params


def _select_samples(args):
    """Sample selection + cuts: the train and valid index windows."""
    from ..data import get_file, ensure_synthetic_registry, hdf5, HLV_LIST

    if args.synthetic:
        ensure_synthetic_registry(n_events=int(args.synthetic),
                                  n_const_max=max(args.n_const, 20))
    hlv_list = list(HLV_LIST)
    input_dim = (args.n_dims * args.n_const) * _on(args.constituents) + \
        len(hlv_list) * _on(args.HLVs)
    with hdf5.File(get_file(args.bkg_data), "r") as f:
        sample_size = len(f[next(iter(f.keys()))])
    args.n_train = [0, min(args.n_train, max(sample_size - int(1e6), sample_size // 2))]
    args.n_valid = [max(args.n_train[-1], sample_size - args.n_valid), sample_size]
    gen_cuts = ['(sample["m"] >= 30)']
    train_cuts = gen_cuts + ['(sample["pt"] <= 5000)']
    valid_cuts = gen_cuts + ['(sample["pt"] <= 5000)']
    return hlv_list, input_dim, train_cuts, valid_cuts


def _make_generators(args, hlv_list, train_cuts, const_scaler, hlv_scaler, writer=True):
    """Scaler fit + OoD load + train/valid BatchGenerators, on the host.
    Under ``--plotting ON`` the training generator draws the first load's
    distributions.  A process that is not the ``writer`` (ranks above 0)
    saves no scaler and draws nothing."""
    from ..data import load_data, BatchGenerator, fit_scaler, apply_scaler

    if (args.const_scaler_type and const_scaler is None) or \
       (args.HLV_scaler_type and hlv_scaler is None):
        print("\nLOADING QCD TRAINING SAMPLE (scaler fit)")
        n_jets = min(args.n_train[1], int(1e9 * args.memGB / args.n_const / args.n_dims / 4))
        train_sample = load_data(args.bkg_data, n_jets, train_cuts, args.n_const,
                                 args.n_dims, args.constituents, args.HLVs, hlv_list,
                                 device=_HOST)
        if _on(args.constituents) and const_scaler is None and args.const_scaler_type:
            const_scaler = fit_scaler(train_sample["constituents"], args.n_dims,
                                      args.const_scaler_out if writer else None,
                                      args.const_scaler_type)
        if _on(args.HLVs) and hlv_scaler is None and args.HLV_scaler_type:
            hlv_scaler = fit_scaler(train_sample["HLVs"], args.n_dims,
                                    args.HLV_scaler_out if writer else None,
                                    args.HLV_scaler_type)
    print("\nLOADING OUTLIER SAMPLE")
    ood_sample = load_data(args.OoD_data, args.n_OoD, train_cuts, args.n_const, args.n_dims,
                           args.constituents, args.HLVs, hlv_list, device=_HOST)
    if "constituents" in ood_sample:
        ood_sample["constituents"] = apply_scaler(ood_sample["constituents"], args.n_dims,
                                                  const_scaler, "OoD", device=_HOST)
    if "HLVs" in ood_sample:
        ood_sample["HLVs"] = apply_scaler(ood_sample["HLVs"], args.n_dims, hlv_scaler, "OoD",
                                          device=_HOST)
    bin_sizes = {"m": 20, "pt": 40} \
        if args.weight_type.split("_")[0] in ("flat", "OoD") else {"m": 10, "pt": 20}
    common = dict(weight_type=args.weight_type, cuts=train_cuts,
                  constituents=args.constituents, hlvs=args.HLVs, hlv_list=hlv_list,
                  bin_sizes=bin_sizes, hlv_scaler=hlv_scaler, const_scaler=const_scaler,
                  mem_gb=args.memGB)
    train_gen = BatchGenerator(args.bkg_data, args.OoD_data, args.n_const, args.n_dims,
                               args.n_train, ood_sample, is_train=True,
                               output_dir=args.output_dir if _on(args.plotting) and writer
                               else None,
                               **common)
    valid_gen = BatchGenerator(args.bkg_data, args.OoD_data, args.n_const, args.n_dims,
                               args.n_valid, ood_sample, **common)
    return train_gen, valid_gen, const_scaler, hlv_scaler


def _eval_noise(n, start, shape, device, generator):
    """The latent noise of evaluation pass ``n`` for the prediction chunk
    that starts at row ``start``: the next draw of ``generator``, pass
    ``n``'s own stream.  The JAX package draws it with threefry from
    ``fold_in(PRNGKey(n), start)``; tests put that draw here."""
    return torch.randn(shape, generator=generator, device=device)


def _valid_predictions(args, params, const_scaler, hlv_scaler, hlv_list, valid_cuts, device):
    """The validation sample and the model's predictions of it, averaged
    over ``--n_iter`` passes of 10,000-row chunks, rows with a non-finite
    prediction dropped.  Returns (y_true, x_true, x_pred, sample, wall_ms),
    numpy on the host, and each step's host-clock ms."""
    from ..data import make_sample, apply_scaler, filtering
    from ..models import vae_apply
    from ..train.loop import features
    from ..utils.logging import StepTimes

    step = StepTimes()
    sample = step("sample", make_sample, args.bkg_data, args.sig_data, args.n_valid,
                  args.n_sig, valid_cuts, args.n_const, args.n_dims, args.constituents,
                  args.HLVs, hlv_list, device=device)
    y_true = np.where(sample["JZW"] == -1, 0, 1)
    if "Geneva" in args.sig_data:      # Delphes weight adjustment (ref vae.py:151)
        sample["weights"][y_true == 0] /= 1e3

    def scale():
        for key, scaler in (("constituents", const_scaler), ("HLVs", hlv_scaler)):
            if key in sample:
                sample[key] = apply_scaler(sample[key], args.n_dims, scaler, device=device)
    step("scale", scale)
    x_true = features(sample)
    latent = params["encoder"]["mean"]["b"].shape[0]
    if args.n_iter > 1:
        print("\nEvaluating with", args.n_iter, "iterations:")

    def predict():
        x = torch.as_tensor(x_true, device=device)
        preds = []
        with torch.inference_mode():
            for n in range(args.n_iter):
                generator = torch.Generator(device).manual_seed(n)
                chunks = []
                for i in range(0, len(x), _EVAL_CHUNK):
                    rows = x[i:i + _EVAL_CHUNK]
                    noise = _eval_noise(n, i, (len(rows), latent), device, generator)
                    chunks.append(vae_apply(params, rows, noise=noise)[0])
                preds.append(torch.cat(chunks).cpu().numpy())
        return np.mean(np.stack(preds, axis=-1), axis=-1)
    x_pred = step("predict", predict)
    y_true, x_true, x_pred, sample = step("filtering", filtering, y_true, x_true, x_pred,
                                          sample)
    return y_true, x_true, x_pred, sample, step


def _evaluate(args, params, const_scaler, hlv_scaler, hlv_list, valid_cuts, device, mesh=None):
    """Validation predictions, then, under ``--plotting ON``, the training
    history and ``plot_results`` (ref OE-VAE/vae.py:145-176).  ``mesh``
    shards the EMD/KSD metrics' jet axes over its ranks, each of which
    calls this; rank 0 alone draws."""
    from ..eval import plot_results
    from ..plotting.history import plot_history

    print("\n+" + 36 * "-" + "+\n+--- VALIDATION SAMPLE EVALUATION ---+\n+"
          + 36 * "-" + "+\n")
    y_true, x_true, x_pred, sample, _ = _valid_predictions(
        args, params, const_scaler, hlv_scaler, hlv_list, valid_cuts, device)
    if _on(args.plotting):
        if os.path.isfile(args.hist_file) and is_writer(mesh):
            plot_history(args.hist_file, args.output_dir)
        plot_results(y_true, x_true, x_pred, sample, args.n_dims, params, EVAL_METRICS,
                     EVAL_LOSS, args.sig_data, args.output_dir, args.apply_cuts,
                     args.normal_losses, args.decorrelation, npe=args.npe, mesh=mesh,
                     device=device)


def main(argv=None):
    from .. import resolve_device
    from ..utils.logging import args_banner
    from ..data.scalers import Scaler
    from ..models import VAEConfig, init_vae
    from ..train import train_model

    args = build_parser().parse_args(argv)
    _check_supported(args)
    device = resolve_device(args.device)
    n_ranks = cli_ranks(args.n_devices, device)
    out_root = _wire_paths(args)
    hlv_list, input_dim, train_cuts, valid_cuts = _select_samples(args)
    placed = launch(main, (list(sys.argv[1:] if argv is None else argv),), n_ranks, device)
    if placed is None:
        return 0
    mesh, device = placed
    print("\nPROGRAM ARGUMENTS:\n" + args_banner(args))

    config = VAEConfig(fc_layers=tuple(args.FC_layers), input_dim=input_dim)
    # --seed drives both the weight init and the reparameterization noise
    params = _load_model_in(
        args, init_vae(torch.Generator(device).manual_seed(args.seed), config, device=device),
        out_root)
    const_scaler = hlv_scaler = None
    if args.const_scaler_type and os.path.isfile(args.const_scaler_in):
        const_scaler = Scaler.load(args.const_scaler_in)
    if args.HLV_scaler_type and os.path.isfile(args.HLV_scaler_in):
        hlv_scaler = Scaler.load(args.HLV_scaler_in)

    if args.n_epochs > 0:
        train_gen, valid_gen, const_scaler, hlv_scaler = _make_generators(
            args, hlv_list, train_cuts, const_scaler, hlv_scaler, is_writer(mesh))
        state_file = out_root + "/" + args.state_file if args.state_file else None
        params, _ = train_model(params, train_gen, valid_gen, args.OE_type, args.n_epochs,
                                args.batch_size, args.beta, args.lamb, args.margin, args.lr,
                                args.hist_file, args.model_in, args.model_out, mesh=mesh,
                                seed=args.seed, state_file=state_file)
        params = _reload_model_out(args, params, mesh)
    if not _on(args.plotting) and not _on(args.apply_cuts):
        return 0
    _evaluate(args, params, const_scaler, hlv_scaler, hlv_list, valid_cuts, device, mesh)
    return 0


# grid axes that lanes of one ensemble can differ in (scalars and seeds);
# anything that changes a shape or the graph stays a sequential group
VMAPPABLE = ("beta", "lamb", "margin", "lr", "seed")
_VM_COERCE = {"beta": float, "lamb": float, "margin": float, "lr": float, "seed": int}


def _grid_configs(passthrough, names, value_rows, output_dirs):
    """Parse the shared argv into per-config args with wired paths.

    Every config is checked before anything is loaded.  Sample selection
    runs once, on the lead config; its resolved ``[start, stop]`` train and
    valid windows are then copied to the other configs (copying the raw
    scalars would make them resolve ``n_valid`` as ``(0, n)`` in the
    evaluation, the training region: a bug the JAX package once had).
    Returns (configs, out_roots, selection) with ``selection = (hlv_list,
    input_dim, train_cuts, valid_cuts)``.
    """
    assert set(names) <= set(VMAPPABLE), names
    parser = build_parser()
    configs = []
    for row, out_dir in zip(value_rows, output_dirs):
        args = parser.parse_args(list(passthrough))
        for name, value in zip(names, row):
            setattr(args, name, _VM_COERCE[name](value))
        args.output_dir = out_dir
        _check_supported(args)
        configs.append(args)
    lead = configs[0]
    out_roots = [_wire_paths(a) for a in configs]
    selection = _select_samples(lead)
    for args in configs[1:]:
        args.n_train, args.n_valid = lead.n_train, lead.n_valid
    return configs, out_roots, selection


def run_ensemble(passthrough, names, value_rows, output_dirs):
    """Train a same-shape hyper-parameter grid as the lanes of one ensemble.

    ``passthrough``: the shared CLI argv; ``names``: the grid axes (a subset
    of VMAPPABLE); ``value_rows``: one tuple of values a config;
    ``output_dirs``: each config's output root, where its weights, history
    and plots land as a sequential sweep's would.  The data preparation
    (scaler fit, OoD load, pairing, reweighting) runs once, on the lead
    config's arguments, which every config shares outside the grid axes.
    """
    from .. import resolve_device
    from ..utils.logging import args_banner
    from ..data.scalers import Scaler
    from ..models import VAEConfig, init_vae
    from ..train.ensemble import train_ensemble, stack_trees, tree_slice

    configs, out_roots, (hlv_list, input_dim, train_cuts, valid_cuts) = \
        _grid_configs(passthrough, names, value_rows, output_dirs)
    lead, out_root = configs[0], out_roots[0]
    device = resolve_device(lead.device)
    n_ranks = cli_ranks(lead.n_devices, device)
    mesh = None
    if n_ranks > 1 and len(configs) % n_ranks:
        print(f"NOTE: {len(configs)} configs not divisible by --n_devices {n_ranks}; "
              "training on one device")
    elif n_ranks > 1:
        placed = launch(run_ensemble, (list(passthrough), list(names),
                                       [list(r) for r in value_rows], list(output_dirs)),
                        n_ranks, device, axis="config")
        if placed is None:
            return 0
        mesh, device = placed
        print(f"Sharding the {len(configs)}-config axis over {n_ranks} devices "
              "(zero-collective sweep)")
    print("\nPROGRAM ARGUMENTS (ensemble lead):\n" + args_banner(lead))
    const_scaler = hlv_scaler = None
    if lead.const_scaler_type and os.path.isfile(lead.const_scaler_in):
        const_scaler = Scaler.load(lead.const_scaler_in)
    if lead.HLV_scaler_type and os.path.isfile(lead.HLV_scaler_in):
        hlv_scaler = Scaler.load(lead.HLV_scaler_in)

    config = VAEConfig(fc_layers=tuple(lead.FC_layers), input_dim=input_dim)
    stacked = stack_trees([
        _load_model_in(a, init_vae(torch.Generator(device).manual_seed(a.seed), config,
                                   device=device), root)
        for a, root in zip(configs, out_roots)])

    if lead.n_epochs > 0:
        train_gen, valid_gen, const_scaler, hlv_scaler = _make_generators(
            lead, hlv_list, train_cuts, const_scaler, hlv_scaler, is_writer(mesh))
        hyper = tuple(np.array([getattr(a, k) for a in configs], np.float32)
                      for k in ("beta", "lamb", "margin"))
        stacked, _ = train_ensemble(
            stacked, hyper, train_gen, valid_gen, lead.OE_type, lead.n_epochs,
            lead.batch_size, lr=[a.lr for a in configs],
            hist_files=[a.hist_file for a in configs],
            model_outs=[a.model_out for a in configs], seeds=[a.seed for a in configs],
            mesh=mesh,
            state_file=out_root + "/" + lead.state_file if lead.state_file else None)
    if not is_writer(mesh):
        return 0

    for g, args in enumerate(configs):
        params = _reload_model_out(args, tree_slice(stacked, g))
        if _on(args.plotting) or _on(args.apply_cuts):
            print(f"\n===== ENSEMBLE EVAL {g}: {args.output_dir} =====")
            _evaluate(args, params, const_scaler, hlv_scaler, hlv_list, valid_cuts, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
