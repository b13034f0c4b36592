"""OE-AAE entry point on PyTorch/CUDA: adversarial training and the
per-signal evaluation.

Counterpart of ``atlasvae/cli/aae.py``: the same flags, path wiring, scaler
fit, OoD load and ``BatchGenerator``, the GAN cycle (``train_aae``), then
for each signal the discriminants (``get_data``), the cut scan (1-D over
the AE discriminant, or ``--scan_2d ON`` over AE x Disc), the ROC curves,
the discriminant histograms and the sculpting curves; plus ``--device``
(default ``cuda``).  ``--n_epochs`` counts GAN cycles.

    python -m atlasvae_torch.cli.aae --synthetic 200000 --n_train 1e5 --n_OoD 1e5 \\
        --n_epochs 1 --batch_size 5000 --lamb 1 --beta 1 --plotting OFF \\
        --apply_cuts OFF --output_dir out

The evaluation draws whenever it runs, as in the JAX package: under
``--plotting ON`` (the default) or ``--apply_cuts ON`` matplotlib is
required, and where it cannot be imported that is refused before any data
is loaded; ``--plotting OFF --apply_cuts OFF`` trains and ends.
``_signal_numbers`` computes one signal's numbers without drawing.

``--model_in`` and ``--AE_weights`` take a native npz or a Keras ``.h5``
(the reference's ``AAE.h5``/``AE.h5``, or one exported here), told apart by
the file's signature; a training run with ``--model_out AAE.h5`` ends with
the Keras export in place of its npz checkpoint.  Keras files go through
h5py where it is installed and through ``data/hdf5.py``'s ``LiteFile``
where it is not (the machine with the card).

``--n_devices N`` above 1 (0: every visible card; 1 under ``--device
cpu``) runs the GAN cycle data-parallel over N ranks
(``parallel/multihost.py::launch``); rank 0 alone prints, writes and
evaluates.
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from ..parallel.mesh import is_writer
from ..parallel.multihost import cli_ranks, launch

_HOST = "cpu"  # data preparation runs on the host; the device gets packed batches
CUTS = ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)']   # the training and validation cuts


def build_parser():
    parser = ArgumentParser()
    parser.add_argument("--n_train", default=1e6, type=float)
    parser.add_argument("--n_valid", default=1e6, type=float)
    parser.add_argument("--n_OoD", default=10e6, type=float)
    parser.add_argument("--n_sig", default=1e6, type=float)
    parser.add_argument("--n_const", default=20, type=int)
    parser.add_argument("--memGB", default=30, type=float,
                        help="host-memory budget for sample loads")
    parser.add_argument("--n_dims", default=3, type=int)
    parser.add_argument("--batch_size", default=5e3, type=float)
    parser.add_argument("--n_epochs", default=100, type=int)  # = n_cycles
    parser.add_argument("--layers_sizes", default=[100, 100, 100], type=int, nargs="+")
    parser.add_argument("--lr", default=1e-6, type=float)
    parser.add_argument("--beta", default=0, type=float)
    parser.add_argument("--lamb", default=0, type=float)
    parser.add_argument("--slurm_id", default=0, type=int)
    parser.add_argument("--weight_type", default="X-S")
    parser.add_argument("--model_in", default="")
    parser.add_argument("--model_out", default="AAE.npz")
    parser.add_argument("--AE_weights", default="")
    parser.add_argument("--HLV_scaler_type", default="")
    parser.add_argument("--HLV_scaler_in", default="")
    parser.add_argument("--HLV_scaler_out", default="")
    parser.add_argument("--const_scaler_type", default="")
    parser.add_argument("--const_scaler_in", default="")
    parser.add_argument("--const_scaler_out", default="")
    parser.add_argument("--hist_file", default="history.pkl")
    parser.add_argument("--output_dir", default="outputs")
    parser.add_argument("--plotting", default="ON")
    parser.add_argument("--apply_cuts", default="OFF")
    parser.add_argument("--normal_loss", default="ON")
    parser.add_argument("--decorrelation", default="OFF")
    parser.add_argument("--constituents", default="OFF")
    parser.add_argument("--HLVs", default="ON")
    parser.add_argument("--synthetic", default=0, type=float)
    parser.add_argument("--bkg_data", default="QCD-Geneva")
    parser.add_argument("--OoD_data", default="OoD-H")
    parser.add_argument("--sig_list", default=["top-Geneva"], nargs="+")
    parser.add_argument("--scan_2d", default="OFF",
                        help="run the AE x Disc 2-D grid scan")
    parser.add_argument("--n_devices", default=0, type=int,
                        help="data-parallel ranks for the GAN cycle, one a card (0 = all "
                             "cards; 1 under --device cpu)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train and evaluate on (default cuda)")
    return parser


def _on(v):
    return v.upper() == "ON" if isinstance(v, str) else bool(v)


def _check_supported(args):
    """Refuse an evaluation (which draws), before any data is loaded, where
    matplotlib cannot be imported."""
    if _on(args.plotting) or _on(args.apply_cuts):
        from ..plotting.backend import require_matplotlib
        require_matplotlib("--plotting ON" if _on(args.plotting) else "--apply_cuts ON")


def _wire_paths(args):
    """Int coercion and the file paths under ``--output_dir``, which is
    created; returns it."""
    for key in ["n_train", "n_valid", "n_OoD", "n_sig", "batch_size"]:
        setattr(args, key, int(getattr(args, key)))
    if args.HLV_scaler_out == "":
        args.HLV_scaler_out = "HLV_" + args.HLV_scaler_type + ".pkl"
    if args.const_scaler_out == "":
        args.const_scaler_out = "const_" + args.const_scaler_type + ".pkl"
    out_root = args.output_dir
    Path(out_root).mkdir(parents=True, exist_ok=True)
    for key in ["model_in", "model_out", "HLV_scaler_in", "HLV_scaler_out",
                "const_scaler_in", "const_scaler_out"]:
        setattr(args, key, out_root + "/" + getattr(args, key))
    return out_root


def _deco(decorrelation):
    """--decorrelation m/pt/2d, and a bare ON for the 2-D flattening."""
    if decorrelation in ("m", "pt", "2d"):
        return decorrelation
    return "2d" if _on(decorrelation) else "OFF"


def _signal_numbers(args, params, sig_data, hlv_list, valid_cuts, hlv_scaler, const_scaler,
                    device):
    """One signal's evaluation numbers, nothing drawn: {'sample', 'y_true',
    'x_loss' (the three discriminants), 'scan' (the 1-D or 2-D scan's
    numbers with the BumpHunter passes its plots show, or None), 'wall_ms'
    (each step's host-clock ms)}."""
    from ..data import make_sample, apply_scaler
    from ..eval import aae_eval
    from ..train.loop import features
    from ..utils.logging import StepTimes

    step = StepTimes()
    sample = step("sample", make_sample, args.bkg_data, sig_data, args.n_valid, args.n_sig,
                  valid_cuts, args.n_const, args.n_dims, args.constituents, args.HLVs,
                  hlv_list, device=_HOST)
    y_true = np.where(sample["JZW"] == -1, 0, 1)
    # signal-peak weight normalization
    sample["weights"][y_true == 0] /= aae_eval.adjust_weights(sample, y_true, factor=20)

    def scale():
        for key, scaler in (("HLVs", hlv_scaler), ("constituents", const_scaler)):
            if key in sample and scaler is not None:
                sample[key] = apply_scaler(sample[key], args.n_dims, scaler, device=_HOST)
    step("scale", scale)
    x_true = features(sample)
    x_loss = step("get_data", aae_eval.get_data, params, sample, y_true, x_true,
                  args.normal_loss, _deco(args.decorrelation))
    if _on(args.scan_2d):
        scan = step("scan_2d", aae_eval._scan_2d_numbers, y_true, x_loss, sample,
                    device=device)
    else:
        scan = step("scan", aae_eval._scan_numbers, y_true, x_loss["Autoencoder"],
                    "Autoencoder", sample, device=device)
    if scan is not None:
        step("bump_hunter", aae_eval._hunt, scan, device=device)
    return dict(sample=sample, y_true=y_true, x_loss=x_loss, scan=scan, wall_ms=step)


def _draw_signal(args, numbers, sig_label, output_dir, device):
    """Draw ``_signal_numbers``' output, in the JAX package's order."""
    from ..eval.aae_eval import _draw_scan, _draw_scan_2d
    from ..plotting.aae_plots import plot_discriminant, plot_correlations
    from ..plotting.performance import roc_curves

    scan, y_true, x_loss, sample = (numbers[k] for k in ("scan", "y_true", "x_loss", "sample"))
    if scan is not None:
        (_draw_scan_2d if _on(args.scan_2d) else _draw_scan)(scan, sig_label, output_dir)
    best = scan["best"] if scan is not None else None
    roc_curves(y_true, x_loss, sample["weights"], list(x_loss), output_dir, device=device)
    for disc_name in x_loss:
        plot_discriminant(y_true, x_loss[disc_name], sample["weights"], output_dir, sig_label,
                          best.get("cuts") if best else None, disc_name)
    plot_correlations(y_true, x_loss, sample, output_dir, device=device)
    print("best cut:", best)


def _make_generator(args, hlv_list, train_cuts, hlv_scaler, const_scaler, writer=True):
    """Scaler fit (where a type is given and none was loaded), the OoD
    sample, and the training ``BatchGenerator``, on the host; a process that
    is not the ``writer`` saves no scaler.  Returns (train_gen, hlv_scaler,
    const_scaler)."""
    from ..data import load_data, BatchGenerator, fit_scaler, apply_scaler

    need_hlv = _on(args.HLVs) and args.HLV_scaler_type and hlv_scaler is None
    need_const = (_on(args.constituents) and args.const_scaler_type
                  and const_scaler is None)
    if need_hlv or need_const:
        print("\nLOADING QCD TRAINING SAMPLE (scaler fit)")
        n_jets = min(args.n_train,
                     int(1e9 * args.memGB / args.n_const / args.n_dims / 4))
        train_sample = load_data(args.bkg_data, n_jets, train_cuts, args.n_const,
                                 args.n_dims, args.constituents, args.HLVs, hlv_list,
                                 device=_HOST)
        if need_hlv:
            hlv_scaler = fit_scaler(train_sample["HLVs"], args.n_dims,
                                    args.HLV_scaler_out if writer else None,
                                    args.HLV_scaler_type)
        if need_const:
            const_scaler = fit_scaler(train_sample["constituents"], args.n_dims,
                                      args.const_scaler_out if writer else None,
                                      args.const_scaler_type)
    print("\nLOADING OUTLIER SAMPLE")
    ood_sample = load_data(args.OoD_data, args.n_OoD, train_cuts, args.n_const,
                           args.n_dims, args.constituents, args.HLVs, hlv_list,
                           device=_HOST)
    if "HLVs" in ood_sample:
        ood_sample["HLVs"] = apply_scaler(ood_sample["HLVs"], args.n_dims, hlv_scaler,
                                          "OoD", device=_HOST)
    if "constituents" in ood_sample and const_scaler is not None:
        ood_sample["constituents"] = apply_scaler(ood_sample["constituents"], args.n_dims,
                                                  const_scaler, "OoD", device=_HOST)
    bin_sizes = {"m": 20, "pt": 40} \
        if args.weight_type.split("_")[0] in ("flat", "OoD") else {"m": 10, "pt": 20}
    train_gen = BatchGenerator(args.bkg_data, args.OoD_data, args.n_const, args.n_dims,
                               [0, args.n_train], ood_sample, args.weight_type,
                               train_cuts, args.constituents, args.HLVs, hlv_list,
                               bin_sizes, hlv_scaler, const_scaler, is_train=True,
                               mem_gb=args.memGB)
    return train_gen, hlv_scaler, const_scaler


def main(argv=None):
    import torch
    from .. import resolve_device
    from ..utils.logging import args_banner
    from ..data import ensure_synthetic_registry, HLV_LIST
    from ..data.scalers import Scaler
    from ..models import AAEConfig, init_aae
    from ..train.aae_loop import train_aae
    from ..train.keras_export import maybe_export_keras
    from ..train.keras_import import load_params_auto

    args = build_parser().parse_args(argv)
    _check_supported(args)
    device = resolve_device(args.device)
    n_ranks = cli_ranks(args.n_devices, device)
    out_root = _wire_paths(args)
    if args.synthetic:
        ensure_synthetic_registry(n_events=int(args.synthetic),
                                  n_const_max=max(args.n_const, 20))
    placed = launch(main, (list(sys.argv[1:] if argv is None else argv),), n_ranks, device)
    if placed is None:
        return 0
    mesh, device = placed
    if mesh is not None:
        print(f"Data-parallel GAN cycle over {n_ranks} devices")

    hlv_list = list(HLV_LIST)
    input_dim = (args.n_dims * args.n_const) * _on(args.constituents) + \
        len(hlv_list) * _on(args.HLVs)
    print("\nPROGRAM ARGUMENTS:\n" + args_banner(args))

    config = AAEConfig(input_dim=input_dim, ae_layers=tuple(args.layers_sizes))
    # drawn on the host: the same initial weights on every device
    params = init_aae(torch.Generator().manual_seed(0), config, device=device)
    hlv_scaler = const_scaler = None
    if args.model_in != out_root + "/" and os.path.isfile(args.model_in):
        print("\nLoading pre-trained weights from: " + args.model_in)
        params = load_params_auto(args.model_in, params, "aae")
    if args.HLV_scaler_type and os.path.isfile(args.HLV_scaler_in):
        hlv_scaler = Scaler.load(args.HLV_scaler_in)
    if args.const_scaler_type and os.path.isfile(args.const_scaler_in):
        const_scaler = Scaler.load(args.const_scaler_in)

    if args.n_epochs > 0:
        train_gen, hlv_scaler, const_scaler = _make_generator(args, hlv_list, CUTS, hlv_scaler,
                                                              const_scaler, is_writer(mesh))
        params, _ = train_aae(params, train_gen, args.n_epochs, args.batch_size, out_root,
                              os.path.basename(args.model_out), args.hist_file,
                              os.path.basename(args.AE_weights) if args.AE_weights else "",
                              args.lamb, args.beta, args.lr, mesh=mesh)
        if is_writer(mesh) and maybe_export_keras(params, args.model_out, "aae"):
            print("Keras-compatible weights exported to " + args.model_out)
    # the evaluation has no collective: rank 0 alone runs it
    if not is_writer(mesh) or (not _on(args.plotting) and not _on(args.apply_cuts)):
        return 0

    print("\n+" + 36 * "-" + "+\n+--- VALIDATION SAMPLE EVALUATION ---+\n+"
          + 36 * "-" + "+\n")
    hist_path = os.path.join(out_root, args.hist_file)
    if os.path.isfile(hist_path):
        from ..plotting.history import plot_history
        plot_history(hist_path, out_root)
    if os.path.isfile(args.model_out):
        params = load_params_auto(args.model_out, params, "aae")
    for sig_data in args.sig_list:
        output_dir = out_root + "/" + sig_data
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        numbers = _signal_numbers(args, params, sig_data, hlv_list, CUTS, hlv_scaler,
                                  const_scaler, device)
        sig_label = sig_data.split("-")[0].split("_")[0]
        print((sig_data + ": plotting performance results").upper())
        _draw_signal(args, numbers, sig_label, output_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
