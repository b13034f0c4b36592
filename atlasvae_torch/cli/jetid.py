"""jet-ID entry point on PyTorch/CUDA: supervised CNN/FCN classifier
training, prediction and results.

Counterpart of ``atlasvae/cli/jetid.py``: the same flag names and 'ON'/'OFF'
string booleans, sample selection, constituent images, scalers, training
with the Keras-style callbacks, prediction and the accuracy / AUC /
background-rejection report, plus ``--device`` (default ``cuda``).  Data are
prepared on the host; the device gets packed batches.

    python -m atlasvae_torch.cli.jetid --NN_type CNN --mixed_precision OFF \\
        --plotting OFF --synthetic 200000 --n_train 1e5 --n_valid 5e4 \\
        --n_epochs 3 --output_dir out
    python -m atlasvae_torch.cli.jetid --NN_type CNN --mixed_precision OFF \\
        --plotting OFF --n_train 1e5 --n_valid 5e4 --n_epochs 0 \\
        --model_in model.npz --output_dir out          # predict only

Not ported yet, and refused with ``NotImplementedError`` while the
arguments are checked, before any data is loaded (ROADMAP Queue 1):
``--n_folds`` above 1 and ``--vmap_folds ON`` (item 10), ``--generator ON``,
``--feature_removal ON`` and ``--weight_type`` other than ``none`` (item 9),
``--n_devices`` above 1 (item 11), ``--plotting ON`` (item 6), Keras ``.h5``
weights in or out (item 10) and bfloat16 compute (item 9): ``--mixed_precision
AUTO``, the default, resolves to bfloat16 for ``--NN_type CNN`` as in the JAX
package and is therefore refused there; pass ``--mixed_precision OFF``.
"""

import os
import pickle
import sys
from argparse import ArgumentParser, SUPPRESS
from pathlib import Path

import numpy as np

_HOST = "cpu"  # data preparation runs on the host; the device gets packed batches


def build_parser():
    parser = ArgumentParser()
    parser.add_argument("--n_train", default=1e5, type=float)
    parser.add_argument("--n_valid", default=1e5, type=float)
    parser.add_argument("--batch_size", default=5e3, type=float)
    parser.add_argument("--n_epochs", default=100, type=int)
    parser.add_argument("--n_classes", default=2, type=int)
    parser.add_argument("--n_folds", default=1, type=int)
    parser.add_argument("--vmap_folds", default="OFF",
                        help="ON: train all k folds as one batched program (not ported)")
    parser.add_argument("--n_devices", default=0, type=int)
    parser.add_argument("--n_gpus", dest="n_devices", type=int,
                        help="reference alias of --n_devices")
    # cluster-path plumbing accepted for command-line compatibility; the
    # dataset registry and --output_dir replace them
    parser.add_argument("--host_name", default="lps", help="no-op")
    parser.add_argument("--node_dir", default="", help="no-op")
    parser.add_argument("--sbatch_var", default=0, type=int, help="no-op")
    parser.add_argument("--NN_type", default="FCN")
    parser.add_argument("--FCN_neurons", default=[200, 200], type=int, nargs="+")
    parser.add_argument("--weight_type", default="none")
    parser.add_argument("--bkg_ratio", default=0, type=float)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--patience", default=10, type=int)
    parser.add_argument("--n_const", default=20, type=int)
    parser.add_argument("--n_tracks", dest="n_const", type=int, default=SUPPRESS,
                        help="reference name of --n_const")
    parser.add_argument("--n_dims", default=3, type=int)
    parser.add_argument("--constituents", default="ON")
    parser.add_argument("--HLVs", default="ON")
    # master branch gates: OFF empties the image / scalar branch lists
    parser.add_argument("--images", default="ON")
    parser.add_argument("--scalars", default="ON")
    # master scaling gate: scaling only when ON and scalar branches exist
    parser.add_argument("--scaling", default="ON")
    parser.add_argument("--metrics", default="loss",
                        choices=["loss", "val_loss", "accuracy", "val_accuracy"],
                        help="the series the checkpoint, plateau and early-stop "
                             "callbacks watch")
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--scaler_type", default="RobustScaler")
    parser.add_argument("--scaler_in", default="",
                        help="load a pickled HLV scaler instead of fitting")
    parser.add_argument("--scaler_out", default="",
                        help="scaler save path (default scaler_<type>.pkl)")
    parser.add_argument("--t_scaling", default="ON",
                        help="RobustScaler on constituent components for the flat "
                             "constituents branch")
    parser.add_argument("--t_scaler_in", default="",
                        help="load a pickled track scaler instead of fitting")
    parser.add_argument("--t_scaler_out", default="t_scaler.pkl")
    parser.add_argument("--dropout", default=0.1, type=float)
    parser.add_argument("--l2", default=1e-7, type=float,
                        help="kernel L2 regularization on hidden Dense/Conv layers")
    parser.add_argument("--image_size", default=16, type=int,
                        help="constituent-image pixels per side (CNN mode)")
    parser.add_argument("--train_cuts", default="",
                        help="extra cut expression on the training slice")
    parser.add_argument("--generator", default="OFF",
                        help="stream training chunks per epoch (not ported)")
    parser.add_argument("--memGB", default=30, type=float,
                        help="host-memory chunk budget in generator mode")
    parser.add_argument("--model_in", default="")
    parser.add_argument("--model_out", default="model.npz")
    parser.add_argument("--results_out", default="valid_results.pkl")
    parser.add_argument("--results_in", default="",
                        help="re-evaluate saved validation results without retraining")
    parser.add_argument("--state_file", default="",
                        help="full-train-state checkpoint (params + Adam state + callback "
                             "counters + generator state): resumes bit for bit")
    parser.add_argument("--output_dir", default="outputs")
    parser.add_argument("--plotting", default="ON")
    parser.add_argument("--n_eval", default=0, type=float,
                        help="generator mode: per-epoch validation slice size")
    parser.add_argument("--eta_region", default="0.0-2.5",
                        help="named |eta| window composed into valid_cuts on results "
                             "re-evaluation")
    parser.add_argument("--sep_bkg", default="OFF",
                        help="ON: report class-0-vs-each-background results separately")
    parser.add_argument("--runDiffPlots", default=0, type=int,
                        help="accepted for command-line compatibility; never read")
    parser.add_argument("--correlations", default="OFF",
                        help="accepted for command-line compatibility; never read")
    parser.add_argument("--feature_removal", default="OFF")
    parser.add_argument("--mixed_precision", default="AUTO",
                        help="bfloat16 compute with float32 master weights.  AUTO resolves "
                             "to ON for CNN and OFF for FCN, as in the JAX package; the "
                             "port computes in float32 and refuses ON")
    parser.add_argument("--valid_cuts", default="")
    parser.add_argument("--bkg_data", default="QCD-Geneva")
    parser.add_argument("--sig_data", default="top-Geneva")
    parser.add_argument("--synthetic", default=0, type=float)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train and predict on (default cuda)")
    return parser


def resolve_compute_dtype(mixed_precision, nn_type):
    """--mixed_precision AUTO/ON/OFF -> compute dtype: AUTO is bfloat16 for
    the CNN towers and float32 for the FCN."""
    value = str(mixed_precision).upper()
    if value == "AUTO":
        return "bfloat16" if nn_type == "CNN" else "float32"
    return "bfloat16" if value == "ON" else "float32"


ETA_REGIONS = ("0.0-1.3", "1.3-1.6", "1.6-2.5")


def _on(v):
    return v.upper() == "ON" if isinstance(v, str) else bool(v)


def _is_keras(path):
    if str(path).endswith((".h5", ".hdf5")):
        return True
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return f.read(8) == b"\x89HDF\r\n\x1a\n"
    return False


def _check_supported(args):
    """Refuse, before any data is loaded, what the port does not run yet."""
    if args.n_folds > 1 or _on(args.vmap_folds):
        raise NotImplementedError("--n_folds > 1 / --vmap_folds ON: k-fold cross-validation "
                                  "is ported with ROADMAP Queue 1 item 10")
    if _on(args.generator):
        raise NotImplementedError("--generator ON: streamed training chunks (merge_samples, "
                                  "the chunk loop) are ported with ROADMAP Queue 1 item 9")
    if _on(args.feature_removal):
        raise NotImplementedError("--feature_removal ON is ported with ROADMAP Queue 1 "
                                  "item 9")
    if (args.n_devices or 1) > 1:
        raise NotImplementedError("--n_devices > 1: data-parallel training is ported with "
                                  "ROADMAP Queue 1 item 11")
    if _on(args.plotting):
        raise NotImplementedError("--plotting ON draws ROC curves and class distributions, "
                                  "ported with ROADMAP Queue 1 item 6; pass --plotting OFF")
    if args.weight_type != "none":
        raise NotImplementedError(f"--weight_type {args.weight_type}: the sample-weight "
                                  "schemes are ported with ROADMAP Queue 1 item 9")
    if (args.model_in and _is_keras(os.path.join(args.output_dir, args.model_in))) or \
            _is_keras(args.model_out):
        raise NotImplementedError("Keras .h5 weights are read and written with "
                                  "train/keras_import.py and keras_export.py, ported with "
                                  "ROADMAP Queue 1 item 10; use a native .npz")
    if resolve_compute_dtype(args.mixed_precision, args.NN_type) != "float32":
        raise NotImplementedError("bfloat16 compute is ported with ROADMAP Queue 1 item 9 "
                                  "(the fused conv kernels are float32); --mixed_precision "
                                  "AUTO resolves to bfloat16 for --NN_type CNN: pass "
                                  "--mixed_precision OFF")


def _eta_cuts(args, sample):
    """Compose the named |eta| window into valid_cuts on results
    re-evaluation."""
    if args.eta_region not in ETA_REGIONS:
        return args.valid_cuts
    eta_1, eta_2 = args.eta_region.split("-")
    key = "eta" if "eta" in sample else "rljet_eta"
    cuts = (f'(abs(sample["{key}"]) >= {eta_1}) & '
            f'(abs(sample["{key}"]) <= {eta_2})')
    return cuts if not args.valid_cuts else f"{cuts} & ({args.valid_cuts})"


def _report_results(v_view, v_labels, probs, train_labels, args, device):
    """Accuracy / AUC / background rejection, for the merged background and
    (``--sep_bkg ON``) each background class separately.  Returns
    {background: (auc, rejections)}."""
    from ..eval.jetid_eval import compo_matrix, discriminant
    from ..eval.roc import auc_score
    from ..plotting.performance import background_rejection

    probs = np.asarray(probs)
    _, accuracy = compo_matrix(v_labels, train_labels, probs)
    print(f"\nVALIDATION SAMPLE ACCURACY: {accuracy:.2f} %")
    bkg_list = ["bkg"]
    if _on(args.sep_bkg) and probs.shape[1] > 2:
        bkg_list += sorted(set(range(probs.shape[1])) - {0})
    results = {}
    for bkg in bkg_list:
        view, disc_labels, disc = discriminant(v_view, v_labels, probs, (0,), bkg)
        auc = auc_score(disc_labels, disc, view["weights"], device)
        tag = "signal vs background" if bkg == "bkg" else f"class 0 vs {bkg}"
        print(f"VALIDATION AUC ({tag}): {auc:.4f}")
        results[bkg] = (auc, background_rejection(disc_labels, disc, view["weights"],
                                                  device=device))
    return results


def _reevaluate(args, out_root):
    """Saved-results re-evaluation: no data loading, no training."""
    path = out_root + "/" + args.results_in
    print("\nLOADING VALIDATION RESULTS FROM", path)
    with open(path, "rb") as f:   # written by this program (results_out)
        v_view, v_labels, probs = pickle.load(f)
    args.valid_cuts = _eta_cuts(args, v_view)
    if args.valid_cuts:
        from ..utils.expr import evaluate_cut
        keep = evaluate_cut(args.valid_cuts, v_view)
        v_view = {k: np.asarray(v)[keep] for k, v in v_view.items()}
        v_labels, probs = v_labels[keep], probs[keep]
        print(f"valid_cuts kept {len(v_labels)} jets")
    _report_results(v_view, v_labels, probs, (), args, _HOST)


def _resolve_in(path, out_root):
    """Resolve a --*_in file against cwd then output_dir; a named but
    missing file warns instead of silently refitting."""
    if not path:
        return None
    for cand in (path, out_root + "/" + path):
        if os.path.isfile(cand):
            return cand
    print(f"WARNING: --scaler file '{path}' not found (also tried {out_root}/) -> refitting")
    return None


def main(argv=None):
    import torch
    from .. import resolve_device
    from ..utils.logging import args_banner
    from ..data import (make_sample, fit_scaler, apply_scaler, constituent_images,
                        ensure_synthetic_registry, HLV_LIST, Scaler)
    from ..models import JetIDConfig, init_jetid
    from ..train.jetid_loop import train_classifier, predict_classifier
    from ..train.checkpoint import load_pytree
    from ..eval.jetid_eval import make_labels, get_class_weight

    args = build_parser().parse_args(argv)
    for key in ["n_train", "n_valid", "n_eval", "batch_size"]:
        setattr(args, key, int(getattr(args, key)))
    out_root = args.output_dir
    if args.results_in:
        Path(out_root).mkdir(parents=True, exist_ok=True)
        print("\nPROGRAM ARGUMENTS:\n" + args_banner(args))
        _reevaluate(args, out_root)
        return 0
    _check_supported(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 compute is float32 in every layer: cuDNN would run the
        # later conv blocks in TF32 (about three decimal digits) by default
        torch.backends.cudnn.allow_tf32 = False
    Path(out_root).mkdir(parents=True, exist_ok=True)
    if args.synthetic:
        ensure_synthetic_registry(n_events=int(args.synthetic),
                                  n_const_max=max(args.n_const, 20))
    print("\nPROGRAM ARGUMENTS:\n" + args_banner(args))

    hlv_list = list(HLV_LIST)
    cuts = ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)']
    n_total = args.n_train + args.n_valid
    sample = make_sample(args.bkg_data, args.sig_data, n_total, n_total, cuts, args.n_const,
                         args.n_dims, args.constituents, args.HLVs, hlv_list,
                         shuffling=True, device=_HOST)
    labels = make_labels(sample, args.n_classes)
    n = len(labels)
    n_train = min(args.n_train, n // 2)
    train_idx, valid_idx = np.arange(n_train), np.arange(n_train, n)
    if args.train_cuts or args.valid_cuts:
        from ..utils.expr import evaluate_cut
        arrays = {k: np.asarray(v) for k, v in sample.items() if np.ndim(v) >= 1}
        if args.train_cuts:
            train_idx = train_idx[evaluate_cut(args.train_cuts, arrays)[train_idx]]
        if args.valid_cuts:
            valid_idx = valid_idx[evaluate_cut(args.valid_cuts, arrays)[valid_idx]]

    scalars, scalar_dims = [], []
    if _on(args.HLVs) and _on(args.scalars):
        scalars, scalar_dims = ["HLVs"], [sample["HLVs"].shape[1]]
    const_dim = sample["constituents"].shape[1] if _on(args.constituents) else 0
    images, image_shapes = (), ()
    if args.NN_type == "CNN" and _on(args.images):
        # CNN mode trains a conv tower on pt-weighted constituent images
        if not _on(args.constituents):
            raise SystemExit("--NN_type CNN requires --constituents ON")
        px = args.image_size
        imgs = np.asarray(constituent_images(sample["constituents"], px, n_dims=args.n_dims,
                                             device=_HOST), np.float32)
        # the normalization scale is fitted on the training rows only and
        # kept beside the model, so a --model_in run on another slice sees
        # the feature scale the model was trained with
        scale_file = out_root + "/image_scale.pkl"
        if args.model_in and os.path.isfile(scale_file):
            with open(scale_file, "rb") as f:   # written by this program
                img_scale = pickle.load(f)
            print(f"Loaded image scale {img_scale:g} from: {scale_file}")
        else:
            fit_rows = imgs[train_idx] if len(train_idx) else imgs
            img_scale = max(float(fit_rows.max()), 1e-6)
            with open(scale_file, "wb") as f:
                pickle.dump(img_scale, f)
        sample["images"] = imgs / img_scale
        images, image_shapes = ("images",), ((px, px),)
        const_dim = 0   # the flat branch is replaced by the image tower
    if not (images or const_dim or scalar_dims):
        raise SystemExit("no input branches left: at least one of "
                         "--images/--scalars/--constituents/--HLVs must be ON")
    config = JetIDConfig(n_classes=args.n_classes, scalars=tuple(scalars),
                         scalar_dims=tuple(scalar_dims), constituent_dim=const_dim,
                         nn_type=args.NN_type, images=images, image_shapes=image_shapes,
                         fcn_neurons=tuple(args.FCN_neurons), dropout=args.dropout,
                         l2=args.l2,
                         compute_dtype=resolve_compute_dtype(args.mixed_precision,
                                                             args.NN_type))
    params = init_jetid(torch.Generator(device).manual_seed(0), config, device=device)

    # scaling only when ON and scalar branches exist
    scaling = bool(scalars) and _on(args.scaling)
    scaler_in = _resolve_in(args.scaler_in, out_root) if scaling else None
    if scaler_in:
        print("Loaded HLV scaler from:", scaler_in)
        sample["HLVs"] = apply_scaler(sample["HLVs"], scaler=Scaler.load(scaler_in),
                                      device=_HOST)
    elif args.scaler_type and scaling:
        scaler_out = args.scaler_out or f"scaler_{args.scaler_type}.pkl"
        scaler = fit_scaler(sample["HLVs"][train_idx], scaler_out=out_root + "/" + scaler_out,
                            scaler_type=args.scaler_type)
        sample["HLVs"] = apply_scaler(sample["HLVs"], scaler=scaler, device=_HOST)

    # track scaler: a RobustScaler per component on the flat constituents
    if const_dim and _on(args.t_scaling):
        t_scaler_in = _resolve_in(args.t_scaler_in, out_root)
        if t_scaler_in:
            t_scaler = Scaler.load(t_scaler_in)
            print("Loaded track scaler from:", t_scaler_in)
        else:
            fit_rows = sample["constituents"][train_idx if len(train_idx) else slice(None)]
            print("Fitting track scaler", end="")
            t_scaler = fit_scaler(fit_rows, n_dims=args.n_dims,
                                  scaler_out=out_root + "/" + args.t_scaler_out,
                                  scaler_type="RobustScaler", reshape=True, verbose=False)
            print(" -> " + out_root + "/" + args.t_scaler_out)
        sample["constituents"] = apply_scaler(sample["constituents"], args.n_dims, t_scaler,
                                              tag="tracks", reshape=True, verbose=False,
                                              device=_HOST)

    def inputs_for(idx):
        out = {}
        if scalars:
            out["HLVs"] = sample["HLVs"][idx]
        if const_dim:
            out["constituents"] = sample["constituents"][idx]
        for name in images:
            out[name] = sample[name][idx]
        return out

    model_out = out_root + "/" + args.model_out
    if args.n_epochs > 0:
        state_file = out_root + "/" + args.state_file if args.state_file else None
        params, _ = train_classifier(
            params, config, inputs_for(train_idx), labels[train_idx], inputs_for(valid_idx),
            labels[valid_idx], args.n_epochs, args.batch_size, args.lr, args.patience,
            get_class_weight(labels[train_idx], args.bkg_ratio), None, model_out,
            state_file=state_file, verbose=bool(args.verbose), monitor=args.metrics)
    elif args.model_in and os.path.isfile(out_root + "/" + args.model_in):
        params = load_pytree(out_root + "/" + args.model_in, params)

    probs = predict_classifier(params, config, inputs_for(valid_idx))
    v_labels = labels[valid_idx]
    v_view = {k: np.asarray(v)[valid_idx] for k, v in sample.items() if np.ndim(v) >= 1}
    _report_results(v_view, v_labels, probs, labels[train_idx], args, device)
    with open(out_root + "/" + args.results_out, "wb") as f:
        pickle.dump((v_view, v_labels, probs), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
