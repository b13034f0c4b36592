"""jet-ID entry point on PyTorch/CUDA: supervised CNN/FCN classifier
training, prediction and results.

Counterpart of ``atlasvae/cli/jetid.py``: the same flag names and 'ON'/'OFF'
string booleans, sample selection, constituent images, scalers, training
with the Keras-style callbacks, prediction and the accuracy / AUC /
background-rejection report, plus ``--device`` (default ``cuda``).  Data are
prepared on the host; the device gets packed batches.

    python -m atlasvae_torch.cli.jetid --NN_type CNN --plotting OFF \\
        --synthetic 200000 --n_train 1e5 --n_valid 5e4 --n_epochs 3 \\
        --weight_type flattening --bkg_ratio 1 --output_dir out
    python -m atlasvae_torch.cli.jetid --NN_type CNN --plotting OFF \\
        --n_train 1e5 --n_valid 5e4 --n_epochs 0 \\
        --model_in model.npz --output_dir out          # predict only

``--mixed_precision AUTO``, the default, computes the CNN in bfloat16 with
float32 master weights, as the JAX package does (``OFF``: float32); the FCN
in float32 (``ON``: bfloat16).  ``--weight_type`` picks a (pt, |eta|)
histogram-matching sample-weight scheme; ``--generator ON`` streams the
training slice in chunks of ``--memGB`` per epoch (FCN only, as in the JAX
package), with scalers fitted on the first chunk and the weight scheme
computed per chunk.  ``--feature_removal ON`` (scalar branches only)
retrains the model once without each HLV, for max(2, n_epochs // 4)
epochs, and prints the ranking of the accuracy drops; with
``--generator ON`` it exits, as in the JAX package.  ``--n_folds k`` (k > 1)
trains k models, fold f on the events whose index is not f - 1 modulo k,
writes ``model_<f>.npz``, and reports the merged cross-validated
predictions of every event (``cross_valid``) as the validation result;
``--vmap_folds ON`` trains the k folds (and the feature-removal runs)
through ``train_kfold_vmapped``, on the JAX package's common batch grid.

``--model_in`` takes a native npz or a Keras ``.h5`` (trained by the
reference or exported here), told apart by the file's signature, with the
model's config for the multi-image concat layout; a training run with
``--model_out model.h5`` ends with the Keras export of its weights (the
float32 master weights) in place of its npz checkpoint, except in k-fold
mode, whose files stay ``model_<f>.npz``.  Keras files go through h5py
where it is installed and through ``data/hdf5.py``'s ``LiteFile`` where it
is not (the machine with the card).

``--n_devices N`` (``--n_gpus``, the reference's MirroredStrategy count)
above 1 trains data-parallel over N ranks, one a card (1 under ``--device
cpu``; 0 means 1, as in the JAX CLI), with the batch N times
``--batch_size`` (ref jet-ID/classifier.py:136-138); k-fold runs train
their folds in turn over the ranks, and ``--vmap_folds ON`` is refused with
it, as in the JAX package.  Rank 0 alone prints, writes, predicts and
draws.
``--plotting ON``, the default, draws the ROC curves and class
distributions with matplotlib; where matplotlib cannot be imported it is
refused before any data is loaded (pass ``--plotting OFF``).
"""

import os
import pickle
import sys
from argparse import ArgumentParser, SUPPRESS
from pathlib import Path

import numpy as np

from ..parallel.mesh import is_writer
from ..parallel.multihost import cli_ranks, launch

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
                        help="ON: train the k folds (and the feature-removal runs) "
                             "through train_kfold_vmapped")
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
                        help="stream training chunks per epoch (FCN mode)")
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
                             "to ON for CNN and OFF for FCN, as in the JAX package")
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
WEIGHT_TYPES = ("bkg_ratio", "flattening", "match2class", "match2max")


def _on(v):
    return v.upper() == "ON" if isinstance(v, str) else bool(v)


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


def _report_results(v_view, v_labels, probs, train_labels, args, out_root, device):
    """Accuracy / AUC / background rejection and (``--plotting ON``) the
    ROC curves, for the merged background and (``--sep_bkg ON``) each
    background class separately, in ``class_0_vs_<k>`` folders, and the
    class distributions of the merged background.  Returns
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
        if _on(args.plotting):
            from ..plotting.performance import roc_curves, class_distributions
            folder = out_root if bkg == "bkg" else out_root + f"/class_0_vs_{bkg}"
            Path(folder).mkdir(parents=True, exist_ok=True)
            roc_curves(disc_labels, {"jet-ID": disc}, view["weights"], ["jet-ID"], folder,
                       device=device)
            if bkg == "bkg":
                class_distributions(v_labels, probs, v_view["weights"], folder)
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
    _report_results(v_view, v_labels, probs, (), args, out_root, _HOST)


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
    from ..train.keras_export import maybe_export_keras
    from ..train.keras_import import load_params_auto
    from ..eval.jetid_eval import make_labels, get_class_weight, get_sample_weights
    from ..plotting.backend import require_matplotlib

    args = build_parser().parse_args(argv)
    for key in ["n_train", "n_valid", "n_eval", "batch_size"]:
        setattr(args, key, int(getattr(args, key)))
    out_root = args.output_dir
    if _on(args.plotting):          # before any load, --results_in's too
        require_matplotlib("--plotting ON")
    if args.results_in:
        Path(out_root).mkdir(parents=True, exist_ok=True)
        print("\nPROGRAM ARGUMENTS:\n" + args_banner(args))
        _reevaluate(args, out_root)
        return 0
    device = resolve_device(args.device)
    n_ranks = cli_ranks(args.n_devices, device, zero_means_all=False)
    Path(out_root).mkdir(parents=True, exist_ok=True)
    if args.synthetic:
        ensure_synthetic_registry(n_events=int(args.synthetic),
                                  n_const_max=max(args.n_const, 20))
    # synchronous data parallelism, the MirroredStrategy replacement (ref
    # jet-ID/models.py:69-81), with its per-replica batch scaling
    placed = launch(main, (list(sys.argv[1:] if argv is None else argv),), n_ranks, device)
    if placed is None:
        return 0
    mesh, device = placed
    writer = is_writer(mesh)
    batch_size = n_ranks * args.batch_size        # ref classifier.py:137-138
    print("\nPROGRAM ARGUMENTS:\n" + args_banner(args))

    hlv_list = list(HLV_LIST)
    cuts = ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)']
    n_total = args.n_train + args.n_valid
    streaming = _on(args.generator)
    first_chunk = None
    if streaming:
        # only the validation slice is held; training chunks stream per epoch
        if args.n_folds > 1 or _on(args.feature_removal) or args.NN_type == "CNN":
            raise SystemExit("--generator ON supports the plain training path "
                             "(no k-fold CV / feature removal / CNN images)")
        chunk = int(1e9 * args.memGB / max(args.n_const * args.n_dims * 4, 1))
        chunk = max(args.batch_size, min(chunk, args.n_train))
        sample = make_sample(args.bkg_data, args.sig_data, [args.n_train, n_total],
                             [args.n_train, n_total], cuts, args.n_const, args.n_dims,
                             args.constituents, args.HLVs, hlv_list, shuffling=True,
                             device=_HOST)
        first_chunk = make_sample(args.bkg_data, args.sig_data, [0, chunk], [0, chunk], cuts,
                                  args.n_const, args.n_dims, args.constituents, args.HLVs,
                                  hlv_list, shuffling=True, device=_HOST)
    else:
        sample = make_sample(args.bkg_data, args.sig_data, n_total, n_total, cuts, args.n_const,
                             args.n_dims, args.constituents, args.HLVs, hlv_list,
                             shuffling=True, device=_HOST)
    labels = make_labels(sample, args.n_classes)
    n = len(labels)
    n_train = 0 if streaming else min(args.n_train, n // 2)
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
            if writer:
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
    # generator mode fits the scalers on the first training chunk
    scaling = bool(scalars) and _on(args.scaling)
    scaler_in = _resolve_in(args.scaler_in, out_root) if scaling else None
    scaler = t_scaler = None
    if scaler_in:
        print("Loaded HLV scaler from:", scaler_in)
        scaler = Scaler.load(scaler_in)
        sample["HLVs"] = apply_scaler(sample["HLVs"], scaler=scaler, device=_HOST)
    elif args.scaler_type and scaling:
        scaler_out = args.scaler_out or f"scaler_{args.scaler_type}.pkl"
        fit_rows = first_chunk["HLVs"] if streaming else sample["HLVs"][train_idx]
        scaler = fit_scaler(fit_rows, scaler_out=out_root + "/" + scaler_out if writer else None,
                            scaler_type=args.scaler_type)
        sample["HLVs"] = apply_scaler(sample["HLVs"], scaler=scaler, device=_HOST)

    # track scaler: a RobustScaler per component on the flat constituents
    if const_dim and _on(args.t_scaling):
        t_scaler_in = _resolve_in(args.t_scaler_in, out_root)
        if t_scaler_in:
            t_scaler = Scaler.load(t_scaler_in)
            print("Loaded track scaler from:", t_scaler_in)
        else:
            fit_rows = first_chunk["constituents"] if streaming else \
                sample["constituents"][train_idx if len(train_idx) else slice(None)]
            print("Fitting track scaler", end="")
            t_scaler = fit_scaler(fit_rows, n_dims=args.n_dims,
                                  scaler_out=out_root + "/" + args.t_scaler_out if writer
                                  else None,
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

    class_source = make_labels(first_chunk, args.n_classes) if streaming else labels[train_idx]
    class_weight = get_class_weight(class_source, args.bkg_ratio)
    sample_weight = None
    if not streaming and args.weight_type in WEIGHT_TYPES:
        train_view = {k: np.asarray(v)[train_idx] for k, v in sample.items() if np.ndim(v) >= 1}
        sample_weight, _ = get_sample_weights(train_view, labels[train_idx], args.weight_type,
                                              args.bkg_ratio)
        # sparse (pt, eta) bins give inf ratios: those rows get weight 0 (or
        # a NaN loss would stop the training), uniform weights if all do
        sample_weight = np.where(np.isfinite(sample_weight), sample_weight,
                                 0.0).astype(np.float32)
        if sample_weight.sum() <= 0:
            print("weight scheme degenerate -> uniform")
            sample_weight = None

    model_out = out_root + "/" + args.model_out
    state_file = out_root + "/" + args.state_file if args.state_file else None
    if args.n_folds > 1:
        # k-fold CV keyed on the event index: fold f trains on the events
        # whose index is not f - 1 modulo k, saves model_<f>.npz, and
        # cross_valid merges the folds' predictions
        from ..eval.jetid_eval import compo_matrix, cross_valid
        from ..train.checkpoint import save_pytree
        event_number = np.arange(n)
        fold_splits = [(np.where(event_number % args.n_folds != fold - 1)[0],
                        np.where(event_number % args.n_folds == fold - 1)[0])
                       for fold in range(1, args.n_folds + 1)]
        fold_outs = [out_root + f"/model_{fold}.npz" for fold in range(1, args.n_folds + 1)]

        def fold_init(fold):
            return init_jetid(torch.Generator().manual_seed(fold), config, device=device)

        def fold_weights(idx):
            if class_weight is None:
                return np.ones(len(idx), np.float32)
            return np.asarray([class_weight[int(l)] for l in labels[idx]], np.float32)

        if _on(args.vmap_folds):
            if mesh is not None:
                raise SystemExit("--vmap_folds ON shards the fold axis, not the data axis — "
                                 "drop --n_devices or use sequential folds")
            from ..train.jetid_loop import train_kfold_vmapped
            best, _ = train_kfold_vmapped(
                [fold_init(fold) for fold in range(1, args.n_folds + 1)], config,
                [(inputs_for(t), labels[t], fold_weights(t)) for t, _ in fold_splits],
                [(inputs_for(v), labels[v], np.ones(len(v), np.float32)) for _, v in fold_splits],
                args.n_epochs, batch_size, args.lr, args.patience, fold_outs,
                monitor=args.metrics, verbose=bool(args.verbose))
            print(f"{args.n_folds} folds trained through train_kfold_vmapped")
        else:
            best = []
            for fold, (t_idx, v_idx) in enumerate(fold_splits, start=1):
                fold_params, _ = train_classifier(
                    fold_init(fold), config, inputs_for(t_idx), labels[t_idx],
                    inputs_for(v_idx), labels[v_idx], args.n_epochs, batch_size, args.lr,
                    args.patience, class_weight, None, fold_outs[fold - 1], verbose=False,
                    mesh=mesh, monitor=args.metrics)
                best.append(fold_params)
                print(f"fold {fold}/{args.n_folds} trained")
        if not writer:      # the rest has no collective: rank 0 alone runs it
            return 0
        # cross_valid loads every fold's file, written even where no epoch
        # improved (or --n_epochs 0)
        for path, fold_params in zip(fold_outs, best):
            if not os.path.isfile(path):
                save_pytree(path, fold_params)
        cv_sample = {"eventNumber": event_number, **inputs_for(slice(None))}
        cv_probs = cross_valid(cv_sample, labels, config, out_root, args.n_folds, params)
        _, cv_acc = compo_matrix(labels, (), cv_probs)
        print(f"\n{args.n_folds}-FOLD CV ACCURACY: {cv_acc:.2f} %")
        # the cross-validated predictions are the validation result: every
        # event scored by the fold that held it out; no single model is trained
        valid_idx = np.arange(n)
    elif args.n_epochs > 0 and streaming:
        from ..train.jetid_loop import train_classifier_streaming
        from ..utils.chunks import index_ranges
        # the JAX package also tunes glibc's heap for the chunk buffers here
        # (utils/hostmem.py::enable_heap_reuse); that is left out on purpose

        def load_iter():
            for lo, hi in index_ranges(args.n_train, bin_size=chunk):
                ch = make_sample(args.bkg_data, args.sig_data, [lo, hi], [lo, hi], cuts,
                                 args.n_const, args.n_dims, args.constituents, args.HLVs,
                                 hlv_list, shuffling=True, verbose=False, device=_HOST)
                if args.train_cuts:   # applied per chunk in generator mode
                    from ..utils.expr import evaluate_cut
                    keep = evaluate_cut(args.train_cuts, {k: np.asarray(v) for k, v in ch.items()
                                                          if np.ndim(v) >= 1})
                    ch = {k: np.asarray(v)[keep] if np.ndim(v) >= 1 else v
                          for k, v in ch.items()}
                ch_labels = make_labels(ch, args.n_classes)
                if scalars and scaler is not None:
                    ch["HLVs"] = apply_scaler(ch["HLVs"], scaler=scaler, verbose=False,
                                              device=_HOST)
                if const_dim and t_scaler is not None:
                    ch["constituents"] = apply_scaler(ch["constituents"], args.n_dims, t_scaler,
                                                      tag="tracks", reshape=True, verbose=False,
                                                      device=_HOST)
                w = np.ones(len(ch_labels), np.float32) if class_weight is None else \
                    np.asarray([class_weight[int(l)] for l in ch_labels], np.float32)
                if args.weight_type in WEIGHT_TYPES:
                    # the scheme per chunk: a small chunk's sparse bins give
                    # inf/NaN rows (weight 0); a chunk that degenerates
                    # keeps its class weights alone
                    sw, _ = get_sample_weights({k: np.asarray(v) for k, v in ch.items()
                                                if np.ndim(v) >= 1}, ch_labels,
                                               args.weight_type, args.bkg_ratio)
                    sw = np.asarray(sw, np.float32)
                    sw = np.where(np.isfinite(sw), sw, 0.0)
                    if sw.sum() > 0:
                        w = w * sw
                    else:
                        print("chunk weight scheme degenerate -> uniform")
                inputs = {}
                if scalars:
                    inputs["HLVs"] = ch["HLVs"]
                if const_dim:
                    inputs["constituents"] = ch["constituents"]
                yield inputs, ch_labels, w

        # --n_eval: per-epoch validation on the first n_eval rows of the
        # validation slice; the results use all of it
        eval_idx = valid_idx[:args.n_eval] if args.n_eval else valid_idx
        if args.n_eval:
            print(f"Per-epoch validation on {len(eval_idx)} of {len(valid_idx)} validation "
                  "jets (--n_eval)")
        params, _ = train_classifier_streaming(
            params, config, load_iter, inputs_for(eval_idx), labels[eval_idx], args.n_epochs,
            batch_size, args.lr, args.patience, model_out, state_file=state_file,
            verbose=bool(args.verbose), mesh=mesh, monitor=args.metrics)
    elif args.n_epochs > 0:
        params, _ = train_classifier(
            params, config, inputs_for(train_idx), labels[train_idx], inputs_for(valid_idx),
            labels[valid_idx], args.n_epochs, batch_size, args.lr, args.patience,
            class_weight, sample_weight, model_out, state_file=state_file,
            verbose=bool(args.verbose), mesh=mesh, monitor=args.metrics)
    elif args.model_in and os.path.isfile(out_root + "/" + args.model_in):
        params = load_params_auto(out_root + "/" + args.model_in, params, "jetid", config)
    if not writer:          # the rest has no collective: rank 0 alone runs it
        return 0
    if args.n_epochs > 0 and args.n_folds <= 1 and \
            maybe_export_keras(params, model_out, "jetid", config):
        print("Keras-compatible weights exported to " + model_out)

    if _on(args.feature_removal) and scalars:
        # the ranking of the HLV columns by the accuracy lost without each
        from ..eval.jetid_eval import feature_removal
        names = hlv_list[:sample["HLVs"].shape[1]]
        drops = feature_removal(
            config, inputs_for(train_idx), labels[train_idx], inputs_for(valid_idx),
            labels[valid_idx], names,
            init_fn=lambda i: init_jetid(torch.Generator().manual_seed(i), config,
                                         device=device),
            epochs=max(2, args.n_epochs // 4), batch_size=args.batch_size, lr=args.lr,
            vmapped=_on(args.vmap_folds))
        print("\nFEATURE-ABLATION RANKING (accuracy drop when removed):")
        for name, drop in sorted(drops.items(), key=lambda kv: -kv[1]):
            print(f"  {name:20s} {100 * drop:+.2f} %")

    probs = cv_probs if args.n_folds > 1 else \
        predict_classifier(params, config, inputs_for(valid_idx))
    v_labels = labels[valid_idx]
    v_view = {k: np.asarray(v)[valid_idx] for k, v in sample.items() if np.ndim(v) >= 1}
    _report_results(v_view, v_labels, probs, labels[train_idx], args, out_root, device)
    with open(out_root + "/" + args.results_out, "wb") as f:
        pickle.dump((v_view, v_labels, probs), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
