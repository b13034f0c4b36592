"""jet-ID evaluation on the host: labels, class and sample weights,
up/down-sampling, composition matrix, k-fold prediction merge,
discriminant, multi-threshold scans and the feature-ablation ranking.

Copies of ``make_labels``, ``get_class_weight``, ``get_sample_weights``,
``upsampling``, ``downsampling``, ``valid_accuracy``, ``compo_matrix``,
``cross_valid``, ``discriminant``, ``multi_cuts`` and ``feature_removal`` of
``atlasvae/eval/jetid_eval.py`` (numpy on the host; the draws come from
``np.random.default_rng(seed)``, so the picks are the JAX package's
indices; ``cross_valid`` predicts and ``feature_removal`` retrains through
``train/jetid_loop.py`` on the device the weights lie on).  ``upsampling``,
``downsampling`` and ``multi_cuts`` have no caller in either package's
CLI: they are kept for library parity.
"""

import itertools

import numpy as np


def make_labels(sample, n_classes=2):
    """Signal (JZW == -1) -> 0, background -> 1."""
    if "labels" in sample:
        return np.asarray(sample["labels"], int)
    return np.where(np.asarray(sample["JZW"]) == -1, 0, 1).astype(int)


def get_class_weight(labels, bkg_ratio=0):
    """Per-class weights balancing signal against the backgrounds; None for
    two classes without a ratio."""
    labels = np.asarray(labels)
    n_e = len(labels)
    n_classes = int(max(labels)) + 1
    if bkg_ratio == 0 and n_classes == 2:
        return None
    if bkg_ratio == 0:
        bkg_ratio = 1
    ratios = {0: 1, **{n: bkg_ratio for n in range(1, n_classes)}}
    return {n: n_e / np.sum(labels == n) * ratios[n] / sum(ratios.values())
            for n in range(n_classes)}


def get_sample_weights(sample, labels, weight_type=None, bkg_ratio=None,
                       hist="2d", ref_class=0, density=False):
    """(pt, |eta|) histogram-matching sample weights
    (ref jet-ID/utils.py:40-91: bkg_ratio / flattening / match2class /
    match2max schemes; same bin construction and normalization)."""
    if weight_type not in ("bkg_ratio", "flattening", "match2class", "match2max"):
        return None, None
    labels = np.asarray(labels)
    pt = np.asarray(sample["pt"])
    eta = np.abs(np.asarray(sample["eta"] if "eta" in sample else sample["rljet_eta"]))
    n_classes = int(max(labels)) + 1
    n_bins = 100
    base = (np.max(pt) / np.min(pt)) ** (1 / n_bins)
    pt_bins = [np.min(pt) * base ** n for n in range(n_bins + 1)]
    pt_bins[-1] = max(pt_bins[-1], np.max(pt)) + 1e-3
    n_bins = 50
    step = np.max(eta) / n_bins
    eta_bins = np.arange(np.min(eta), np.max(eta) + step, step)
    eta_bins[-1] = max(eta_bins[-1], np.max(eta)) + 1e-3
    if hist == "pt":
        eta_bins = [eta_bins[0], eta_bins[-1]]
    if hist == "eta":
        pt_bins = [pt_bins[0], pt_bins[-1]]
    pt_ind = np.digitize(pt, pt_bins, right=False) - 1
    eta_ind = np.digitize(eta, eta_bins, right=False) - 1
    hist_ref = np.histogram2d(pt[labels == ref_class], eta[labels == ref_class],
                              bins=[pt_bins, eta_bins], density=density)[0]
    if density:
        hist_ref *= np.sum(labels == ref_class)
    hist_ref = np.maximum(hist_ref, np.min(hist_ref[hist_ref != 0]))
    if np.isscalar(bkg_ratio):
        bkg_ratio = n_classes * [bkg_ratio]
    total_ref_array, total_bkg_array, hist_bkg_array = [], [], []
    for n in [c for c in range(n_classes) if c != ref_class]:
        hist_bkg = np.histogram2d(pt[labels == n], eta[labels == n],
                                  bins=[pt_bins, eta_bins], density=density)[0]
        if density:
            hist_bkg *= np.sum(labels == n)
        hist_bkg = np.maximum(hist_bkg, np.min(hist_bkg[hist_bkg != 0]))
        ratio = np.sum(hist_bkg) / np.sum(hist_ref) if bkg_ratio is None \
            else bkg_ratio[n]
        if weight_type == "bkg_ratio":
            total_ref = hist_ref * max(1, np.sum(hist_bkg) / np.sum(hist_ref) / ratio)
            total_bkg = hist_bkg * max(1, np.sum(hist_ref) / np.sum(hist_bkg) * ratio)
        elif weight_type == "flattening":
            total_ref = np.ones(hist_ref.shape) * max(np.max(hist_ref),
                                                      np.max(hist_bkg) / ratio)
            total_bkg = np.ones(hist_bkg.shape) * max(np.max(hist_bkg),
                                                      np.max(hist_ref) * ratio)
        elif weight_type == "match2class":
            total_ref = hist_ref * max(1, np.max(hist_bkg / hist_ref) / ratio)
            total_bkg = total_ref * ratio
        else:  # match2max
            total_ref = np.maximum(hist_ref, hist_bkg / ratio)
            total_bkg = np.maximum(hist_bkg, hist_ref * ratio)
        total_ref_array.append(total_ref[None, ...])
        total_bkg_array.append(total_bkg[None, ...])
        hist_bkg_array.append(hist_bkg[None, ...])
    hist_ref_array = hist_ref[None, ...]
    hist_bkg_array = np.concatenate(hist_bkg_array, axis=0)
    total_ref_array = np.concatenate(total_ref_array, axis=0)
    total_bkg_array = np.concatenate(total_bkg_array, axis=0)
    total_ref_ratio = total_ref_array / np.max(total_ref_array, axis=0)
    total_ref_array = np.max(total_ref_array, axis=0)
    total_bkg_array = total_bkg_array / total_ref_ratio
    weights_array = np.concatenate([total_ref_array / hist_ref_array,
                                    total_bkg_array / hist_bkg_array])
    sample_weight = np.zeros(len(labels), np.float32)
    class_list = [ref_class] + [n for n in range(n_classes) if n != ref_class]
    for n in range(n_classes):
        sample_weight = np.where(labels == class_list[n],
                                 weights_array[n, ...][pt_ind, eta_ind],
                                 sample_weight)
    return (sample_weight * len(labels) / np.sum(sample_weight),
            {"pt": pt_bins, "eta": eta_bins})


def upsampling(sample, labels, bins, indices, hist_sig, hist_bkg,
               total_sig, total_bkg, seed=0):
    """Duplicate-sample classes up to target pt-bin populations
    (ref jet-ID/utils.py:100-113)."""
    rng = np.random.default_rng(seed)
    new_sig = np.int_(np.around(total_sig)) - hist_sig
    new_bkg = np.int_(np.around(total_bkg)) - hist_bkg
    picks = []
    for n in range(len(bins) - 1):
        for mask, new in [((indices == n) & (labels == 0), new_sig[n]),
                          ((indices == n) & (labels != 0), new_bkg[n])]:
            idx = np.where(mask)[0]
            if len(idx) == 0:
                continue
            picks.append(idx)
            if new > 0:
                picks.append(rng.choice(idx, new, replace=len(idx) < new))
    indices = np.concatenate(picks)
    rng.shuffle(indices)
    return ({key: np.take(val, indices, axis=0) for key, val in sample.items()},
            np.take(labels, indices))


def downsampling(sample, labels, bkg_ratio=None, pt_key="pt", seed=0):
    """Bin-matched signal/background downsampling split
    (ref jet-ID/utils.py:116-130)."""
    rng = np.random.default_rng(seed)
    pt = np.asarray(sample[pt_key])
    bins = [0, 10, 20, 30, 40, 60, 80, 100, 130, 180, 250, 500]
    indices = np.digitize(pt, bins, right=True) - 1
    hist_sig = np.histogram(pt[labels == 0], bins)[0]
    hist_bkg = np.histogram(pt[labels != 0], bins)[0]
    if bkg_ratio is None:
        bkg_ratio = np.sum(hist_bkg) / np.sum(hist_sig)
    total_sig = np.int_(np.around(np.minimum(hist_sig, hist_bkg / bkg_ratio)))
    total_bkg = np.int_(np.around(np.minimum(hist_bkg, hist_sig * bkg_ratio)))
    ind_sig = [np.where((indices == n) & (labels == 0))[0][:total_sig[n]]
               for n in range(len(bins) - 1)]
    ind_bkg = [np.where((indices == n) & (labels != 0))[0][:total_bkg[n]]
               for n in range(len(bins) - 1)]
    valid_ind = np.concatenate(ind_sig + ind_bkg)
    rng.shuffle(valid_ind)
    train_ind = np.setdiff1d(np.arange(len(pt)), valid_ind)
    pick = lambda idx: ({k: np.take(v, idx, axis=0) for k, v in sample.items()},
                        np.take(labels, idx))
    return (*pick(valid_ind), *pick(train_ind))


def valid_accuracy(labels, probs):
    return np.sum(np.argmax(probs, axis=1) == labels) / len(labels)


def compo_matrix(valid_labels, train_labels=(), valid_probs=None):
    """Composition/confusion matrix in percent; returns (matrix, accuracy)."""
    valid_labels = np.asarray(valid_labels)
    if valid_probs is None:
        pred = valid_labels
    else:
        pred = np.argmax(valid_probs, axis=1)
    n_classes = int(max(valid_labels.max(), pred.max())) + 1
    matrix = np.zeros((n_classes, n_classes))
    np.add.at(matrix, (valid_labels, pred), 1)
    matrix = 100 * matrix.T / np.maximum(matrix.sum(axis=1), 1)
    ratios = np.array([100 * np.mean(valid_labels == n) for n in range(n_classes)])
    accuracy = ratios @ np.diag(matrix) / 100
    return matrix, accuracy


def cross_valid(valid_sample, valid_labels, config, output_dir, n_folds, params_template,
                scalers=None):
    """k-fold prediction merge keyed on ``eventNumber % n_folds``: each event
    is scored by ``model_<fold>.npz``, the fold that held it out (the
    reference returns an undefined name here; the merged probabilities are
    returned).  The probabilities are as wide as ``config.n_classes``, not
    as the labels present, and -1.0 where no fold scored an event;
    ``scalers``: optional {fold: HLV scaler} applied to the scalar branches.
    Predicts on the device of ``params_template``."""
    from ..data.scalers import apply_scaler
    from ..train.checkpoint import load_pytree, tree_flatten
    from ..train.jetid_loop import predict_classifier

    device = tree_flatten(params_template)[0].device
    valid_probs = np.full(valid_labels.shape + (config.n_classes,), -1.0)
    event_number = np.asarray(valid_sample["eventNumber"])
    for fold in range(1, n_folds + 1):
        mask = event_number % n_folds == fold - 1
        sample = {k: v[mask] for k, v in valid_sample.items()}
        params = load_pytree(f"{output_dir}/model_{fold}.npz", params_template)
        if scalers and scalers.get(fold) is not None:
            for key in sample:
                if key in config.scalars:
                    sample[key] = apply_scaler(sample[key], scaler=scalers[fold],
                                               verbose=False, device=device)
        inputs = {k: sample[k] for k in list(config.scalars) + list(config.images)
                  + (["constituents"] if config.constituent_dim else [])}
        probs = predict_classifier(params, config, inputs)
        valid_probs[mask] = probs
        print(f"FOLD {fold}/{n_folds} ACCURACY: "
              f"{100 * valid_accuracy(valid_labels[mask], probs):.2f} %")
    return valid_probs


def discriminant(sample, labels, probs, sig_list=(0,), bkg="bkg"):
    """Multi-class -> binary discriminant combination."""
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    if probs.shape[1] > 2:
        bkg_list = sorted(set(range(probs.shape[1])) - set(sig_list))
        bkg = bkg_list if bkg == "bkg" else [bkg]
        ratios = np.array([np.mean(labels == n) for n in range(probs.shape[1])])
        new_labels = np.array([0 if l in sig_list else 1 if l in bkg else -1
                               for l in labels])
        keep = new_labels != -1
        sig_probs = sum(ratios[n] * probs[:, n] for n in sig_list)[keep]
        bkg_probs = sum(ratios[n] * probs[:, n] for n in bkg_list)[keep]
        sample = {k: v[keep] for k, v in sample.items()}
        new_labels = new_labels[keep]
        tie = sig_probs == bkg_probs
        sig_probs = np.where(tie, 0.5, sig_probs)
        bkg_probs = np.where(tie, 0.5, bkg_probs)
        return sample, new_labels, sig_probs / (sig_probs + bkg_probs)
    return sample, labels, probs[:, 0]


def multi_cuts(labels, probs, step=0.2, multi=True):
    """Efficiencies over a grid of per-class probability-ratio thresholds,
    rows sorted by descending signal efficiency."""
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    n_classes = probs.shape[1]
    repeat = n_classes - 1 if multi else n_classes
    cut_list = np.arange(0, 1, step)
    cut_tuples = np.array(list(itertools.product(cut_list, repeat=repeat)))
    results = []
    for fracs in cut_tuples:
        if multi:
            cuts = probs[:, 0] >= np.max(probs[:, 1:] * (fracs / (1 - fracs)), axis=1)
        else:
            cuts = probs[:, 0] >= (probs[:, 1:] @ fracs[1:]) * (fracs[0] / (1 - fracs[0]))
        row = [np.sum((labels == c) & cuts) / max(np.sum(labels == c), 1)
               for c in range(n_classes)]
        row.append(np.sum((labels != 0) & cuts) / max(np.sum(labels != 0), 1))
        results.append(row)
    results = np.array(results)
    return results[results[:, 0].argsort()[::-1]]


def _blank_column(d, i):
    """Copy of an inputs dict with 2-D scalar column ``i`` zeroed."""
    arrs = {k: np.array(v, np.float32, copy=True) for k, v in dict(d).items()}
    for k in arrs:
        if arrs[k].ndim == 2 and arrs[k].shape[1] > i:
            arrs[k][:, i] = 0.0
    return arrs


def feature_removal(config, inputs, labels, valid_inputs, valid_labels, features, init_fn,
                    epochs=10, batch_size=500, lr=1e-3, vmapped=False):
    """Feature-ablation ranking: retrain with each feature's column zeroed
    and compare the validation accuracy with the baseline's.  Scalars
    only; ``init_fn(i)`` gives lane i's initial weights (lane 0 the
    baseline, lane 1 + i the run without feature i).  Returns {feature:
    accuracy drop}.

    ``vmapped=True`` trains the F + 1 runs through one
    ``train_kfold_vmapped`` call (the same model, each lane its own blanked
    data), which equals the sequential runs wherever they pack their
    batches alike (``batch_size`` at most the sample's size)."""
    from ..train.jetid_loop import predict_classifier, train_classifier, train_kfold_vmapped
    if vmapped:
        ones_t = np.ones(len(labels), np.float32)
        ones_v = np.ones(len(valid_labels), np.float32)
        lanes = [dict(inputs)] + [_blank_column(inputs, i) for i in range(len(features))]
        v_lanes = [dict(valid_inputs)] + [_blank_column(valid_inputs, i)
                                          for i in range(len(features))]
        best, _ = train_kfold_vmapped(
            [init_fn(i) for i in range(len(lanes))], config,
            [(lane, labels, ones_t) for lane in lanes],
            [(lane, valid_labels, ones_v) for lane in v_lanes], epochs, batch_size, lr,
            verbose=False)
        accs = [valid_accuracy(valid_labels, predict_classifier(p, config, v))
                for p, v in zip(best, v_lanes)]
        return {f: accs[0] - accs[1 + i] for i, f in enumerate(features)}
    base_params, _ = train_classifier(init_fn(0), config, inputs, labels, valid_inputs,
                                      valid_labels, epochs, batch_size, lr, verbose=False)
    base_acc = valid_accuracy(valid_labels, predict_classifier(base_params, config,
                                                               valid_inputs))
    drops = {}
    for i, feature in enumerate(features):
        blank = lambda d: _blank_column(d, i)
        params, _ = train_classifier(init_fn(i + 1), config, blank(inputs), labels,
                                     blank(valid_inputs), valid_labels, epochs, batch_size, lr,
                                     verbose=False)
        probs = predict_classifier(params, config, blank(valid_inputs))
        drops[feature] = base_acc - valid_accuracy(valid_labels, probs)
    return drops
