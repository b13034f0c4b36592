"""jet-ID evaluation on the host: labels, class weights, composition
matrix, discriminant.

Copies of ``make_labels``, ``get_class_weight``, ``valid_accuracy``,
``compo_matrix`` and ``discriminant`` of ``atlasvae/eval/jetid_eval.py``
(numpy only).  The sample-weight schemes, up/down-sampling, k-fold
``cross_valid``, ``multi_cuts`` and ``feature_removal`` are not ported yet.
"""

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
