"""AAE plots: logit-axis discriminant histograms, sculpting curves, the
combined-cut ROC.

Copies of ``atlasvae/plotting/aae_plots.py``: ``plot_discriminant``
(logit x axis with the best-cut line), ``plot_correlations`` and
``get_distance`` (per-cut JSD of the background's m and pt spectra),
``smoothing`` and ``binary_dics_eff`` (the ROC of the 2-D scan's cut
pairs).  matplotlib is imported by the drawing functions
(``plotting/backend.py``); the ROC sweeps run on ``device``.
"""

import numpy as np

from .backend import pyplot
from ..eval.roc import get_rates


def _logit(x, delta=1e-6):
    x = np.clip(np.asarray(x, np.float64), delta, 1 - delta)
    return np.log10(x) - np.log10(1 - x)


def plot_discriminant(y_true, x_loss, weights, output_dir, sig_label="signal",
                      best_cut=None, disc_name="Autoencoder", n_bins=50):
    """Discriminant distributions on a logit axis with the best-cut line."""
    plt = pyplot()
    y_true = np.asarray(y_true)
    logit_loss = _logit(x_loss)
    lo, hi = np.percentile(logit_loss, [0.1, 99.9])
    bins = np.linspace(lo, hi, n_bins)
    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True)
    for n, (label, color) in enumerate([(sig_label, "tab:orange"), ("QCD", "tab:blue")]):
        sel = y_true == n
        w = np.asarray(weights[sel], np.float64)
        w *= 100.0 / np.sum(w)
        plt.hist(np.clip(logit_loss[sel], lo, hi), bins, histtype="step",
                 weights=w, label=label, color=color, lw=2, log=True)
    if best_cut is not None and disc_name in best_cut:
        axes.axvline(_logit(best_cut[disc_name]), ls="--", lw=1.5, color="black",
                     label="best cut")
    plt.xlabel(f"logit({disc_name})", fontsize=24)
    plt.ylabel("Distribution (%)", fontsize=24)
    plt.legend(loc="upper left", fontsize=18)
    out = f"{output_dir}/discriminant_{disc_name}.png"
    print("Saving discriminant plot to:", out)
    plt.savefig(out)
    plt.close(fig)


def get_distance(y_true, sample, x_loss, var="m", n_cuts=50, device="cuda"):
    """JSD between the uncut and the cut background spectra of ``var``
    across thresholds; returns (bkg efficiency in percent, JSD)."""
    from scipy.spatial import distance
    fpr, tpr, thresholds = get_rates(y_true, x_loss, sample["weights"], device=device)
    eff_val = np.logspace(np.log10(max(np.min(fpr), 1e-3)), 2, n_cuts)
    idx = np.minimum(np.searchsorted(fpr, eff_val, side="right"), len(fpr) - 1)
    values = np.asarray(sample[var])[y_true == 1]
    losses = np.asarray(x_loss)[y_true == 1]
    w = np.asarray(sample["weights"])[y_true == 1]
    rng = (0, np.percentile(values, 99.9))
    p = np.histogram(values, bins=100, range=rng, weights=w)[0]
    jsd, eff = [], []
    for i in idx:
        sel = losses >= thresholds[i]
        if not np.any(sel):
            continue
        q = np.histogram(values[sel], bins=100, range=rng, weights=w[sel])[0]
        with np.errstate(all="ignore"):
            jsd.append(distance.jensenshannon(p, q))
        eff.append(fpr[i])
    return np.asarray(eff), np.asarray(jsd)


def plot_correlations(y_true, x_loss_dict, sample, output_dir, device="cuda"):
    """Mass and pt sculpting JSD curves per discriminant."""
    plt = pyplot()
    fig, axes = plt.subplots(figsize=(13, 8), ncols=2, sharey=True)
    for ax, var in zip(axes, ("m", "pt")):
        for name, x_loss in x_loss_dict.items():
            eff, jsd = get_distance(y_true, sample, x_loss, var, device=device)
            ax.plot(eff, jsd, label=name, lw=2)
        ax.set_xscale("log")
        ax.set_xlabel(rf"$\epsilon_{{\mathrm{{bkg}}}}$ (%) — {var}", fontsize=20)
        ax.grid(True)
    axes[0].set_ylabel("JSD", fontsize=22)
    axes[0].legend(loc="upper right", fontsize=14)
    out = f"{output_dir}/correlations.png"
    print("Saving sculpting curves  to:", out)
    plt.savefig(out)
    plt.close(fig)


def smoothing(x, y, sort=False):
    """Monotone envelope of a scatter of (eff, eff) points."""
    x, y = np.asarray(x), np.asarray(y)
    idx = np.argsort(x, kind="mergesort") if sort else np.arange(len(x))
    x, y = x[idx], np.maximum.accumulate(y[idx])
    keep = np.unique(y, return_index=True)[1]
    return x[keep], y[keep]


def binary_dics_eff(tpr, fpr, output_dir, sig_label="signal", best_fpr=None):
    """Combined-cut ROC from the 2-D grid's (tpr, fpr) cloud; returns the
    smoothed (fpr, tpr)."""
    plt = pyplot()
    fpr, tpr = np.asarray(fpr), np.asarray(tpr)
    keep = fpr > 0
    fpr, tpr = smoothing(fpr[keep], tpr[keep], sort=True)
    fig = plt.figure(figsize=(13, 8))
    plt.gca().grid(True)
    plt.plot(100 * tpr, 1 / fpr, lw=2, label=f"Auto+Disc 2-D cuts ({sig_label})")
    if best_fpr is not None:
        plt.axvline(100 * np.interp(best_fpr, fpr, tpr), ls="--", lw=1, color="dimgray")
    plt.yscale("log")
    plt.xlabel(r"$\epsilon_{\mathrm{sig}}$ (%)", fontsize=24)
    plt.ylabel(r"$1/\epsilon_{\mathrm{bkg}}$", fontsize=24)
    plt.legend(fontsize=16)
    out = f"{output_dir}/ROC_2d_cuts.png"
    print("Saving combined-cut ROC  to:", out)
    plt.savefig(out)
    plt.close(fig)
    return fpr, tpr
