"""Performance-evaluation plots and numbers: significance scans, bump
results, ROC suites, mass-sculpting curves, loss and class distributions,
background rejection.

Counterpart of ``atlasvae/plotting/performance.py`` (ref OE-VAE/plots.py:262-332,
:400-527, :530-619, :622-668, :809-943; jet-ID/plots.py:128-244).  The ROC
rates are ``eval/roc.py::get_rates`` on ``device``; the rest is numpy and
scipy on the host.  ``roc_curves`` and ``mass_correlation`` compute their
numbers and then draw them with ``_draw_roc`` and
``_draw_mass_correlation``, which ``eval/results.py`` calls on numbers it
computed earlier.  matplotlib
is imported at the first drawing call, so this module loads where
matplotlib is not installed.
"""

import os
import warnings

import numpy as np

from ..eval.roc import _trapezoid, get_rates, roc_rates
from ..stats.fit import gaussian
from ..utils.chunks import density_weights
from .backend import pyplot

_COLOR = {"MSE": "tab:orange", "MAE": "tab:brown", "X-S": "tab:purple",
          "JSD": "tab:cyan", "EMD": "tab:green", "KSD": "black",
          "KLD": "tab:red", "Latent": "tab:blue", "Inputs": "gray",
          "Inputs_scaled": "black"}


def plot_sigma_scan(eff, sigma, eff_type, x_min, x_max, file_name):
    """Significance vs cut-efficiency curve (ref OE-VAE/plots.py:296-326)."""
    plt = pyplot()
    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True)
    plt.plot(eff, sigma, color="tab:blue", lw=2, zorder=1)
    plt.xlim(x_min, x_max)
    max_val, max_eff = np.max(sigma), eff[np.argmax(sigma)]
    if eff_type == "bkg":
        plt.xscale("log")
        plt.xlabel(r"$\epsilon_{\mathrm{bkg}}$ (%)", fontsize=25)
        xmin = (np.log10(max_eff) - np.log10(x_min)) / (np.log10(x_max) - np.log10(x_min))
    else:
        plt.xlabel(r"$\epsilon_{\mathrm{sig}}$ (%)", fontsize=25)
        xmin = (max_eff - x_min) / (x_max - x_min)
    axes.axhline(max_val, xmin=xmin, xmax=1, ls="--", linewidth=1.0, color="dimgray")
    plt.ylabel("Significance", fontsize=25)
    print("Saving max significance  to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)


def plot_bump_result(data, data_weights, y_true, bins, bin_sigma, loc_sigma,
                     max_sigma, bump_range, m_range, gaussian_par, sig_label,
                     filename, log=False):
    """Stacked mass distributions + per-bin significance profile with the
    Gaussian fit overlay (ref OE-VAE/plots.py:448-527)."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(figsize=(12, 8), ncols=1, nrows=2,
                                   sharex=True,
                                   gridspec_kw={"height_ratios": [3, 1]})
    data_weights = 100 * np.asarray(data_weights, np.float64) / np.sum(data_weights)
    data_weights = density_weights(data, data_weights, bins)
    samples = [data[y_true == 1], data[y_true == 0]]
    weights = [data_weights[y_true == 1], data_weights[y_true == 0]]
    labels = ["QCD", sig_label or "signal"]
    colors = ["tab:blue", "tab:orange"]
    ax1.hist(samples, bins, weights=weights, histtype="barstacked", log=log,
             lw=3, alpha=0.2, label=labels, color=colors, zorder=0)
    h = ax1.hist(np.concatenate(samples), bins=bins,
                 weights=np.concatenate(weights), histtype="step", log=log,
                 lw=3, fill=False, edgecolor=colors[1], alpha=1)
    last = len(h[0]) - 1  # window may end on the final bin edge
    vl_y = [h[0][min(np.argmin(np.abs(bump_range[0] - bins)), last)],
            h[0][min(np.argmin(np.abs(bump_range[1] - bins)), last)]]
    ax1.vlines(bump_range, 0, vl_y, colors="tab:red", ls=(0, (4, 1)), lw=2,
               label="Bump")
    ax1.legend(loc="upper right", frameon=False, fontsize=20)
    ax1.set_ylabel("Probability Density (%)", fontsize=22)
    ax1.set_xlim(m_range)
    ax2.hist(bins[:-1], bins, histtype="step", weights=bin_sigma, lw=3,
             fill=True, edgecolor="darkgray", facecolor=(0.5, 0.5, 0.5, 0.2))
    if gaussian_par is not None:
        xs = np.linspace(m_range[0], m_range[1], 1000)
        a0, b0, c0, height, mean, std = gaussian_par
        ax2.plot(xs, a0 * gaussian((xs - b0) / c0, height, mean, std),
                 color="dimgray", lw=2)
    for edge in bump_range:
        ax2.axvline(edge, 0, 1, color="tab:red", ls=(0, (4, 1)), lw=2)
    ax2.set_xlabel(r"$m\,$(GeV)", fontsize=24)
    ax2.set_ylabel(r"$\sigma$", fontsize=24)
    if loc_sigma is not None and np.isfinite(loc_sigma):
        ax2.text(0.75, 0.85, rf"$\sigma_{{local}} = {loc_sigma:.1f}$",
                 fontsize=14, transform=ax2.transAxes, va="top")
    print("Saving bump hunting plot to:", filename)
    fig.subplots_adjust(hspace=0.08)
    plt.savefig(filename, bbox_inches="tight")
    plt.close(fig)


def roc_curves(y_true, x_losses, weights, metrics_list, output_dir, wps=(1, 10),
               device="cuda"):
    """Background-rejection (1/eps_bkg vs eps_sig, AUC legend) and signal
    gain plots (ref OE-VAE/plots.py:809-943); returns {metric: (fpr, tpr,
    thresholds)}, the rates in percent."""
    metrics_dict = {m: get_rates(y_true, x_losses[m], weights, device=device)
                    for m in metrics_list}
    _draw_roc(metrics_dict, output_dir)
    return metrics_dict


def _draw_roc(metrics_dict, output_dir):
    """``roc_curves``' two plots from its {metric: (fpr, tpr, thresholds)}."""
    plt = pyplot()
    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True)
    for metric, (fpr, tpr, _) in metrics_dict.items():
        label = metric if metric != "Inputs_scaled" else "Inputs (scaled)"
        auc = _trapezoid(tpr, fpr) / 1e4
        plt.plot(tpr, 100 / fpr, label=f"{label} (AUC: {auc:.3f})", lw=2,
                 color=_COLOR.get(metric, "black"))
    plt.yscale("log")
    plt.xlim(0, 100)
    plt.xlabel(r"$\epsilon_{\mathrm{sig}}$ (%)", fontsize=25)
    plt.ylabel(r"$1/\epsilon_{\mathrm{bkg}}$", fontsize=25)
    plt.legend(loc="upper right", fontsize=15)
    file_name = str(output_dir) + "/bkg_rejection.png"
    print("Saving bkg rejection     to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)

    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True)
    for metric, (fpr, tpr, _) in metrics_dict.items():
        plt.plot(tpr, tpr / fpr, label=metric, lw=2,
                 color=_COLOR.get(metric, "black"))
    plt.xlim(0, 100)
    plt.yscale("log")
    plt.xlabel(r"$\epsilon_{\mathrm{sig}}$ (%)", fontsize=25)
    plt.ylabel(r"$G_{S/B}=\epsilon_{\mathrm{sig}}/\epsilon_{\mathrm{bkg}}$",
               fontsize=25)
    plt.legend(loc="upper right", fontsize=15)
    file_name = str(output_dir) + "/signal_gain.png"
    print("Saving signal gain       to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)


def _mass_distances(y_true, x_loss, x_mass, weights, truth, rates, n_cuts=100):
    """JSD between the uncut and cut mass spectra of class ``truth`` across
    ``n_cuts`` thresholds of ``rates``, ``get_rates``' output for these
    inputs (ref OE-VAE/plots.py:530-560).  Returns (jsd, sig_eff, bkg_eff)
    lists."""
    from scipy.spatial import distance
    fpr, tpr, thresholds = rates
    eff = fpr
    x_min = fpr[0]
    eff_val = np.logspace(np.log10(x_min), np.log10(100), n_cuts)
    idx = np.minimum(np.searchsorted(eff, eff_val, side="right"), len(eff) - 1)
    thresholds, tpr, fpr = thresholds[idx], tpr[idx], fpr[idx]
    losses = x_loss[y_true == truth]
    masses = x_mass[y_true == truth]
    w = weights[y_true == truth]
    p = np.histogram(masses, bins=100, range=(0, 500), weights=w)[0]
    jsd, sig_eff, bkg_eff = [], [], []
    for n, thr in enumerate(thresholds):
        sel = losses >= thr
        if not np.any(sel):
            continue
        q = np.histogram(masses[sel], bins=100, range=(0, 500), weights=w[sel])[0]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jsd.append(distance.jensenshannon(p, q))
        sig_eff.append(tpr[n])
        bkg_eff.append(fpr[n])
    return jsd, sig_eff, bkg_eff


def mass_correlation(y_true, x_losses, x_mass, weights, metrics_list,
                     loss_metric, output_dir, eff_type="bkg", device="cuda"):
    """Mass-sculpting JSD curves per metric (ref OE-VAE/plots.py:563-619),
    one metric after the other."""
    rates = {m: get_rates(y_true, x_losses[m], weights, device=device) for m in metrics_list}
    _draw_mass_correlation(_mass_curves(y_true, x_losses, x_mass, weights, rates), output_dir,
                           eff_type)


def _mass_curves(y_true, x_losses, x_mass, weights, rates):
    """{metric: {truth: (jsd, sig_eff, bkg_eff)}} for each metric of
    ``rates`` ({metric: its ``get_rates`` output}), background first."""
    return {metric: {truth: _mass_distances(y_true, x_losses[metric], x_mass, weights, truth,
                                            metric_rates)
                     for truth in (1, 0)}
            for metric, metric_rates in rates.items()}


def _draw_mass_correlation(curves, output_dir, eff_type="bkg"):
    """``mass_correlation``'s plot from {metric: {truth: (jsd, sig_eff,
    bkg_eff)}}, the background (truth 1) before the signal of each."""
    plt = pyplot()
    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True)
    for metric, by_truth in curves.items():
        for truth in (1, 0):
            jsd, sig_eff, bkg_eff = by_truth[truth]
            label = f"{metric} ({'sig' if truth == 0 else 'bkg'})"
            ls, alpha = ("-", 1.0) if truth == 1 else ("-", 0.5)
            xs = bkg_eff if eff_type == "bkg" else sig_eff
            plt.plot(xs, jsd, label=label, color=_COLOR.get(metric, "black"),
                     lw=2, ls=ls, alpha=alpha)
    plt.xlabel(rf"$\epsilon_{{\mathrm{{{eff_type}}}}}$ (%)", fontsize=25)
    plt.ylabel("JSD", fontsize=25)
    if eff_type == "bkg":
        plt.xscale("log")
        plt.xlim(1e-4, 100)
    plt.ylim(0, 1.0)
    plt.legend(loc="upper center", fontsize=15, ncol=2)
    file_name = str(output_dir) + "/mass_correlation.png"
    print("Saving mass sculpting    to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)


def loss_distributions(y_true, x_loss, weights, metric, output_dir,
                       best_loss=None, n_bins=100, normalize=True,
                       density=True, log=False):
    """Signal/background discriminant distributions
    (ref OE-VAE/plots.py:622-668)."""
    plt = pyplot()
    if log:
        bins = np.logspace(-2, 4, num=n_bins)
    else:
        bins = np.linspace(0, 1, num=n_bins)
    labels = [r"$t\bar{t}$", "QCD"]
    colors = ["tab:orange", "tab:blue"]
    fig = plt.figure(figsize=(13, 8))
    ax = plt.gca()
    ax.grid(True)
    for n in sorted(set(np.asarray(y_true))):
        variable = x_loss[y_true == n]
        w = np.array(weights[y_true == n], np.float64)
        if normalize:
            w *= 100 / np.sum(w)
        if density:
            w = density_weights(variable, w, bins)
        plt.hist(variable, bins, histtype="step", weights=w, label=labels[n],
                 color=colors[n], lw=2)
    if best_loss is not None and metric == best_loss["metric"]:
        ax.axvline(best_loss["loss"], ls="--", linewidth=1.0, color="black")
    if log:
        plt.xscale("log")
        plt.yscale("log")
    else:
        plt.xlim(bins[0], bins[-1])
    name = {"Latent": "KLD Latent Loss", "Inputs": "Inputs",
            "Inputs_scaled": "Inputs (scaled)"}.get(
        metric, metric + " Reconstruction Loss")
    plt.xlabel(name, fontsize=24)
    plt.ylabel("Distribution Density (%)", fontsize=24)
    plt.legend(loc="upper left", fontsize=18)
    out = os.path.join(str(output_dir), "metrics_losses")
    os.makedirs(out, exist_ok=True)
    file_name = os.path.join(out, metric + "_loss.png")
    print("Saving metric loss       to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)


def class_distributions(y_true, y_prob, weights, output_dir,
                        class_names=("Signal", "QCD"), n_bins=50):
    """Per-class network-probability distributions: weighted, normalized
    to 100% per class, log-scaled counts (ref jet-ID/plots.py:128-244
    ``plot_distributions_DG``, the signal-probability panel)."""
    plt = pyplot()
    y_true = np.asarray(y_true)
    y_prob = np.asarray(y_prob)
    prob_sig = y_prob[:, 0] if y_prob.ndim > 1 else y_prob
    colors = ["tab:orange", "tab:blue", "tab:green", "tab:red",
              "tab:purple", "tab:brown"]
    bins = np.linspace(0, 100, n_bins + 1)
    fig = plt.figure(figsize=(12, 8))
    ax = plt.gca()
    ax.grid(True)
    for n in sorted(set(y_true)):
        sel = y_true == n
        w = np.array(np.asarray(weights)[sel], np.float64)
        w *= 100 / max(np.sum(w), 1e-30)  # ref plots.py:155 percent norm
        name = class_names[n] if n < len(class_names) else f"class {n}"
        plt.hist(100 * prob_sig[sel], bins, histtype="step", weights=w,
                 log=True, label=name, color=colors[n % len(colors)], lw=2)
    plt.xlim(0, 100)
    plt.ylim(1e-3, 1e2)
    plt.xlabel("Signal probability (%)", fontsize=24)
    plt.ylabel("Distribution (%)", fontsize=24)
    plt.legend(loc="upper center", fontsize=18)
    file_name = os.path.join(str(output_dir), "distributions.png")
    print("Saving class probability distributions to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)


def background_rejection(y_true, y_prob, weights=None, sig_eff=(90, 80, 70), device="cuda"):
    """Background rejection 1/eps_bkg at fixed signal efficiencies.  Returns
    {eff_percent: rejection} and prints one line each."""
    y_true = np.asarray(y_true)
    score = np.asarray(y_prob[:, 0] if np.ndim(y_prob) > 1 else y_prob)
    w = np.ones(len(y_true)) if weights is None else np.asarray(weights)
    # roc_rates treats class 0 as signal
    fpr, tpr, _ = roc_rates(y_true, score, w, device)
    out = {}
    for val in sig_eff:
        idx = np.searchsorted(tpr, val / 100.0, side="left")
        rej = 1.0 / max(float(fpr[min(idx, len(fpr) - 1)]), 1e-30)
        out[val] = rej
        print(f"BACKGROUND REJECTION AT {val}%: {rej:>6.0f}")
    return out
