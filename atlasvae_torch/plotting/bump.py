"""Bump-hunting plots: bump histogram, test statistic, tomography
(ref OE-VAE/BumpHunter/bumphunter_1dim.py:1646-1918, OE-VAE/plots.py:448-527).

Counterpart of ``atlasvae/plotting/bump.py``: numpy arrays in, matplotlib
imported at the first drawing call.  With no ``filename`` a plot is shown
(which the Agg backend does not do) and left open, as in the JAX package."""

import numpy as np

from .backend import pyplot


def _save_or_show(plt, fig, filename):
    if filename is None:
        plt.show()
    else:
        plt.savefig(filename, bbox_inches="tight")
        plt.close(fig)


def plot_bump_histogram(data_hist, bkg_hist, bins, bin_sigma, bump_range,
                        rang=None, label="", filename=None):
    """Data vs background with the bump window and per-bin significances
    (ref bumphunter_1dim.py:1796-1858)."""
    plt = pyplot()
    import matplotlib.gridspec as grd
    bins = np.asarray(bins)
    fig = plt.figure(figsize=(12, 10))
    gs = grd.GridSpec(2, 1, height_ratios=[4, 1])
    ax1 = plt.subplot(gs[0])
    plt.title(f"Distributions with bump  {label}", size="xx-large")
    histo = plt.hist(bins[:-1], bins=bins, histtype="step", range=rang,
                     weights=bkg_hist, label="background", linewidth=2, color="red")
    plt.errorbar(0.5 * (bins[1:] + bins[:-1]), data_hist,
                 xerr=(bins[1:] - bins[:-1]) / 2,
                 yerr=np.sqrt(np.maximum(data_hist, 0)),
                 ls="", color="blue", label="data", marker=".")
    bmin, bmax = bump_range
    last = len(histo[0]) - 1  # window may end on the final bin edge
    ymax = [histo[0][min(np.argmin(np.abs(bmin - bins)), last)],
            histo[0][min(np.argmin(np.abs(bmax - bins)), last)]]
    plt.vlines([bmin, bmax], 0, ymax, colors="r", linestyles="dashed", label="BUMP")
    plt.legend(fontsize="xx-large")
    plt.yscale("log")
    if rang is not None:
        plt.xlim(rang)
    plt.tight_layout()
    plt.subplot(gs[1], sharex=ax1)
    plt.hist(bins[:-1], bins=bins, range=rang, weights=bin_sigma)
    plt.plot(np.full(2, bmin), [bin_sigma.min(), bin_sigma.max()], "r--", linewidth=2)
    plt.plot(np.full(2, bmax), [bin_sigma.min(), bin_sigma.max()], "r--", linewidth=2)
    plt.ylabel("significance", size="xx-large")
    _save_or_show(plt, fig, filename)


def plot_stat_distribution(t_ar, global_pval, show_pval=False, filename=None):
    """Pseudo-experiment test-statistic distribution + data marker
    (ref bumphunter_1dim.py:1867-1918)."""
    plt = pyplot()
    t_ar = np.asarray(t_ar)
    fig = plt.figure(figsize=(12, 8))
    if show_pval:
        plt.title(f"BumpHunter statistics distribution      "
                  f"global p-value = {global_pval:1.4f}", size="xx-large")
    else:
        plt.title("BumpHunter statistics distribution")
    h = plt.hist(t_ar[1:], bins=100, histtype="step", linewidth=2,
                 label="pseudo-data")
    plt.plot(np.full(2, t_ar[0]), [0, h[0].max()], "r--", linewidth=2, label="data")
    plt.legend(fontsize="xx-large")
    plt.xlabel("BumpHunter statistic", size="xx-large")
    plt.yscale("log")
    _save_or_show(plt, fig, filename)


def plot_tomography(bins, res_ar, widths, filename=None):
    """Local p-value vs window position, one trace per width
    (ref bumphunter_1dim.py:1513-1644)."""
    plt = pyplot()
    bins = np.asarray(bins)
    fig = plt.figure(figsize=(12, 8))
    for w, pvals in zip(widths, res_ar):
        valid = np.asarray(pvals) < 1.0
        pos = bins[:-1][:len(pvals)][valid[:len(bins) - 1]]
        plt.plot(pos, np.asarray(pvals)[:len(bins) - 1][valid[:len(bins) - 1]],
                 marker=".", ls="", label=f"width={w}")
    plt.yscale("log")
    plt.xlabel("window position", size="xx-large")
    plt.ylabel("local p-value", size="xx-large")
    plt.legend()
    _save_or_show(plt, fig, filename)
