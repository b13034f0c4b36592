"""Sample kinematic distribution plots (ref OE-VAE/plots.py:221-225
``sample_distributions`` and :671-744 ``plot_distributions``).

Counterpart of ``atlasvae/plotting/distributions.py``: numpy on the host,
matplotlib imported at the first drawing call."""

import numpy as np

from ..utils.chunks import bin_edges, density_weights
from .backend import pyplot


def _sig_tag(sig_data):
    for token, tag in [("top", r"$t\bar{t}$"), ("VZ", r"$t\bar{t}$"),
                       ("BSM", "BSM"), ("OoD", "OoD"), ("2HDM", "2HDM")]:
        if token in str(sig_data):
            return tag
    return "N.A."


def plot_distributions(samples, sig_data, plot_var, bin_sizes, output_dir,
                       file_name="", weight_type="None", normalize=True,
                       density=True, log=True):
    """Signal-vs-background histogram of m or pt, optionally a cut sample
    overlaid at half alpha (ref OE-VAE/plots.py:671-744)."""
    plt = pyplot()
    tag = _sig_tag(sig_data)
    if "OoD" in str(sig_data):
        labels = {0: [tag, "QCD"], 1: [tag + " (weighted)", "QCD (weighted)"]}
    else:
        labels = {0: [tag, "QCD"], 1: [tag + " (cut)", "QCD (cut)"]}
    colors = ["tab:orange", "tab:blue"]
    alphas = [1, 0.5]
    xlabel = {"pt": "$p_t$", "m": "$m$", "m_over_pt": "$m/p_t$"}.get(plot_var, plot_var)
    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True)
    if not isinstance(samples, list):
        samples = [samples]
    for m in (0, 1):
        for n, sample in enumerate(samples):
            condition = sample["JZW"] == -1 if m == 0 else sample["JZW"] >= 0
            if not np.any(condition):
                continue
            if plot_var == "m_over_pt":
                variable = np.float32(sample["m"] / sample["pt"])[condition]
                size = 0.01
            else:
                variable = np.float32(sample[plot_var][condition])
                size = bin_sizes[plot_var]
            weights = np.array(sample["weights"][condition], dtype=np.float64)
            # bins from the unconditioned sample by default, so that signal
            # and QCD share one grid; from the conditioned one for
            # m_over_pt and flat weighting (ref OE-VAE/plots.py:697-700)
            if plot_var == "m_over_pt" or "flat" in str(weight_type):
                lo = max(0.0, float(np.min(variable)))
                hi = float(np.max(variable))
            else:
                full = np.float32(sample[plot_var])
                lo = max(0.0, float(np.min(full)))
                hi = float(np.max(full))
            bins = bin_edges(hi, size, lo)
            if len(bins) < 2:  # degenerate after a hard cut (ref plots.py:710-712)
                continue
            if normalize:
                denom = np.sum(samples[0]["weights"]) if weight_type == "None" \
                    else np.sum(sample["weights"])
                weights *= 100.0 / denom
            if density:
                weights = density_weights(variable, weights, bins)
            plt.hist(variable, bins, histtype="step", weights=weights,
                     color=colors[m], lw=2, log=log, alpha=alphas[n],
                     label=labels[n][m])
    plt.xlabel(xlabel + (" (GeV)" if plot_var != "m_over_pt" else ""), fontsize=24)
    plt.ylabel("Distribution density" + (" (%)" if normalize else ""), fontsize=24)
    plt.legend(loc="upper right", ncol=1 if len(samples) == 1 else 2, fontsize=18)
    if file_name == "":
        file_name = (plot_var if plot_var == "pt" else "mass") + "_dist.png"
    file_name = str(output_dir) + "/" + file_name
    print("Saving", format(plot_var, ">2s"), "distributions  to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)


def sample_distributions(sample, sig_data, output_dir, name, weight_type="None",
                         bin_sizes=None):
    """m and pt distribution pair (ref OE-VAE/plots.py:221-225), one plot
    after the other."""
    bin_sizes = bin_sizes or {"m": 2.5, "pt": 10}
    for var in ("m", "pt"):
        plot_distributions(sample, sig_data, var, bin_sizes, output_dir,
                           f"{name}_{var}.png", weight_type)
