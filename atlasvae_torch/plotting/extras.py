"""Additional analysis plots and utilities.

Counterpart of ``atlasvae/plotting/extras.py``, on the port's own encoder
(``models/vae.py``) and ``data/jets.py::jets_4v``; matplotlib, sklearn's
``TSNE`` and the pickle cache are loaded inside the functions
(``backend.pyplot``).  No entry point of either package calls these.
Parity equivalents of the reference's remaining plot helpers:
``tSNE`` latent embedding (ref OE-VAE/plots.py:107-126),
``combine_ROC_curves`` multi-run overlay (:747-806, generalized to take
explicit {label: rates-file} inputs instead of hard-coded cluster
paths), ``pt_reconstruction`` (:966-991), weighted ``KS_distance``
(:1001-1015), ``bin_meshgrid`` grid-search heatmaps (:1018-1051).
"""

import pickle

import numpy as np

from .backend import pyplot


def tsne_embedding(y_true, x_true, params, output_dir, file_name="tSNE_scatter",
                   max_points=5000, perplexity=30, learning_rate=100.0, device="cuda"):
    """2-D t-SNE of the encoder means (ref OE-VAE/plots.py:107-126), the
    encoder run on ``device``; caches the embedding pickle like the
    reference."""
    import os
    import torch
    from sklearn.manifold import TSNE
    from ..models.vae import encode
    from ..utils.tensors import as_float_tensor
    plt = pyplot()
    cache = f"{output_dir}/{file_name}.pkl"
    y_true = np.asarray(y_true)[:max_points]
    if not os.path.isfile(cache):
        with torch.no_grad():
            z_mean, _ = encode(params, as_float_tensor(np.asarray(x_true[:max_points],
                                                                  np.float32), device))
        embedding = TSNE(n_components=2, random_state=0, perplexity=perplexity,
                         learning_rate=learning_rate)
        z_embedded = embedding.fit_transform(z_mean.cpu().numpy())
        with open(cache, "wb") as f:
            pickle.dump(z_embedded, f, protocol=4)
    else:
        with open(cache, "rb") as f:
            z_embedded = pickle.load(f)
    fig = plt.figure(figsize=(12, 8))
    plt.gca().grid(True)
    labels = [r"$t\bar{t}$", "QCD"]
    colors = ["tab:orange", "tab:blue"]
    for n in sorted(set(y_true)):
        plt.scatter(z_embedded[y_true == n, 0], z_embedded[y_true == n, 1],
                    color=colors[n], s=10, label=labels[n], alpha=0.1)
    leg = plt.legend(loc="upper right", fontsize=18)
    for lh in leg.legend_handles:
        lh.set_alpha(1)
    out = f"{output_dir}/{file_name}.png"
    print("Saving tSNE 2D-embedding to:", out)
    plt.savefig(out)
    plt.close(fig)
    return z_embedded


def combine_roc_curves(pos_rates, output_dir, file_name="ROC_curves.png"):
    """Overlay multiple runs' (fpr, tpr) curves with AUCs
    (ref OE-VAE/plots.py:747-806).  ``pos_rates``: {label: (fpr, tpr)}
    with fractional rates, or {label: path-to-pos_rates.pkl}."""
    plt = pyplot()
    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True, which="both", ls="--", color="tab:blue", alpha=0.2)
    for label, rates in pos_rates.items():
        if isinstance(rates, str):
            with open(rates, "rb") as f:
                loaded = pickle.load(f)
            fpr, tpr = loaded["fpr"], loaded["tpr"]
        else:
            fpr, tpr = rates
        fpr, tpr = np.asarray(fpr), np.asarray(tpr)
        keep = fpr != 0
        fpr, tpr = fpr[keep], tpr[keep]
        auc = np.trapezoid(tpr, fpr)
        plt.plot(100 * tpr, 1 / fpr, label=f"{label} (AUC: {auc:.4f})", lw=2)
    plt.xlim(0, 100)
    plt.ylim(1, 1e5)
    plt.yscale("log")
    plt.xlabel(r"$\epsilon_{\mathrm{sig}}$ (%)", fontsize=25)
    plt.ylabel(r"$1/\epsilon_{\mathrm{bkg}}$", fontsize=25)
    plt.legend(loc="best", fontsize=14, ncol=2)
    out = f"{output_dir}/{file_name}"
    print("Saving ROC curves to:", out)
    plt.savefig(out)
    plt.close(fig)


def pt_reconstruction(x_true, x_pred, y_true, weights, output_dir, n_bins=200,
                      n_dims=4, device="cuda"):
    """True vs reconstructed jet-pt distributions
    (ref OE-VAE/plots.py:966-991).  ``n_dims`` selects the constituent
    layout: 4 = flat (E,px,py,pz) blocks (their jet pt from ``jets_4v`` on
    ``device``), 3 = flat (px,py,pz)."""
    from ..data.jets import jets_4v
    plt = pyplot()

    def jet_pt(x):
        x = np.asarray(x, np.float32)
        if n_dims == 4:
            return jets_4v(x, device)["pt_calo"]
        total = x.reshape(len(x), -1, n_dims).sum(axis=1)
        return np.hypot(total[:, 0], total[:, 1])

    pt_true = jet_pt(x_true)
    pt_pred = jet_pt(x_pred)
    if weights is None:
        weights = np.ones(len(y_true))
    lo = min(pt_true.min(), pt_pred.min())
    hi = max(pt_true.max(), pt_pred.max())
    bins = np.linspace(lo, hi, n_bins + 1)
    width = bins[1] - bins[0]
    fig = plt.figure(figsize=(13, 8))
    plt.gca().grid(True)
    labels = [r"$t\bar{t}$", "QCD"]
    colors = ["tab:orange", "tab:blue"]
    for n in sorted(set(np.asarray(y_true))):
        w = weights[y_true == n] * 100 / np.sum(weights[y_true == n]) / width
        plt.hist(pt_true[y_true == n], bins, histtype="step", weights=w,
                 label=labels[n], lw=2, color=colors[n], alpha=1)
        plt.hist(pt_pred[y_true == n], bins, histtype="step", weights=w,
                 label=labels[n] + " (rec)", lw=2, color=colors[n], alpha=0.5)
    plt.xlabel("$p_t$", fontsize=24)
    plt.ylabel("Distribution density (%/GeV)", fontsize=24)
    plt.legend(loc="upper right", ncol=2, fontsize=18)
    out = f"{output_dir}/pt_reconstruction.png"
    print("Saving pt reconstruction  to:", out)
    plt.savefig(out)
    plt.close(fig)


def ks_distance(dist_1, dist_2, weights_1=None, weights_2=None):
    """Weighted two-sample KS statistic (ref OE-VAE/plots.py:1001-1015)."""
    dist_1, dist_2 = np.asarray(dist_1), np.asarray(dist_2)
    if weights_1 is None:
        weights_1 = np.ones_like(dist_1)
    if weights_2 is None:
        weights_2 = np.ones_like(dist_2)
    idx_1, idx_2 = np.argsort(dist_1), np.argsort(dist_2)
    dist_1, weights_1 = dist_1[idx_1], weights_1[idx_1]
    dist_2, weights_2 = dist_2[idx_2], weights_2[idx_2]
    dist_all = np.concatenate([dist_1, dist_2])
    cum_1 = np.hstack([0, np.cumsum(weights_1) / np.sum(weights_1)])
    cum_2 = np.hstack([0, np.cumsum(weights_2) / np.sum(weights_2)])
    cdf_1 = cum_1[np.searchsorted(dist_1, dist_all, side="right")]
    cdf_2 = cum_2[np.searchsorted(dist_2, dist_all, side="right")]
    return np.max(np.abs(cdf_1 - cdf_2))


def bin_meshgrid(beta_val, lamb_val, z_val, file_name, vmin=None, vmax=None,
                 color="black", prec=2):
    """(beta, lambda) grid-search heatmap (ref OE-VAE/plots.py:1018-1051);
    cells with -1 annotate 'Ind' (indeterminate)."""
    plt = pyplot()
    z_val = np.asarray(z_val, float)
    fmt = lambda n: int(n) if float(n) == int(n) else format(n, ".1f")
    beta_lab = [fmt(n) for n in beta_val]
    lamb_lab = [fmt(n) for n in lamb_val]
    beta_idx = np.arange(len(beta_val) + 1) - 0.5
    lamb_idx = np.arange(len(lamb_val) + 1) - 0.5
    fig = plt.figure(figsize=(11, 7.5))
    if vmin is None:
        vmin = np.min(z_val[z_val != -1])
    if vmax is None:
        vmax = np.max(z_val[z_val != -1])
    plt.pcolormesh(beta_idx, lamb_idx, z_val, cmap="Blues", edgecolors="black",
                   vmin=vmin, vmax=vmax)
    plt.xticks(np.arange(len(beta_val)), beta_lab)
    plt.yticks(np.arange(len(lamb_val)), lamb_lab)
    for x in range(len(beta_val)):
        for y in range(len(lamb_val)):
            text = "Ind" if z_val[y, x] == -1 else format(z_val[y, x], f".{prec}f")
            plt.text(x, y, text, {"color": color, "fontsize": 18},
                     ha="center", va="center")
    plt.xlabel("Beta", fontsize=25)
    plt.ylabel("Lambda", fontsize=25)
    plt.colorbar(fraction=0.04, pad=0.02)
    plt.tight_layout()
    print("Saving meshgrid to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)
