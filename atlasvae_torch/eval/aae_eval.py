"""AAE evaluation: discriminants, weight adjustment, cut scans.

Counterpart of ``atlasvae/eval/aae_eval.py``.  The discriminants and the
weight adjustment are host numpy in float64, as in the JAX package; the two
inference heads run on the device the parameters lie on, in 100,000-row
chunks, and come to the host once.  Each scan computes its numbers first
(``_scan_numbers``, ``_scan_2d_numbers``: the cut grid and each cut's
histograms on the host, the local sigmas of every cut in one
``batched_local_sigma`` on ``device``, the best cut; ``_hunt``: the
``_hunter_numbers`` of the samples its plots show) and imports no
matplotlib; ``_draw_scan`` and ``_draw_scan_2d`` then draw them.

The 2-D scan's grid is a 3-D weighted histogram over (AE-cut rank,
Disc-cut rank, mass bin) followed by suffix cumulative sums along the two
rank axes: every cut pair's mass spectrum at once, with shared adaptive bins
from the uncut background.
"""

import numpy as np
import torch

from ..models.aae import ae_apply, discriminator_apply
from ..stats import batched_local_sigma
from ..train.checkpoint import tree_flatten
from ..utils.chunks import bin_edges
from .bump import _WIDTHS, _STEPS, _adaptive_bins, _draw_hunter, _hunter_numbers, \
    pad_hist_matrices
from .deco import mass_deco
from .roc import get_rates

_SCAN_KEYS = ("JZW", "m", "pt", "weights")
_DISCS_2D = ("Autoencoder", "Discriminator")


def aae_loss_mapping(x):
    """AAE variant of the [0, 1] mapping (the negative branch uses
    1 / (1 - x))."""
    x = np.asarray(x)
    if np.all((x >= 0) & (x <= 1)):
        return x
    if np.all((x >= -1) & (x <= 0)):
        return x + 1
    if np.all(x >= 0):
        return x / (1 + x)
    if np.all(x <= 0):
        return 1 / (1 - x)
    return (x / (np.abs(x) + 1) + 1) / 2


def adjust_weights(sample, y_true, bin_size=5, m_range=None, factor=10 ** 0.5):
    """Signal-peak normalization factor."""
    m_sig, m_bkg = sample["m"][y_true == 0], sample["m"][y_true == 1]
    w_sig, w_bkg = sample["weights"][y_true == 0], sample["weights"][y_true == 1]
    m_bins = bin_edges(np.max(m_sig), bin_size)
    h_sig = np.histogram(m_sig, m_bins, m_range, weights=w_sig)[0]
    h_bkg = np.histogram(m_bkg, m_bins, m_range, weights=w_bkg)[0]
    idx = np.argmax(h_sig)
    return factor * h_sig[idx] / max(h_bkg[idx], 1e-30)


def make_discriminant(p, q, metric="MAE", delta=1e-32):
    """Per-jet discriminant between true and reconstructed feature matrices
    (JSD is the square-root variant)."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    if metric in ("JSD", "KLD", "X-S", "MARE"):
        p = np.maximum(p, delta)
        q = np.maximum(q, delta)
    if metric == "MSE":
        return np.mean((p - q) ** 2, axis=1)
    if metric == "MAE":
        return np.mean(np.abs(p - q), axis=1)
    if metric == "MARE":
        return np.mean(np.abs(p - q) / p, axis=1)

    def kld(a, b):
        with np.errstate(all="ignore"):
            return np.nan_to_num(a * np.log2(a / b))

    if metric in ("JSD", "KLD", "X-S"):
        p = p / np.sum(p, axis=1)[:, None]
        q = q / np.sum(q, axis=1)[:, None]
    if metric == "KLD":
        return np.sum(kld(p, q), axis=1)
    if metric == "JSD":
        m = (p + q) / 2
        return np.sqrt(np.sum((kld(p, m) + kld(q, m)) / 2, axis=1))
    if metric == "X-S":
        return np.sum(kld(p, p * q), axis=1)
    raise ValueError(metric)


def aae_inference(params, x_true, chunk=100_000):
    """(AE reconstructions, discriminator probabilities) as host numpy,
    computed on the device the parameters lie on."""
    device = tree_flatten(params)[0].device
    x = torch.as_tensor(np.asarray(x_true, np.float32)).to(device)
    recon, disc = [], []
    with torch.inference_mode():
        for i in range(0, len(x), chunk):
            recon.append(ae_apply(params, x[i:i + chunk]))
            disc.append(discriminator_apply(params, x[i:i + chunk]))
        return torch.cat(recon).cpu().numpy(), torch.cat(disc).cpu().numpy()


def get_data(params, sample, y_true, x_true, normal_loss="ON", deco="OFF"):
    """The three AAE discriminants (+ the [0, 1] mapping, + the mass
    decorrelation).  ``sample['weights']`` should already carry the
    ``adjust_weights`` normalization."""
    x_auto, x_disc = aae_inference(params, x_true)
    x_loss = {
        "Autoencoder": make_discriminant(x_true, x_auto, metric="MAE"),
        "Discriminator": x_disc[:, 2],
    }
    x_loss["Auto+Disc"] = (x_loss["Autoencoder"] + x_loss["Discriminator"]) / 2
    on = lambda f: (f.upper() == "ON") if isinstance(f, str) else bool(f)
    if on(normal_loss) or deco in ("m", "pt", "2d"):
        x_loss = {k: aae_loss_mapping(v) for k, v in x_loss.items()}
    if deco in ("m", "pt", "2d"):
        x_loss = {k: mass_deco(y_true, sample, v, deco=deco) for k, v in x_loss.items()}
    return x_loss


def _scan_numbers(y_true, x_loss, disc_name, sample, n_cuts=100, m_range=(0, 800),
                  device="cuda"):
    """The 1-D scan's numbers: {'best': the best-cut record, 'eff' and
    'sigma': the normalized local-sigma curve (sigma_cut / sigma_uncut),
    'loc_sigma': each kept cut's local sigma, 'x_min', 'max_sigma': the
    largest bin significance of any cut, 'sample' and 'cut_sample': the
    scan's sample and its part above the best cut, 'hists': the (data,
    background) matrices of the batched scan}, or None where no cut keeps
    100 background jets and a finite sigma."""
    fpr, tpr, thresholds = get_rates(y_true, x_loss, sample["weights"], device=device)
    x_min = np.min(fpr)
    eff_val = np.logspace(np.log10(x_min), np.log10(100), num=n_cuts)
    idx = np.minimum(np.searchsorted(fpr, eff_val, side="right"), len(fpr) - 1)
    sample = {key: sample[key] for key in _SCAN_KEYS}

    data_hists, bkg_hists, kept = [], [], []
    for i in idx:
        cut = x_loss >= thresholds[i]
        jzw_c, m_c, w_c = sample["JZW"][cut], sample["m"][cut], sample["weights"][cut]
        bkg_m, bkg_w = m_c[jzw_c != -1], w_c[jzw_c != -1]
        if len(bkg_m) < 100:
            continue
        try:
            bins = _adaptive_bins(bkg_m, m_range, 5)
        except Exception:
            continue
        data_hists.append(np.histogram(m_c, bins=bins, weights=w_c)[0])
        bkg_hists.append(np.histogram(bkg_m, bins=bins, weights=bkg_w)[0])
        kept.append(i)
    if not kept:
        return None
    data_mat, bkg_mat = pad_hist_matrices(data_hists, bkg_hists, n_cuts)
    loc_sigma, _, _, bin_sigma = (t.cpu().numpy() for t in batched_local_sigma(
        data_mat, bkg_mat, _WIDTHS, _STEPS, device=device))
    loc_sigma = loc_sigma[:len(data_hists)]
    max_sigma = bin_sigma[:len(data_hists)].max(axis=1)
    finite = np.isfinite(loc_sigma) & np.isfinite(max_sigma)
    kept = np.asarray(kept)[finite]
    loc_sigma, max_sigma = loc_sigma[finite], max_sigma[finite]
    if len(kept) == 0:
        return None
    cut_thresholds = np.take(thresholds, kept)
    # only the local-sigma curve is drawn, normalized to the loosest cut's
    loc_norm = loc_sigma / loc_sigma[-1]
    best = int(np.argmax(loc_norm))
    nearest = np.argmin(np.abs(thresholds - cut_thresholds[best]))
    best_cut = {"cuts": {disc_name: cut_thresholds[best]}, "sig_eff": tpr[nearest],
                "bkg_eff": fpr[nearest]}
    cut_sample = {k: v[x_loss > cut_thresholds[best]] for k, v in sample.items()}
    return dict(best=best_cut, eff=np.take(fpr, kept), sigma=loc_norm, loc_sigma=loc_sigma,
                x_min=x_min, max_sigma=float(np.max(max_sigma)), sample=sample,
                cut_sample=cut_sample, hunt_cut=True, hists=(data_mat, bkg_mat))


def _hunt(numbers, npe=1000, device="cuda"):
    """Add to a scan's numbers 'hunters': the ``_hunter_numbers`` of its
    uncut sample and, where its 'hunt_cut' says so, of its best-cut sample,
    the BumpHunter passes its plots show."""
    samples = (numbers["sample"], numbers["cut_sample"])[:1 + numbers["hunt_cut"]]
    numbers["hunters"] = [_hunter_numbers(s, npe=npe, device=device) for s in samples]
    return numbers


def _draw_scan(numbers, sig_label, output_dir):
    """``aae_bump_scan``'s plots: the sigma curve, BumpHunter on the uncut
    and the best-cut sample, their m and pt distributions."""
    from ..plotting.performance import plot_sigma_scan
    from ..plotting.distributions import sample_distributions
    plot_sigma_scan(numbers["eff"], numbers["sigma"], "bkg", max(numbers["x_min"], 1e-4), 100,
                    str(output_dir) + "/BH_sigma.png")
    samples = (numbers["sample"], numbers["cut_sample"])
    for s, hunter, name in zip(samples, numbers["hunters"], ("BH_uncut", "BH_best")):
        _draw_hunter(s, hunter, numbers["max_sigma"], sig_label,
                     str(output_dir) + f"/{name}.png")
    sample_distributions(list(samples), sig_label, output_dir, "BH_bkg_supp",
                         bin_sizes={"m": 5, "pt": 10})


def aae_bump_scan(y_true, x_loss, disc_name, sample, sig_label, output_dir,
                  n_cuts=100, m_range=(0, 800), make_plots=True, npe=1000, device="cuda"):
    """Normalized significance scan over one discriminant's cuts: the
    scans of all cuts as one batched scan on ``device``; ``make_plots``
    with an ``output_dir`` draws the curve and BumpHunter on the uncut and
    the best-cut sample.  Returns the best-cut record {'cuts', 'sig_eff',
    'bkg_eff'}, or None."""
    numbers = _scan_numbers(y_true, x_loss, disc_name, sample, n_cuts, m_range, device)
    if numbers is None:
        return None
    if make_plots and output_dir is not None:
        _draw_scan(_hunt(numbers, npe, device), sig_label, output_dir)
    return numbers["best"]


def _scan_2d_numbers(y_true, x_loss, sample, n_cuts=40, m_range=(0, 800), device="cuda"):
    """The 2-D (AE x Disc) scan's numbers: {'best': the best cut-pair
    record, 'tpr', 'fpr' and 'loc_sigma' of every pair, 'best_fpr',
    'max_sigma' at the best pair, 'sample', 'cut_sample', 'hunt_cut'
    (whether the cut sample keeps 100 background jets), 'hists': the (data,
    background) matrices of the batched scan}, or None where no pair has a
    finite sigma."""
    loss_1, loss_2 = (np.asarray(x_loss[n], np.float64) for n in _DISCS_2D)
    sample = {key: sample[key] for key in _SCAN_KEYS}
    w = sample["weights"]

    def cut_grid(loss):
        fpr, _, thresholds = get_rates(y_true, loss, w, device=device)
        eff_val = np.logspace(np.log10(np.min(fpr)), np.log10(100), num=n_cuts)
        idx = np.minimum(np.searchsorted(fpr, eff_val, side="left"), len(fpr) - 1)
        return np.take(thresholds, idx)

    thr_1, thr_2 = cut_grid(loss_1), cut_grid(loss_2)
    # the rank of the finest threshold each jet passes: a jet counts in every
    # cut pair (i, j) with thr_1[i] <= loss_1 and thr_2[j] <= loss_2
    order_1, order_2 = np.argsort(thr_1), np.argsort(thr_2)
    r1 = np.searchsorted(thr_1[order_1], loss_1, side="right") - 1
    r2 = np.searchsorted(thr_2[order_2], loss_2, side="right") - 1
    bkg_mask = y_true == 1
    bins = _adaptive_bins(sample["m"][bkg_mask], m_range, 5)
    m_idx = np.clip(np.digitize(sample["m"], bins), 1, len(bins) - 1) - 1
    nbins = len(bins) - 1

    def grid_hist(select):
        keep = select & (r1 >= 0) & (r2 >= 0)
        h = np.zeros((n_cuts, n_cuts, nbins), np.float64)
        np.add.at(h, (r1[keep], r2[keep], m_idx[keep]), w[keep])
        # suffix cumsum: pair (i, j) sums all ranks >= (i, j)
        h = np.cumsum(h[::-1], axis=0)[::-1]
        return np.cumsum(h[:, ::-1], axis=1)[:, ::-1]

    inside = (sample["m"] >= bins[0]) & (sample["m"] <= bins[-1])
    data_h = grid_hist(inside)
    bkg_h = grid_hist(inside & bkg_mask)
    sig_h = grid_hist(inside & ~bkg_mask)
    flat_data = data_h.reshape(-1, nbins).astype(np.float32)
    flat_bkg = bkg_h.reshape(-1, nbins).astype(np.float32)
    loc_sigma, _, _, bin_sigma = (t.cpu().numpy() for t in batched_local_sigma(
        flat_data, flat_bkg, _WIDTHS, _STEPS, device=device))
    max_sigma = bin_sigma.max(axis=1)
    tpr = sig_h.sum(axis=2).reshape(-1) / max(np.sum(w[~bkg_mask]), 1e-30)
    fpr = bkg_h.sum(axis=2).reshape(-1) / max(np.sum(w[bkg_mask]), 1e-30)

    finite = np.isfinite(loc_sigma) & (flat_bkg.sum(axis=1) > 0)
    if not np.any(finite):
        return None
    flat_idx = np.arange(n_cuts * n_cuts)[finite]
    best_flat = flat_idx[int(np.argmax(loc_sigma[finite]))]
    i, j = best_flat // n_cuts, best_flat % n_cuts
    best = {"cuts": {_DISCS_2D[0]: thr_1[order_1][i], _DISCS_2D[1]: thr_2[order_2][j]},
            "sig_eff": 100 * tpr[best_flat], "bkg_eff": 100 * fpr[best_flat]}
    cuts = (loss_1 >= best["cuts"][_DISCS_2D[0]]) & (loss_2 >= best["cuts"][_DISCS_2D[1]])
    cut_sample = {k: v[cuts] for k, v in sample.items()}
    return dict(best=best, tpr=tpr, fpr=fpr, loc_sigma=loc_sigma, best_fpr=fpr[best_flat],
                max_sigma=float(max_sigma[best_flat]), sample=sample, cut_sample=cut_sample,
                hunt_cut=bool(np.sum(cuts & bkg_mask) >= 100), hists=(flat_data, flat_bkg))


def _draw_scan_2d(numbers, sig_label, output_dir):
    """``aae_bump_scan_2d``'s plots: the combined-cut ROC, BumpHunter on
    the uncut and (where it keeps 100 background jets) the best-cut sample,
    their m and pt distributions."""
    from ..plotting.aae_plots import binary_dics_eff
    from ..plotting.distributions import sample_distributions
    binary_dics_eff(numbers["tpr"], numbers["fpr"], output_dir, sig_label, numbers["best_fpr"])
    samples = (numbers["sample"], numbers["cut_sample"])
    for s, hunter, name in zip(samples, numbers["hunters"], ("BH_uncut", "BH_best")):
        _draw_hunter(s, hunter, numbers["max_sigma"], sig_label,
                     str(output_dir) + f"/{name}.png")
    sample_distributions(list(samples), sig_label, output_dir, "BH_bkg_supp",
                         bin_sizes={"m": 5, "pt": 10})


def aae_bump_scan_2d(y_true, x_loss, sample, sig_label, output_dir, n_cuts=40,
                     m_range=(0, 800), make_plots=True, npe=1000, device="cuda"):
    """Two-discriminant (AE x Disc) threshold grid scan: n_cuts^2 cut pairs'
    local sigmas in one batched scan on ``device``; ``make_plots`` with an
    ``output_dir`` draws the combined-cut ROC and BumpHunter on the uncut
    and the best-cut sample.  Returns the best 2-D cut record, or None."""
    numbers = _scan_2d_numbers(y_true, x_loss, sample, n_cuts, m_range, device)
    if numbers is None:
        return None
    if make_plots and output_dir is not None:
        _draw_scan_2d(_hunt(numbers, npe, device), sig_label, output_dir)
    return numbers["best"]
