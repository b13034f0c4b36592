"""Significance scans over discriminant cuts.

Counterpart of ``atlasvae/eval/bump.py``:

* ``bump_hunter``: one BumpHunter pass on a cut sample with adaptive
  min-count bins and a Gaussian fit of the bin-significance profile
  (ref OE-VAE/utils.py:467-529).
* ``bump_scan``: significance vs background-efficiency curve over ~100
  logit-spaced cuts.  Each cut's histograms are built on the host with its
  own adaptive bins; the data scans of all cuts run as one batched scan on
  ``device`` (``stats.batched_local_sigma``).  Only the local sigma is
  plotted by the reference (ref OE-VAE/plots.py:285-291 + utils.py:494), so
  no pseudo-experiments are run per cut.
* ``generate_cuts``: background-suppression plots at fixed efficiencies
  (ref OE-VAE/plots.py:88-104).

Each of them computes its numbers first (``_hunter_numbers``,
``_scan_numbers``, ``_cut_samples``: the scans on ``device``, histograms on
the host) and then draws them (``_draw_hunter``, ``_draw_scan``,
``_draw_cuts``), so that ``eval/results.py`` can compute every number of
the evaluation before it draws any of them.
"""

import os

import numpy as np

from ..utils.chunks import bin_edges, merged_bins
from ..stats import BumpHunter1D, batched_local_sigma, fit_gaussian
from .roc import get_rates, make_cut

_WIDTHS = (2, 3, 4, 5, 6)     # ref OE-VAE/utils.py:483
_STEPS = (1, 1, 1, 1, 1)


def pad_hist_matrices(data_hists, bkg_hists, n_rows_min):
    """Stack per-cut histograms into fixed matrices: the width rounded up
    to a multiple of 32 bins and the rows up to the full cut grid, the
    shapes and masks of the JAX package (which pads for one compile).
    Trailing zero bins/rows never scan (bkg=0 -> every window invalid)."""
    nbins = -(-max(len(h) for h in data_hists) // 32) * 32
    n_rows = max(len(data_hists), n_rows_min)
    pad = lambda h: np.pad(h, (0, nbins - len(h)))
    data_mat = np.zeros((n_rows, nbins))
    bkg_mat = np.zeros((n_rows, nbins))
    data_mat[:len(data_hists)] = np.stack([pad(h) for h in data_hists])
    bkg_mat[:len(bkg_hists)] = np.stack([pad(h) for h in bkg_hists])
    return data_mat, bkg_mat


def _adaptive_bins(bkg_m, m_range, bin_size, logspace=False):
    m_min = max(m_range[0], float(np.min(bkg_m)))
    m_max = min(m_range[1], float(np.max(bkg_m)))
    if logspace:
        base = np.logspace(np.log10(max(1, m_min)), np.log10(m_max), num=100)
    else:
        base = bin_edges(m_max, bin_size, m_min)
    return merged_bins(bkg_m, base, min_bin_count=20)  # ref utils.py:477


def _hunter_numbers(sample, m_range=(0, 800), bin_size=5, logspace=False, npe=1000,
                    verbose=False, device="cuda"):
    """One BumpHunter pass on ``sample``'s mass with adaptive bins, and the
    Gaussian fit of its per-bin significances: a dict of what
    ``bump_hunter`` returns and draws."""
    y_true = np.where(sample["JZW"] == -1, 0, 1)
    data, data_weights = sample["m"], sample["weights"]
    bkg, bkg_weights = data[y_true == 1], data_weights[y_true == 1]
    bins = _adaptive_bins(bkg, m_range, bin_size, logspace)
    data_hist = np.histogram(data, bins=bins, range=m_range, weights=data_weights)[0]
    bkg_hist = np.histogram(bkg, bins=bins, range=m_range, weights=bkg_weights)[0]
    hunter = BumpHunter1D(rang=list(m_range), width_min=2, width_max=6,
                          width_step=1, scan_step=1, npe=npe, seed=None,
                          bins=bins, device=device)
    hunter.bump_scan(data_hist, bkg_hist, is_hist=True, verbose=verbose)
    bin_sigma, bump_range = hunter.plot_bump(data_hist, bkg_hist, is_hist=True)
    gaussian_par = None
    try:
        gaussian_par = fit_gaussian(bins, bin_sigma, bump_range)
    except Exception:
        try:
            gaussian_par = fit_gaussian(bins, bin_sigma)
        except Exception:
            pass
    loc_sigma = hunter.bump_info(data_hist, is_hist=True, verbose=verbose)
    max_sigma = None if gaussian_par is None else gaussian_par[0] * gaussian_par[3]
    return dict(y_true=y_true, bins=bins, bin_sigma=bin_sigma, bump_range=bump_range,
                gaussian_par=gaussian_par, loc_sigma=loc_sigma, max_sigma=max_sigma,
                m_range=m_range)


def _draw_hunter(sample, hunter, max_sigma, sig_label, filename):
    from ..plotting.performance import plot_bump_result
    plot_bump_result(sample["m"], sample["weights"], hunter["y_true"], hunter["bins"],
                     hunter["bin_sigma"], hunter["loc_sigma"], max_sigma,
                     hunter["bump_range"], hunter["m_range"], hunter["gaussian_par"],
                     sig_label, filename)


def bump_hunter(sample, filename=None, sig_label=None, max_sigma=None,
                m_range=(0, 800), bin_size=5, print_info=False, logspace=False,
                npe=1000, device="cuda"):
    """Full BumpHunter treatment of one (cut) sample, drawn to ``filename``
    if one is given; returns (loc_sigma, max_sigma) (ref OE-VAE/utils.py:467-501)."""
    hunter = _hunter_numbers(sample, m_range, bin_size, logspace, npe,
                             filename is not None and print_info, device)
    if max_sigma is None:
        max_sigma = hunter["max_sigma"]
    if filename is not None:
        _draw_hunter(sample, hunter, max_sigma, sig_label, filename)
    return hunter["loc_sigma"], max_sigma


def _cut_histograms(x_loss, thresholds, idx, sample, m_range, bin_size):
    """Each cut's data and background mass histograms with its own adaptive
    bins (host, numpy); cuts keeping fewer than 100 background jets are
    skipped.  Returns (data_hists, bkg_hists, kept cut indices)."""
    data_hists, bkg_hists, kept = [], [], []
    for i in idx:
        cut = x_loss > thresholds[i]
        m_cut, w_cut = sample["m"][cut], sample["weights"][cut]
        jzw_cut = sample["JZW"][cut]
        bkg_m, bkg_w = m_cut[jzw_cut != -1], w_cut[jzw_cut != -1]
        if len(bkg_m) < 100:
            continue
        try:
            bins = _adaptive_bins(bkg_m, m_range, bin_size)
            data_hists.append(np.histogram(m_cut, bins=bins, weights=w_cut)[0])
            bkg_hists.append(np.histogram(bkg_m, bins=bins, weights=bkg_w)[0])
            kept.append(i)
        except Exception:
            continue
    return data_hists, bkg_hists, kept


def _cut_grid(y_true, x_loss, weights, n_cuts=100, eff_type="bkg", device="cuda"):
    """The cut scan's grid: the ROC thresholds, the efficiency (percent)
    the curve is drawn against, the threshold index of each of the
    ``n_cuts`` (+1 for bkg efficiency) logit-spaced cuts, and the plot's
    x range."""
    def logit(x):
        return np.log10(x) - np.log10(1 - x)

    def inverse_logit(x):
        return 1 / (1 + 10 ** (-x))

    fpr, tpr, thresholds = get_rates(y_true, x_loss, weights, device=device)
    x_max = 100
    if eff_type == "sig":
        eff = tpr
        x_min = 10 * np.floor(tpr[0] / 10)
        eff_val = np.linspace(tpr[0], x_max, n_cuts)
    else:
        eff = fpr
        # the lowest threshold can pass zero bkg events (fpr == 0,
        # common on small/weighted samples): use the smallest positive
        # fpr so the logit grid stays finite
        pos = fpr[fpr > 0]
        min_fpr = pos.min() if len(pos) else 1e-4
        x_min = min(10 ** np.ceil(np.log10(min_fpr)), 50.0)
        eff_val = np.append(
            100 * inverse_logit(np.linspace(logit(x_min / 100),
                                            -logit(x_min / 100), n_cuts)), 100)
    idx = np.minimum(np.searchsorted(eff, eff_val, side="right"), len(eff) - 1)
    return thresholds, eff, idx, (x_min, x_max)


def _scan_numbers(y_true, x_loss, loss_metric, sample, n_cuts=100, eff_type="bkg",
                  m_range=(0, 800), bin_size=5, device="cuda"):
    """The cut scan's numbers: {'best': the best-cut record, 'eff' and
    'sigma': the curve, 'x_range': its plot's x range}, or None where no
    cut keeps 100 background jets or a finite sigma."""
    thresholds, eff, idx, x_range = _cut_grid(y_true, x_loss, sample["weights"], n_cuts,
                                              eff_type, device)
    data_hists, bkg_hists, kept = _cut_histograms(x_loss, thresholds, idx, sample,
                                                  m_range, bin_size)
    if not kept:
        return None
    data_mat, bkg_mat = pad_hist_matrices(data_hists, bkg_hists, n_cuts + 1)
    loc_sigma = batched_local_sigma(data_mat, bkg_mat, _WIDTHS, _STEPS,
                                    device=device)[0].cpu().numpy()
    sigma = loc_sigma[:len(data_hists)]
    kept = np.asarray(kept)
    thresholds_k, eff_k = np.take(thresholds, kept), np.take(eff, kept)
    finite = np.isfinite(sigma)
    thresholds_k, eff_k, sigma = thresholds_k[finite], eff_k[finite], sigma[finite]
    if len(sigma) == 0:
        return None
    best = int(np.argmax(sigma))
    return {"best": {"metric": loss_metric, "eff": eff_k[best], "loss": thresholds_k[best]},
            "eff": eff_k, "sigma": sigma, "x_range": x_range}


def _scan_sample(sample):
    return {key: sample[key] for key in ("JZW", "m", "pt", "weights")}


def _best_cut(sample, x_loss, best_loss):
    """The scan's sample (m, pt, weights, JZW) above the best cut."""
    return {key: val[x_loss > best_loss["loss"]] for key, val in _scan_sample(sample).items()}


def _draw_scan(scan, hunter, sample, cut_sample, sig_data, output_dir, eff_type="bkg"):
    """``bump_scan``'s plots: the sigma curve, the best cut's bump
    (``hunter``: ``_hunter_numbers`` of ``cut_sample``) and its m and pt
    distributions beside the uncut sample's."""
    from ..plotting.performance import plot_sigma_scan
    from ..plotting.distributions import sample_distributions
    plot_sigma_scan(scan["eff"], scan["sigma"], eff_type, *scan["x_range"],
                    str(output_dir) + "/BH_sigma.png")
    _draw_hunter(cut_sample, hunter, hunter["max_sigma"], _sig_label(sig_data),
                 str(output_dir) + "/BH_best.png")
    sample_distributions([_scan_sample(sample), cut_sample], sig_data, output_dir,
                         "BH_bkg_supp", bin_sizes={"m": 2.5, "pt": 10})


def bump_scan(y_true, x_loss, loss_metric, sample, sig_data, output_dir,
              n_cuts=100, eff_type="bkg", npe=1000, m_range=(0, 800),
              bin_size=5, make_plots=True, device="cuda"):
    """Significance vs cut-efficiency curve; returns the best-cut record
    {'metric', 'eff', 'loss'} (ref OE-VAE/plots.py:262-332).

    Per-cut adaptive binning on the host; the n_cuts data scans as one
    batched scan on ``device``.  ``make_plots`` with an ``output_dir``
    draws the curve, then runs ``bump_hunter`` (its default mass range and
    bins) on the best cut and draws it and the cut's distributions.
    """
    scan = _scan_numbers(y_true, x_loss, loss_metric, sample, n_cuts, eff_type, m_range,
                         bin_size, device)
    if scan is None:
        return None
    if make_plots and output_dir is not None:
        cut_sample = _best_cut(sample, x_loss, scan["best"])
        hunter = _hunter_numbers(cut_sample, npe=npe, device=device)
        _draw_scan(scan, hunter, sample, cut_sample, sig_data, output_dir, eff_type)
    return scan["best"]


def _sig_label(sig_data):
    for token, tag in [("top", "Top"), ("VZ", "VZ"), ("BSM", "BSM"),
                       ("OoD", "OoD"), ("2HDM", "2HDM")]:
        if token in str(sig_data):
            return tag
    return "N.A."


def _cut_samples(y_true, sample, x_loss, loss_metric, cut_types=("bkg_eff", "gain"),
                 device="cuda"):
    """The background-suppression cuts: [(plot name, cut sample)], six at
    fixed background efficiencies and one at the best gain or sigma."""
    print("\nAPPLYING CUTS ON SAMPLE:")
    positive_rates = get_rates(y_true, x_loss, sample["weights"], device=device)
    cuts = []
    for cut_type in cut_types:
        if cut_type == "bkg_eff":
            for bkg_eff in (1e-4, 1e-3, 1e-2, 1e-1, 1e0, 1e1):
                cuts.append((f"bkg_suppression/bkg_eff_{bkg_eff:1.0e}",
                             make_cut(y_true, x_loss, sample, positive_rates, loss_metric,
                                      cut_type, bkg_eff)))
        if cut_type in ("gain", "sigma"):
            cuts.append((f"bkg_suppression/best_{cut_type}",
                         make_cut(y_true, x_loss, sample, positive_rates, loss_metric,
                                  cut_type)))
    return cuts


def _draw_cuts(cuts, sample, sig_data, output_dir):
    from ..plotting.distributions import sample_distributions
    os.makedirs(os.path.join(str(output_dir), "bkg_suppression"), exist_ok=True)
    for name, cut_sample in cuts:
        sample_distributions([sample, cut_sample], sig_data, output_dir, name)


def generate_cuts(y_true, sample, x_loss, loss_metric, sig_data, output_dir,
                  cut_types=("bkg_eff", "gain"), device="cuda"):
    """Background-suppression plots at fixed bkg efficiencies and at the
    best gain/sigma cut (ref OE-VAE/plots.py:88-104)."""
    _draw_cuts(_cut_samples(y_true, sample, x_loss, loss_metric, cut_types, device), sample,
               sig_data, output_dir)
