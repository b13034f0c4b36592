"""Pedagogical / debug figures.

Counterpart of ``atlasvae/plotting/pedagogy.py``, on the port's own
decorrelation (``eval/deco.py``); matplotlib is loaded inside each drawing
function (``backend.pyplot``) and scipy inside ``_maxwell_cdf``.  No entry
point of either package calls these.  Two families:

* The decorrelation teaching figures (ref OE-AAE/plots.py:1140-1688):
  ``deco_walkthrough`` re-derives the reference's full analytic figure
  bank (quartic/Maxwell pdfs, CDF-flattening pushforward, logit-axis
  panels, plus the AUC/spectra/ROC illustrations), and ``deco_example``
  is a data-driven companion that runs the real 2-D flattening on an
  actual sample.
* jet-ID debug plots (ref jet-ID/plots.py:382-550): ``cal_images``
  (mean calorimeter images per class), ``plot_tracks`` (track-number +
  per-variable mean/max/gap panels), ``plot_scalars`` (raw vs
  transformed), ``plot_vertex``.
"""

import numpy as np

from ..eval.deco import cum_distribution, _apply_cdf, mass_deco
from .backend import pyplot


def deco_example(y_true, sample, x_loss, output_dir, m_window=(100, 200)):
    """Three-panel decorrelation walkthrough: (1) discriminant before,
    (2) the background CDF in one mass window, (3) discriminant after
    2-D flattening (ref OE-AAE/plots.py:1140-1688, condensed)."""
    plt = pyplot()
    y_true = np.asarray(y_true)
    x_loss = np.asarray(x_loss, np.float64)
    mass = np.asarray(sample["m"])
    in_window = (mass >= m_window[0]) & (mass < m_window[1])
    bkg_cell = x_loss[(y_true == 1) & in_window]
    fig, axes = plt.subplots(figsize=(18, 5), ncols=3)
    bins = np.linspace(0, 1, 40)
    for n, (label, color) in enumerate([("signal", "tab:orange"),
                                        ("QCD", "tab:blue")]):
        axes[0].hist(x_loss[y_true == n], bins, histtype="step", lw=2,
                     label=label, color=color, density=True)
    axes[0].set_xlabel("discriminant")
    axes[0].set_title("before decorrelation")
    axes[0].legend()
    values, cdf = cum_distribution(bkg_cell)
    grid = np.linspace(0, 1, 200)
    axes[1].plot(grid, _apply_cdf((values, cdf), grid), lw=2, color="tab:blue")
    axes[1].set_xlabel("discriminant")
    axes[1].set_ylabel("background CDF")
    axes[1].set_title(f"QCD CDF in m in [{m_window[0]}, {m_window[1]}) GeV")
    flat = mass_deco(y_true, sample, x_loss.copy(), deco="2d")
    for n, (label, color) in enumerate([("signal", "tab:orange"),
                                        ("QCD", "tab:blue")]):
        axes[2].hist(flat[y_true == n], bins, histtype="step", lw=2,
                     label=label, color=color, density=True)
    axes[2].set_xlabel("decorrelated discriminant")
    axes[2].set_title("after 2-D CDF flattening")
    axes[2].legend()
    out = f"{output_dir}/deco_example.png"
    print("Saving decorrelation example to:", out)
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return flat


def cal_images(images, labels, output_dir, class_names=("signal", "background"),
               mode="mean"):
    """Mean (or std) detector image per class
    (ref jet-ID/plots.py:382-448, condensed to the per-class panels)."""
    plt = pyplot()
    images = np.asarray(images, np.float64)
    labels = np.asarray(labels)
    classes = sorted(set(labels))
    fig, axes = plt.subplots(figsize=(6 * len(classes), 5), ncols=len(classes))
    if len(classes) == 1:
        axes = [axes]
    for ax, cls in zip(axes, classes):
        img = images[labels == cls]
        panel = img.mean(axis=0) if mode == "mean" else img.std(axis=0)
        im = ax.imshow(panel, origin="lower", cmap="viridis", aspect="auto")
        name = class_names[cls] if cls < len(class_names) else f"class {cls}"
        ax.set_title(f"{name} ({mode})")
        plt.colorbar(im, ax=ax, fraction=0.046)
    out = f"{output_dir}/cal_images_{mode}.png"
    print("Saving calorimeter images to:", out)
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# Analytic decorrelation walkthrough (ref OE-AAE/plots.py:1140-1688).
#
# The reference generates a bank of data-free teaching figures from
# closed-form distributions: a quartic background pdf, Maxwell-shaped
# signal pdfs, their CDFs, the pushforward of both under the background
# CDF (the flattening transform), and the same on a logit axis.  The
# math below is re-derived from those definitions; annotation is
# content-complete (axis arrows, highlighted bin, integral construction,
# best-significance cut, 1/4 asymptote, probability tick labels) without
# reproducing the reference's hand-tuned typography.
# ---------------------------------------------------------------------------

def _quartic_coeff():
    """Quartic pdf with f(0)=f(1)=0, f'(0.2)=0, f''(0.75)=0, integral 1
    (the constraint set of ref OE-AAE/plots.py:1141-1152)."""
    x0, x1, d1, d2 = 0.0, 1.0, 0.2, 0.75
    a = np.array([
        [x0 ** 4, x0 ** 3, x0 ** 2, x0, 1],
        [x1 ** 4, x1 ** 3, x1 ** 2, x1, 1],
        [4 * d1 ** 3, 3 * d1 ** 2, 2 * d1, 1, 0],
        [12 * d2 ** 2, 6 * d2, 2, 0, 0],
        [1 / 5, 1 / 4, 1 / 3, 1 / 2, 1],
    ])
    return np.linalg.solve(a, np.array([0.0, 0.0, 0.0, 0.0, 1.0]))


def _poly_pdf(x, c):
    return c[0] * x ** 4 + c[1] * x ** 3 + c[2] * x ** 2 + c[3] * x + c[4]


def _poly_cdf(x, c):
    return (c[0] * x ** 5 / 5 + c[1] * x ** 4 / 4 + c[2] * x ** 3 / 3
            + c[3] * x ** 2 / 2 + c[4] * x)


def _maxwell_pdf(x, a):
    return np.sqrt(2 / np.pi) * (x ** 2 / a ** 3) * np.exp(-x ** 2 / (2 * a ** 2))


def _maxwell_cdf(x, a):
    from scipy.special import erf
    return (erf(x / (np.sqrt(2) * a))
            - np.sqrt(2 / np.pi) * (x / a) * np.exp(-x ** 2 / (2 * a ** 2)))


def _axis_arrows(ax, x_origin=None, y_origin=None):
    xmin, xmax = ax.get_xlim()
    ymin, ymax = ax.get_ylim()
    x0 = xmin if x_origin is None else x_origin
    y0 = ymin if y_origin is None else y_origin
    ax.annotate("", xy=(xmax + 0.06 * (xmax - xmin), y0), xytext=(xmin, y0),
                arrowprops=dict(arrowstyle="-|>", lw=2, color="black"),
                annotation_clip=False)
    ax.annotate("", xy=(x0, ymax + 0.10 * (ymax - ymin)), xytext=(x0, ymin),
                arrowprops=dict(arrowstyle="-|>", lw=2, color="black"),
                annotation_clip=False)
    ax.set_xticks([]) if not len(ax.get_xticks()) else None
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)


def _best_significance_cut(F_bkg_vals, F_sig_vals, score):
    """argmax of eps_sig/sqrt(eps_bkg) over thresholds
    (ref OE-AAE/plots.py:1171-1177 ``best_significance``)."""
    bkg_eff = 1 - np.asarray(F_bkg_vals)
    sig_eff = 1 - np.asarray(F_sig_vals)
    ok = (bkg_eff > 0) & (bkg_eff < 1) & (sig_eff < 1)
    sigma = np.where(ok, sig_eff / np.sqrt(np.maximum(bkg_eff, 1e-300)), -1)
    return float(np.asarray(score)[np.argmax(sigma)])


def _pushforward_hist(F_bkg, F_sig, edges_in=None, edges_out=None):
    """Histogram of the pushforward x -> F_bkg(x) weighted by each pdf
    (ref OE-AAE/plots.py:1651-1663 ``get_hist``, vectorized)."""
    x = edges_in if edges_in is not None else np.linspace(0, 1, 100001)
    mid = (x[:-1] + x[1:]) / 2
    x_map = F_bkg(mid)
    n_bkg = np.diff(F_bkg(x))
    n_sig = np.diff(F_sig(x))
    new_x = (edges_out if edges_out is not None
             else np.linspace(x_map.min(), x_map.max(), 1001))
    hist_bkg = np.histogram(x_map, bins=new_x, weights=n_bkg)[0]
    hist_sig = np.histogram(x_map, bins=new_x, weights=n_sig)[0]
    hist_bkg = hist_bkg / hist_bkg.sum()
    hist_sig = hist_sig / hist_sig.sum()
    return new_x, hist_bkg, hist_sig


def deco_walkthrough(output_dir, series=("poly", "maxwell"), extras=False):
    """The full analytic figure bank of ref OE-AAE/plots.py:1140-1688.

    Emits deco_0 (binned (m, pt) plane), then per series s in
    {1: quartic bkg, 2: Maxwell bkg}: deco_{s}a (pdfs + best cut),
    deco_{s}b (background CDF with the integral construction),
    deco_{s}c (flattened distributions: bkg uniform), deco_{s}d (the
    same on a logit axis with probability ticks and the 1/4 asymptote).
    ``extras=True`` adds the standalone illustrations the reference
    keeps behind its figure switch: AUC, uncut/cut spectra,
    distributions (TN/FP/FN/TP), ROC/gain/sigma curves.
    Returns the list of files written.
    """
    plt = pyplot()
    import os
    os.makedirs(output_dir, exist_ok=True)
    written = []
    colors = {"bkg": "tab:blue", "sig": "tab:orange", "QCD": "darkgray"}

    def save(fig, name):
        path = f"{output_dir}/deco_{name}.png"
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    # ---- figure 0: the binned (m, pt) plane ------------------------------
    fig, ax = plt.subplots(figsize=(9, 6))
    x = np.linspace(0, 1.07, 2001)
    y = _maxwell_pdf(x + 0.35, a=0.32)
    ax.plot(x, y, color="darkgray", lw=3, label="QCD")
    ax.fill_between(x, y, alpha=0.1, color="gray")
    xb = np.linspace(0.15, 0.20, 50)
    ax.fill_between(xb, _maxwell_pdf(xb + 0.35, a=0.32), alpha=0.3,
                    color="dimgray", hatch="//", edgecolor="dimgray")
    ax.annotate("Bin", xy=(0.175, 1.0), xytext=(0.4, 1.3), fontsize=16,
                arrowprops=dict(arrowstyle="-|>", color="black",
                                connectionstyle="arc3,rad=-0.2"))
    ax.set_xlim(0, 1); ax.set_ylim(0, 1.9)
    ax.set_xticks([]); ax.set_yticks([])
    ax.set_xlabel(r"$m\,;\,p_T$", fontsize=20)
    ax.set_ylabel(r"$\mathcal{P}$", fontsize=20, rotation=0)
    _axis_arrows(ax)
    ax.legend(loc="upper left", frameon=False, fontsize=14)
    save(fig, "0")

    # ---- per-series panels a-d -------------------------------------------
    coeff = _quartic_coeff()
    defs = {
        "poly": ("1", lambda v: _poly_pdf(v, coeff),
                 lambda v: _poly_cdf(v, coeff)),
        "maxwell": ("2", lambda v: _maxwell_pdf(v, a=0.215),
                    lambda v: _maxwell_cdf(v, a=0.215)),
    }
    f_sig = lambda v: _maxwell_pdf(1 - v, a=0.12)          # noqa: E731
    F_sig = lambda v: 1 - _maxwell_cdf(1 - v, a=0.12)      # noqa: E731

    for key in series:
        tag, f_bkg, F_bkg = defs[key]
        x = np.linspace(0, 1, 100001)

        # (a) pdfs + best-significance threshold
        fig, ax = plt.subplots(figsize=(9, 6))
        ax.plot(x, f_bkg(x), color=colors["bkg"], lw=3, label="Background")
        ax.plot(x, f_sig(x), color=colors["sig"], lw=3, label="Signal")
        ax.fill_between(x, f_bkg(x), alpha=0.1, color=colors["bkg"])
        ax.fill_between(x, f_sig(x), alpha=0.1, color=colors["sig"])
        cut = _best_significance_cut(F_bkg(x), F_sig(x), x)
        ax.axvline(cut, ymin=0, ymax=max(f_bkg(cut), f_sig(cut)) / 5,
                   ls="--", lw=2, color="tab:gray")
        ax.set_xlim(0, 1); ax.set_ylim(0, 5)
        ax.set_xticks([0, 1]); ax.set_yticks(range(6))
        ax.set_xlabel(r"$x$", fontsize=20)
        ax.set_ylabel(r"$f(x)$", fontsize=20)
        _axis_arrows(ax)
        ax.legend(loc="upper left", frameon=False, fontsize=14)
        save(fig, f"{tag}a")

        # (b) background CDF with the integral construction
        fig, ax = plt.subplots(figsize=(9, 6))
        ax.plot(x, F_bkg(x), color=colors["bkg"], lw=3, label="Background")
        xb = np.linspace(0.28, 0.32, 50)
        ax.fill_between(xb, F_bkg(xb), alpha=0.25, color=colors["bkg"])
        ax.fill_betweenx(F_bkg(xb), xb, alpha=0.25, color=colors["bkg"])
        ax.annotate("", xy=(0.3, float(F_bkg(np.array(0.3)))), xytext=(0.3, 0),
                    arrowprops=dict(arrowstyle="-|>", lw=2, color="black"))
        ax.annotate("", xy=(0, float(F_bkg(np.array(0.3)))),
                    xytext=(0.3, float(F_bkg(np.array(0.3)))),
                    arrowprops=dict(arrowstyle="-|>", lw=2, color="black"))
        ax.text(0.62, 0.78, r"$F(x)=\int_0^{x} f(t)\,dt$", fontsize=18)
        ax.text(0.30, -0.06, r"$\Delta x$", fontsize=14, ha="center")
        ax.text(-0.05, float(F_bkg(np.array(0.3))), r"$\Delta F$",
                fontsize=14, va="center", ha="right")
        ax.set_xlim(0, 1); ax.set_ylim(0, 1)
        ax.set_xticks([0, 1]); ax.set_yticks([0, 1])
        ax.set_xlabel(r"$x$", fontsize=20)
        ax.set_ylabel(r"$F(x)$", fontsize=20)
        _axis_arrows(ax)
        ax.legend(loc="upper left", frameon=False, fontsize=14)
        save(fig, f"{tag}b")

        # (c) distributions after the flattening map: bkg -> uniform
        new_x, hist_bkg, hist_sig = _pushforward_hist(F_bkg, F_sig)
        mid = (new_x[:-1] + new_x[1:]) / 2
        fig, ax = plt.subplots(figsize=(9, 6))
        ax.plot(mid, hist_bkg / np.diff(new_x), color=colors["bkg"], lw=3,
                label="Background")
        ax.plot(mid, hist_sig / np.diff(new_x), color=colors["sig"], lw=3,
                label="Signal")
        ax.fill_between(mid, hist_bkg / np.diff(new_x), alpha=0.1,
                        color=colors["bkg"])
        ax.fill_between(mid, hist_sig / np.diff(new_x), alpha=0.1,
                        color=colors["sig"])
        cut = _best_significance_cut(np.cumsum(hist_bkg),
                                     np.cumsum(hist_sig), new_x[1:])
        ax.axvline(cut, ls="--", lw=2, color="tab:gray")
        ax.set_xlim(0, 1); ax.set_ylim(0, 8)
        ax.set_xticks([0, 1])
        ax.set_xlabel(r"$F$", fontsize=20)
        ax.set_ylabel(r"$g(F)$", fontsize=20)
        _axis_arrows(ax)
        ax.legend(loc="upper left", frameon=False, fontsize=14)
        save(fig, f"{tag}c")

        # (d) same on a logit axis (base e) with probability ticks
        base = np.e
        x_min10, x_max10 = (-3, 3) if tag == "1" else (-3, 4.1)
        logit = lambda v: (np.log(v) - np.log1p(-v)) / np.log(base)  # noqa: E731
        inv_logit = lambda v: 1 / (1 + base ** (-v))                 # noqa: E731
        pos = ([10.0 ** n for n in range(int(np.floor(x_min10)), 0)] + [0.5]
               + [1 - 10.0 ** n
                  for n in range(-1, -int(np.floor(x_max10)) - 1, -1)])
        lab = (["0." + "0" * n + "1"
                for n in range(int(np.floor(x_min10)) + 5, -1, -1)] + ["0.5"]
               + ["0.9" + "9" * n for n in range(0, int(np.floor(x_max10)))])
        tick_pos = logit(np.array(pos))
        x_min = np.log(10.0 ** x_min10) / np.log(base)
        x_max = np.log(10.0 ** x_max10) / np.log(base)
        edges_in = inv_logit(np.linspace(1.5 * x_min, 1.5 * x_max, 200001))
        new_t = np.linspace(x_min, x_max * 1.1, 1001)
        _, hist_bkg, hist_sig = _pushforward_hist(
            F_bkg, F_sig, edges_in=edges_in, edges_out=inv_logit(new_t))
        mid = (new_t[:-1] + new_t[1:]) / 2
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.plot(mid, hist_bkg / np.diff(new_t), color=colors["bkg"], lw=3,
                label="Background")
        ax.plot(mid, hist_sig / np.diff(new_t), color=colors["sig"], lw=3,
                label="Signal")
        ax.fill_between(mid, hist_bkg / np.diff(new_t), alpha=0.1,
                        color=colors["bkg"])
        ax.fill_between(mid, hist_sig / np.diff(new_t), alpha=0.1,
                        color=colors["sig"])
        # flattened bkg on a base-e logit axis peaks at exactly 1/4
        peak = np.max(hist_bkg / np.diff(new_t))
        ax.axhline(peak, xmin=0, xmax=(-x_min) / (x_max - x_min), ls=":",
                   lw=2, color="tab:gray")
        ax.text(x_min - 0.25, peak, r"$\frac{1}{4}$", fontsize=16,
                va="center", ha="right")
        ax.set_xlim(x_min, x_max)
        ax.set_xticks(tick_pos, labels=lab, rotation=20)
        ax.set_ylim(0, 0.65 if tag == "1" else 0.3)
        ax.set_xlabel(r"$F$", fontsize=20)
        ax.set_ylabel(r"$g(t)$", fontsize=20)
        _axis_arrows(ax, x_origin=x_min)
        ax.legend(loc="upper left", frameon=False, fontsize=14)
        save(fig, f"{tag}d")

    if extras:
        _deco_extras(output_dir, colors, coeff, save)
    return written


def _deco_extras(output_dir, colors, coeff, save):
    """Standalone illustrations (ref OE-AAE/plots.py plot_number
    'AUC'/'uncut'/'cut'/'distributions'/'ROC_curve'/'gain_curve'/
    'sigma_curve' — kept behind the figure switch in the reference).
    Files are recorded through ``save``, which appends to the caller's
    written-files list."""
    plt = pyplot()
    x = np.linspace(0, 1, 100001)

    def rectircle(v, a, b, r):
        return b * (1 - (np.abs(v) / a) ** (2 * a / r)) ** (r / (2 * b))

    # AUC illustration: family of ROC shapes + random/quasi-perfect
    fig, ax = plt.subplots(figsize=(9, 6))
    for r in (0.4, 0.605, 0.785):
        y = rectircle(x, 1, 1, r)
        ax.plot(x, y, color="darkgray", lw=3)
        ax.text(0.75, rectircle(np.array(0.75), 1, 1, r) + 0.01,
                f"AUC$=${np.trapezoid(y, x):.2f}", fontsize=11, color="gray")
    ax.plot(x, 1 - x, color="tab:blue", lw=3)
    ax.text(0.12, 0.80, "AUC$=$0.50\n(random)", fontsize=12,
            color="tab:blue", ha="center")
    ax.set_xlim(0, 1); ax.set_ylim(0, 1)
    ax.set_xlabel(r"$\epsilon_{\mathrm{sig}}$", fontsize=18)
    ax.set_ylabel(r"$1-\epsilon_{\mathrm{bkg}}$", fontsize=18)
    _axis_arrows(ax)
    save(fig, "AUC")

    # uncut / cut mass spectra with a weak/strong bump
    for name, shift in (("uncut", 1.0), ("cut", -1.0)):
        fig, ax = plt.subplots(figsize=(9, 6))
        qcd = _maxwell_pdf(x / 2.5 + 0.2, a=0.2) + shift
        bump = np.exp(-(x - 0.5) ** 2 / (2 * 0.03 ** 2))
        ax.plot(x, np.log(np.exp(qcd) + np.exp(bump)), color=colors["QCD"],
                lw=3, label="QCD")
        sel = (x >= 0.4) & (x <= 0.6)
        ax.plot(x[sel], bump[sel], color=colors["sig"], lw=3, label="Signal")
        ax.annotate("Weak\nsignal" if name == "uncut" else "Strong\nsignal",
                    xy=(0.5, float(np.log(np.exp(qcd) + np.exp(bump))[50000])),
                    xytext=(0.62, 3.0), fontsize=13,
                    arrowprops=dict(arrowstyle="-|>", color="black",
                                    connectionstyle="arc3,rad=-0.1"))
        ax.set_xlim(0, 1); ax.set_ylim(0, 4)
        ax.set_xticks([]); ax.set_yticks([])
        ax.set_xlabel(r"$m$", fontsize=20)
        ax.set_ylabel(r"$\mathcal{P}$", fontsize=20, rotation=0)
        _axis_arrows(ax)
        ax.legend(loc="upper right", frameon=False, fontsize=13)
        save(fig, name)

    # distributions with TN/FP/FN/TP regions at a variable threshold
    fig, ax = plt.subplots(figsize=(9, 6))
    xx = np.linspace(0, 1.07, 100001)
    f_b = _maxwell_pdf(xx, a=0.16)
    f_s = _poly_pdf(1 - xx, coeff) - 0.1
    ax.plot(xx, f_b, color=colors["bkg"], lw=3, label="Background")
    ax.plot(xx, f_s, color=colors["sig"], lw=3, label="Signal")
    ax.fill_between(xx, f_b, alpha=0.1, color=colors["bkg"])
    ax.fill_between(xx, f_s, alpha=0.1, color=colors["sig"])
    x_cut = 0.4
    ax.fill_between(xx[xx >= x_cut], f_b[xx >= x_cut], color="none",
                    edgecolor=colors["bkg"], hatch="//")
    ax.fill_between(xx[xx <= x_cut], np.maximum(f_s[xx <= x_cut], 0),
                    color="none", edgecolor=colors["sig"], hatch="\\\\")
    ax.axvline(x_cut, lw=3, color="dimgray")
    for label, px, py, c in (("FN", 0.22, 0.2, colors["sig"]),
                             ("FP", 0.45, 0.2, colors["bkg"]),
                             ("TN", 0.22, 1.5, colors["bkg"]),
                             ("TP", 0.80, 0.8, colors["sig"])):
        ax.text(px, py, label, fontsize=20, fontweight="bold", color=c,
                ha="center")
    ax.text(x_cut, -0.25, "Variable threshold", fontsize=13, ha="center",
            color="dimgray")
    ax.set_xlim(0, 1); ax.set_ylim(0, 4)
    ax.set_xticks([]); ax.set_yticks([])
    ax.set_xlabel(r"$\mathcal{D}$", fontsize=20)
    ax.set_ylabel(r"$\mathcal{P}$", fontsize=20, rotation=0)
    _axis_arrows(ax)
    ax.legend(loc="upper right", frameon=False, fontsize=13)
    save(fig, "distributions")

    # ROC / gain / sigma curves from the analytic pair
    e_bkg = _maxwell_cdf(np.array(1.0), 0.16) - _maxwell_cdf(x, 0.16)
    e_sig = _poly_cdf(1 - x, coeff) - _poly_cdf(np.array(0.0), coeff)
    ok = e_bkg > 0
    for name, yv, ylab, ylog in (
            ("ROC_curve", 1 - e_bkg, r"$1-\epsilon_{\mathrm{bkg}}$", False),
            ("gain_curve", np.where(ok, e_sig / np.maximum(e_bkg, 1e-300), np.nan),
             r"$G_{\mathrm{s/b}}$", True),
            ("sigma_curve",
             np.where(ok, e_sig / np.sqrt(np.maximum(e_bkg, 1e-300)), np.nan),
             r"$\sigma_{\mathrm{ratio}}$", True)):
        fig, ax = plt.subplots(figsize=(9, 6))
        ax.plot(e_sig, yv, color="darkgray", lw=3)
        if name == "ROC_curve":
            acc = e_sig * 0.5 + (1 - e_bkg) * 0.5
            i = int(np.argmax(acc))
            ax.scatter([e_sig[i]], [yv[i]], s=80, color="black", zorder=5,
                       label=f"Best accuracy ({100 * acc[i]:.0f}%)")
            ax.legend(loc="lower right", frameon=False, fontsize=13)
            ax.set_ylim(0, 1)
        elif ylog:
            ax.set_yscale("log")
        ax.set_xlim(0, 1)
        ax.set_xlabel(r"$\epsilon_{\mathrm{sig}}$", fontsize=18)
        ax.set_ylabel(ylab, fontsize=18)
        save(fig, name)


# ---------------------------------------------------------------------------
# jet-ID track/scalar debug plots (ref jet-ID/plots.py:449-550).
# ---------------------------------------------------------------------------

def plot_vertex(sample, output_dir):
    """Track-vertex value distribution in % (ref jet-ID/plots.py:449-461)."""
    plt = pyplot()
    sample = np.asarray(sample)
    fig, ax = plt.subplots(figsize=(9, 6))
    bins = np.arange(0, 50, 1)
    ax.hist(sample, bins=bins, weights=np.full(len(sample), 100 / len(sample)),
            align="left", rwidth=0.5, lw=2)
    ax.set_xlim(-0.5, 10.5)
    ax.set_xticks(np.arange(0, 11))
    ax.set_xlabel("Track vertex value", fontsize=16)
    ax.set_ylabel("Distribution (%)", fontsize=16)
    out = f"{output_dir}/tracks_vertex.png"
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_scalars(sample, sample_trans, variable, output_dir):
    """Raw vs scaler-transformed distribution of one scalar variable
    (ref jet-ID/plots.py:464-481)."""
    plt = pyplot()
    fig, axes = plt.subplots(figsize=(14, 6), ncols=2)
    for ax, data, title in ((axes[0], sample[variable], "raw"),
                            (axes[1], sample_trans[variable], "transformed")):
        data = np.asarray(data, np.float64)
        lo, hi = np.nanpercentile(data, [0.1, 99.9])
        ax.hist(data, bins=np.linspace(min(lo, -1), max(hi, 1), 200),
                histtype="step", lw=2)
        ax.set_title(f"{variable} ({title})")
        ax.set_xlabel("Value")
        ax.set_ylabel("Number of entries")
    out = f"{output_dir}/scalars_{variable}.png"
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


_TRACK_VARS = {  # per-variable panel limits (ref jet-ID/plots.py:485-489)
    "efrac": dict(idx=0, mean_lim=(0, 3), max_lim=(0, 2), diff_lim=(0, 1)),
    "deta": dict(idx=1, mean_lim=(0, 5e-4), max_lim=(0, 0.03),
                 diff_lim=(0, 0.04)),
    "dphi": dict(idx=2, mean_lim=(0, 1e-3), max_lim=(0, 0.1),
                 diff_lim=(0, 0.05)),
    "d0": dict(idx=3, mean_lim=(0, 0.2), max_lim=(0, 0.1), diff_lim=(0, 0.3)),
    "z0": dict(idx=4, mean_lim=(0, 0.5), max_lim=(0, 0.3), diff_lim=(0, 10)),
}


def plot_tracks(tracks, labels, variable, output_dir):
    """Per-class track-number distributions (individually and globally
    normalized) plus mean / max-abs / average-gap panels of one track
    variable (ref jet-ID/plots.py:484-550, vectorized: per-event Python
    loops replaced with masked array reductions)."""
    plt = pyplot()
    tracks = np.asarray(tracks, np.float64)
    labels = np.asarray(labels)
    info = _TRACK_VARS[variable]
    classes = np.arange(labels.max() + 1)
    present = np.sum(np.abs(tracks), axis=2) != 0
    n_tracks = present.sum(axis=1)
    var = tracks[..., info["idx"]]
    with np.errstate(invalid="ignore"):
        var_mean = np.where(n_tracks > 0,
                            np.sum(var * present, 1) / np.maximum(n_tracks, 1),
                            np.nan)
        var_max = np.where(n_tracks > 0,
                           np.max(np.abs(var) * present, 1), np.nan)
        vmax = np.max(np.where(present, var, -np.inf), axis=1)
        vmin = np.min(np.where(present, var, np.inf), axis=1)
        var_diff = np.where(n_tracks >= 2,
                            (vmax - vmin) / np.maximum(n_tracks - 1, 1),
                            np.nan)
    # track-number panels
    fig, axes = plt.subplots(figsize=(14, 6), ncols=2)
    bins = np.arange(0, 17)
    for k, ax in enumerate(axes):
        for cls in classes[::-1]:
            sel = labels == cls
            norm = sel.sum() if k == 0 else len(labels)
            ax.hist(n_tracks[sel], bins=bins, histtype="step", lw=2,
                    align="left", weights=np.full(sel.sum(), 100 / norm),
                    label=f"class {cls} (mean: {n_tracks[sel].mean():3.1f})")
        ax.set_xlim(0, 15)
        ax.set_xlabel("Number of tracks", fontsize=14)
        ax.set_ylabel("Normalized entries (%)", fontsize=14)
        ax.set_title("Track number distribution"
                     + ("\n(individually normalized)" if k == 0 else ""))
        ax.legend(fontsize=11)
    out1 = f"{output_dir}/tracks_number.png"
    fig.savefig(out1, bbox_inches="tight")
    plt.close(fig)
    # per-variable metric panels
    fig, axes = plt.subplots(figsize=(18, 5), ncols=3)
    metrics = (("mean", var_mean, "Average"),
               ("max", var_max, "Maximum absolute"),
               ("diff", var_diff, "Average difference"))
    for ax, (key, vals, title) in zip(axes, metrics):
        x1, x2 = info[f"{key}_lim"]
        bins = np.linspace(0.9 * x1, 1.1 * x2, 101)
        total = np.isfinite(vals).sum()
        for cls in classes[::-1]:
            data = vals[(labels == cls) & np.isfinite(vals)]
            ax.hist(data, bins=bins, histtype="step", lw=2,
                    weights=np.full(len(data), 100 / max(total, 1)),
                    label=f"class {cls}")
        ax.set_xlim(x1, x2)
        ax.set_title(f"{title} value of {variable}'s", fontsize=14)
        ax.set_xlabel(f"{title} value", fontsize=14)
        ax.set_ylabel("Normalized entries (%)", fontsize=14)
        ax.legend(fontsize=11)
    out2 = f"{output_dir}/tracks_{variable}.png"
    fig.savefig(out2, bbox_inches="tight")
    plt.close(fig)
    return out1, out2
