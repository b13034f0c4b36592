"""BumpHunter1D in torch on the card.

Counterpart of ``atlasvae/stats/bumphunter.py`` (the reference's
pyBumpHunter fork, arXiv:1101.0390), with the same public surface and the
same core:

* the (width x position) window scan is one array program: windowed counts
  summed directly, per-window Poisson p-values through the log-space
  incomplete gamma (``ops/gammainc.py``) evaluated **once** over the stacked
  (widths, references, histograms, bins) tensor, and a masked minimum over
  the flattened (width x bin) axis;
* ``scan_histograms`` takes a batch of references (each with its own scan
  range): the per-cut scans of ``batched_local_sigma`` and
  ``batched_bump_sigma`` are one call, not a loop over the cuts, because
  eager PyTorch launches a kernel for every operation of the p-value loops;
* p-values are carried as log p end to end, so no significance saturates.

Pseudo-experiments are Poisson draws from a ``torch.Generator`` on the
scan's device, seeded with ``seed`` (None means 0); the JAX package draws
from threefry, so the streams differ and parity is checked on injected
draws.  Every draw goes through ``_poisson_pseudo``.

Histogramming stays on the host (numpy, float64, then float32); the draws,
the scans, ``_bin_significance`` and ``sigma_from_log_pval`` run on
``device`` (default ``cuda``).  The drawing methods (``plot_bump`` with a
``filename`` or ``make_histo``, ``plot_stat``, ``plot_tomography``,
``plot_inject``) draw from host copies with ``plotting/bump.py``.
"""

import abc

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.gammainc import log_gammainc_lower, log_gammainc_upper, sigma_from_log_pval
from ..parallel.mesh import all_sum, axis_size, shard_leading
from .deprecation import deprecated, warn_legacy_arg


# --------------------------------------------------------------- core scan

def _window_sums(x, w):
    """Sum of w consecutive bins along the last axis, added left to right
    as ``jax.lax.reduce_window`` does.

    NOT a cumsum difference: differencing float32 cumulative sums cancels
    catastrophically once the histogram total exceeds 2^24 counts (inside
    the 1e7-jet production scale) and corrupts the minimum window."""
    n = x.shape[-1] - w + 1
    out = x[..., :n]
    for j in range(1, w):
        out = out + x[..., j:j + n]
    return out


def _scan(hists, ref, widths, scan_steps, hinf, hsup, mode, use_sideband, sideband_width):
    """The scan of ``scan_histograms`` on (B, K, n) histograms, (B, n)
    references and (B,) scan ranges; outputs carry the (B, K) axes, the
    per-window log p-values (W, B, K, n)."""
    b, k, nbins = hists.shape
    pos = torch.arange(nbins, device=hists.device)
    hinf, hsup = hinf[:, None], hsup[:, None]
    if use_sideband:
        vinf, vsup = hinf, hsup
        if sideband_width is not None:
            hinf = hinf + sideband_width
            hsup = hsup - sideband_width
        in_range = (pos >= vinf) & (pos < vsup)
        ref_total = torch.where(in_range, ref, 0.0).sum(-1)[:, None, None]
        hist_total = torch.where(in_range[:, None, :], hists, 0.0).sum(-1)[..., None]

    all_nh, all_nr, all_valid = [], [], []
    for w, step in zip(widths, scan_steps):
        nh = F.pad(_window_sums(hists, w), (0, w - 1))           # (B, K, n)
        nr = F.pad(_window_sums(ref, w), (0, w - 1))[:, None, :].expand_as(nh)
        valid = (pos >= hinf) & (pos + w <= hsup) & ((pos - hinf) % step == 0)
        if use_sideband:
            nr = nr * ((hist_total - nh) / torch.clamp(ref_total - nr, min=1e-12))
        all_nh.append(nh)
        all_nr.append(nr)
        all_valid.append(valid[:, None, :])

    nh, nr, valid = torch.stack(all_nh), torch.stack(all_nr), torch.stack(all_valid)
    if mode == "excess":
        window_ok = (nh > nr) & (nr > 0)
        logp = log_gammainc_lower(nh, torch.clamp(nr, min=1e-30))
    else:  # deficit
        window_ok = nh < nr
        logp = log_gammainc_upper(nh + 1.0, torch.clamp(nr, min=1e-30))
    log_pvals = torch.where(window_ok & valid, logp, 0.0)       # (W, B, K, n)

    def flat(t):   # (W, B, K, n) -> (B, K, W*n)
        return t.permute(1, 2, 0, 3).reshape(b, k, -1)

    # the first minimum, as jnp.argmin (torch documents the same)
    arg = torch.argmin(flat(log_pvals), dim=-1, keepdim=True)
    min_log_pval = flat(log_pvals).gather(-1, arg)[..., 0]
    min_loc = (arg % nbins)[..., 0]
    min_width = torch.as_tensor(widths, device=hists.device)[(arg // nbins)[..., 0]]
    signal_eval = (flat(nh).gather(-1, arg) - flat(nr).gather(-1, arg))[..., 0]
    # no qualifying window anywhere (all log p masked to 0): report 0
    # evaluated signal, like the reference's dummy-window branch
    signal_eval = torch.where(min_log_pval >= 0.0, 0.0, signal_eval)
    return min_log_pval, min_loc, min_width, signal_eval, log_pvals


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def scan_histograms(hists, ref, widths, scan_steps, hinf, hsup, mode="excess",
                    use_sideband=False, sideband_width=None, device="cuda"):
    """Scan K histograms against a reference in one program.

    Args:
      hists: (K, nbins) data + pseudo-data histograms, or (B, K, nbins)
        against a batch of references.
      ref: (nbins,) background histogram, or (B, nbins).
      widths: tuple of window widths (bins).
      scan_steps: tuple of per-width position strides.
      hinf, hsup: scan range [hinf, hsup), scalars or (B,).
    Returns (tensors on ``device``):
      min_log_pval: (K,) log of the min window p-value per histogram.
      min_loc: (K,) window start bin.
      min_width: (K,) window width (bins).
      signal_eval: (K,) data-minus-reference in the min window.
      log_pvals: (n_widths, K, nbins) per-window log p-values (masked
        windows = 0).
    With a batch of references each output gains the B axis after the
    widths' axis: (B, K) and (n_widths, B, K, nbins).
    """
    device = resolve_device(device)
    hists, ref = _f32(hists, device), _f32(ref, device)
    batched = ref.ndim == 2
    if not batched:
        hists, ref = hists[None], ref[None]
    hinf = torch.as_tensor(hinf, device=device).reshape(-1).expand(ref.shape[0])
    hsup = torch.as_tensor(hsup, device=device).reshape(-1).expand(ref.shape[0])
    out = _scan(hists, ref, tuple(widths), tuple(scan_steps), hinf, hsup, mode,
                use_sideband, sideband_width)
    if batched:
        return out
    *per_hist, log_pvals = out
    return (*(t[0] for t in per_hist), log_pvals[:, 0])


def _poisson_pseudo(generator, rate, npe):
    """``npe`` Poisson draws of every bin of ``rate``: a float32 tensor of
    shape (npe,) + rate.shape on rate's device.  Every pseudo-experiment of
    this module is drawn here, so tests can inject one draw on both
    sides."""
    return torch.poisson(rate.expand((npe,) + tuple(rate.shape)).contiguous(),
                         generator=generator)


def _bin_significance(data_hist, ref_hist):
    """Per-bin signed significance (ref plot_bump :1772-1794)."""
    excess = (data_hist > ref_hist) & (ref_hist > 0)
    deficit = data_hist < ref_hist
    logp_e = log_gammainc_lower(data_hist, torch.clamp(ref_hist, min=1e-30))
    logp_d = log_gammainc_upper(data_hist + 1.0, torch.clamp(ref_hist, min=1e-30))
    logp = torch.where(excess, logp_e, torch.where(deficit, logp_d, 0.0))
    sig = sigma_from_log_pval(logp)
    sig = torch.where(excess | deficit, sig, 0.0)
    sig = torch.clamp(sig, min=0.0)                        # ref :1792
    sig = torch.where(torch.isfinite(sig), sig, 0.0)       # ref :1793
    return torch.where(deficit, -sig, sig)                 # ref :1794


def _scan_ranges(ref):
    """Per row of (B, n) references: [first, last + 1) of the non-empty
    bins; an empty row gives the empty range [n, 0)."""
    nbins = ref.shape[-1]
    idx = torch.arange(nbins, device=ref.device)
    non0 = ref > 0
    hinf = torch.where(non0, idx, nbins).amin(-1)
    hsup = torch.where(non0, idx, -1).amax(-1) + 1
    return hinf, hsup


# ------------------------------------------------------------------ class

class BumpHunter1D:
    """Drop-in equivalent of the reference BumpHunter1D
    (ref bumphunter_1dim.py:19-317 constructor surface); ``device`` is
    where the draws and scans run."""

    def __init__(self, rang=None, mode="excess", width_min=1, width_max=None,
                 width_step=1, scan_step=1, npe=100, bins=60, weights=None,
                 nworker=4, sigma_limit=5, str_min=0.5, str_step=0.25,
                 str_scale="lin", signal_exp=None, flip_sig=True,
                 npe_inject=100, seed=None, use_sideband=False,
                 sideband_width=None, Nworker=None, useSideBand=None,
                 Npe=None, device="cuda"):
        # Legacy kwarg spellings, remapped with a FutureWarning
        # (ref :149-151 decorators + :290-295 inline remap).
        if useSideBand is not None:
            warn_legacy_arg("BumpHunter1D", "useSideBand", "use_sideband")
            use_sideband = useSideBand
        if Nworker is not None:
            warn_legacy_arg("BumpHunter1D", "Nworker", "nworker")
            nworker = Nworker
        if Npe is not None:
            warn_legacy_arg("BumpHunter1D", "Npe", "npe")
            npe = Npe
        self.device = resolve_device(device)
        self.rang = rang
        self.mode = mode
        self.width_min = width_min
        self.width_max = width_max
        self.width_step = width_step
        self.scan_step = scan_step
        self.npe = npe
        self.bins = bins
        self.weights = weights
        self.nworker = nworker  # kept for API parity; scans are vectorized
        self.sigma_limit = sigma_limit
        self.str_min = str_min
        self.str_step = str_step
        self.str_scale = str_scale
        self.signal_exp = signal_exp
        self.flip_sig = flip_sig
        self.npe_inject = npe_inject
        self.seed = seed
        self.use_sideband = use_sideband
        self.sideband_width = sideband_width
        self.reset()

    # ------------------------------------------------------------- utils

    def reset(self):
        """Clear result state (ref :704-727)."""
        self.global_Pval = 0
        self.significance = 0
        self.res_ar = []
        self.min_Pval_ar = []
        self.log_Pval_ar = []
        self.min_loc_ar = []
        self.min_width_ar = []
        self.t_ar = []
        self.signal_eval = 0
        self.norm_scale = None
        self.signal_min = 0
        self.signal_ratio = None
        self.data_inject = []
        self.sigma_ar = []
        self.str_ar = []

    def save_state(self):
        """Snapshot every knob + result into a dict (ref :729-779).

        The flip_sig setting is stored under the reference's dict key
        'sig_flip' (ref :757) so state dicts interchange both ways, with the
        JAX package's too; the device is not part of the state."""
        keys = ["mode", "rang", "bins", "weights", "width_min", "width_max",
                "width_step", "scan_step", "npe", "nworker", "seed",
                "sigma_limit", "str_min", "str_step", "str_scale",
                "signal_exp", "npe_inject", "use_sideband",
                "global_Pval", "significance", "res_ar", "min_Pval_ar",
                "log_Pval_ar", "min_loc_ar", "min_width_ar", "t_ar",
                "signal_eval", "norm_scale", "signal_min", "signal_ratio",
                "data_inject"]
        state = {k: getattr(self, k) for k in keys}
        state["sig_flip"] = self.flip_sig
        return state

    def load_state(self, state):
        """Restore from a save_state dict (ref :781-919).

        Accepts the reference's 'sig_flip' key AND restores it into the
        live ``flip_sig`` attribute — the reference loads it into a dead
        ``self.sig_flip`` (ref :875-878) while signal_inject reads
        ``self.flip_sig``, losing the setting; a bug not replicated.  The
        hunter keeps its own device."""
        state = {k: v for k, v in state.items() if k != "device"}
        for k, v in BumpHunter1D(device=self.device).__dict__.items():
            setattr(self, k, state.get(k, v))
        for k, v in state.items():
            if k != "sig_flip":
                setattr(self, k, v)
        if "sig_flip" in state:
            self.flip_sig = state["sig_flip"]
        elif "flip_sig" in state:  # dicts written by older snapshots
            self.flip_sig = state["flip_sig"]

    # --------------------------------------------------------- internals

    def _widths(self, nbins):
        wmax = self.width_max if self.width_max is not None else nbins // 2
        self.width_max = wmax
        widths = tuple(range(self.width_min, wmax + 1, self.width_step))
        if self.scan_step == "full":
            steps = widths
        elif self.scan_step == "half":
            steps = tuple(max(1, w // 2) for w in widths)
        else:
            steps = tuple(int(self.scan_step) for _ in widths)
        return widths, steps

    def _histogram(self, data, bkg, is_hist):
        if not is_hist:
            bkg_hist, bins = np.histogram(bkg, bins=self.bins,
                                          weights=self.weights, range=self.rang)
            data_hist = np.histogram(data, bins=bins, range=self.rang)[0]
            self.bins = bins
        else:
            bkg_hist = np.asarray(bkg, dtype=np.float64)
            if self.weights is not None:
                bkg_hist = bkg_hist * self.weights
            data_hist = np.asarray(data, dtype=np.float64)
        return data_hist.astype(np.float32), bkg_hist.astype(np.float32)

    def _scan_range(self, ref):
        non0 = np.nonzero(ref > 0)[0]
        if len(non0) == 0:
            return 0, len(ref)
        return int(non0.min()), int(non0.max()) + 1

    def _generator(self):
        return torch.Generator(self.device).manual_seed(0 if self.seed is None else self.seed)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _sigma(self, log_p):
        """sigma_from_log_pval of a host number, on the hunter's device."""
        return float(sigma_from_log_pval(torch.tensor(np.float32(log_p), device=self.device)))

    def _scan(self, hists, bkg_hist, widths, steps, hinf, hsup):
        out = scan_histograms(hists, bkg_hist, widths, steps, hinf, hsup, self.mode,
                              self.use_sideband, self.sideband_width, self.device)
        return [t.cpu().numpy() for t in out]

    def _global(self):
        """Global p-value and significance from t_ar (ref :1194-1219 #DG:
        the lower limit -ndtri(1/npe) when no pseudo t reaches the data's)."""
        tdat = self.t_ar[0]
        s = int(np.sum(self.t_ar[1:] >= tdat))
        self.global_Pval = s / self.npe
        if self.global_Pval == 1:
            self.significance = 0
        elif self.global_Pval == 0:
            self.significance = self._sigma(np.log(1.0 / self.npe))
        else:
            self.significance = self._sigma(np.log(self.global_Pval))
        return s

    # ------------------------------------------------------------ public

    def bump_scan(self, data, bkg, is_hist=False, do_pseudo=True,
                  multi_chan=False, verbose=True):
        """Full BumpHunter scan: data + npe pseudo-experiments, global
        p-value and significance (ref :922-1226).  ``multi_chan=True``
        takes per-channel lists and combines channels per ref
        ``_scan_hist_multi`` (:478-700)."""
        if multi_chan:
            return self._bump_scan_multi(data, bkg, is_hist, do_pseudo, verbose)
        data_hist, bkg_hist = self._histogram(data, bkg, is_hist)
        widths, steps = self._widths(len(data_hist))
        hinf, hsup = self._scan_range(bkg_hist)
        # padded to a multiple of 32 bins, as the JAX package pads them for
        # one compile: the same shapes here; widths and [hinf, hsup) come
        # from the true bin count, so the padded zero bins never scan
        nbins_true = len(data_hist)
        tail = (-nbins_true) % 32
        if tail:
            data_hist = np.pad(data_hist, (0, tail)).astype(np.float32)
            bkg_hist = np.pad(bkg_hist, (0, tail)).astype(np.float32)
        if verbose:
            print(f"{len(widths)} values of width will be tested")
            print("SCAN")

        hists = self._tensor(data_hist)[None, :]
        ref = self._tensor(bkg_hist)
        if do_pseudo:
            hists = torch.cat([hists, _poisson_pseudo(self._generator(), ref, self.npe)])
        min_logp, min_loc, min_width, signal_eval, log_pvals = self._scan(
            hists, ref, widths, steps, hinf, hsup)

        if not do_pseudo and np.size(self.log_Pval_ar) > 1:
            # Reuse the cached pseudo-experiment distribution from the
            # previous scan: only slot 0 (the data) is replaced
            # (ref :1086-1096 keeps min_Pval_ar when do_pseudo=False).
            min_logp = np.concatenate([min_logp, self.log_Pval_ar[1:]])
            min_loc = np.concatenate([min_loc, self.min_loc_ar[1:]])
            min_width = np.concatenate([min_width, self.min_width_ar[1:]])

        self.log_Pval_ar = min_logp
        with np.errstate(under="ignore"):
            self.min_Pval_ar = np.exp(min_logp.astype(np.float64))
        self.min_loc_ar = min_loc.astype(int)
        self.min_width_ar = min_width.astype(int)
        self.signal_eval = float(signal_eval[0])
        self.res_ar = [np.exp(log_pvals[w, 0, :nbins_true].astype(np.float64))
                       for w in range(len(widths))]
        self.t_ar = -min_logp.astype(np.float64)  # t = -ln(min p), ref :1194

        if self.use_sideband:
            # best-window sideband scale of the data scan, for plot_bump
            # (ref :419,453-454,475 stores min_scale as norm_scale)
            loc, w = int(min_loc[0]), int(min_width[0])
            nh = float(np.sum(data_hist[loc:loc + w]))
            nr = float(np.sum(bkg_hist[loc:loc + w]))
            hist_total = float(np.sum(data_hist[hinf:hsup]))
            ref_total = float(np.sum(bkg_hist[hinf:hsup]))
            self.norm_scale = (hist_total - nh) / max(ref_total - nr, 1e-12)

        if len(self.t_ar) > 1:
            s = self._global()
            if verbose:
                print(f"Global p-value : {self.global_Pval:1.4f}  ({s} / {self.npe})")
                if self.global_Pval == 0:
                    print(f"Significance > {self.significance:1.5f} (lower limit)")
                elif self.global_Pval != 1:
                    print(f"Significance = {self.significance:1.5f}")
        elif verbose:
            print("No pseudo data found : can't compute global p-value")

    def _bump_scan_multi(self, data, bkg, is_hist=False, do_pseudo=True,
                         verbose=True):
        """Multi-channel scan (ref ``_scan_hist_multi`` :478-700): each
        channel is scanned independently; channels combine only when the
        per-channel best windows *overlap* in physical coordinates, and
        the combined statistic is t = -ln(prod of per-channel min p)
        (ref :696).  No-overlap scans get p = 1 (ref :649-656).

        The intended interval intersection is implemented for both edges,
        not the reference's clipping (which pins the left edge to bin 1 and
        rounds the right edge outward, ref :667-672), as in the JAX package.
        The channels' pseudo-data come one after the other from one
        generator.
        """
        n_chan = len(data)
        bins_in = self.bins if isinstance(self.bins, list) else \
            [self.bins for _ in range(n_chan)]
        per_chan = []
        generator = self._generator()
        for ch in range(n_chan):
            saved_bins, self.bins = self.bins, bins_in[ch]
            data_hist, bkg_hist = self._histogram(data[ch], bkg[ch], is_hist)
            bins_in[ch] = self.bins
            self.bins = saved_bins
            widths, steps = self._widths(len(data_hist))
            hinf, hsup = self._scan_range(bkg_hist)
            hists = self._tensor(data_hist)[None, :]
            ref = self._tensor(bkg_hist)
            if do_pseudo:
                hists = torch.cat([hists, _poisson_pseudo(generator, ref, self.npe)])
            per_chan.append(self._scan(hists, ref, widths, steps, hinf, hsup)[:4])
        self.bins = bins_in

        k = len(per_chan[0][0])
        logp = np.stack([c[0] for c in per_chan])         # (C, K)
        locs = np.stack([c[1] for c in per_chan]).astype(int)
        widths_arr = np.stack([c[2] for c in per_chan]).astype(int)
        # physical window edges per channel/scan
        lo = np.stack([np.asarray(bins_in[ch])[locs[ch]] for ch in range(n_chan)])
        hi = np.stack([np.asarray(bins_in[ch])[locs[ch] + widths_arr[ch]]
                       for ch in range(n_chan)])
        inter_lo = np.max(lo, axis=0)
        inter_hi = np.min(hi, axis=0)
        overlap = inter_lo < inter_hi
        combined_logp = np.where(overlap, logp.sum(axis=0), 0.0)

        self.log_Pval_ar = combined_logp
        with np.errstate(under="ignore"):
            self.min_Pval_ar = np.exp(logp.astype(np.float64)).T  # (K, C)
        self.min_loc_ar = locs.T
        self.min_width_ar = widths_arr.T
        self.signal_eval = np.array([per_chan[ch][3][0] for ch in range(n_chan)])
        self.t_ar = -combined_logp.astype(np.float64)
        if k > 1:
            self._global()
            if verbose:
                print(f"Global p-value : {self.global_Pval:1.4f}  "
                      f"significance = {self.significance:1.5f}")
        return (inter_lo[0], inter_hi[0]) if overlap[0] else None

    def bump_info(self, data, is_hist=False, verbose=True):
        """Result summary; returns the *local* significance
        -ndtri(min p of data), unbounded (ref :2018-2127 #DG return).
        Multi-channel state reports the combined overlap window
        (ref :2055-2060)."""
        if np.ndim(self.min_loc_ar) == 2:  # multi-channel scan state
            bins_list = self.bins
            locs = self.min_loc_ar[0]
            widths = self.min_width_ar[0]
            bmin = max(np.asarray(bins_list[ch])[locs[ch]] for ch in range(len(locs)))
            bmax = min(np.asarray(bins_list[ch])[locs[ch] + widths[ch]]
                       for ch in range(len(locs)))
        else:
            bins = self.bins if is_hist or not np.isscalar(self.bins) else \
                np.histogram_bin_edges(data, bins=self.bins, range=self.rang)
            if np.isscalar(bins):  # is_hist scan with no edges: bin coords
                bins = np.arange(int(bins) + 1)
            bmin = bins[self.min_loc_ar[0]]
            bmax = bins[self.min_loc_ar[0] + self.min_width_ar[0]]
        loc_sigma = self._sigma(self.log_Pval_ar[0])
        if verbose:
            sig_ev = float(np.sum(self.signal_eval))
            min_p = float(np.prod(np.atleast_1d(self.min_Pval_ar[0])))
            print(f"\nBump edges : [{bmin:.3g}, {bmax:.3g}]"
                  f"  (loc={self.min_loc_ar[0]}, width={self.min_width_ar[0]})")
            print(f"Bump mean | width : {(bmax + bmin) / 2:.3g} | {bmax - bmin:.3g}")
            print(f"Evaluated number of signal events : {sig_ev:.3g}")
            print(f"Local p-value | test statistic : {min_p:.5g}"
                  f" | {self.t_ar[0]:.5g}")
            print(f"Local significance : {loc_sigma:.5g}")
            print(f"Global p-value : {self.global_Pval:.5g}")
            if self.global_Pval == 0:
                print(f"Global significance : >{self.significance:.3g}  (lower limit)")
            else:
                print(f"Global significance : {self.significance:.3g}")
        return loc_sigma

    def plot_bump(self, data, bkg, is_hist=False, use_sideband=None, label="",
                  filename=None, make_histo=False, useSideBand=None):
        """Per-bin signed significances + optional bump plot; returns
        (bin_sigma, (Bmin, Bmax)) (ref :1646-1860)."""
        if useSideBand is not None:  # ref :1645 + :1696-1697
            warn_legacy_arg("plot_bump", "useSideBand", "use_sideband")
            use_sideband = useSideBand
        data_hist, bkg_hist = self._histogram(data, bkg, is_hist)
        bins = self.bins
        bmin = bins[self.min_loc_ar[0]]
        bmax = bins[self.min_loc_ar[0] + self.min_width_ar[0]]
        if use_sideband is None:
            use_sideband = self.use_sideband
        if use_sideband and self.norm_scale is not None:
            bkg_hist = bkg_hist * self.norm_scale
        sig = _bin_significance(self._tensor(data_hist), self._tensor(bkg_hist)).cpu().numpy()
        if make_histo or filename is not None:
            from ..plotting.bump import plot_bump_histogram
            plot_bump_histogram(data_hist, bkg_hist, bins, sig, (bmin, bmax), self.rang, label,
                                filename)
        return sig, (bmin, bmax)

    def plot_stat(self, show_Pval=False, filename=None):
        """BumpHunter test-statistic distribution plot (ref :1867-1918)."""
        from ..plotting.bump import plot_stat_distribution
        plot_stat_distribution(self.t_ar, self.global_Pval, show_Pval, filename)

    def plot_tomography(self, data, is_hist=False, filename=None):
        """p-value vs window position per width (ref :1513-1644)."""
        from ..plotting.bump import plot_tomography as _plot
        widths, _ = self._widths(len(self.res_ar[0]) if self.res_ar else 1)
        _plot(self.bins, self.res_ar, widths, filename)

    def signal_inject(self, sig, bkg, is_hist=False, verbose=True):
        """Signal-injection sensitivity scan: raise the injected strength
        until the median significance reaches sigma_limit
        (ref :1233-1506).  The background draw and every strength step's
        draw come one after the other from one generator."""
        if not is_hist:
            bkg_hist, bins = np.histogram(bkg, bins=self.bins,
                                          weights=self.weights, range=self.rang)
            sig_base = np.histogram(sig, bins=bins, range=self.rang)[0]
            self.bins = bins
            if self.signal_exp is None:
                self.signal_exp = len(np.asarray(sig))
            sig_scale = self.signal_exp / max(len(np.asarray(sig)), 1)
        else:
            bkg_hist = np.asarray(bkg, dtype=np.float64)
            if self.weights is not None:
                bkg_hist = bkg_hist * self.weights
            sig_base = np.asarray(sig, dtype=np.float64)
            if self.signal_exp is None:
                self.signal_exp = float(sig_base.sum())
            sig_scale = self.signal_exp / max(float(sig_base.sum()), 1e-12)
        bkg_hist = bkg_hist.astype(np.float32)
        widths, steps = self._widths(len(bkg_hist))
        hinf, hsup = self._scan_range(bkg_hist)
        generator = self._generator()
        ref = self._tensor(bkg_hist)

        # Background-only t distribution.
        bkg_logp, bkg_loc, bkg_width = self._scan(
            _poisson_pseudo(generator, ref, self.npe), ref, widths, steps, hinf, hsup)[:3]
        t_bkg = -bkg_logp

        self.sigma_ar = []
        self.str_ar = []
        self.global_Pval, self.significance = 1.0, 0.0
        strength, i = 0.0, 1
        data_hist = bkg_hist
        t_inj = np.zeros(0)
        while (self.significance < self.sigma_limit
               and self.global_Pval > 1 / self.npe):
            if self.str_scale == "lin":
                strength = self.str_min if i == 1 else strength + self.str_step
            elif self.str_scale == "log":
                if i == 1:
                    strength = 10 ** self.str_min
                    self.str_step = strength
                else:
                    strength += self.str_step
                    if abs(strength - 10 * self.str_step) < 1e-6:
                        self.str_step *= 10
            else:
                print("ERROR : Bad str_scale value ! Must be either 'lin' or 'log'")
                return
            if verbose:
                print(f"   STEP {i} : signal strength = {strength}")
            self.signal_min = self.signal_exp * strength
            if self.mode == "deficit":
                self.signal_min = -self.signal_min
            sig_hist = sig_base * strength * sig_scale
            if self.mode == "deficit" and self.flip_sig:
                sig_hist = -sig_hist
            data_hist = (bkg_hist + sig_hist).astype(np.float32)
            pseudo_data = _poisson_pseudo(generator, self._tensor(np.maximum(data_hist, 0)),
                                          self.npe_inject)
            inj_logp, inj_loc, inj_width = self._scan(pseudo_data, ref, widths, steps,
                                                      hinf, hsup)[:3]
            t_inj = -inj_logp
            tdat, tinf, tsup = (np.median(t_inj), np.quantile(t_inj, 0.16),
                                np.quantile(t_inj, 0.84))
            qs = [np.sum(t_bkg > t) / self.npe for t in (tdat, tinf, tsup)]
            self.global_Pval = qs[0]
            sigmas = [self._sigma(np.log(max(q, 1.0 / self.npe))) for q in qs]
            self.significance = sigmas[0]
            self.sigma_ar.append([sigmas[0], abs(sigmas[0] - sigmas[1]),
                                  abs(sigmas[0] - sigmas[2])])
            self.str_ar.append(strength)
            if verbose:
                print(f"Global p-value : {self.global_Pval:1.4f}   "
                      f"significance = {self.significance:1.5f}")
            i += 1
        if verbose:
            if self.significance > self.sigma_limit:
                print("REACHED SIGMA LIMIT")
            elif self.global_Pval <= 1 / self.npe:
                print(f"REACHED STAT LIMIT AT {self.significance:.3f} SIGMA")
        self.signal_ratio = abs(self.signal_min / self.signal_exp)
        self.data_inject = data_hist
        # background results + the last injection's results, like the
        # reference's append at :1495-1500 — plot_bump/bump_info after
        # signal_inject read these arrays
        self.t_ar = np.append(t_bkg, t_inj)
        if len(t_inj):
            self.min_Pval_ar = np.exp(np.append(bkg_logp, inj_logp).astype(np.float64))
            self.min_loc_ar = np.append(bkg_loc, inj_loc).astype(int)
            self.min_width_ar = np.append(bkg_width, inj_width).astype(int)
        else:  # loop never ran (sigma_limit <= 0): background scans only
            self.min_Pval_ar = np.exp(bkg_logp.astype(np.float64))
            self.min_loc_ar = bkg_loc.astype(int)
            self.min_width_ar = bkg_width.astype(int)
        self.sigma_ar = np.array(self.sigma_ar)
        self.str_ar = np.array(self.str_ar)

    def plot_inject(self, filename=None):
        """Significance vs injected signal strength after signal_inject,
        with the 16/84-quantile band as asymmetric error bars and upper
        limits where the band saturates (ref :1921-2014).  For
        str_scale='log' a second log-x panel is saved alongside
        (filename may be a (linear, log) pair as in the reference)."""
        from ..plotting.backend import pyplot
        plt = pyplot()
        sigma = np.asarray(self.sigma_ar)
        strengths = np.asarray(self.str_ar)[:len(sigma)]
        is_sat = sigma[:, 2] == 0

        def draw(log_x, fname):
            fig = plt.figure(figsize=(12, 8))
            plt.title("Significance vs signal strength", size="xx-large")
            plt.errorbar(strengths, sigma[:, 0], yerr=[sigma[:, 1], sigma[:, 2]], marker="o",
                         linewidth=2, uplims=is_sat)
            if log_x:
                plt.xscale("log")
            plt.xlabel("Signal strength", size="xx-large")
            plt.ylabel("Significance", size="xx-large")
            if fname is None:
                plt.show()
            else:
                plt.savefig(fname, bbox_inches="tight")
                plt.close(fig)

        if self.str_scale == "log":
            lin_name, log_name = (filename if isinstance(filename, (tuple, list))
                                  else (filename, None))
            draw(False, lin_name)
            if log_name is not None or filename is None:
                draw(True, log_name)
        else:
            draw(False, filename)

    # -------------------------------------------- legacy API (deprecated)
    # The reference keeps its pre-rename pyBumpHunter surface alive via
    # warn-once FutureWarning shims (ref :724-727, :777-780, :914-917,
    # :1228-1231, :1506-1509, :1640-1643, :1862-1865, :1916-1919,
    # :2013-2016, :2130-2257).

    @deprecated("Use `reset` instead.")
    def Reset(self, *args, **kwargs):
        return self.reset(*args, **kwargs)

    @deprecated("Use `save_state` instead.")
    def SaveState(self, *args, **kwargs):
        return self.save_state(*args, **kwargs)

    @deprecated("Use `load_state` instead.")
    def LoadState(self, *args, **kwargs):
        return self.load_state(*args, **kwargs)

    @deprecated("Use `bump_scan` instead.")
    def BumpScan(self, *args, **kwargs):
        return self.bump_scan(*args, **kwargs)

    @deprecated("Use `signal_inject` instead.")
    def SignalInject(self, *args, **kwargs):
        return self.signal_inject(*args, **kwargs)

    @deprecated("Use `plot_tomography` instead.")
    def GetTomography(self, *args, **kwargs):
        return self.plot_tomography(*args, **kwargs)

    @deprecated("Use `plot_bump` instead.")
    def PlotBump(self, *args, **kwargs):
        return self.plot_bump(*args, **kwargs)

    @deprecated("Use `plot_stat` instead.")
    def PlotBHstat(self, *args, **kwargs):
        return self.plot_stat(*args, **kwargs)

    @deprecated("Use `plot_inject` instead.")
    def PlotInject(self, *args, **kwargs):
        return self.plot_inject(*args, **kwargs)

    @deprecated("Use `bump_info` instead.")
    def print_bump_info(self):
        """Local bump info in bin coordinates (ref :2130-2167); the
        significance comes from the log-p state, so p underflow never
        saturates it."""
        print("BUMP WINDOW")
        print(f"   loc = {self.min_loc_ar[0]}")
        print(f"   width = {self.min_width_ar[0]}")
        min_p = self.min_Pval_ar[0]
        if np.ndim(min_p) == 0:
            print(f"   local p-value = {float(min_p):.5g}")
            print(f"   -ln(loc p-value) = {float(self.t_ar[0]):.5f}")
            sigma = self._sigma(self.log_Pval_ar[0])
        else:
            per_ch = "  ".join(f"{float(p):.5g}" for p in min_p)
            print(f"   local p-value (per channel) = [ {per_ch}  ]")
            print(f"   local p-value (combined) = {float(np.prod(min_p)):.5g}")
            print(f"   -ln(loc p-value) (combined) = {float(self.t_ar[0]):.5f}")
            sigma = self._sigma(np.sum(self.log_Pval_ar[0]))
        print(f"   local significance = {sigma:.5f}")
        print("")

    @deprecated("Use `print_bump_info` instead.")
    def PrintBumpInfo(self, *args, **kwargs):
        return self.print_bump_info(*args, **kwargs)

    @deprecated("Use `bump_info` instead.")
    def print_bump_true(self, data, bkg, is_hist=False):
        """Global bump info in real (axis) scale (ref :2174-2251):
        delegates to bump_info."""
        return self.bump_info(data, is_hist=is_hist, verbose=True)

    @deprecated("Use `print_bump_true` instead.")
    def PrintBumpTrue(self, *args, **kwargs):
        return self.print_bump_true(*args, **kwargs)


class BumpHunterInterface(metaclass=abc.ABCMeta):
    """Abstract base for BumpHunter-style scanners (ref :2260-2353); user
    code subclasses it to plug custom scanners into scripts typed against
    the reference."""

    @abc.abstractmethod
    def reset(self):
        """Reset all inner result state."""

    @abc.abstractmethod
    def save_state(self):
        """Return a dict snapshot of all parameters and results."""

    @abc.abstractmethod
    def load_state(self, state):
        """Restore parameters/results from a save_state dict."""

    @abc.abstractmethod
    def bump_scan(self, data, bkg, is_hist, do_pseudo):
        """Run the BumpHunter algorithm (arXiv:1101.0390)."""

    @abc.abstractmethod
    def signal_inject(self, sig, bkg, is_hist):
        """Signal-injection sensitivity scan."""


# BumpHunter1D satisfies the interface structurally; register it so
# isinstance checks written against the ABC accept it.
BumpHunterInterface.register(BumpHunter1D)


# --------------------------------------------------- batched cut scanning

def batched_local_sigma(data_hists, bkg_hists, widths, scan_steps, mode="excess",
                        device="cuda"):
    """Local (data-only) BumpHunter significances for many paired (data,
    background) histograms, (B, nbins) each, in one scan against the batch
    of references, each with its own scan range; no pseudo-experiments
    (the reference's per-cut grids plot only the local sigma,
    ref OE-AAE/plots.py:283-285,330-332).

    Returns (loc_sigma, min_loc, min_width, bin_sigma) tensors on
    ``device``."""
    device = resolve_device(device)
    data, bkg = _f32(data_hists, device), _f32(bkg_hists, device)
    hinf, hsup = _scan_ranges(bkg)
    min_logp, min_loc, min_width, _, _ = _scan(data[:, None, :], bkg, tuple(widths),
                                               tuple(scan_steps), hinf, hsup, mode,
                                               False, None)
    return (sigma_from_log_pval(min_logp[:, 0]), min_loc[:, 0], min_width[:, 0],
            _bin_significance(data, bkg))


def _global_sigmas(min_logp, npe, mesh=None, axis="data"):
    """(local sigma, global sigma, t_data) from (..., 1 + npe) min log p;
    with ``mesh``, the pseudo-experiments are this rank's share and the
    exceedance count is summed over the ``axis`` ranks as an integer."""
    t = -min_logp
    s = (t[..., 1:] >= t[..., :1]).sum(-1)
    if mesh is not None:
        all_sum(mesh, s, axis)
    global_logp = torch.log(torch.clamp(s.to(torch.float32), min=1.0) / npe)
    return sigma_from_log_pval(min_logp[..., 0]), sigma_from_log_pval(global_logp), t[..., 0]


def bump_sigma_sharded(data_hist, bkg_hist, widths, scan_steps, npe=1000,
                       mode="excess", seed=0, mesh=None, axis="data", device="cuda"):
    """Global BumpHunter scan of one (data, background) pair with npe
    pseudo-experiments.  With ``mesh``, every rank draws the whole (npe,
    nbins) pseudo-data from the seeded generator and scans its share of
    them beside the data; the exceedance count, an integer, is the only
    collective, so the result equals the single-device scan exactly.  npe
    must be a multiple of the ``axis`` ranks.

    Returns (local_sigma, global_sigma, t_data) scalars as tensors."""
    device = resolve_device(device)
    npe = int(npe)
    if mesh is not None and npe % axis_size(mesh, axis):
        raise ValueError(f"npe={npe} must be a multiple of the '{axis}' mesh axis size "
                         f"{axis_size(mesh, axis)}")
    data, bkg = _f32(data_hist, device), _f32(bkg_hist, device)
    pseudo = _poisson_pseudo(torch.Generator(device).manual_seed(seed), bkg, npe)
    if mesh is not None:
        pseudo = shard_leading(mesh, pseudo, axis)
    hists = torch.cat([data[None, :], pseudo])
    hinf, hsup = _scan_ranges(bkg[None])
    min_logp = _scan(hists[None], bkg[None], tuple(widths), tuple(scan_steps), hinf, hsup,
                     mode, False, None)[0][0]
    return _global_sigmas(min_logp, npe, mesh, axis)


def batched_bump_sigma(data_hists, bkg_hists, widths, scan_steps, npe=1000,
                       mode="excess", seed=0, device="cuda"):
    """Independent BumpHunter scans for many (data, bkg) histogram pairs
    in one scan (the reference fans this out as one OS process per
    threshold cut, ref OE-VAE/plots.py:289-290); every cut's pseudo-data
    are drawn from one generator.

    Returns (local_sigma, global_sigma, t_data) tensors of shape (n_cuts,)."""
    device = resolve_device(device)
    npe = int(npe)
    data, bkg = _f32(data_hists, device), _f32(bkg_hists, device)
    pseudo = _poisson_pseudo(torch.Generator(device).manual_seed(seed), bkg, npe)
    hists = torch.cat([data[:, None, :], pseudo.transpose(0, 1)], dim=1)
    hinf, hsup = _scan_ranges(bkg)
    min_logp = _scan(hists, bkg, tuple(widths), tuple(scan_steps), hinf, hsup, mode,
                     False, None)[0]
    return _global_sigmas(min_logp, npe)
