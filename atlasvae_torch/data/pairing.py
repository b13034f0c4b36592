"""Outlier-exposure pairing on Morton codes.

Counterpart of ``atlasvae/data/pairing.py``: (m, pt) are quantized onto a
2^13 x 2^13 grid of 10 GeV cells and every jet gets a Morton (Z-order) code
(pt bits in the even positions, m bits in the odd ones).  The OoD sample is
sorted by code once, so every coarser cell -- the code with its low
2*level bits dropped -- is a contiguous range of it, and "widen the
window until it holds a jet" becomes: the finest level whose range is
non-empty, found for every level at once by two batched
``torch.searchsorted`` calls, then a uniform draw inside that range.

The codes equal the JAX package's bit for bit; the draws come from a
``torch.Generator`` seeded with ``seed`` and differ from JAX's threefry
draws, so the two packages pick other jets of the same cell.  Pairing is
load preparation and runs on the host (CPU tensors).
"""

import time

import numpy as np
import torch

_BITS = 13            # bins per axis = 8192; covers m <= 81 TeV at 10 GeV cells
_BASE_M_WIDTH = 10.0
_BASE_PT_WIDTH = 10.0


def _part1by1(x):
    """Spread the low 16 bits of x so there is a 0 bit between each."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _morton(im, ipt):
    """pt bits in the even (first dropped) positions, m bits in the odd
    ones: coarsening one level doubles the pt window first, then m."""
    return _part1by1(ipt) | (_part1by1(im) << 1)


def _codes(m, pt, m0, pt0):
    """int64 Morton codes of float32 (m, pt) relative to (m0, pt0).  The
    divisions are true float32 divisions by 10, as the JAX package's."""
    top = (1 << _BITS) - 1
    im = torch.clamp(((m - m0) / _BASE_M_WIDTH).to(torch.int32), 0, top).to(torch.int64)
    ipt = torch.clamp(((pt - pt0) / _BASE_PT_WIDTH).to(torch.int32), 0, top).to(torch.int64)
    return _morton(im, ipt)


def cell_ranges(codes, sorted_codes):
    """[lo, hi) of the sorted OoD codes sharing each background code's
    finest non-empty cell."""
    levels = torch.arange(2 * _BITS + 1, dtype=torch.int64)[:, None]
    prefix = codes[None, :] >> levels                               # (L+1, B)
    lo = torch.searchsorted(sorted_codes, (prefix << levels).reshape(-1)).reshape(prefix.shape)
    hi = torch.searchsorted(sorted_codes, ((prefix + 1) << levels).reshape(-1)) \
        .reshape(prefix.shape)
    level = torch.argmax((hi > lo).to(torch.int8), dim=0)          # first non-empty level
    return lo.gather(0, level[None])[0], hi.gather(0, level[None])[0]


def _pair_indices(generator, codes, sorted_codes):
    lo, hi = cell_ranges(codes, sorted_codes)
    count = torch.clamp(hi - lo, min=1)
    draw = torch.randint(0, 1 << 30, codes.shape, generator=generator) % count
    return lo + draw


def ood_pairing(bkg_sample, ood_sample, seed=0, verbose=True):
    """Pair every background jet with an OoD jet of the same (m, pt) cell,
    widened until it holds one.  Returns the OoD sample re-indexed to align
    1:1 with ``bkg_sample``."""
    start = time.time()
    if verbose:
        print("Pairing OoD with QCD", end=" ", flush=True)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    m_ood, pt_ood = as_f32(ood_sample["m"]), as_f32(ood_sample["pt"])
    m_bkg, pt_bkg = as_f32(bkg_sample["m"]), as_f32(bkg_sample["pt"])
    m0 = torch.minimum(m_ood.min(), m_bkg.min())
    pt0 = torch.minimum(pt_ood.min(), pt_bkg.min())
    codes = _codes(m_ood, pt_ood, m0, pt0).numpy()
    order = np.argsort(codes, kind="stable")
    sorted_codes = torch.as_tensor(codes[order])
    generator = torch.Generator().manual_seed(seed)
    picked = []
    chunk = 2_000_000
    for i in range(0, len(m_bkg), chunk):
        codes_bkg = _codes(m_bkg[i:i + chunk], pt_bkg[i:i + chunk], m0, pt0)
        picked.append(_pair_indices(generator, codes_bkg, sorted_codes).numpy())
    indices = order[np.concatenate(picked)] if picked else np.zeros(0, np.int64)
    if verbose:
        print(f"( {time.time() - start:2.1f} s)")
    return {key: np.take(val, indices, axis=0) for key, val in ood_sample.items()}


def ood_sampling(bkg_sample, ood_sample, adjust_weights=False, seed=None):
    """Random resample of the OoD sample to the background's size."""
    rng = np.random.default_rng(seed)
    source = len(next(iter(ood_sample.values())))
    target = len(next(iter(bkg_sample.values())))
    indices = rng.choice(source, target, replace=source < target)
    out = {key: np.take(val, indices, axis=0) for key, val in ood_sample.items()}
    if adjust_weights:
        out["weights"] = out["weights"] * np.float32(source / target)
    return out
