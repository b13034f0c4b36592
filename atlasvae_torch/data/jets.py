"""Jet-constituent array functions in torch.

Counterpart of ``atlasvae/data/jets.py``.  The host-facing functions take numpy arrays (or
tensors), compute on ``device`` in chunks, and return numpy arrays, as the
JAX package's wrappers do, so the loader's sample stays a dict of numpy
arrays; ``jets_3v`` also converts a tensor where it lies, for the metric
bank.
"""

import math

import numpy as np
import torch

# Chunk length for host->device streaming of multi-10M-jet arrays.
_CHUNK = 1_000_000


def _chunked(fn, jets, device, chunk=_CHUNK):
    jets = torch.as_tensor(np.asarray(jets))
    parts = [fn(jets[i:i + chunk].to(device)).cpu().numpy()
             for i in range(0, len(jets), chunk)]
    return np.concatenate(parts, axis=0) if parts else np.asarray(jets)


def _pt(px, py):
    """sqrt(px^2 + py^2) with XLA's CPU arithmetic: px*px is fused into the
    sum as one FMA, and the square root is correctly rounded (taken in
    float64, which rounds to the same float32; torch's vectorised float32
    sqrt on the CPU is off by an ulp for about 0.6% of inputs).  Two
    constituents whose pt differ in the last bit sort the same way in both
    packages only with both."""
    pt2 = torch.addcmul(py * py, px, px)
    return torch.sqrt(pt2.to(torch.float64)).to(torch.float32)


def _sort_by_pt(jets):
    """Sort each jet's (E,px,py,pz) constituent blocks by descending pt.
    Stable, as jnp.argsort(stable=True): zero-padded constituents all have
    pt 0 and keep their order."""
    n = jets.shape[1] // 4
    jets = jets.reshape(-1, n, 4).to(torch.float32)
    pt = _pt(jets[:, :, 1], jets[:, :, 2])
    order = torch.argsort(-pt, dim=-1, stable=True)
    jets = torch.take_along_dim(jets, order[:, :, None], dim=1)
    return jets.reshape(jets.shape[0], -1)


def sort_constituents_by_pt(jets, device="cuda"):
    return _chunked(_sort_by_pt, jets, device)


def pad_constituents(jets, n_const):
    """Truncate/zero-pad the flat (E,px,py,pz) layout to 4*n_const columns."""
    jets = np.asarray(jets, dtype=np.float32)
    want = 4 * n_const
    if jets.shape[1] >= want:
        return jets[:, :want]
    pad = np.zeros((jets.shape[0], want - jets.shape[1]), dtype=np.float32)
    return np.hstack([jets, pad])


def _jets_4v(jets):
    """Summed-constituent jet kinematics, stacked as (pt_calo, m_calo).
    The mass is a cancellation (E^2 - p^2), so the arithmetic follows XLA's:
    constituents summed left to right, and E*E - px*px fused into one FMA."""
    n = jets.shape[1] // 4
    parts = jets.reshape(-1, n, 4).to(torch.float32)
    four = parts[:, 0].clone()
    for i in range(1, n):
        four += parts[:, i]
    e, px, py, pz = four[:, 0], four[:, 1], four[:, 2], four[:, 3]
    pt = torch.sqrt(px ** 2 + py ** 2)
    m2 = torch.addcmul(-(px * px), e, e) - py * py - pz * pz
    m = torch.sqrt(torch.clamp(m2, min=0.0))
    return torch.stack([pt, m], dim=1)


def jets_4v(jets, device="cuda"):
    jets = np.asarray(jets)
    if len(jets) == 0:
        return {"pt_calo": np.zeros(0, np.float32), "m_calo": np.zeros(0, np.float32)}
    pt_m = _chunked(_jets_4v, jets, device)
    return {"pt_calo": pt_m[:, 0].copy(), "m_calo": pt_m[:, 1].copy()}


def _jets_3v(jets, n_dims):
    """Per-constituent (pt, rapidity, phi) triplets from flat (px,py,pz)
    (``n_dims`` 3) or (E,px,py,pz) blocks; a constituent whose
    (E+pz)/(E-pz) is not a positive finite number (zero padding, E == pz)
    gets rapidity 0."""
    jets = jets.to(torch.float32).reshape(jets.shape[0], -1, n_dims)
    if n_dims == 3:
        px, py, pz = jets[..., 0], jets[..., 1], jets[..., 2]
        e = torch.sqrt(px ** 2 + py ** 2 + pz ** 2)
    else:
        e, px, py, pz = jets[..., 0], jets[..., 1], jets[..., 2], jets[..., 3]
    pt = torch.sqrt(px ** 2 + py ** 2)
    ratio = (e + pz) / (e - pz)
    good = (ratio > 0) & torch.isfinite(ratio)
    y = torch.where(good, torch.log(torch.where(ratio > 0, ratio, 1.0)) / 2, 0.0)
    phi = torch.atan2(py, px)
    return torch.stack([pt, y, phi], dim=-1)


def jets_3v(jets, n_dims, device="cuda"):
    """(jets, n_dims*n_const) -> (jets, n_const, 3) in (pt, y, phi).  A
    tensor is converted on its own device and stays a tensor; an array is
    converted on ``device`` in chunks and comes back as an array."""
    if isinstance(jets, torch.Tensor):
        return _jets_3v(jets, n_dims)
    return _chunked(lambda x: _jets_3v(x, n_dims), jets, device)


def _count_constituents(jets):
    """Number of constituents per jet with any non-zero component."""
    n = jets.shape[1] // 4
    mags = jets.reshape(-1, n, 4).to(torch.float32).abs().sum(dim=2)
    return (mags > 0).sum(dim=1).to(torch.int32)


def count_constituents(jets, device="cuda"):
    return _chunked(_count_constituents, jets, device)


def _cumulative_pt(jets):
    """pt of the cumulative constituent sum."""
    n = jets.shape[1] // 4
    csum = torch.cumsum(jets.reshape(-1, n, 4).to(torch.float32), dim=1)
    return torch.sqrt(csum[:, :, 1] ** 2 + csum[:, :, 2] ** 2)


def constituent_pt_cumulative(jets, device="cuda"):
    return _chunked(_cumulative_pt, jets, device)


def _image_bins(jets, n_pixels, extent, n_dims):
    """Per constituent: the flat pixel index in a (delta-eta, delta-phi) grid
    around the pt-weighted jet axis, and its pt weight (0 for padding).  pt
    and |p| follow XLA's CPU arithmetic (the squares fused into the sum as
    FMAs), as ``_pt`` does: a constituent one ulp off lands in the
    neighbouring pixel."""
    n = jets.shape[1] // n_dims
    p = jets.reshape(-1, n, n_dims).to(torch.float32)
    px, py, pz = (p[..., n_dims - 3 + i] for i in range(3))
    pt2 = torch.addcmul(py * py, px, px)
    pt = torch.sqrt(pt2)
    p_tot = torch.sqrt(torch.addcmul(pt2, pz, pz))
    ratio = torch.clamp(pz / torch.clamp_min(p_tot, 1e-30), -1 + 1e-6, 1 - 1e-6)
    eta = torch.atanh(ratio)
    phi = torch.atan2(py, px)
    alive = (p.abs().sum(dim=-1) > 0).to(torch.float32)
    w_sum = torch.clamp_min((pt * alive).sum(dim=1, keepdim=True), 1e-30)
    eta_axis = (eta * pt * alive).sum(dim=1, keepdim=True) / w_sum
    # circular mean for phi (no seam at -pi/pi)
    sin_axis = (torch.sin(phi) * pt * alive).sum(dim=1, keepdim=True)
    cos_axis = (torch.cos(phi) * pt * alive).sum(dim=1, keepdim=True)
    phi_axis = torch.atan2(sin_axis, cos_axis)
    deta = eta - eta_axis
    dphi = torch.remainder(phi - phi_axis + math.pi, 2 * math.pi) - math.pi
    ix = torch.clamp(((deta + extent) / (2 * extent) * n_pixels).to(torch.int32), 0, n_pixels - 1)
    iy = torch.clamp(((dphi + extent) / (2 * extent) * n_pixels).to(torch.int32), 0, n_pixels - 1)
    return ix * n_pixels + iy, pt * alive


def _const_images(jets, n_pixels, extent, n_dims):
    """pt-weighted images by scatter-add.  One constituent slot at a time:
    within a call no two updates meet in a pixel, so the sums are taken in
    constituent order on every device (one scatter over all slots would use
    atomics on the card, in an order that changes from run to run)."""
    flat_idx, wts = _image_bins(jets, n_pixels, extent, n_dims)
    flat_idx = flat_idx.to(torch.int64)
    images = torch.zeros((jets.shape[0], n_pixels * n_pixels), device=jets.device)
    for j in range(flat_idx.shape[1]):
        images.scatter_add_(1, flat_idx[:, j:j + 1], wts[:, j:j + 1])
    return images.reshape(-1, n_pixels, n_pixels)


def constituent_images(jets, n_pixels=16, extent=1.0, n_dims=4, device="cuda"):
    """(jets, n_dims*n_const) flat constituents -> (jets, n_pixels, n_pixels)
    pt-weighted (delta-eta, delta-phi) images centred on the jet axis, in
    chunks on ``device``.  ``n_dims`` selects the layout: 4 = (E,px,py,pz)
    blocks, 3 = (px,py,pz)."""
    jets = np.asarray(jets)
    if jets.shape[1] % n_dims != 0:
        raise ValueError(f"constituent width {jets.shape[1]} is not a multiple of "
                         f"n_dims={n_dims}")
    return _chunked(lambda x: _const_images(x, n_pixels, extent, n_dims), jets, device)


def drop_energy_component(jets):
    """(E,px,py,pz) -> (px,py,pz) flat layout for n_dims=3."""
    jets = np.asarray(jets, dtype=np.float32)
    n = jets.shape[1] // 4
    # the width is spelled out: -1 cannot be inferred for an empty slice,
    # which the scorer loads when a file ends on a chunk boundary
    return jets.reshape(-1, n, 4)[..., 1:].reshape(jets.shape[0], 3 * n)
