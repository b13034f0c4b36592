"""Jet-constituent array functions in torch.

Counterpart of the loader-facing part of ``atlasvae/data/jets.py``.  The
host-facing functions take numpy arrays (or tensors), compute on
``device`` in chunks, and return numpy arrays, as the JAX package's
wrappers do, so the loader's sample stays a dict of numpy arrays.
"""

import numpy as np
import torch

# Chunk length for host->device streaming of multi-10M-jet arrays.
_CHUNK = 1_000_000


def _chunked(fn, jets, device, chunk=_CHUNK):
    jets = torch.as_tensor(np.asarray(jets))
    parts = [fn(jets[i:i + chunk].to(device)).cpu().numpy()
             for i in range(0, len(jets), chunk)]
    return np.concatenate(parts, axis=0) if parts else np.asarray(jets)


def _sort_by_pt(jets):
    """Sort each jet's (E,px,py,pz) constituent blocks by descending pt.
    Stable, as jnp.argsort(stable=True): zero-padded constituents all have
    pt 0 and keep their order."""
    n = jets.shape[1] // 4
    jets = jets.reshape(-1, n, 4).to(torch.float32)
    pt = torch.sqrt(jets[:, :, 1] ** 2 + jets[:, :, 2] ** 2)
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


def drop_energy_component(jets):
    """(E,px,py,pz) -> (px,py,pz) flat layout for n_dims=3."""
    jets = np.asarray(jets, dtype=np.float32)
    n = jets.shape[1] // 4
    return jets.reshape(-1, n, 4)[..., 1:].reshape(jets.shape[0], -1)
