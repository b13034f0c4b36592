"""Lorentz kinematics for the ETL, vectorized over jets and constituents.

Re-derives the reference's PyROOT ``TLorentzVector`` preprocessing
(ref tools/root_utils.py:104-154) as pure array math — no ROOT
dependency, batched over the whole sample:

* ``pt_eta_phi_m_to_epxpypz``: (pt, eta, phi, m) -> (E, px, py, pz)
  (ref ``jet_Lorentz_4v`` :113-119),
* ``canonicalize_jets``: the three-step jet-frame canonicalization —
  RotateZ(-phi_jet), transverse de-boost along z (BoostVector with
  perp = 0), RotateX(-alpha) energy-weighted alignment
  (ref ``jet_processing`` :122-154),
* ``pt_order_jets``: descending-pt constituent ordering
  (ref ``jet_pt_ordering`` :106-110).

Zero-padded constituents stay exactly zero through every step (all
operations are linear and the weighted-alignment sums mask r == 0).
"""

import numpy as np


def pt_eta_phi_m_to_epxpypz(pt, eta, phi, m):
    """(pt, eta, phi, m) -> (E, px, py, pz), elementwise (broadcast)."""
    pt, eta, phi, m = np.broadcast_arrays(
        np.asarray(pt, np.float64), eta, phi, m)
    out = np.empty(pt.shape + (4,), np.float64)
    out[..., 1] = pt * np.cos(phi)
    out[..., 2] = pt * np.sin(phi)
    out[..., 3] = pt * np.sinh(eta)
    out[..., 0] = np.sqrt(out[..., 1] ** 2 + out[..., 2] ** 2
                          + out[..., 3] ** 2
                          + np.asarray(m, np.float64) ** 2)
    return out


# The three frame transforms below update their (J, C, 4) input IN
# PLACE (one (J, C) temporary each instead of a fresh (J, C, 4) stack —
# at 10M-jet conversion scale the full-block allocations were the
# dominant convert() cost).  canonicalize_jets copies its input once.

def _rotate_z(p4, angle):
    """Rotate momenta about z by ``angle`` (per-jet), in place."""
    c, s = np.cos(angle)[:, None], np.sin(angle)[:, None]
    px = c * p4[..., 1] - s * p4[..., 2]
    p4[..., 2] = s * p4[..., 1] + c * p4[..., 2]
    p4[..., 1] = px
    return p4


def _rotate_x(p4, angle):
    c, s = np.cos(angle)[:, None], np.sin(angle)[:, None]
    py = c * p4[..., 2] - s * p4[..., 3]
    p4[..., 3] = s * p4[..., 2] + c * p4[..., 3]
    p4[..., 2] = py
    return p4


def _boost_z(p4, beta):
    """Boost along z with per-jet velocity beta, in place."""
    beta = np.clip(np.asarray(beta), -1 + 1e-12, 1 - 1e-12)
    gamma = 1.0 / np.sqrt(1.0 - beta ** 2)
    g, gb = gamma[:, None], (gamma * beta)[:, None]
    e = g * p4[..., 0] + gb * p4[..., 3]
    p4[..., 3] = gb * p4[..., 0] + g * p4[..., 3]
    p4[..., 0] = e
    return p4


def canonicalize_jets(jets):
    """Center/boost/rotate canonicalization of (J, C, 4) = (E,px,py,pz)
    constituent arrays (ref tools/root_utils.py:122-154):

    1. rotate about z by -phi(jet) so the jet points along +x,
    2. boost by the negative longitudinal component of the jet velocity
       (TLorentzVector.BoostVector with SetPerp(0)),
    3. rotate about x by -alpha, alpha = atan2(sum E_i eta_i / r_i,
       sum E_i phi_i / r_i) over constituents (energy-weighted
       (eta, phi) alignment onto the phi axis).
    """
    jets = np.array(jets, np.float64)       # copy: transforms are in-place
    total = jets.sum(axis=1)
    phi_jet = np.arctan2(total[:, 2], total[:, 1])
    # longitudinal boost velocity before any rotation (ref :127-131)
    beta_z = np.where(total[:, 0] != 0, total[:, 3] / np.maximum(total[:, 0], 1e-30), 0.0)
    jets = _rotate_z(jets, -phi_jet)
    jets = _boost_z(jets, -beta_z)

    e, px, py, pz = (jets[..., i] for i in range(4))
    p_tot = np.sqrt(px ** 2 + py ** 2 + pz ** 2)
    pt = np.sqrt(px ** 2 + py ** 2)
    phi_c = np.arctan2(py, px)
    with np.errstate(divide="ignore", invalid="ignore"):
        eta_c = np.where(p_tot > np.abs(pz) + 1e-30,
                         np.arctanh(np.clip(pz / np.maximum(p_tot, 1e-30),
                                            -1 + 1e-12, 1 - 1e-12)), 0.0)
    r = np.sqrt(phi_c ** 2 + eta_c ** 2)
    alive = np.abs(jets).sum(axis=-1) > 0
    wgt = np.where((r > 0) & alive, e / np.maximum(r, 1e-30), 0.0)
    weighted_phi = np.sum(phi_c * wgt, axis=1)
    weighted_eta = np.sum(eta_c * wgt, axis=1)
    alpha = np.arctan2(weighted_eta, weighted_phi)  # align at phi (ref :148)
    jets = _rotate_x(jets, -alpha)
    return jets


def pt_order_jets(jets):
    """Descending-pt constituent ordering of (J, C, 4) arrays
    (ref tools/root_utils.py:106-110)."""
    jets = np.asarray(jets)
    pt = np.sqrt(jets[..., 1] ** 2 + jets[..., 2] ** 2)
    order = np.argsort(-pt, axis=1, kind="stable")
    return np.take_along_axis(jets, order[..., None], axis=1)


def summed_4v(jets):
    """Summed-jet (E, pt_calo, m_calo) (ref tools/root_utils.py:93-98)."""
    total = np.asarray(jets, np.float64).sum(axis=1)
    e, px, py, pz = total.T
    pt = np.sqrt(px ** 2 + py ** 2)
    m = np.sqrt(np.maximum(0, e ** 2 - px ** 2 - py ** 2 - pz ** 2))
    return {"E": e, "pt_calo": pt, "m_calo": m}
