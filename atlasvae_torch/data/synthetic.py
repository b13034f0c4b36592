"""Physics-like synthetic jet datasets for tests and benchmarks.

Copy of ``atlasvae/data/synthetic.py`` (numpy; the port imports nothing
of the JAX package).  Files are written through ``data/hdf5.py``: h5py
where it is installed, else the port's own HDF5 writer.

The reference trains on ~10M-event LHC HDF5 files that are not shipped
with the code (ref OE-VAE/utils.py:15-32).  This module fabricates files
with the *same schema* — ``constituents`` as flat (E,px,py,pz) blocks,
the high-level-variable columns of OE-VAE/vae.py:72-73, ``weights``,
``JZW``, ``DSID`` — and self-consistent kinematics, so every pipeline
stage (loading, pairing, scaling, training, BumpHunter scans) can run
end-to-end without the private inputs.

Jet model: ``n`` massless constituents with momentum fractions drawn
from a Dirichlet and angular spread set by the target m/pt ratio; the
jet's stored (pt, m) are recomputed from the constituent sums, so
derived kinematics match ``jets_4v`` exactly.
"""

import numpy as np

from . import hdf5
from .registry import register_file, data_dir

# Per-class generative settings: mass spectrum + substructure tendencies.
_CLASSES = {
    "QCD": dict(mass="falling", jzw="slices"),
    "top": dict(mass="top", jzw=-1.0),
    "W": dict(mass="w", jzw=-1.0),
    "2HDM": dict(mass="2hdm", jzw=-1.0),
    "VZ": dict(mass="vz", jzw=-1.0),
    "H-OoD": dict(mass="broad", jzw=-1.0),
}


def _sample_mass(kind, n, rng):
    if kind == "falling":  # steeply falling QCD-like spectrum
        m = rng.exponential(scale=90.0, size=n) + 25.0
        return np.clip(m, 25.0, 780.0)
    if kind == "top":  # t->bqq full reconstruction around 173 + W feed-down
        choice = rng.random(n)
        m = np.where(
            choice < 0.7,
            rng.normal(172.5, 14.0, n),
            np.where(choice < 0.85, rng.normal(80.4, 9.0, n), rng.exponential(70.0, n) + 30.0),
        )
        return np.clip(m, 25.0, 780.0)
    if kind == "w":
        return np.clip(rng.normal(80.4, 8.0, n), 25.0, 780.0)
    if kind == "2hdm":
        return np.clip(np.where(rng.random(n) < 0.8, rng.normal(500.0, 35.0, n),
                                rng.exponential(90.0, n) + 30.0), 25.0, 780.0)
    if kind == "vz":
        return np.clip(np.where(rng.random(n) < 0.8, rng.normal(500.0, 40.0, n),
                                rng.exponential(90.0, n) + 30.0), 25.0, 780.0)
    if kind == "broad":  # outlier-exposure sample: wide flat-ish masses
        return rng.uniform(25.0, 700.0, n)
    raise ValueError(kind)


def _make_constituents(pt, mass, n_const, n_max, rng):
    """Massless constituents whose sum has exactly (pt, m).

    Construction: mirrored pairs of massless momenta in the jet rest
    frame (so the total momentum vanishes and the total energy is m,
    i.e. the invariant mass is m *exactly*), then a boost along x to the
    requested transverse momentum.  No small-angle approximation — the
    derived m_calo/pt_calo (see jets_4v) reproduce the generated
    spectra up to float32 rounding.
    """
    n_jets = len(pt)
    n_pairs = n_max // 2
    # isotropic unit vectors per pair
    costh = rng.uniform(-1, 1, (n_jets, n_pairs))
    phi = rng.uniform(0, 2 * np.pi, (n_jets, n_pairs))
    sinth = np.sqrt(1 - costh ** 2)
    u = np.stack([sinth * np.cos(phi), sinth * np.sin(phi), costh], axis=-1)
    # energy fractions over alive pairs
    alive_pairs = (np.arange(n_pairs)[None, :] < (n_const[:, None] // 2))
    frac = rng.dirichlet(np.full(n_pairs, 0.6), size=n_jets) * alive_pairs
    frac /= np.maximum(frac.sum(axis=1, keepdims=True), 1e-12)
    e_pair = frac * (mass[:, None] / 2.0)          # each of the pair gets e
    p4 = np.zeros((n_jets, n_max, 4))
    p4[:, 0::2, 0] = e_pair
    p4[:, 1::2, 0] = e_pair
    p4[:, 0::2, 1:] = e_pair[..., None] * u
    p4[:, 1::2, 1:] = -e_pair[..., None] * u
    # boost along x: E_jet = sqrt(pt^2 + m^2), gamma = E_jet/m
    e_jet = np.sqrt(pt ** 2 + mass ** 2)
    gamma = (e_jet / np.maximum(mass, 1e-9))[:, None]
    gbeta = (pt / np.maximum(mass, 1e-9))[:, None]
    e_new = gamma * p4[:, :, 0] + gbeta * p4[:, :, 1]
    px_new = gbeta * p4[:, :, 0] + gamma * p4[:, :, 1]
    p4[:, :, 0], p4[:, :, 1] = e_new, px_new
    # Descending-pt ordering, as the production files assume.
    pt_i = np.sqrt(p4[:, :, 1] ** 2 + p4[:, :, 2] ** 2)
    order = np.argsort(-pt_i, axis=1, kind="stable")
    p4 = np.take_along_axis(p4, order[:, :, None], axis=1)
    return p4.reshape(n_jets, 4 * n_max).astype(np.float32)


def make_synthetic_dataset(path, kind, n_events, n_const_max=100, seed=0):
    """Write one synthetic HDF5 sample with the production schema."""
    rng = np.random.default_rng(seed)
    cfg = _CLASSES[kind]
    mass = _sample_mass(cfg["mass"], n_events, rng).astype(np.float64)
    pt = (450.0 + rng.pareto(3.0, n_events) * 180.0).clip(450.0, 1200.0)
    n_const = np.clip(rng.poisson(38 if kind == "QCD" else 52, n_events), 5, n_const_max)
    const = _make_constituents(pt, mass, n_const, n_const_max, rng)
    # Recompute (pt, m) from the generated constituents for consistency.
    four = const.reshape(n_events, n_const_max, 4).sum(axis=1)
    e, px, py, pz = four.T
    pt_calo = np.sqrt(px ** 2 + py ** 2)
    m_calo = np.sqrt(np.maximum(0.0, e ** 2 - px ** 2 - py ** 2 - pz ** 2))

    # Substructure HLVs with class-dependent tendencies.
    tau1 = np.abs(rng.normal(0.30, 0.08, n_events)) + 0.02
    if kind in ("top", "VZ"):
        tau21 = np.clip(rng.normal(0.55, 0.12, n_events), 0.05, 1.0)
        tau32 = np.clip(rng.normal(0.55, 0.10, n_events), 0.05, 1.0)
    elif kind in ("W", "2HDM", "H-OoD"):
        tau21 = np.clip(rng.normal(0.35, 0.10, n_events), 0.05, 1.0)
        tau32 = np.clip(rng.normal(0.80, 0.10, n_events), 0.05, 1.2)
    else:
        tau21 = np.clip(rng.normal(0.75, 0.12, n_events), 0.05, 1.2)
        tau32 = np.clip(rng.normal(0.85, 0.10, n_events), 0.05, 1.2)
    tau2 = tau1 * tau21
    tau3 = tau2 * tau32
    ecf2 = (m_calo ** 2 / np.maximum(pt_calo, 1e-6) ** 2) * rng.lognormal(0.0, 0.2, n_events)
    ecf3 = ecf2 ** 1.5 * rng.lognormal(0.0, 0.3, n_events)
    d12 = m_calo * rng.lognormal(-0.7, 0.4, n_events)
    d23 = d12 * rng.uniform(0.1, 0.6, n_events)
    eta = rng.normal(0.0, 1.2, n_events)

    if cfg["jzw"] == "slices":
        jzw = rng.integers(0, 4, n_events).astype(np.float32)
        # Mild per-slice weights: spread wide enough to exercise the
        # cross-section machinery, narrow enough that weighted histograms
        # keep near-Poisson statistics (real JZW weights behave likewise
        # after the reference's luminosity scaling).
        weights = (1.25 ** -jzw * rng.lognormal(0.0, 0.1, n_events)).astype(np.float32)
        dsid = (361020 + jzw).astype(np.float32)
    else:
        jzw = np.full(n_events, cfg["jzw"], dtype=np.float32)
        weights = np.ones(n_events, dtype=np.float32)
        dsid = np.full(n_events, 500000.0, dtype=np.float32)

    with hdf5.File(path, "w") as f:
        f.create_dataset("constituents", data=const, compression="lzf")
        for key, val in dict(
            rljet_pt_comb=pt_calo, rljet_m_comb=m_calo,
            rljet_Tau1_wta=tau1, rljet_Tau2_wta=tau2, rljet_Tau3_wta=tau3,
            rljet_eta=eta, rljet_ECF3=ecf3, ECF2=ecf2, d12=d12, d23=d23,
            weights=weights, JZW=jzw, DSID=dsid,
        ).items():
            f.create_dataset(key, data=np.asarray(val, dtype=np.float32))
    return path


# Logical-name -> synthetic class for the standard registry entries.
_SYNTHETIC_KINDS = {
    "QCD-Geneva": "QCD",
    "top-Geneva": "top",
    "2HDM-Geneva": "2HDM",
    "VZ-Geneva": "VZ",
    "OoD-H": "H-OoD",
    "OoD-W": "W",
}


def ensure_synthetic_registry(directory=None, n_events=20_000, n_const_max=100,
                              names=None, seed=0):
    """Create-and-register synthetic files for the standard sample names."""
    import pathlib
    directory = pathlib.Path(data_dir() if directory is None else directory)
    directory.mkdir(parents=True, exist_ok=True)
    names = names or list(_SYNTHETIC_KINDS)
    for i, name in enumerate(names):
        path = directory / f"synthetic_{name}.h5"
        regenerate = True
        if path.exists():
            # regenerate only when the existing file is SMALLER than
            # requested — a leftover small probe file would otherwise
            # silently clamp every later large-scale run
            with hdf5.File(path, "r") as f:
                existing = len(f[next(iter(f))])
            regenerate = existing < n_events
            if regenerate:
                print(f"Regenerating {path.name}: {existing} < {n_events} "
                      "events requested")
        if regenerate:
            make_synthetic_dataset(path, _SYNTHETIC_KINDS[name], n_events,
                                   n_const_max=n_const_max, seed=seed + i)
        register_file(name, path)
    return directory
