"""The port's data layer for training against the JAX package: Morton
pairing, OoD sampling, reweighting and one ``BatchGenerator`` load.

Exact where both sides run the same arithmetic: the Morton codes (bit for
bit, jets on bin edges included), ``ood_sampling`` (numpy's generator),
the weights (numpy) and the background side of a load.  The pairing draws
come from different generators (torch vs threefry), so there every pair
either package picks is checked to lie in the background jet's finest
non-empty Morton cell.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlasvae.data import BatchGenerator as JaxBatchGenerator, load_data as jax_load_data, \
    fit_scaler as jax_fit_scaler
from atlasvae.data import pairing as jax_pairing, registry as jax_registry, weights as jax_weights
from atlasvae_torch.data import (BatchGenerator, load_data, fit_scaler, registry, pairing,
                                 weights)
from plot_record import recording


@pytest.fixture(scope="module")
def port_registry(synth_dir):
    # both packages' registries: a JAX CLI run with --synthetic earlier in
    # the same worker re-registers the JAX names to its own files
    for name in ("QCD-Geneva", "OoD-H"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
        jax_registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    return synth_dir


def _kinematics(rng, n, m_lo=30.0, pt_lo=450.0):
    m = rng.uniform(m_lo, 400.0, n).astype(np.float32)
    pt = rng.uniform(pt_lo, 1200.0, n).astype(np.float32)
    return m, pt


def _with_edges(m, pt, m0, pt0):
    """Put jets exactly on cell edges, and one ulp to either side."""
    edges_m = (np.float32(m0) + np.float32(10.0) * np.arange(1, 30, dtype=np.float32))
    edges_pt = (np.float32(pt0) + np.float32(10.0) * np.arange(1, 30, dtype=np.float32))
    k = len(edges_m)
    for i, shift in enumerate((None, -np.inf, np.inf)):
        em = edges_m if shift is None else np.nextafter(edges_m, np.float32(shift))
        ep = edges_pt if shift is None else np.nextafter(edges_pt, np.float32(shift))
        m[i * k:(i + 1) * k], pt[i * k:(i + 1) * k] = em, ep
    return m, pt


def test_codes_match_jax_bit_for_bit(rng):
    m, pt = _kinematics(rng, 5000)
    m0, pt0 = np.float32(m.min()), np.float32(pt.min())
    m, pt = _with_edges(m, pt, m0, pt0)
    want = np.asarray(jax_pairing._codes(jnp.asarray(m), jnp.asarray(pt), m0, pt0))
    got = pairing._codes(torch.from_numpy(m), torch.from_numpy(pt), torch.tensor(m0),
                         torch.tensor(pt0)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _finest_cells(bkg, ood):
    """Per background jet: the finest level whose cell holds an OoD jet,
    and that cell's prefix, from the shared codes."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    m0 = min(ood["m"].min(), bkg["m"].min())
    pt0 = min(ood["pt"].min(), bkg["pt"].min())
    codes = lambda s: pairing._codes(f(s["m"]), f(s["pt"]), torch.tensor(np.float32(m0)),
                                     torch.tensor(np.float32(pt0)))
    ood_codes, bkg_codes = codes(ood), codes(bkg)
    sorted_codes = torch.sort(ood_codes).values
    levels = torch.arange(27)[:, None]
    prefix = bkg_codes[None] >> levels
    nonempty = torch.searchsorted(sorted_codes, (prefix + 1) << levels) > \
        torch.searchsorted(sorted_codes, prefix << levels)
    assert bool(nonempty.any(dim=0).all())
    level = torch.argmax(nonempty.to(torch.int8), dim=0)
    cell = bkg_codes >> level
    lo, hi = pairing.cell_ranges(bkg_codes, sorted_codes)
    assert torch.equal(lo, torch.searchsorted(sorted_codes, cell << level))
    assert torch.equal(hi, torch.searchsorted(sorted_codes, (cell + 1) << level))
    return ood_codes, cell, level


def _assert_same_cells(bkg, ood, picked_idx):
    ood_codes, cell, level = _finest_cells(bkg, ood)
    picked = ood_codes[torch.from_numpy(np.asarray(picked_idx, np.int64))]
    assert torch.equal(picked >> level, cell)


def test_every_pair_lies_in_the_finest_nonempty_cell(rng):
    n_bkg, n_ood = 3000, 700
    m, pt = _kinematics(rng, n_bkg)
    bkg = {"m": m, "pt": pt, "weights": np.ones(n_bkg, np.float32)}
    m, pt = _kinematics(rng, n_ood, m_lo=60.0)
    ood = {"m": m, "pt": pt, "weights": np.ones(n_ood, np.float32),
           "idx": np.arange(n_ood)}
    got = pairing.ood_pairing(bkg, ood, seed=3, verbose=False)
    want = jax_pairing.ood_pairing(bkg, ood, seed=3, verbose=False)
    for side in (got, want):
        assert set(side) == set(ood) and len(side["idx"]) == n_bkg
        np.testing.assert_array_equal(side["m"], ood["m"][side["idx"]])
        _assert_same_cells(bkg, ood, side["idx"])
    # the draws are seeded: the same seed picks the same jets again
    again = pairing.ood_pairing(bkg, ood, seed=3, verbose=False)
    np.testing.assert_array_equal(again["idx"], got["idx"])


@pytest.mark.parametrize("adjust,seed", [(False, 0), (True, 5), (False, None)])
def test_ood_sampling_matches_jax(rng, adjust, seed):
    bkg = {"m": rng.uniform(size=50).astype(np.float32)}
    ood = {"m": rng.uniform(size=80).astype(np.float32),
           "weights": rng.uniform(size=80).astype(np.float32)}
    if seed is None:  # unseeded draws differ; only shapes and values agree in kind
        got = pairing.ood_sampling(bkg, ood)
        assert got["m"].shape == (50,) and np.isin(got["m"], ood["m"]).all()
        return
    got = pairing.ood_sampling(bkg, ood, adjust, seed)
    want = jax_pairing.ood_sampling(bkg, ood, adjust, seed)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


WEIGHT_TYPES = ["None", "X-S", "flat_m", "flat_pt", "flat_2d", "OoD_m", "OoD_pt", "OoD_2d"]


@pytest.mark.parametrize("weight_type", WEIGHT_TYPES)
def test_reweight_sample_matches_jax(rng, weight_type):
    def sample(n, scale):
        m, pt = _kinematics(rng, n)
        return {"m": m * scale, "pt": pt, "weights": rng.lognormal(0, 0.5, n)
                .astype(np.float32)}
    bkg, sig = sample(2000, 1.0), sample(900, 1.3)
    bins = {"m": 20, "pt": 40} if weight_type.split("_")[0] in ("flat", "OoD") \
        else {"m": 10, "pt": 20}
    got = weights.reweight_sample({k: v.copy() for k, v in bkg.items()},
                                  {k: v.copy() for k, v in sig.items()}, bins, weight_type)
    want = jax_weights.reweight_sample({k: v.copy() for k, v in bkg.items()},
                                       {k: v.copy() for k, v in sig.items()}, bins,
                                       weight_type)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["weights"], w["weights"])
    if "OoD" in weight_type:
        assert got[1]["weights"].max() <= 1e4


def test_weights_factors_match_jax(port_registry, rng):
    path = str(port_registry / "synthetic_QCD-Geneva.h5")
    jzw = rng.integers(0, 4, 500).astype(np.float32)
    np.testing.assert_array_equal(weights.weights_factors(jzw, path),
                                  jax_weights.weights_factors(jzw, path))
    assert weights.weights_factors(np.zeros(100), path) == \
        jax_weights.weights_factors(np.zeros(100), path)
    got = load_data("QCD-Geneva", 300, adjust_weights=True, verbose=False, device="cpu")
    want = jax_load_data("QCD-Geneva", 300, adjust_weights=True, verbose=False)
    np.testing.assert_array_equal(got["weights"], want["weights"])


def test_one_generator_load_matches_jax(port_registry):
    kw = dict(n_const=20, n_dims=3, constituents="OFF", hlvs="ON")
    ood = load_data("OoD-H", 3000, **kw, verbose=False, device="cpu")
    ood["idx"] = np.arange(len(ood["m"]))
    hlv_scaler = fit_scaler(ood["HLVs"], scaler_type="RobustScaler", verbose=False)
    jax_scaler = jax_fit_scaler(ood["HLVs"], scaler_type="RobustScaler", verbose=False)
    common = dict(n_bkg=[0, 2500], weight_type="X-S", cuts=['(sample["m"] >= 30)'],
                  bin_sizes={"m": 10, "pt": 20}, **{k: v for k, v in kw.items()})
    got_bkg, got_ood = BatchGenerator("QCD-Geneva", "OoD-H", ood_sample=ood,
                                      hlv_scaler=hlv_scaler, **common)[0]
    want_bkg, want_ood = JaxBatchGenerator("QCD-Geneva", "OoD-H", ood_sample=ood,
                                           hlv_scaler=jax_scaler, **common)[0]
    assert set(got_bkg) == set(want_bkg)
    for key in want_bkg:
        np.testing.assert_array_equal(got_bkg[key], want_bkg[key])
    assert set(got_ood) == set(want_ood) and len(got_ood["m"]) == len(got_bkg["m"])
    _assert_same_cells(got_bkg, ood, got_ood["idx"])
    _assert_same_cells(want_bkg, ood, want_ood["idx"])
    # X-S: the OoD weights are scaled to the background's sum
    np.testing.assert_allclose(got_ood["weights"].sum(), got_bkg["weights"].sum(), rtol=1e-5)


def test_single_load_epoch_hands_out_the_same_objects(port_registry, tmp_path):
    gen = BatchGenerator("QCD-Geneva", "OoD-H", 20, 3, [0, 1000], constituents="OFF",
                         weight_type="None", bin_sizes={"m": 10, "pt": 20},
                         output_dir=str(tmp_path))
    with recording(tmp_path) as records:
        first, second = next(iter(gen)), next(iter(gen))
    assert first[0] is second[0] and first[1] is second[1]
    # an output_dir draws the first load's distributions, once
    assert sorted(records) == ["train_m.png", "train_pt.png"]


def test_multi_load_iteration_matches_indexing_and_raises(port_registry, monkeypatch):
    kw = dict(constituents="OFF", weight_type="None", bin_sizes={"m": 10, "pt": 20},
              mem_gb=20 * 3 * 4 * 1000 / 1e9)
    gen = BatchGenerator("QCD-Geneva", "OoD-H", 20, 3, [0, 2500], **kw)
    assert gen.load_size == 1000 and len(gen) == 3
    direct = [gen[i] for i in range(3)]
    for (b1, o1), (b2, o2) in zip(direct, iter(gen)):
        np.testing.assert_array_equal(b1["HLVs"], b2["HLVs"])
        np.testing.assert_array_equal(o1["HLVs"], o2["HLVs"])

    def failing(idx):
        raise OSError("disk gone")
    monkeypatch.setattr(gen, "_prepare_load", failing)
    with pytest.raises(OSError, match="disk gone"):
        list(iter(gen))
