"""The port's data layer against the JAX package on the same files.

``load_data`` on the shared synthetic files with constituents OFF and ON
(HLVs and kinematics at float32 rtol 1e-6; the pt-sorted constituents
exact, since the sort must break the zero-padding ties as
``jnp.argsort(stable=True)`` does, and order live constituents whose pt
differ in the last bit as XLA's fused arithmetic does), ``jets_3v``,
``count_constituents`` and ``constituent_pt_cumulative`` (rtol 1e-5 / atol
1e-6: log, atan2 and a running sum differ by an ulp), the four scaler
transforms and their
inverses (rtol 1e-5 / atol 1e-5: erfc, pow and log differ by an ulp
between the two libraries), scaler pickles written by the JAX package,
``interp`` on tied quantiles (bit-exact against ``jnp.interp``), and the
HDF5 subset the port writes and reads without h5py (bit-exact both ways
with h5py).
"""

import pickle
import subprocess
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlasvae.data import load_data as jax_load_data, sort_constituents_by_pt as jax_sort
from atlasvae.data import scalers as jax_scalers
from atlasvae_torch.data import hdf5, load_data, sort_constituents_by_pt, scalers, jets

CPU = torch.device("cpu")
QCD = "synthetic_QCD-Geneva.h5"


def _compare_samples(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("constituents", ["OFF", "ON"])
def test_load_data_matches_jax(synth_dir, constituents):
    path = str(synth_dir / QCD)
    args = ((100, 1700), ['(sample["m"] >= 30)'], 20, 3, constituents)
    want = jax_load_data(path, *args, verbose=False)
    got = load_data(path, *args, verbose=False, device=CPU)
    _compare_samples(got, want)
    if constituents == "ON":
        np.testing.assert_array_equal(got["constituents"], want["constituents"])


def test_load_data_derives_kinematics_from_constituents(synth_dir):
    path = str(synth_dir / QCD)
    var_list = ["rljet_Tau1_wta", "rljet_Tau2_wta", "rljet_Tau3_wta", "rljet_eta",
                "rljet_ECF3", "ECF2", "d12", "d23", "weights", "JZW"]
    want = jax_load_data(path, 500, var_list=var_list, verbose=False)
    got = load_data(path, 500, var_list=var_list, verbose=False, device=CPU)
    _compare_samples(got, want)


def test_sort_by_pt_breaks_padding_ties_like_jax(rng):
    jets4 = rng.normal(size=(64, 12, 4)).astype(np.float32)
    jets4[:, 7:] = 0.0                       # zero padding: pt ties at 0
    jets4[::2, 3:] *= -0.0                   # signed zeros mixed in
    jets4[:, 5] = jets4[:, 4]                # exact ties between live constituents
    flat = jets4.reshape(64, -1)
    got = sort_constituents_by_pt(flat, device=CPU)
    np.testing.assert_array_equal(got, np.asarray(jax_sort(flat)))


def test_sort_by_pt_near_ties_sort_as_jax(rng):
    """Pairs of live constituents whose px^2 + py^2 tie, or differ by one
    ulp, according to whether px*px is fused into the sum: (px, py) beside
    (py, px), and beside a copy with px one ulp larger.  XLA on the CPU
    contracts px*px + py*py into fma(px, px, py*py) and rounds the square
    root correctly; the port must order every such pair the same way."""
    n_jets, n = 4000, 16
    jets4 = np.zeros((n_jets, n, 4), np.float32)
    px = (rng.normal(size=(n_jets, n // 4)) * 30).astype(np.float32)
    py = (rng.normal(size=(n_jets, n // 4)) * 30).astype(np.float32)
    jets4[:, 0::4, 1], jets4[:, 0::4, 2] = px, py
    jets4[:, 1::4, 1], jets4[:, 1::4, 2] = py, px                     # swapped
    jets4[:, 2::4, 1], jets4[:, 2::4, 2] = np.nextafter(px, np.float32(np.inf)), py
    jets4[:, 3::4, 1], jets4[:, 3::4, 2] = -py, px                    # rotated
    jets4[..., 0] = rng.uniform(1, 2, (n_jets, n))
    jets4[..., 3] = rng.normal(size=(n_jets, n))
    jets4[::3, 12:] = 0.0                                             # some padding too
    # the construction does what it says: with the FMA many swapped pairs
    # stop being ties (float64 holds px*px exactly)
    a, b = px.astype(np.float64), py.astype(np.float64)
    fused = (a * a + (py * py).astype(np.float64)).astype(np.float32)
    fused_swapped = (b * b + (px * px).astype(np.float64)).astype(np.float32)
    assert np.mean(np.sqrt(fused) != np.sqrt(fused_swapped)) > 0.05
    flat = jets4.reshape(n_jets, -1)
    got = sort_constituents_by_pt(flat, device=CPU)
    np.testing.assert_array_equal(got, np.asarray(jax_sort(flat)))


@pytest.mark.parametrize("n_dims", [3, 4])
def test_jets_3v_matches_jax(rng, n_dims):
    from atlasvae.data import jets_3v as jax_jets_3v
    blocks = rng.normal(size=(50, 9, n_dims)).astype(np.float32) * 20
    if n_dims == 4:
        p = np.sqrt((blocks[..., 1:] ** 2).sum(-1))
        blocks[..., 0] = p * rng.uniform(1.0, 1.2, p.shape)       # E >= |p|
        blocks[3, 2, 0] = blocks[3, 2, 3] = 7.0                     # e == pz: ratio infinite
        blocks[4, 1, 0] = -blocks[4, 1, 3]                          # e == -pz: ratio 0
        blocks[5, 0, 0] = 0.5 * abs(blocks[5, 0, 3])                # |pz| > e: ratio negative
    else:
        blocks[3, 2, :2] = 0.0                                    # along the beam: e == |pz|
    blocks[:, 6:] = 0.0                                           # zero padding: 0 / 0
    flat = blocks.reshape(50, -1)
    want = jax_jets_3v(flat, n_dims)
    got = jets.jets_3v(flat, n_dims, device=CPU)
    assert got.shape == (50, 9, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:, 6:], 0.0)
    assert got[3, 2, 1] == 0.0
    as_tensor = jets.jets_3v(torch.from_numpy(flat), n_dims)
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), got)


def test_count_and_cumulative_pt_match_jax(rng):
    from atlasvae.data import count_constituents as jax_count, \
        constituent_pt_cumulative as jax_cumulative
    jets4 = rng.normal(size=(70, 11, 4)).astype(np.float32)
    n_live = rng.integers(0, 12, 70)
    jets4[np.arange(11)[None, :] >= n_live[:, None]] = 0.0
    jets4[5, 1] = [0.0, -0.0, 0.0, 1e-30]                       # live by one tiny component
    flat = jets4.reshape(70, -1)
    got = jets.count_constituents(flat, device=CPU)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jax_count(flat)))
    np.testing.assert_allclose(jets.constituent_pt_cumulative(flat, device=CPU),
                               np.asarray(jax_cumulative(flat)), rtol=1e-5, atol=1e-6)


def test_jets_4v_and_drop_energy(rng):
    from atlasvae.data import jets_4v as jax_jets_4v, drop_energy_component as jax_drop
    flat = np.abs(rng.normal(size=(40, 32))).astype(np.float32)
    got, want = jets.jets_4v(flat, device=CPU), jax_jets_4v(flat)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    np.testing.assert_array_equal(jets.drop_energy_component(flat), jax_drop(flat))
    assert jets.jets_4v(flat[:0], device=CPU)["pt_calo"].shape == (0,)


@pytest.mark.parametrize("kind", ["QuantileTransformer", "PowerTransformer",
                                  "RobustScaler", "MaxAbsScaler"])
def test_scaler_transforms_match_jax(rng, kind):
    x = np.concatenate([rng.lognormal(size=(600, 3)),
                        rng.integers(0, 4, size=(600, 1)),          # tied quantiles
                        rng.normal(size=(600, 1))], axis=1).astype(np.float32)
    scaler = jax_scalers.fit_scaler(x, scaler_type=kind, verbose=False)
    ported = scalers.Scaler(**vars(scaler))
    probe = np.concatenate([x[:200], x[:5] * 3 - 1]).astype(np.float32)
    want = jax_scalers.apply_scaler(probe, scaler=scaler, verbose=False)
    got = scalers.apply_scaler(probe, scaler=ported, verbose=False, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    as_tensor = scalers.apply_scaler(torch.from_numpy(probe), scaler=ported, verbose=False)
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), got)
    want_inv = jax_scalers.inverse_scaler(want, scaler=scaler, verbose=False)
    got_inv = scalers.inverse_scaler(want, scaler=ported, verbose=False, device=CPU)
    np.testing.assert_allclose(got_inv, want_inv, rtol=1e-5, atol=1e-5)


def test_scaler_pickled_by_jax_package_loads(tmp_path, rng):
    x = rng.normal(size=(300, 4)).astype(np.float32)
    jax_scalers.fit_scaler(x, scaler_out=tmp_path / "s.pkl", verbose=False)
    loaded = scalers.Scaler.load(tmp_path / "s.pkl")
    assert type(loaded) is scalers.Scaler and loaded.kind == "robust"
    want = jax_scalers.Scaler.load(tmp_path / "s.pkl")
    np.testing.assert_array_equal(loaded.center, want.center)
    np.testing.assert_array_equal(loaded.scale, want.scale)
    # and no JAX is imported to read it
    code = ("import sys; from atlasvae_torch.data.scalers import Scaler; "
            f"s = Scaler.load({str(tmp_path / 's.pkl')!r}); "
            "assert s.kind == 'robust'; "
            "assert 'jax' not in sys.modules and 'atlasvae' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_interp_matches_jnp_on_tied_quantiles():
    xp = np.array([0.0, 0.0, 1.0, 1.0, 1.0, 2.5, 4.0, 4.0], np.float32)
    fp = np.linspace(0, 1, len(xp)).astype(np.float32)
    x = np.array([-1, 0, 0.5, 1, 1 + 1e-7, 2, 2.5, 3.9, 4, 5, -0.0], np.float32)
    want = np.asarray(jnp.interp(x, xp, fp))
    got = scalers.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    np.testing.assert_array_equal(got.numpy(), want)
    batched = scalers.interp(torch.from_numpy(np.stack([x, x + 0.25])),
                             torch.from_numpy(np.stack([xp, xp])),
                             torch.from_numpy(np.stack([fp, fp])))
    np.testing.assert_array_equal(batched[0].numpy(), want)
    np.testing.assert_array_equal(batched[1].numpy(), np.asarray(jnp.interp(x + 0.25, xp, fp)))


@pytest.mark.parametrize("n", [1, 2, 7, 10_000])
def test_linspace_matches_jnp(n):
    np.testing.assert_array_equal(scalers._linspace01(n, CPU).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, n)))


def _arrays(rng):
    out = {f"col{i:02d}": rng.normal(size=50).astype(np.float32) for i in range(16)}
    out.update(constituents=rng.normal(size=(50, 12)).astype(np.float32),
               f8=rng.normal(size=(2, 3, 4)), i4=np.arange(5, dtype=np.int32),
               i8=np.arange(3, dtype=np.int64), empty=np.zeros(0, np.float32))
    return out


def test_hdf5_lite_writes_what_h5py_reads(tmp_path, rng):
    arrays = _arrays(rng)
    with hdf5.LiteFile(tmp_path / "lite.h5", "w") as f:
        for key, val in arrays.items():
            f.create_dataset(key, data=val, compression="lzf")
        grown = f.create_dataset("grown", shape=(0,), maxshape=(None,), dtype=np.float32)
        for part in (np.arange(3), np.arange(4) + 10):
            n = len(grown)
            grown.resize((n + len(part),))
            grown[n:] = part
    arrays["grown"] = np.array([0, 1, 2, 10, 11, 12, 13], np.float32)
    with h5py.File(tmp_path / "lite.h5", "r") as f:
        assert sorted(f) == sorted(arrays)
        for key, val in arrays.items():
            assert f[key].dtype == val.dtype
            np.testing.assert_array_equal(f[key][()], val)
    with hdf5.LiteFile(tmp_path / "lite.h5") as f:
        np.testing.assert_array_equal(f["constituents"][10:20, :], arrays["constituents"][10:20])
        for key, val in arrays.items():
            np.testing.assert_array_equal(f[key][:], val)


def test_hdf5_lite_reads_h5py_files_and_refuses_compressed(tmp_path, rng):
    arrays = _arrays(rng)
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        for key, val in arrays.items():
            f.create_dataset(key, data=val)
        f.create_dataset("packed", data=np.ones(64, np.float32), compression="lzf")
        f.create_dataset("checked", data=np.ones(64, np.float32), fletcher32=True)
    # lzf is read; a filter LiteFile does not decode is refused by name
    with pytest.raises(OSError, match="fletcher32.*h5py"):
        hdf5.LiteFile(tmp_path / "h5py.h5")
    with h5py.File(tmp_path / "h5py.h5", "a") as f:
        del f["checked"]
    with hdf5.LiteFile(tmp_path / "h5py.h5") as f:
        assert sorted(f) == sorted([*arrays, "packed"])
        np.testing.assert_array_equal(f["packed"][:], np.ones(64, np.float32))
        for key, val in arrays.items():
            np.testing.assert_array_equal(f[key][:], val)
