"""The port's ETL (``atlasvae_torch.etl``, ``atlasvae_torch.cli.etl``)
against the JAX package's (``atlasvae.etl``, ``atlasvae.cli.etl``) on the
same seeded ROOT ntuples.

Every test that writes HDF5 runs twice: with h5py (the port writes
lzf-chunked files, as the JAX package does) and with ``LiteFile`` in its
place (``hdf5._h5py`` set to None, as on the machine with the card: the
port writes contiguous, uncompressed files and reads the JAX package's
lzf-chunked ones).  The JAX package always writes through h5py.  Both runs
must give the same datasets as the JAX package, bit for bit, dtypes and
shapes included: ``convert`` (dijet, ttbar, extra branches, the raw ATLAS
``vector<vector<float>>`` layout, four reader threads), ``read_root_files``
and ``count_constituents``, ``file_processing`` (the same rows in the same
order, and the same again when re-run in the same folder), the CLI, and
``load_data`` on the merged file (rtol 1e-6, constituents exact, as
``tests/test_torch_data.py`` holds it).
"""

import os
import shutil

import h5py
import numpy as np
import pytest
import torch

from atlasvae.cli import etl as jax_cli
from atlasvae.data import load_data as jax_load_data
from atlasvae.etl import (canonicalize_jets as jax_canonicalize, file_processing as jax_merge,
                          pt_eta_phi_m_to_epxpypz as jax_p4, pt_order_jets as jax_order,
                          rootio, summed_4v as jax_summed)
from atlasvae.etl import branches as jax_branches, root2h5 as jax_root2h5
from atlasvae_torch.cli import etl as cli
from atlasvae_torch.data import hdf5, load_data
from atlasvae_torch.etl import (branches, canonicalize_jets, file_processing, lorentz,
                                pt_eta_phi_m_to_epxpypz, pt_order_jets, root2h5, rootnative,
                                summed_4v)
from test_etl import _fixture_branches, _vvf_entries

CPU = torch.device("cpu")


@pytest.fixture(params=["h5py", "lite"])
def backend(request, monkeypatch):
    """Which library the port's HDF5 goes through."""
    if request.param == "lite":
        monkeypatch.setattr(hdf5, "_h5py", None)
    return request.param


def _ntuples(root, rng, dsids_sizes, layout="leaf", max_const=100, extra=False):
    """Seeded ntuples, one folder a DSID, as the reference's grid output."""
    for dsid, sizes in dsids_sizes.items():
        folder = root / f"user.sim.{dsid}.ntuples"
        folder.mkdir(parents=True)
        for i, n in enumerate(sizes):
            data = _fixture_branches(rng, n, max_const=max_const)
            if extra:
                data["eventNumber"] = np.arange(n, dtype=np.int64) + 1000 * i
                data["NPV"] = rng.integers(1, 60, n).astype(np.int32)
            if layout == "vvf":       # the raw ATLAS layout: one list a jet, the leading one first
                for key in root2h5.JET_VAR:
                    data[key] = [[lead] + [rng.normal(size=3).astype(np.float32)
                                           for _ in range(int(rng.integers(0, 3)))]
                                 for lead in data[key]]
            rootio.write_tree(str(folder / f"part._{i:06d}.root"), "nominal", data)


def _same_files(got_path, want_path, compressed):
    """The port's file holds the JAX package's datasets bit for bit; with
    h5py it is lzf-compressed as well, with LiteFile contiguous."""
    with h5py.File(got_path) as got, h5py.File(want_path) as want:
        assert sorted(got) == sorted(want)
        for key in want:
            a, b = got[key][()], want[key][()]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key
            assert got[key].compression == ("lzf" if compressed else None), key
    with hdf5.LiteFile(got_path) as lite, h5py.File(want_path) as want:
        for key in want:
            assert lite[key][()].tobytes() == want[key][()].tobytes(), key


@pytest.mark.parametrize("fn", ["p4", "canonicalize", "order", "summed"])
def test_lorentz_matches_jax(fn):
    rng = np.random.default_rng(1)
    pt = rng.uniform(1, 100, (50, 12))
    pt[:, 9:] = 0
    eta, phi = rng.normal(0, 1.5, (50, 12)), rng.uniform(-np.pi, np.pi, (50, 12))
    p4 = jax_p4(pt, eta, phi, 0.0) * (pt > 0)[..., None]
    ours = {"p4": lambda: pt_eta_phi_m_to_epxpypz(pt, eta, phi, 0.3),
            "canonicalize": lambda: canonicalize_jets(p4), "order": lambda: pt_order_jets(p4),
            "summed": lambda: summed_4v(p4)}[fn]()
    theirs = {"p4": lambda: jax_p4(pt, eta, phi, 0.3),
              "canonicalize": lambda: jax_canonicalize(p4), "order": lambda: jax_order(p4),
              "summed": lambda: jax_summed(p4)}[fn]()
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys()
        ours, theirs = [ours[k] for k in theirs], [theirs[k] for k in theirs]
    np.testing.assert_array_equal(ours, theirs)
    assert lorentz.__name__.startswith("atlasvae_torch.")


def test_tables_and_catalog_match_jax():
    for sample in jax_root2h5._TABLES:
        assert root2h5.id_weights(sample) == jax_root2h5.id_weights(sample)
    for name in ("LUMINOSITY", "SCALARS", "JET_VAR", "OTHERS", "MEV_SCALARS", "_TABLES"):
        assert getattr(root2h5, name) == getattr(jax_root2h5, name), name
    assert branches.catalog() == jax_branches.catalog() and len(branches.catalog()) == 171
    assert branches.JAGGED == jax_branches.JAGGED


CONVERT_CASES = {
    "dijet": (dict(sample_type="topo-dijet", tag=1, seed=3), {"361024": [130, 90]}, {}),
    "ttbar": (dict(sample_type="topo-ttbar", n_constituents=9, seed=0),
              {"410284": [80], "410285": [70]}, {}),
    "extra_branches": (dict(sample_type="topo-dijet", tag=0, n_constituents=9,
                            extra_branches=["eventNumber", "NPV"]), {"361023": [60]},
                       dict(extra=True)),
    "vvf_layout": (dict(sample_type="topo-dijet", tag=0, seed=1), {"361023": [100]},
                   dict(layout="vvf")),
    "threads": (dict(sample_type="topo-dijet", tag=1, seed=3, n_workers=4),
                {"361024": [40, 50, 60, 30, 20]}, {}),
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_convert_matches_jax(tmp_path, backend, case):
    kwargs, dsids, ntuple_kw = CONVERT_CASES[case]
    _ntuples(tmp_path / "root", np.random.default_rng(len(case)), dsids, **ntuple_kw)
    calls = rootnative.native_calls["final_jets_native"]
    got = root2h5.convert(str(tmp_path / "root"), str(tmp_path / "port"), **kwargs)
    assert rootnative.native_calls["final_jets_native"] == calls + 1
    want = jax_root2h5.convert(str(tmp_path / "root"), str(tmp_path / "jax"),
                               **dict(kwargs, n_workers=1))
    assert os.path.basename(got) == os.path.basename(want)
    _same_files(got, want, backend == "h5py")


def test_reading_functions_match_jax(tmp_path):
    _ntuples(tmp_path, np.random.default_rng(2), {"361023": [70, 40]}, max_const=30)
    folder = ["user.sim.361023.ntuples"]
    pairs = root2h5.get_files(str(tmp_path), folder)
    assert pairs == jax_root2h5.get_files(str(tmp_path), folder)
    assert root2h5.count_constituents(pairs) == jax_root2h5.count_constituents(pairs)
    table = root2h5.id_weights("topo-dijet")
    var_list = root2h5.SCALARS + root2h5.JET_VAR + root2h5.OTHERS
    got = root2h5.read_root_files(pairs, var_list, "topo-dijet", table, 12)
    want = jax_root2h5.read_root_files(pairs, var_list, "topo-dijet", table, 12)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes()


def _merge_inputs(folder, rng):
    """Three converted-style inputs of different widths and dtypes, written
    by h5py as the JAX package's convert writes them."""
    folder.mkdir()
    for i, n in enumerate([37, 53, 41]):
        with h5py.File(folder / f"in_{i}.h5", "w") as f:
            f.create_dataset("constituents", data=rng.normal(size=(n, 8 + 4 * i))
                             .astype(np.float16), compression="lzf")
            f.create_dataset("weights", data=np.full(n, i, np.float32), compression="lzf")
            f.create_dataset("rljet_n_constituents", data=rng.integers(1, 9, n).astype(np.int32),
                             compression="lzf")
            f.create_dataset("JZW", data=np.full(n, i, np.int8), compression="lzf")


@pytest.mark.parametrize("n_files", [1, 4])
def test_file_processing_matches_jax(tmp_path, backend, n_files):
    _merge_inputs(tmp_path / "port", np.random.default_rng(4))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    got = file_processing(str(tmp_path / "port"), n_constituents=4, n_files=n_files)
    want = jax_merge(str(tmp_path / "jax"), n_constituents=4, n_files=n_files)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax")
    _same_files(got, want, backend == "h5py")
    assert sorted(os.listdir(tmp_path / "port" / "merging")) == ["merging.h5"]
    with h5py.File(got) as f:
        assert f["constituents"].dtype == np.float16 and f["rljet_n_constituents"].dtype == np.uint8
    # a re-run in the same folder sweeps up neither the merged file nor stale parts
    (tmp_path / "port" / "merging" / "part_07.h5").write_bytes(b"stale")
    got = file_processing(str(tmp_path / "port"), n_constituents=4, n_files=3)
    want = jax_merge(str(tmp_path / "jax"), n_constituents=4, n_files=3)
    _same_files(got, want, backend == "h5py")


def test_cli_flags_match_jax():
    def flags(parser):
        return sorted((a.dest, tuple(a.option_strings), repr(a.default), repr(a.choices),
                       repr(a.nargs)) for a in parser._actions)
    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())


def test_etl_chain_matches_jax(tmp_path, backend, capsys):
    """ntuples -> cli/etl.py (convert) -> --merging ON -> load_data with
    cuts and constituents, each package on its own copy."""
    _ntuples(tmp_path / "root", np.random.default_rng(6),
             {"361024": [150, 120], "361025": [110]})
    outputs = {}
    for package, main in (("port", cli.main), ("jax", jax_cli.main)):
        h5_dir = tmp_path / package
        for tag in ("1", "2"):
            assert main(["--sample_type", "topo-dijet", "--tag", tag, "--input_path",
                         str(tmp_path / "root"), "--output_path", str(h5_dir)]) == 0
        assert main(["--merging", "ON", "--input_path", str(h5_dir)]) == 0
        outputs[package] = str(h5_dir / "merging" / "merging.h5")
    assert "Merged into:" in capsys.readouterr().out
    _same_files(outputs["port"], outputs["jax"], backend == "h5py")
    args = ((0, 330), ['(sample["m"] >= 0.5)'], 20, 3, "ON")
    hlvs = dict(hlv_list=["rljet_Tau1_wta", "rljet_Tau2_wta", "rljet_Tau3_wta", "pt", "m",
                          "tau21", "tau32"], verbose=False)
    got = load_data(outputs["port"], *args, **hlvs, device=CPU)
    want = jax_load_data(outputs["jax"], *args, **hlvs)
    assert set(got) == set(want) and len(got["m"]) > 200
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got["constituents"], want["constituents"])
