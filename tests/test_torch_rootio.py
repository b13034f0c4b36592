"""The port's ROOT I/O (``atlasvae_torch.etl.rootio``, ``rootcodec``,
``rootnative``, ``source``) against the JAX package's on the same inputs.

- Writing: ``write_tree`` gives the same bytes as the JAX package's for
  every dtype, basket split, codec and STL layout its tests cover (the file
  name is part of the bytes, so both write under the same name).
- Reading: both packages read the same arrays, jagged and flat, from files
  they wrote, from the spec-assembled large-format files of
  ``rootio_spec_fixture`` (every codec, object- and member-wise) and from
  the frozen ``tests/fixtures/golden_bigfile_zlib.root`` (also against its
  ``.npz``).
- Corrupt files: both refuse the same files with the same error class and
  message (or read the same arrays where the damage misses what is read).
- Native against plain: the C++ basket decoder (``native/rootio_decode.cpp``,
  built with g++ into the port's build directory) against the port's Python
  loop, bit for bit; the fused ``final_jets_native`` bit-equal to the JAX
  package's copy of the same kernel and, against the numpy pipeline, within
  the contract the JAX package's tests state (one float16 ulp at halfway
  points, near-massless ``m_calo`` to 2e-4).
"""

import os
import shutil

import numpy as np
import pytest

from atlasvae.etl import rootio as jax_rootio, rootnative as jax_rootnative
from atlasvae.etl import source as jax_source
from atlasvae.etl.root2h5 import final_jets as jax_final_jets
from atlasvae_torch import native
from atlasvae_torch.etl import rootio, rootnative, source
from atlasvae_torch.etl.rootcodec import RootIOError
from atlasvae_torch.etl.root2h5 import final_jets
from rootio_spec_fixture import build_bigfile_fixture
from test_etl import _fixture_branches, _vvf_entries

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _cases(rng):
    """name -> (branches, write_tree keyword arguments)"""
    n = 1503
    flat = {"f32": rng.normal(size=n).astype(np.float32),
            "f64": rng.normal(size=n),
            "i32": rng.integers(-5, 5, n).astype(np.int32),
            "i64": rng.integers(0, 2**40, n).astype(np.int64),
            "i16": rng.integers(-3, 3, n).astype(np.int16),
            "i8": rng.integers(-100, 100, n).astype(np.int8),
            "u8": rng.integers(0, 255, n).astype(np.uint8),
            "jag": [rng.normal(size=c).astype(np.float32) for c in rng.integers(0, 7, n)]}
    return {
        "dtypes_baskets": (flat, dict(basket_entries=400)),
        "uncompressed_empty": ({"x": flat["f32"][:257], "jag": [np.zeros(0, np.float32)] * 257},
                               dict(compression=None)),
        "lz4": (flat, dict(compression="lz4", basket_entries=700)),
        "zstd": (flat, dict(compression="zstd")),
        "vvf_multibasket": ({"clus": _vvf_entries(rng, 803),
                             "ivv": [[rng.integers(-9, 9, m).astype(np.int32)
                                      for m in rng.integers(0, 3, k)]
                                     for k in rng.integers(0, 3, 803)],
                             "flat": rng.normal(size=803).astype(np.float32)},
                            dict(basket_entries=300)),
        "vvf_2d_entries": ({"clus": [rng.normal(size=(2, 5)).astype(np.float32) if i % 3
                                     else np.zeros((0, 5), np.float32) for i in range(40)]}, {}),
        "cube_3d": ({"c": rng.normal(size=(7, 3, 5)).astype(np.float32)}, {}),
        "memberwise": ({"c": _vvf_entries(rng, 257)}, dict(stl_memberwise=True)),
        "stl_depth1": ({"x": flat["jag"][:600],
                        "y": [rng.normal(size=c) for c in rng.integers(0, 4, 600)]},
                       dict(stl_branches=("x", "y"), basket_entries=250)),
        "canonical": (_fixture_branches(rng, 300, max_const=100), {}),
        # one basket of incompressible bytes past zlib's 24-bit frame size
        "large_basket": ({"v": [rng.random(2000) for _ in range(1100)]},
                         dict(basket_entries=1100)),
    }


CASES = list(_cases(np.random.default_rng(0)))


def _same(a, b, what):
    if isinstance(a, list) or isinstance(b, list):
        assert isinstance(a, list) and isinstance(b, list) and len(a) == len(b), what
        for u, v in zip(a, b):
            _same(u, v, what)
        return
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_trees(path, tree="nominal"):
    """Both packages read every branch of ``path`` alike; returns the port's
    tree."""
    mine, theirs = rootio.read_tree(path, tree), jax_rootio.read_tree(path, tree)
    assert mine.num_entries == theirs.num_entries and mine.keys() == theirs.keys()
    for key in theirs.keys():
        _same(mine.array(key), theirs.array(key), key)
        _same(list(mine.array_jagged(key)), list(theirs.array_jagged(key)), key)
    return mine


@pytest.mark.parametrize("case", CASES)
def test_write_tree_bytes_match_jax(tmp_path, case):
    branches, kwargs = _cases(np.random.default_rng(0))[case]
    paths = []
    for package, writer in (("port", rootio), ("jax", jax_rootio)):
        os.makedirs(tmp_path / package)
        paths.append(str(tmp_path / package / f"{case}.root"))
        writer.write_tree(paths[-1], "nominal", branches, **kwargs)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    tree = _same_trees(paths[0])
    for key, want in branches.items():
        if isinstance(want, np.ndarray) and want.ndim == 1:
            _same(np.asarray(tree.array(key)), want, key)


@pytest.mark.parametrize("codec", [None, "zlib", "lz4", "zstd", "xz"])
@pytest.mark.parametrize("memberwise", [False, True])
def test_read_tree_of_spec_assembled_files_matches_jax(tmp_path, codec, memberwise):
    path = str(tmp_path / "golden.root")
    build_bigfile_fixture(path, codec=codec, memberwise=memberwise)
    _same_trees(path)


def test_read_tree_of_frozen_fixture_matches_jax_and_npz():
    tree = _same_trees(os.path.join(FIXTURE_DIR, "golden_bigfile_zlib.root"))
    expect = np.load(os.path.join(FIXTURE_DIR, "golden_bigfile_zlib.npz"), allow_pickle=True)
    for key in ("pt", "event", "n_trk"):
        np.testing.assert_array_equal(np.asarray(tree.array(key)), expect[key])
    trk, cl = tree.array("trk_pt"), tree.array("cl")
    assert len(trk) == len(expect["trk_pt"]) and len(cl) == len(expect["cl"])
    for got, want in zip(trk, expect["trk_pt"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(cl, expect["cl"]):      # the npz keeps empty lists as object arrays
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _outcome(package, path):
    """The arrays ``package`` reads from ``path``, or its error's class
    name and message."""
    try:
        tree = package.read_tree(path, "nominal")
        return {key: tree.array(key) for key in tree.keys()}
    except (RootIOError, jax_rootio.RootIOError, KeyError) as exc:
        return type(exc).__name__, str(exc).replace(path, "<path>")


def _damaged(buf, kind, rng):
    """``kind`` of damage done to a good file's bytes."""
    if kind == "bad_magic":
        return b"NOPE" + buf[4:]
    if kind == "empty":
        return b""
    if kind == "header_only":
        return buf[:24]
    if kind == "truncated":
        return [buf[:cut] for cut in sorted(set(rng.integers(0, len(buf), 12)) |
                                            {len(buf) - 1, len(buf) - 9})]
    flips = []
    for i in rng.integers(0, len(buf), 24):
        copy = bytearray(buf)
        copy[int(i)] ^= int(rng.integers(1, 256))
        flips.append(bytes(copy))
    return flips


@pytest.mark.parametrize("kind", ["bad_magic", "empty", "header_only", "truncated", "flipped"])
def test_corrupt_files_are_refused_as_jax_refuses_them(tmp_path, kind):
    rng = np.random.default_rng(5)
    branches = {"pt": rng.uniform(0, 100, 2000).astype(np.float32),
                "trk": [rng.normal(size=c).astype(np.float32) for c in rng.integers(0, 5, 2000)],
                "vv": _vvf_entries(rng, 2000)}
    good = str(tmp_path / "ok.root")
    rootio.write_tree(good, "nominal", branches, basket_entries=512)
    damaged = _damaged(open(good, "rb").read(), kind, rng)
    path = tmp_path / "bad.root"
    refused = 0
    for data in damaged if isinstance(damaged, list) else [damaged]:
        path.write_bytes(data)
        mine, theirs = _outcome(rootio, str(path)), _outcome(jax_rootio, str(path))
        if isinstance(theirs, tuple):
            assert mine == theirs
            refused += 1
        else:
            assert isinstance(mine, dict) and mine.keys() == theirs.keys()
            for key in theirs:
                _same(mine[key], theirs[key], key)
    assert refused > 0 or kind == "flipped"


@pytest.mark.parametrize("kind", ["f4", "f8", "i4", "i8", "i2", "u1"])
@pytest.mark.parametrize("memberwise", [False, True])
def test_native_basket_decoder_matches_python(tmp_path, monkeypatch, kind, memberwise):
    rng = np.random.default_rng(11)
    entries = [[rng.integers(-50, 50, rng.integers(0, 5)).astype(kind)
                for _ in range(rng.integers(0, 3))] for _ in range(300)]
    entries[0], entries[1] = [], [np.zeros(0, kind)]
    path = str(tmp_path / "vv.root")
    rootio.write_tree(path, "nominal", {"vv": entries, "v": [e[0] if e else np.zeros(0, kind)
                                                              for e in entries]},
                      basket_entries=64, stl_memberwise=memberwise, stl_branches=("v",))
    calls = rootnative.native_calls["decode_stl_basket"]
    fast = rootio.read_tree(path, "nominal")
    got = {key: (fast.array(key), list(fast.array_jagged(key))) for key in ("vv", "v")}
    assert rootnative.native_calls["decode_stl_basket"] > calls
    monkeypatch.setattr(rootnative, "load_lib", lambda: None)
    slow = rootio.read_tree(path, "nominal")
    for key in ("vv", "v"):
        _same(got[key][0], slow.array(key), key)
        _same(got[key][1], list(slow.array_jagged(key)), key)
    _same(got["vv"][0], [[np.asarray(v) for v in e] for e in entries], "vv")


def _padded_jets(rng, n_jets, n_const):
    pt, eta, phi = (np.zeros((n_jets, n_const)) for _ in range(3))
    for i, c in enumerate(rng.integers(0, n_const + 1, n_jets)):
        pt[i, :c] = rng.uniform(1, 500, c)
        eta[i, :c] = rng.uniform(-2, 2, c)
        phi[i, :c] = rng.uniform(-3, 3, c)
    return pt, eta, phi


def _f16_ulps(a, b):
    def ordered(x):
        u = x.view(np.uint16).astype(np.int32)
        return np.where(u & 0x8000, 0x8000 - (u & 0x7FFF), 0x8000 + (u & 0x7FFF))
    return np.abs(ordered(a.ravel()) - ordered(b.ravel()))


def test_final_jets_native_matches_jax_and_numpy(monkeypatch):
    rng = np.random.default_rng(12)
    pt, eta, phi = _padded_jets(rng, 3000, 30)
    pt[17, 3] = -4.0                    # a non-positive pt is masked dead
    pt[18, :] = 0.0                     # a jet of padding only
    calls = rootnative.native_calls["final_jets_native"]
    nat = final_jets(pt, eta, phi)
    assert rootnative.native_calls["final_jets_native"] == calls + 1
    theirs = jax_rootnative.final_jets_native(pt, eta, phi)
    for key in theirs:
        assert nat[key].dtype == theirs[key].dtype and nat[key].tobytes() == theirs[key].tobytes()
    monkeypatch.setattr(rootnative, "load_lib", lambda: None)
    plain = final_jets(pt, eta, phi)
    monkeypatch.setenv("ATLASVAE_NO_NATIVE", "1")
    jax_plain = jax_final_jets(pt, eta, phi)
    for key in plain:
        assert plain[key].tobytes() == jax_plain[key].tobytes(), key
    for key in ("constituents", "E", "pt_calo"):
        ulps = _f16_ulps(nat[key], plain[key])
        assert ulps.max(initial=0) <= 1, key
        assert np.mean((ulps > 0) & (plain[key].ravel() != 0)) < 1e-4, key
    a, b = np.float64(nat["m_calo"]), np.float64(plain["m_calo"])
    apart = a != b
    assert np.abs(b[apart]).max(initial=0) < 1e-4
    np.testing.assert_allclose(a[apart], b[apart], atol=2e-4)


@pytest.mark.parametrize("layout", ["vv", "v", "leaf", "flat"])
def test_leading_padded_matches_jax(tmp_path, layout):
    rng = np.random.default_rng(13)
    n = 200
    if layout == "vv":
        data, kw = {"b": _vvf_entries(rng, n)}, {}
    elif layout in ("v", "leaf"):
        data = {"b": [rng.normal(size=c).astype(np.float32) for c in rng.integers(0, 9, n)]}
        kw = {"stl_branches": ("b",)} if layout == "v" else {}
    else:
        data, kw = {"b": rng.normal(size=n).astype(np.float32)}, {}
    path = str(tmp_path / "l.root")
    rootio.write_tree(path, "nominal", data, **kw)
    mine = source.open_tree(path, backend="rootio")
    theirs = jax_source.open_tree(path, backend="rootio")
    for n_const in (0, 3, 12):
        _same(mine.leading_padded("b", n_const), theirs.leading_padded("b", n_const), n_const)
    _same(mine.leading_list("b"), theirs.leading_list("b"), "leading_list")


def test_native_builds_once_into_the_build_dir(tmp_path, monkeypatch):
    """From many threads at once, with nothing built yet: one library, in
    the port's build directory (never beside the source), that every
    thread decodes with."""
    from concurrent.futures import ThreadPoolExecutor
    monkeypatch.setenv("ATLASVAE_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIBS", {})
    rng = np.random.default_rng(14)
    entries = _vvf_entries(rng, 50)
    path = str(tmp_path / "r.root")
    rootio.write_tree(path, "nominal", {"vv": entries}, basket_entries=16)
    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(lambda _: rootio.read_tree(path, "nominal").array("vv"),
                                range(8)))
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len(built) == 1 and built[0].startswith("librootio_decode-") and \
        built[0].endswith(".so")
    assert native.library_path("rootio_decode").parent == tmp_path / "build"
    assert not [p for p in os.listdir(os.path.dirname(native.__file__)) if p.endswith(".so")]
    for got in results:
        _same(got, [[np.asarray(v) for v in e] for e in entries], "vv")
    shutil.rmtree(tmp_path / "build")
