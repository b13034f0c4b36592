"""``atlasvae_torch/data/hdf5.py``'s ``LiteFile`` against h5py, both ways, on
the part of HDF5 that Keras weight files use: nested groups, ``a/b/c``
paths, attributes (fixed-length byte strings, scalar and 1-D, numeric
arrays and scalars, the empty ``weight_names`` Keras 2 writes for a layer
with no weights; variable-length strings and null dataspaces read), ``:0``
dataset names, groups with many links (several B-tree leaves in h5py's
files) and attributes in continuation blocks.  Data files written the old
way come out byte for byte the same (a hash pinned from the writer before
groups and attributes existed).
"""

import hashlib

import h5py
import numpy as np
import pytest

from atlasvae_torch.data import hdf5

# sha256 of _data_file's and of an empty file's bytes as the flat-file
# writer wrote them before groups and attributes were added
OLD_WRITER_SHA256 = {
    "data": "796bc31ac4808671eaf2bba182d525b3ef875f5f98d54f1547894cc796d74d1b",
    "empty": "6a06caa6285473f3981108b7e161743aada4274ccb0496ec436ad6409be8e534",
}


def _data_file(path):
    rng = np.random.default_rng(2024)
    arrays = {f"col{i:02d}": rng.normal(size=50).astype(np.float32) for i in range(16)}
    arrays.update(constituents=rng.normal(size=(50, 12)).astype(np.float32),
                  f8=rng.normal(size=(2, 3, 4)), i4=np.arange(5, dtype=np.int32),
                  i8=np.arange(3, dtype=np.int64), empty=np.zeros(0, np.float32))
    with hdf5.LiteFile(path, "w") as f:
        for key, val in arrays.items():
            f.create_dataset(key, data=val)
        grown = f.create_dataset("grown", shape=(0,), maxshape=(None,), dtype=np.float32)
        grown.resize((4,))
        grown[:] = np.arange(4)


def test_data_files_are_byte_for_byte_the_old_writers(tmp_path):
    _data_file(tmp_path / "data.h5")
    with hdf5.LiteFile(tmp_path / "empty.h5", "w"):
        pass
    for name, want in OLD_WRITER_SHA256.items():
        got = hashlib.sha256((tmp_path / f"{name}.h5").read_bytes()).hexdigest()
        assert got == want, name


def _keras2_like(f):
    """A Keras 2 legacy weight file's shape, through any writer with h5py's
    interface."""
    f.attrs["layer_names"] = np.array([b"input_1", b"encoder", b"dropout"])
    f.attrs["backend"] = np.bytes_(b"tensorflow")
    f.attrs["keras_version"] = np.bytes_(b"2.11.0")
    f.attrs["sizes"] = np.arange(6, dtype=np.int64).reshape(2, 3)
    f.attrs["rate"] = np.float64(0.1)
    for layer in ("input_1", "dropout"):
        f.create_group(layer).attrs["weight_names"] = np.array([])
    g = f.create_group("encoder")
    names = [b"autoencoder/encoder/dense/kernel:0", b"autoencoder/encoder/dense/bias:0"]
    g.attrs["weight_names"] = np.array(names, dtype="S64")
    rng = np.random.default_rng(7)
    g.create_dataset(names[0].decode(), data=rng.normal(size=(12, 8)).astype(np.float32))
    g.create_dataset(names[1].decode(), data=rng.normal(size=8).astype(np.float32))
    d = f.create_dataset("scalars/step", data=np.int32(5))
    d.attrs["unit"] = np.bytes_(b"steps")
    d.attrs["bounds"] = np.array([0.5, 1.5], np.float32)


def _same_value(got, want):
    if isinstance(want, h5py.Empty):
        want = hdf5.Empty(want.dtype)
    assert type(got) is type(want), (got, want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _same_tree(lite, ref):
    """Every link, attribute and dataset of ``lite`` as h5py reads ``ref``,
    in h5py's order."""
    assert list(lite.keys()) == list(ref.keys())
    assert list(lite.attrs.keys()) == list(ref.attrs.keys())
    for key in ref.attrs:
        _same_value(lite.attrs[key], ref.attrs[key])
    for (name, item), (ref_name, ref_item) in zip(lite.items(), ref.items()):
        assert name == ref_name
        assert hdf5.is_group(item) == isinstance(ref_item, h5py.Group)
        if hdf5.is_group(item):
            _same_tree(item, ref_item)
            continue
        assert item.shape == ref_item.shape and item.dtype == ref_item.dtype
        _same_value(np.asarray(item), np.asarray(ref_item))
        _same_value(item[()], ref_item[()])
        assert list(item.attrs.keys()) == list(ref_item.attrs.keys())
        for key in ref_item.attrs:
            _same_value(item.attrs[key], ref_item.attrs[key])


def test_lite_writes_groups_and_attributes_that_h5py_reads(tmp_path):
    path = tmp_path / "lite.h5"
    with hdf5.LiteFile(path, "w") as f:
        _keras2_like(f)
    with h5py.File(path, "r") as ref, hdf5.LiteFile(path) as lite:
        assert ref.attrs["backend"] == np.bytes_(b"tensorflow")
        assert ref.attrs["layer_names"].dtype == np.dtype("S7")
        assert ref["dropout"].attrs["weight_names"].shape == (0,)
        assert ref["scalars/step"][()] == 5 and ref["scalars/step"].shape == ()
        _same_tree(lite, ref)
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        _keras2_like(f)
    with h5py.File(tmp_path / "h5py.h5", "r") as ref, h5py.File(path, "r") as lite:
        _same_tree(lite, ref)


def test_lite_reads_what_h5py_writes(tmp_path):
    """Nested groups, a group of 300 links (h5py's symbol-table nodes hold 8,
    so its B-tree has two levels), 60 attributes on one group (some in
    continuation blocks), variable-length strings, a null dataspace."""
    path = tmp_path / "h5py.h5"
    with h5py.File(path, "w") as f:
        _keras2_like(f)
        f.attrs["vlen"] = "tensorflow"            # h5py writes a str variable-length
        f.attrs["vlen_bytes"] = b"2.11.0"         # ... and a bytes scalar too
        f.attrs["nothing"] = h5py.Empty("f4")
        many = f.create_group("many")
        for i in range(300):
            many.create_dataset(f"layer_{i}/vars/0", data=np.full((2, i % 3 + 1), i, np.float32))
        for i in range(60):
            many.attrs[f"attr_{i}"] = np.arange(i + 1, dtype=np.int32)
    with h5py.File(path, "r") as ref, hdf5.LiteFile(path) as lite:
        assert lite.attrs["vlen"] == "tensorflow" and lite.attrs["vlen_bytes"] == "2.11.0"
        assert lite.attrs["nothing"] == hdf5.Empty("f4")
        assert len(lite["many"]) == 300 and "many/layer_299/vars/0" in lite
        _same_tree(lite, ref)


def test_paths_and_refusals(tmp_path):
    path = tmp_path / "paths.h5"
    with hdf5.LiteFile(path, "w") as f:
        f.create_dataset("a/b/kernel:0", data=np.ones(3, np.float32))
        assert hdf5.is_group(f) and hdf5.is_group(f["a"]) and hdf5.is_group(f["/a/b"])
        assert not hdf5.is_group(f["a/b/kernel:0"]) and "a/b/bias:0" not in f
        with pytest.raises(ValueError, match="already exists"):
            f.create_group("a/b")
        with pytest.raises(ValueError, match="is a dataset"):
            f.create_dataset("a/b/kernel:0/x", data=np.ones(1))
        with pytest.raises(TypeError, match="byte strings"):
            f.attrs["name"] = "str"
    with hdf5.LiteFile(path) as f:
        assert f.get("a/missing") is None
        with pytest.raises(KeyError, match="missing"):
            f["a/missing"]
        with pytest.raises(ValueError, match="not open for writing"):
            f.attrs["x"] = 1
    # a dtype outside the subset: refused when the dataset is made
    with hdf5.LiteFile(tmp_path / "complex.h5", "w") as f:
        with pytest.raises(TypeError, match="LiteFile stores"):
            f.create_dataset("c", data=np.ones(2, np.complex64))
        assert "c" not in f


def test_file_falls_back_to_lite_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setattr(hdf5, "_h5py", None)
    with hdf5.File(tmp_path / "x.h5", "w") as f:
        assert isinstance(f, hdf5.LiteFile)
        f.create_dataset("g/x", data=np.arange(3.0))
    with hdf5.File(tmp_path / "x.h5") as f:
        assert isinstance(f, hdf5.LiteFile) and hdf5.is_group(f["g"])
        np.testing.assert_array_equal(f["g/x"][:], np.arange(3.0))


# ---------------------------------------------------------------- the data files
# The reference's data files and the JAX ETL's are chunked and lzf-compressed,
# with float16, int8 and uint8 datasets; the machine with the card has no h5py.
# tests/fixtures/h5py_*.h5 were written by h5py 3.14 (HDF5 1.14.6) through
# tests/hdf5_fixtures.py (`python tests/hdf5_fixtures.py`: the JAX package's
# own convert + file_processing on 280 seeded jets, then chunked datasets made
# with h5py: gzip+shuffle, a resized maxshape=(None, 3) dataset with unwritten
# chunks, with and without a fill value, an lzf chunk stored raw under its
# filter-mask bit, edge chunks on two axes, one lzf dataset of each integer
# type); h5py_fixtures.npz holds their arrays as h5py read them.

FIXTURES = __import__("os").path.join(__import__("os").path.dirname(__file__), "fixtures")
FIXTURE_ARRAYS = np.load(f"{FIXTURES}/h5py_fixtures.npz")
DTYPES = ["f2", "f4", "f8", "i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8"]


def _sample(rng, dtype, shape):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.normal(scale=100, size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("key", sorted(FIXTURE_ARRAYS.files))
def test_lite_reads_the_h5py_fixtures_bit_equal(key):
    name, dataset = key.split("/")
    want = FIXTURE_ARRAYS[key]
    with hdf5.LiteFile(f"{FIXTURES}/{name}") as f, h5py.File(f"{FIXTURES}/{name}") as ref:
        assert ref[dataset].chunks is not None            # every fixture dataset is chunked
        got = f[dataset][()]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        half = len(want) // 2
        assert f[dataset][half - 3:half + 40].tobytes() == want[half - 3:half + 40].tobytes()


def test_fixtures_hold_what_they_claim():
    with h5py.File(f"{FIXTURES}/h5py_etl_merged.h5") as f:
        assert f["constituents"].dtype == np.float16 and f["constituents"].compression == "lzf"
        assert f["rljet_n_constituents"].dtype == np.uint8 and f["JZW"].dtype == np.int8
    with h5py.File(f"{FIXTURES}/h5py_chunked.h5") as f, \
            hdf5.LiteFile(f"{FIXTURES}/h5py_chunked.h5") as lite:
        assert f["gzip_shuffle"].compression == "gzip" and f["gzip_shuffle"].shuffle
        assert f["grown"].maxshape == (None, 3)
        stored = lite["grown"]._chunks.index
        assert len(stored) < -(-f["grown"].shape[0] // f["grown"].chunks[0])   # a tail unwritten
        np.testing.assert_array_equal(lite["fill"][100:], np.full((20, 3), -1.5, np.float32))
        masks = [mask for _, _, mask, _ in lite["lzf_raw"]._chunks.index]
        assert masks == [0, 1, 0]                # the random chunk stored raw
        assert f["lzf_raw"].id.read_direct_chunk((256,))[0] == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("filters", ["lzf", "gzip_shuffle", "chunked_only", "lzf_shuffle_2d"])
def test_lite_reads_chunked_datasets_as_h5py(tmp_path, dtype, filters):
    rng = np.random.default_rng(DTYPES.index(dtype))
    shape, chunks = ((173, 7), (20, 3)) if filters == "lzf_shuffle_2d" else ((173,), (20,))
    data = _sample(rng, dtype, shape)
    data[40:100] = data[0]                       # compressible stretches too
    kwargs = {"lzf": dict(compression="lzf"),
              "gzip_shuffle": dict(compression="gzip", shuffle=True),
              "chunked_only": dict(maxshape=(None,)),
              "lzf_shuffle_2d": dict(compression="lzf", shuffle=True)}[filters]
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=chunks, **kwargs)
        f.attrs["x"] = data[:5]
    with h5py.File(path) as ref, hdf5.LiteFile(path) as lite:
        x = lite["x"]
        assert x.dtype == data.dtype and x.shape == data.shape
        for index in [(), slice(None), slice(3, 47), slice(19, 21), slice(None, None, 7),
                      slice(150, None), -2, 5, (slice(10, 90), 1) if len(shape) == 2 else 7]:
            assert x[index].tobytes() == ref["x"][index].tobytes(), index
        assert np.asarray(x).tobytes() == data.tobytes()
        assert lite.attrs["x"].dtype == data.dtype and lite.attrs["x"].tobytes() == data[:5].tobytes()


def test_a_leading_slice_decodes_only_the_chunks_it_overlaps(tmp_path):
    data = np.arange(4000, dtype=np.float32).reshape(1000, 4)
    path = tmp_path / "rows.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(100, 4), compression="lzf")
    with hdf5.LiteFile(path) as f:
        chunks = f["x"]._chunks
        np.testing.assert_array_equal(f["x"][250:420], data[250:420])
        assert chunks.decoded == 3                       # rows 200-499
        np.testing.assert_array_equal(f["x"][999], data[999])
        assert chunks.decoded == 4
        np.testing.assert_array_equal(f["x"][:], data)
        assert chunks.decoded == 14


def _nbit_dataset(f, data):
    space = h5py.h5s.create_simple(data.shape)
    plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    plist.set_chunk((10,))
    plist.set_filter(h5py.h5z.FILTER_NBIT)
    h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_INT32, space, plist).write(
        h5py.h5s.ALL, h5py.h5s.ALL, data)


@pytest.mark.parametrize("other", ["fletcher32", "scaleoffset", "nbit", "szip"])
def test_other_filters_are_refused_by_name(tmp_path, other):
    data = np.arange(40, dtype=np.int32)
    path = tmp_path / "other.h5"
    kwargs = {"fletcher32": dict(fletcher32=True), "scaleoffset": dict(scaleoffset=0),
              "szip": dict(compression="szip")}
    with h5py.File(path, "w") as f:
        if other == "nbit":
            _nbit_dataset(f, data)
        else:
            f.create_dataset("x", data=data, chunks=(10,), **kwargs[other])
    with pytest.raises(OSError, match=f"{other} filter"):
        hdf5.LiteFile(path)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lite_writes_every_dtype_for_h5py(tmp_path, dtype):
    rng = np.random.default_rng(7)
    data = _sample(rng, dtype, (9, 2))
    path = tmp_path / "w.h5"
    with hdf5.LiteFile(path, "w") as f:
        f.create_dataset("g/x", data=data)
        f.create_dataset("s", data=data[0, 0])
        f["g"].attrs["a"] = data[:, 0]
        f.attrs["scalar"] = data[1, 1]
    with h5py.File(path) as ref, hdf5.LiteFile(path) as lite:
        for got in (ref, lite):
            assert got["g/x"].dtype == data.dtype
            assert got["g/x"][()].tobytes() == data.tobytes()
            assert got["s"][()] == data[0, 0]
            assert got["g"].attrs["a"].dtype == data.dtype
            assert got["g"].attrs["a"].tobytes() == data[:, 0].tobytes()
            assert got.attrs["scalar"] == data[1, 1]


@pytest.mark.parametrize("links", [65, 130, 64 * 32 + 1])
def test_lite_writes_groups_of_more_than_64_links(tmp_path, links):
    """Several symbol-table nodes under one B-tree node, and from 2,049
    links (more than 32 nodes of 64) a B-tree of two levels."""
    path = tmp_path / "wide.h5"
    with hdf5.LiteFile(path, "w") as f:
        for i in range(links):
            f.create_dataset(f"g/d{i:05d}", data=np.full(2, i, np.int16))
        f.create_dataset("top", data=np.arange(3.0))
    with h5py.File(path) as ref, hdf5.LiteFile(path) as lite:
        assert len(ref["g"]) == links and list(ref["g"]) == [f"d{i:05d}" for i in range(links)]
        assert ref["g/d00000"][1] == 0 and ref[f"g/d{links - 1:05d}"][0] == links - 1
        assert "g/d00064" in ref and ref["g"].get(f"d{links // 2:05d}")[0] == links // 2
        _same_tree(lite, ref)


def _lzf_chunks():
    """(raw lzf chunk, its size decoded) of every chunk of the fixtures'
    lzf datasets that lzf shrank (its filter-mask bit clear)."""
    out = []
    for name in ("h5py_etl_merged.h5", "h5py_chunked.h5"):
        with h5py.File(f"{FIXTURES}/{name}") as f:
            for key in f:
                d = f[key]
                if d.compression != "lzf":
                    continue
                for i in range(d.id.get_num_chunks()):
                    info = d.id.get_chunk_info(i)
                    mask, raw = d.id.read_direct_chunk(info.chunk_offset)
                    if mask == 0:
                        out.append((raw, int(np.prod(d.chunks)) * d.dtype.itemsize))
    return out


def test_lzf_decoders_agree_with_each_other_and_h5py(tmp_path):
    from atlasvae_torch.data import lzf
    assert lzf.backend() == "native"                  # g++ is here: the C decoder builds
    rng = np.random.default_rng(9)
    pieces = [np.zeros(3000, np.uint8), np.tile(rng.integers(0, 255, 7, dtype=np.uint8), 900),
              rng.integers(0, 255, 500, dtype=np.uint8), np.arange(5000).astype(np.uint8),
              np.repeat(rng.integers(0, 4, 300, dtype=np.uint8), 37)]
    path = tmp_path / "runs.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.concatenate(pieces), compression="lzf", chunks=(4096,))
    cases = _lzf_chunks()
    with h5py.File(path) as f:
        d = f["x"]
        for start in range(0, len(d), 4096):
            mask, raw = d.id.read_direct_chunk((start,))
            if mask == 0:
                cases.append((raw, 4096))
    assert len(cases) > 20
    for raw, size in cases:
        plain, native = lzf.decompress_plain(raw, size), lzf.decompress_native(raw, size)
        assert plain == native and len(plain) == size
    with h5py.File(path) as f, hdf5.LiteFile(path) as lite:
        assert lite["x"][()].tobytes() == f["x"][()].tobytes()
    for bad in (b"\x05ab", b"\x20\x00", b"\xe0"):     # short literal, reference before the output
        for decode in (lzf.decompress_plain, lzf.decompress_native):
            with pytest.raises(ValueError, match="LZF"):
                decode(bad, 64)


@pytest.mark.parametrize("decoder", ["plain", "native"])
def test_lzf_streams_concatenate(decoder):
    """LZF back-references are relative to the output position, so the
    fixtures' chunks joined into one stream decode to their outputs joined:
    the reference-size stream that chip_smoke.py times its decoders on."""
    from atlasvae_torch.data import lzf
    decode = getattr(lzf, f"decompress_{decoder}")
    cases = _lzf_chunks()
    assert len(cases) > 20
    joined = b"".join(raw for raw, _ in cases) * 3
    size = 3 * sum(size for _, size in cases)
    assert decode(joined, size) == b"".join(lzf.decompress_plain(*c) for c in cases) * 3
