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
    # more links than one symbol-table node holds: refused, and no file written
    with pytest.raises(ValueError, match="at most 64 a group.*h5py"):
        with hdf5.LiteFile(tmp_path / "wide.h5", "w") as f:
            for i in range(65):
                f.create_dataset(f"g/d{i}", data=np.zeros(1))
    assert not (tmp_path / "wide.h5").exists()


def test_file_falls_back_to_lite_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setattr(hdf5, "_h5py", None)
    with hdf5.File(tmp_path / "x.h5", "w") as f:
        assert isinstance(f, hdf5.LiteFile)
        f.create_dataset("g/x", data=np.arange(3.0))
    with hdf5.File(tmp_path / "x.h5") as f:
        assert isinstance(f, hdf5.LiteFile) and hdf5.is_group(f["g"])
        np.testing.assert_array_equal(f["g/x"][:], np.arange(3.0))
