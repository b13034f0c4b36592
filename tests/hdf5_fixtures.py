"""Writes the h5py-made fixtures that ``LiteFile`` is held to where h5py is
missing (``tests/test_torch_hdf5_lite.py`` and ``chip_smoke.py``'s ``etl``
phase):

    python tests/hdf5_fixtures.py        # rewrites tests/fixtures/h5py_*

- ``h5py_etl_merged.h5``: what the JAX package's ETL writes.  Seeded ROOT
  ntuples of 150 and 130 jets (the canonical branches, 1-9 constituents)
  for the topo-dijet DSIDs 361024 and 361025, each converted by
  ``atlasvae.etl.root2h5.convert`` (lzf, int8 ``JZW``, float16
  kinematics), then shuffle-merged by ``atlasvae.etl.file_processing``
  into 3 parts and one lzf-chunked file (float16 constituents, uint8
  counts);
- ``h5py_chunked.h5``: chunked datasets made directly with h5py:
  ``gzip_shuffle`` (int32, deflate after shuffle), ``grown`` (float32,
  ``maxshape=(None, 3)``, 50 rows written, then resized to 120, so its
  last chunks are never written), ``fill`` (the same with fill value -1.5),
  ``lzf_raw`` (uint8 in chunks of 256: a random chunk that lzf cannot
  shrink is stored raw, its filter-mask bit set, between compressible
  ones), ``edges`` (float16, 250 x 40 in chunks of 64 x 16: edge chunks on
  both axes) and one lzf dataset of each of int8, uint8, int16, uint16,
  uint32, uint64, float64;
- ``h5py_fixtures.npz``: every dataset's array, keyed ``file/dataset``.
"""

import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
FILES = ("h5py_etl_merged.h5", "h5py_chunked.h5")


def _branches(rng, n):
    from atlasvae.etl.root2h5 import MEV_SCALARS, SCALARS
    out = {key: (rng.uniform(0.5, 3.0, n) * (1000.0 if key in MEV_SCALARS else 1.0))
           .astype(np.float32) for key in SCALARS}
    out["weight_mc"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    out["weight_pileup"] = rng.uniform(0.9, 1.1, n).astype(np.float32)
    out["rljet_topTag_DNN19_qqb_score"] = rng.uniform(0, 1, n).astype(np.float32)
    counts = rng.integers(1, 10, n)
    out["rljet_n_constituents"] = counts.astype(np.int32)
    out["rljet_assoc_cluster_pt"] = [rng.uniform(1e3, 2e5, c).astype(np.float32) for c in counts]
    out["rljet_assoc_cluster_eta"] = [rng.normal(0, 1, c).astype(np.float32) for c in counts]
    out["rljet_assoc_cluster_phi"] = [rng.uniform(-3, 3, c).astype(np.float32) for c in counts]
    return out


def _etl_merged(work, out_path):
    from atlasvae.etl import file_processing, rootio
    from atlasvae.etl.root2h5 import convert
    rng = np.random.default_rng(16)
    h5_dir = os.path.join(work, "h5")
    for tag, (dsid, n) in enumerate([("361024", 150), ("361025", 130)], start=1):
        ntuples = os.path.join(work, "root", f"user.sim.{dsid}.ntuples")
        os.makedirs(ntuples)
        rootio.write_tree(os.path.join(ntuples, "part._000001.root"), "nominal",
                          _branches(rng, n))
        convert(os.path.join(work, "root"), h5_dir, "topo-dijet", tag=tag, seed=tag)
    shutil.move(file_processing(h5_dir, n_files=3), out_path)


def _chunked(out_path):
    import h5py
    rng = np.random.default_rng(61)
    with h5py.File(out_path, "w") as f:
        f.create_dataset("gzip_shuffle", data=rng.integers(-1000, 1000, 500).astype(np.int32),
                         compression="gzip", shuffle=True, chunks=(64,))
        for name, fill in (("grown", None), ("fill", -1.5)):
            d = f.create_dataset(name, shape=(50, 3), maxshape=(None, 3), chunks=(16, 3),
                                 dtype=np.float32, compression="lzf", fillvalue=fill)
            d[:] = rng.normal(size=(50, 3)).astype(np.float32)
            d.resize((120, 3))
        raw = np.concatenate([np.zeros(256, np.uint8), rng.integers(0, 256, 256, dtype=np.uint8),
                              np.arange(200, dtype=np.uint8)])
        f.create_dataset("lzf_raw", data=raw, compression="lzf", chunks=(256,))
        edges = np.round(rng.normal(size=(250, 40)), 1).astype(np.float16)
        f.create_dataset("edges", data=edges, compression="lzf", chunks=(64, 16))
        for dtype in ("i1", "u1", "i2", "u2", "u4", "u8", "f8"):
            info = np.iinfo(dtype) if dtype[0] in "iu" else None
            data = (rng.integers(info.min, info.max, 300, dtype=dtype, endpoint=True)
                    if info else rng.normal(size=300))
            f.create_dataset(f"lzf_{np.dtype(dtype).name}", data=data, compression="lzf",
                             chunks=(128,))


def build(out_dir=FIXTURES):
    import h5py
    with tempfile.TemporaryDirectory() as work:
        _etl_merged(work, os.path.join(out_dir, FILES[0]))
    _chunked(os.path.join(out_dir, FILES[1]))
    arrays = {}
    for name in FILES:
        with h5py.File(os.path.join(out_dir, name), "r") as f:
            for key in f:
                arrays[f"{name}/{key}"] = f[key][()]
    np.savez_compressed(os.path.join(out_dir, "h5py_fixtures.npz"), **arrays)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    build()
