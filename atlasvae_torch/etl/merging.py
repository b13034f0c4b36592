"""Shuffle-merge of per-DSID HDF5 files into one mixed dataset.

Re-implements the reference's merging flow (ref tools/merging.py:8-70):
split every input into N chunks, round-robin shuffle-mix the chunks
into N intermediate files, then append them into one output.  Chunked
I/O replaces the 10-process fan-out with sequential streaming (HDF5
writes here are disk-bound, not CPU-bound).

Every file goes through :mod:`atlasvae_torch.data.hdf5`: lzf-chunked
where h5py is installed, as the JAX package writes them, contiguous and
uncompressed through ``LiteFile`` where it is not.  The merged file is
written once, in mode ``"w"`` (``LiteFile`` has no ``"a"``): each dataset
made at its full shape, filled part by part, the parts removed after;
the rows and their order are those of the JAX package's rename-and-append.
A ``LiteFile`` writer holds the whole merged file in memory until it
closes.
"""

import os
import time

import numpy as np

from ..data import hdf5

_TYPE_DICT = {"constituents": np.float16, "rljet_n_constituents": np.uint8}


def _chunks(shape):
    return (min(10000, shape[0]),) + tuple(shape[1:]) if shape[0] else None


def mix_samples(data_path, data_files, idx_list, out_idx, n_constituents,
                merge_dir, seed=0):
    """Build intermediate file ``out_idx`` from one chunk of every input
    (ref tools/merging.py:30-54: per-key concat, zero-pad constituents to
    4*n_constituents, within-file shuffle)."""
    rng = np.random.default_rng(seed + out_idx)
    with hdf5.File(os.path.join(data_path, data_files[0]), "r") as f:
        keys = list(f.keys())
    out_name = os.path.join(merge_dir, f"part_{out_idx:02d}.h5")
    order = None
    with hdf5.File(out_name, "w") as out:
        file_order = rng.permutation(len(data_files))
        for key in keys:
            parts = []
            for in_idx in file_order:
                lo, hi = idx_list[in_idx][out_idx]
                with hdf5.File(os.path.join(data_path, data_files[in_idx]), "r") as f:
                    data = f[key][lo:hi]
                if key == "constituents" and data.shape[1] < 4 * n_constituents:
                    padded = np.zeros((len(data), 4 * n_constituents), np.float16)
                    padded[:, :data.shape[1]] = data
                    data = padded
                parts.append(data)
            sample = np.concatenate(parts)
            if order is None:
                order = np.random.default_rng(0).permutation(len(sample))
            dtype = _TYPE_DICT.get(key, sample.dtype)
            out.create_dataset(key, data=sample[order].astype(dtype),
                               compression="lzf", chunks=_chunks(sample.shape))
    return out_name


def merge_files(merge_dir, output_file=None):
    """Append all intermediate files into one (ref tools/merging.py:57-70),
    in part order.  Only the ``part_*.h5`` intermediates are merged — a
    previous run's merged output living in the same dir must never be
    picked up as an input (that silently doubles the dataset on re-runs).
    The parts are removed once the merged file is written."""
    h5_files = sorted(f for f in os.listdir(merge_dir)
                      if f.startswith("part_") and f.endswith(".h5"))
    if not h5_files:
        raise FileNotFoundError(f"no part_*.h5 intermediates in {merge_dir}")
    paths = [os.path.join(merge_dir, f) for f in h5_files]
    with hdf5.File(paths[0], "r") as first:
        layout = {key: (first[key].shape[1:], first[key].dtype) for key in first}
    sizes = []
    for path in paths:
        with hdf5.File(path, "r") as part:
            sizes.append(len(part["constituents"]))
    idx = np.concatenate([[0], np.cumsum(sizes)])
    output_file = output_file or os.path.basename(merge_dir.rstrip("/")) + ".h5"
    out_path = os.path.join(merge_dir, output_file)
    with hdf5.File(out_path, "w") as data:
        for key, (tail, dtype) in layout.items():
            shape = (int(idx[-1]),) + tuple(tail)
            data.create_dataset(key, shape, dtype=dtype, compression="lzf",
                                chunks=_chunks(shape))
        for n, path in enumerate(paths):
            with hdf5.File(path, "r") as part:
                for key in layout:
                    data[key][idx[n]:idx[n + 1]] = part[key][:]
    for path in paths:
        os.remove(path)
    return out_path


def file_processing(data_path, n_constituents="unknown", n_files=40,
                    output_file=None):
    """Full shuffle-merge (ref tools/merging.py:8-27)."""
    data_files = sorted(f for f in os.listdir(data_path) if f.endswith(".h5"))
    shapes = []
    for name in data_files:
        with hdf5.File(os.path.join(data_path, name), "r") as f:
            shapes.append(f["constituents"].shape)
    n_jets, max_components = zip(*shapes)
    if n_constituents == "unknown":
        n_constituents = max(max_components) // 4
    n_files = min(n_files, min(n_jets))
    # exactly n_files contiguous chunks per input (no dropped remainder)
    idx_list = [list(zip(b[:-1], b[1:]))
                for b in (np.linspace(0, n, n_files + 1, dtype=int) for n in n_jets)]
    merge_dir = os.path.join(data_path, "merging")
    os.makedirs(merge_dir, exist_ok=True)
    # drop intermediates from an earlier (possibly interrupted) run: a
    # stale part_NN.h5 beyond this run's n_files would be merged in
    for name in os.listdir(merge_dir):
        if name.startswith("part_") and name.endswith(".h5"):
            os.remove(os.path.join(merge_dir, name))
    start = time.time()
    for out_idx in range(n_files):
        mix_samples(data_path, data_files, idx_list, out_idx, n_constituents,
                    merge_dir)
    print(f"Mixed {n_files} intermediate files ({time.time() - start:2.1f} s)")
    return merge_files(merge_dir, output_file)
