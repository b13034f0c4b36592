"""Tree-source adapters: one protocol over uproot and the built-in reader.

The reference reads ntuples exclusively through uproot
(ref tools/root_utils.py:31-52); this module keeps that capability when
uproot is installed and otherwise uses :mod:`atlasvae_torch.etl.rootio`, so the
full conversion pipeline is executable (and tested) in environments
without uproot.

Constituent branches: ATLAS stores ``vector<vector<float>>`` (per
event: one list per R=1.0 jet); the reference always takes the leading
jet's list (``n[0]``, ref tools/root_utils.py:42-43).  ``leading_list``
returns exactly that — a list of 1-D arrays, one per entry — from
either backend: rootio reads STL TBranchElement branches natively, and
also accepts counter-jagged leaf-list trees (already one list per
entry).
"""

import numpy as np

from . import rootio


def pad_leading(jets, n_const):
    """Zero-pad/truncate a list of per-entry 1-D arrays to a dense
    ``(n_entries, n_const)`` float64 block (ref tools/root_utils.py:42-46
    semantics; the generic row-by-row fallback — RootIOSource overrides
    with a vectorized columnar version)."""
    out = np.zeros((len(jets), n_const), np.float64)
    for i, v in enumerate(jets):
        k = min(len(v), n_const)
        out[i, :k] = v[:k]
    return out


class RootIOSource:
    """Backed by the built-in minimal ROOT reader (rootio subset files)."""

    backend = "rootio"

    def __init__(self, path, tree="nominal"):
        self._tree = rootio.read_tree(path, tree)
        self.num_entries = self._tree.num_entries

    def keys(self):
        return [k for k in self._tree.keys() if not k.startswith("N_")]

    def __contains__(self, key):
        return key in self._tree

    def scalar(self, key):
        arr = self._tree.array(key)
        if isinstance(arr, list):
            raise TypeError(f"{key} is jagged; use leading_list")
        return np.asarray(arr)

    def leading_list(self, key):
        arr = self._tree.array(key)
        if not isinstance(arr, list):
            # a flat branch read as per-entry singletons
            return [np.atleast_1d(v) for v in np.asarray(arr)]
        if arr and isinstance(arr[0], list):
            # vector<vector<T>>: leading jet (ref tools/root_utils.py:43)
            return [np.asarray(e[0], np.float64) if len(e) else np.zeros(0)
                    for e in arr]
        return arr

    def leading_padded(self, key, n_const):
        """Padded leading-jet block, computed columnar: one fancy-index
        scatter from the branch's (flat, outer, inner) jagged decode
        instead of a Python loop over entries — the consumer-side half
        of the native basket decoder's speedup (root2h5 pads every
        constituent branch this way, ref tools/root_utils.py:42-46)."""
        flat, outer, inner = self._tree.array_jagged(key)
        if outer is None:                    # flat branch: singletons
            out = np.zeros((len(flat), n_const), np.float64)
            if n_const > 0:
                out[:, 0] = np.asarray(flat, np.float64)
            return out
        outer = np.asarray(outer, np.int64)
        n = len(outer)
        if inner is not None:
            # vector<vector<T>>: the leading inner vector per entry
            if len(inner) == 0:
                lens = offs = np.zeros(n, np.int64)
            else:
                vec_starts = np.cumsum(inner) - inner
                first = np.cumsum(outer) - outer   # entry's 1st inner vec
                has = outer > 0
                safe = np.minimum(first, len(inner) - 1)
                lens = np.where(has, inner[safe], 0)
                offs = np.where(has, vec_starts[safe], 0)
        else:                                # the entry's own vector
            lens = outer
            offs = np.cumsum(outer) - outer
        # inconsistent counts (e.g. a lying leafcount branch) must not
        # index past the flat data: clamp like the row loop, whose
        # np.split views came up short and zero-padded silently
        offs = np.minimum(offs, len(flat))
        lens = np.minimum(lens, len(flat) - offs)
        k = np.minimum(lens, n_const).astype(np.int64)
        out = np.zeros((n, n_const), np.float64)
        tot = int(k.sum())
        if tot:
            rows = np.repeat(np.arange(n), k)
            cols = np.arange(tot) - np.repeat(np.cumsum(k) - k, k)
            out[rows, cols] = flat[np.repeat(offs, k) + cols]
        return out


class UprootSource:
    """Backed by uproot, handling the raw ATLAS ``vector<vector<float>>``
    layout (ref tools/root_utils.py:35-49 semantics)."""

    backend = "uproot"

    def __init__(self, path, tree="nominal"):
        import uproot
        self._file = uproot.open(path)
        self._tree = self._file[tree]
        self.num_entries = self._tree.num_entries

    def keys(self):
        return list(self._tree.keys())

    def __contains__(self, key):
        return key in set(self._tree.keys())

    def scalar(self, key):
        arr = self._tree[key].array(library="np")
        return np.reshape(np.asarray(arr), (len(arr),))

    def leading_list(self, key):
        arr = self._tree[key].array(library="np")
        out = []
        for entry in arr:
            entry = np.asarray(entry, object) if not isinstance(
                entry, np.ndarray) else entry
            if entry.dtype == object or entry.ndim > 1:
                # vector<vector<float>>: leading jet (ref root_utils.py:43)
                out.append(np.asarray(entry[0], np.float64)
                           if len(entry) else np.zeros(0))
            else:
                out.append(np.asarray(entry, np.float64))
        return out

    def leading_padded(self, key, n_const):
        return pad_leading(self.leading_list(key), n_const)


def open_tree(path, tree="nominal", backend="auto"):
    """Open ``path`` and return a tree source.

    backend: 'auto' (uproot if importable, else rootio), 'uproot',
    or 'rootio'.  Overridable via ``ATLASVAE_ROOT_BACKEND``.
    """
    import os
    backend = os.environ.get("ATLASVAE_ROOT_BACKEND", backend)
    if backend == "uproot":
        return UprootSource(path, tree)
    if backend == "rootio":
        return RootIOSource(path, tree)
    try:
        import uproot  # noqa: F401
        return UprootSource(path, tree)
    except ImportError:
        return RootIOSource(path, tree)
