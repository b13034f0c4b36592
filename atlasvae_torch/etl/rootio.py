"""Minimal ROOT-format TTree I/O (no uproot/PyROOT dependency).

The reference ETL reads ATLAS ntuples with ``uproot``
(ref tools/root_utils.py:16-52); neither the port's test machine nor the
H100 machine has uproot, so the port carries its own implementation of the ROOT on-disk
container, re-derived from the public format documentation (the TFile
format description in ROOT's io docs and the layout documented by the
uproot project).  Nothing here is copied from the reference (which
contains no ROOT-format code at all — it delegates to uproot).

Scope (documented subset, enough for the ATLAS ntuple surface the
reference uses):

* TFile small-format (version < 1000000) header / TKey records /
  TDirectory / keys list, with zlib ("ZL"), lz4 ("L4", XXH64-checksummed
  blocks) or zstd ("ZS") record compression — see ``rootcodec``; "XZ"
  (lzma) is additionally readable.  Malformed input (truncation, corrupt
  streams, bad checksums, unknown codecs) raises the named
  ``RootIOError`` family, never a bare struct/zlib error.
* Leaf-list TTrees: flat branches of float32/float64/int32/int64/int16/
  int8/uint8, and counter-jagged branches (``var[N_var]/F`` style with a
  TLeafI count leaf).
* STL-container TBranchElement branches holding ``vector<T>`` and
  ``vector<vector<T>>`` — the raw ATLAS constituent layout (one list per
  R=1.0 jet per event, ref tools/root_utils.py:42-43).  Entries are
  streamed object-wise: a 6-byte bytecount+version header on the outer
  vector, ``int32`` element count, then each inner ``vector<T>`` as a
  bare count+data block (no per-element header) — the layout uproot
  interprets as ``AsVector(True, AsVector(False, dtype))``.  The
  member-wise variant (version flag ``0x4000`` plus a 2-byte inner class
  version) is read and can be written for round-trip coverage.
* Class versions follow ROOT 6.22/6.24 (TTree v20, TBranch v13,
  TLeaf v2).  Readability by real ROOT/uproot is designed-for and
  covered by a cross-check test of the JAX package's copy that runs
  whenever uproot is importable (tests/test_etl.py); without uproot,
  correctness is established by byte-level format assertions plus
  writer->reader round-trips, and the port's copy is held to the JAX
  package's byte for byte (tests/test_torch_rootio.py).

Writer: :func:`write_tree`.  Reader: :class:`RootFile` / :func:`read_tree`.
"""

import struct

import numpy as np

from . import rootnative
from .rootcodec import (RootIOError, TruncatedFileError, CorruptRecordError,
                        compress_record, decompress_record)

# ---------------------------------------------------------------- constants
MAGIC = b"root"
FILE_VERSION = 62406            # ROOT 6.24/06-style version stamp
BEGIN = 100
K_BYTE_COUNT_MASK = 0x40000000
K_NEW_CLASS_TAG = 0xFFFFFFFF
K_CLASS_MASK = 0x80000000
K_MAP_OFFSET = 2
DATIME = ((2026 - 1995) << 26) | (1 << 22) | (1 << 17)  # fixed 2026-01-01
KEY_FIXED = 26      # nbytes(4) ver(2) objlen(4) datime(4) keylen(2) cycle(2)
#                     seekkey(4) seekpdir(4) — small-file TKey fixed part

# leaf class name, struct format, numpy dtype per supported kind
_LEAF = {
    "f4": ("TLeafF", ">f4"), "f8": ("TLeafD", ">f8"),
    "i4": ("TLeafI", ">i4"), "i8": ("TLeafL", ">i8"),
    "i2": ("TLeafS", ">i2"), "i1": ("TLeafB", ">i1"),
    # unsigned kinds share the signed leaf class + fIsUnsigned flag and
    # a lowercase title code, as in real ROOT
    "u1": ("TLeafB", ">u1"), "u2": ("TLeafS", ">u2"),
    "u4": ("TLeafI", ">u4"), "u8": ("TLeafL", ">u8"),
}
_LEAF_CODE = {"f4": "F", "f8": "D", "i4": "I", "i8": "L",
              "i2": "S", "i1": "B",
              "u1": "b", "u2": "s", "u4": "i", "u8": "l"}
# class -> SIGNED base kind; Leaf.dtype upgrades via fIsUnsigned
_LEAF_BY_CLASS = {v[0]: k for k, v in _LEAF.items()
                  if not k.startswith("u")}

# STL element typenames (ROOT spelling, with the "> >" nested-template
# space) <-> numpy kinds, for vector<T> / vector<vector<T>> branches
_STL_TYPE = {"f4": "float", "f8": "double", "i4": "int", "i8": "Long64_t",
             "i2": "short", "i1": "char", "u1": "unsigned char",
             "u2": "unsigned short", "u4": "unsigned int",
             "u8": "ULong64_t"}
_STL_KIND = {v: k for k, v in _STL_TYPE.items()}
_STL_KIND.update({"Int_t": "i4", "Float_t": "f4", "Double_t": "f8",
                  "long long": "i8", "long": "i8",
                  "UInt_t": "u4", "UShort_t": "u2",
                  "unsigned long long": "u8", "unsigned long": "u8",
                  "bool": "u1", "Bool_t": "u1",
                  "Short_t": "i2", "Char_t": "i1", "UChar_t": "u1"})
K_MEMBERWISE = 0x4000           # kStreamedMemberWise flag on the version


def _parse_stl(classname):
    """'vector<vector<float> >' -> (depth, element np.dtype)."""
    name = classname.replace(" >", ">").strip()
    depth = 0
    while name.startswith("vector<") and name.endswith(">"):
        name = name[len("vector<"):-1].strip()
        depth += 1
    kind = _STL_KIND.get(name)
    if depth not in (1, 2) or kind is None:
        raise NotImplementedError(f"unsupported STL branch type {classname!r}")
    return depth, np.dtype(f">{kind}")


def _tstring(s):
    b = s.encode() if isinstance(s, str) else s
    if len(b) < 255:
        return struct.pack(">B", len(b)) + b
    return struct.pack(">BI", 255, len(b)) + b


def _read_tstring(buf, pos):
    if pos >= len(buf):
        raise TruncatedFileError(
            f"buffer ends before a TString length byte at offset {pos}")
    n = buf[pos]
    pos += 1
    if n == 255:
        if pos + 4 > len(buf):
            raise TruncatedFileError(
                f"buffer ends inside a long-form TString length at "
                f"offset {pos}")
        n = struct.unpack_from(">I", buf, pos)[0]
        pos += 4
    if pos + n > len(buf):
        raise TruncatedFileError(
            f"TString at offset {pos} promises {n} bytes, only "
            f"{len(buf) - pos} present (truncated file?)")
    try:
        return buf[pos:pos + n].decode(), pos + n
    except UnicodeDecodeError as e:
        raise CorruptRecordError(
            f"TString at offset {pos} is not valid UTF-8 ({e})") from e


def _bc(body):
    """Byte-count-framed blob: u32 (len | mask) prefix."""
    return struct.pack(">I", len(body) | K_BYTE_COUNT_MASK) + body


def _versioned(version, members):
    return _bc(struct.pack(">h", version) + members)


def _tobject():
    # fVersion, fUniqueID, fBits (kIsOnHeap|kNotDeleted)
    return struct.pack(">hII", 1, 0, 0x03000000)


def _tnamed(name, title):
    return _versioned(1, _tobject() + _tstring(name) + _tstring(title))


def _objarray(blobs, name=""):
    body = _tobject() + _tstring(name) + struct.pack(">ii", len(blobs), 0)
    return _versioned(3, body + b"".join(blobs))


def _iofeatures():
    # bc + v1 + 4 reserved bytes + fIOBits
    return _versioned(1, b"\x00\x00\x00\x00" + struct.pack(">B", 0))


class _Writer:
    """Accumulates the file image; records object positions for refs."""

    def __init__(self, compression="zlib"):
        if compression not in (None, "zlib", "lz4", "zstd"):
            raise ValueError(f"unsupported write compression {compression!r};"
                             f" use 'zlib', 'lz4', 'zstd' or None")
        self.image = bytearray(b"\x00" * BEGIN)
        self.compression = compression
        self.keys = []          # raw key headers, for the keys-list record

    # -- records ------------------------------------------------------------
    def _key_header(self, nbytes, objlen, keylen, cycle, seek, seekpdir,
                    classname, name, title, trailer=b""):
        return (struct.pack(">ihIIhh", nbytes, 4, objlen, DATIME, keylen,
                            cycle)
                + struct.pack(">ii", seek, seekpdir)
                + _tstring(classname) + _tstring(name) + _tstring(title)
                + trailer)

    def add_record(self, classname, name, title, payload, trailer=b"",
                   cycle=1, compress=None, seekpdir=BEGIN):
        """Write one TKey record; returns (seek, nbytes, keylen)."""
        seek = len(self.image)
        keylen = (KEY_FIXED + len(_tstring(classname)) + len(_tstring(name))
                  + len(_tstring(title)) + len(trailer))
        objlen = len(payload)
        body = payload
        codec = (self.compression if compress is None
                 else (self.compression or "zlib") if compress else None)
        if codec and objlen > 128:
            comp = compress_record(payload, codec)
            if len(comp) < objlen:
                body = comp
        nbytes = keylen + len(body)
        header = self._key_header(nbytes, objlen, keylen, cycle, seek,
                                  seekpdir, classname, name, title, trailer)
        assert len(header) == keylen
        self.image += header + body
        return seek, nbytes, keylen

    def finish(self, fname, title, seekinfo, nbytesinfo):
        """Keys-list record, TFile/TDirectory record patch, file header."""
        nkeys_payload = struct.pack(">i", len(self.keys)) + b"".join(self.keys)
        seekkeys, nbyteskeys, _ = self.add_record(
            "TFile", fname, title, nkeys_payload, compress=False)
        # first record at BEGIN: TFile name/title + TDirectoryFile
        strings = _tstring(fname) + _tstring(title)
        keylen = (KEY_FIXED + len(_tstring("TFile")) + len(_tstring(fname))
                  + len(_tstring(title)))
        nbytesname = keylen + len(strings)
        dirbytes = struct.pack(">hIIiiiii", 5, DATIME, DATIME, nbyteskeys,
                               nbytesname, BEGIN, 0, seekkeys)
        payload = strings + dirbytes
        header = self._key_header(keylen + len(payload), len(payload), keylen,
                                  1, BEGIN, 0, "TFile", fname, title)
        self.image[BEGIN:BEGIN + len(header) + len(payload)] = header + payload
        end = len(self.image)
        hdr = (MAGIC + struct.pack(">iiiiiii", FILE_VERSION, BEGIN, end, 0, 0,
                                   0, nbytesname)
               + struct.pack(">B", 4) + struct.pack(">i", 101)
               + struct.pack(">ii", seekinfo, nbytesinfo)
               + struct.pack(">h", 1) + b"\x00" * 16)
        self.image[:len(hdr)] = hdr

    def reserve_first_record(self, fname, title):
        keylen = (KEY_FIXED + len(_tstring("TFile")) + len(_tstring(fname))
                  + len(_tstring(title)))
        strings = _tstring(fname) + _tstring(title)
        size = keylen + len(strings) + 30
        self.image += b"\x00" * (BEGIN + size - len(self.image))


def _normalise(arr):
    """-> (kind, flat values >dtype, counts or None)."""
    if isinstance(arr, np.ndarray) and arr.dtype != object and arr.ndim == 1:
        kind = arr.dtype.str[1:]
        if kind not in _LEAF:
            kind = {"f2": "f4", "b1": "u1"}.get(kind, "f8")
        return kind, np.asarray(arr, f">{kind}"), None
    # jagged: sequence of per-entry 1-D arrays
    parts = [np.atleast_1d(np.asarray(a)) for a in arr]
    kind = parts[0].dtype.str[1:] if parts else "f4"
    if kind not in _LEAF:
        kind = "f4" if parts and parts[0].dtype.kind == "f" else "i4"
    flat = (np.concatenate(parts).astype(f">{kind}") if parts
            else np.zeros(0, f">{kind}"))
    counts = np.array([len(p) for p in parts], ">i4")
    return kind, flat, counts


def _is_doubly_jagged(arr):
    """True when ``arr`` is a per-entry sequence of LISTS of arrays (or
    2-D arrays) — the vector<vector<T>> shape; plain jagged entries are
    1-D arrays / scalar lists."""
    if isinstance(arr, np.ndarray) and arr.dtype != object:
        # a regular (n, j, k) ndarray is uniform-multiplicity vv data
        # (each entry a 2-D matrix); (n, k) is uniform singly-jagged
        return arr.ndim >= 3
    for entry in arr:
        if isinstance(entry, np.ndarray):
            if entry.ndim >= 2 or entry.dtype == object:
                return True
            if entry.size:        # non-empty 1-D array: singly jagged
                return False
            continue              # empty: ambiguous, look further
        if isinstance(entry, (list, tuple)):
            if len(entry) > 0:
                return np.ndim(entry[0]) >= 1
            continue              # empty list: ambiguous, look further
        return False
    return False


def _normalise_vv(arr):
    """-> (kind, list of per-entry lists of 1-D element arrays)."""
    entries, kind = [], None
    for e in arr:
        inner = [np.atleast_1d(np.asarray(v)) for v in e]
        if kind is None and inner:
            k = inner[0].dtype.str[1:]
            kind = k if k in _STL_TYPE else (
                "f4" if inner[0].dtype.kind == "f" else "i4")
        entries.append(inner)
    return kind or "f4", entries


def _leaf_element_blob(name, title):
    """TLeafElement v1: TLeaf base + fID=-1 + fType=0 (whole object)."""
    base = _tnamed(name, title) + struct.pack(">iiiBB", 1, 0, 0, 0, 0)
    base += struct.pack(">I", 0)                    # null fLeafCount
    return _versioned(1, _versioned(2, base) + struct.pack(">ii", -1, 0))


def _leaf_blob(classname, name, title, length, lentype, signed_range,
               leafcount_ref, maximum, version=1, unsigned=False):
    base = _tnamed(name, title) + struct.pack(
        ">iiiBB", length, lentype, 0, 1 if signed_range else 0,
        1 if unsigned else 0)
    base += (struct.pack(">I", leafcount_ref) if leafcount_ref
             else struct.pack(">I", 0))
    base = _versioned(2, base)
    if classname == "TLeafF":
        tail = struct.pack(">ff", 0, maximum)
    elif classname == "TLeafD":
        tail = struct.pack(">dd", 0, maximum)
    elif classname == "TLeafL":
        tail = struct.pack(">qq", 0, int(maximum))
    elif classname == "TLeafS":
        tail = struct.pack(">hh", 0, int(maximum))
    elif classname == "TLeafB":
        tail = struct.pack(">bb", 0, int(maximum))
    else:
        tail = struct.pack(">ii", 0, int(maximum))
    return _versioned(version, base + tail)


def _obj_any_new(classname, blob):
    """Object written with explicit class info (kNewClassTag form)."""
    body = (struct.pack(">I", K_NEW_CLASS_TAG) + classname.encode() + b"\x00"
            + blob)
    return struct.pack(">I", len(body) | K_BYTE_COUNT_MASK) + body


def write_tree(path, treename, branches, title="", compression="zlib",
               basket_entries=20000, stl_memberwise=False,
               stl_branches=()):
    """Write ``branches`` (dict name -> 1-D array; list of per-entry
    arrays for jagged data; list of per-entry LISTS of arrays — or 2-D
    arrays — for raw-ATLAS ``vector<vector<T>>`` data) as a TTree in a
    new ROOT file.

    ``compression``: 'zlib' (default), 'lz4' (XXH64-checksummed LZ4
    blocks), 'zstd' (requires the ``zstandard`` package) or None.

    ``stl_memberwise`` streams STL entries with the member-wise version
    flag (round-trip coverage for that layout).  Names in
    ``stl_branches`` force singly-jagged data into ``vector<T>``
    TBranchElement form instead of the default counter-jagged leaf
    list."""
    w = _Writer(compression)
    fname = path.split("/")[-1]
    w.reserve_first_record(fname, title)

    norm, counters, stl = {}, {}, {}
    for name, arr in branches.items():
        if _is_doubly_jagged(arr):
            kind, entries = _normalise_vv(arr)
            stl[name] = (kind, entries,
                         f"vector<vector<{_STL_TYPE[kind]}> >", 2)
            continue
        if name in stl_branches:
            parts = [np.atleast_1d(np.asarray(v)) for v in arr]
            k = parts[0].dtype.str[1:] if parts else "f4"
            if k not in _STL_TYPE:
                k = "f4" if parts and parts[0].dtype.kind == "f" else "i4"
            stl[name] = (k, parts, f"vector<{_STL_TYPE[k]}>", 1)
            continue
        kind, flat, counts = _normalise(arr)
        norm[name] = (kind, flat, counts)
        if counts is not None:
            counters[name] = f"N_{name}"
    n_entries = ({len(v[1]) if v[2] is None else len(v[2])
                  for v in norm.values()}
                 | {len(v[1]) for v in stl.values()})
    assert len(n_entries) == 1, "branches must share the entry count"
    n_entries = n_entries.pop()

    # ---- baskets (data records first, like ROOT's streaming writer)
    baskets = {}        # branch -> list of (seek, nbytes, entry0, n)

    def _write_basket(bname, payload, border, entry0, nev, nevbufsize,
                      offsets=None):
        if offsets is not None:
            payload = (payload + struct.pack(">i", nev)
                       + np.asarray(offsets, ">i4").tobytes())
        keylen = (KEY_FIXED + len(_tstring("TBasket")) + len(_tstring(bname))
                  + len(_tstring(treename)) + 19)
        trailer = struct.pack(">hiiiiB", 3, len(payload) + keylen, nevbufsize,
                              nev, keylen + border, 0)
        seek, nbytes, _ = w.add_record("TBasket", bname, treename, payload,
                                       trailer=trailer)
        baskets.setdefault(bname, []).append((seek, nbytes, entry0, nev))

    order = []
    for name in branches:
        if name in counters:
            order.append(counters[name])
        order.append(name)

    for name, (kind, flat, counts) in norm.items():
        itemsize = np.dtype(f">{kind}").itemsize
        if counts is None:
            for e0 in range(0, max(n_entries, 1), basket_entries):
                nev = min(basket_entries, n_entries - e0)
                if nev <= 0 and n_entries > 0:
                    break
                data = flat[e0:e0 + nev].tobytes()
                _write_basket(name, data, len(data), e0, nev, itemsize)
                if n_entries == 0:
                    break
        else:
            cname = counters[name]
            starts = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
            for e0 in range(0, max(n_entries, 1), basket_entries):
                nev = min(basket_entries, n_entries - e0)
                if nev <= 0 and n_entries > 0:
                    break
                cdata = counts[e0:e0 + nev].tobytes()
                _write_basket(cname, cdata, len(cdata), e0, nev, 4)
                lo, hi = starts[e0], starts[e0 + nev]
                data = flat[lo:hi].tobytes()
                keylen = (KEY_FIXED + len(_tstring("TBasket"))
                          + len(_tstring(name)) + len(_tstring(treename)) + 19)
                offs = keylen + (starts[e0:e0 + nev] - lo) * itemsize
                _write_basket(name, data, len(data), e0, nev, 0,
                              offsets=offs)
                if n_entries == 0:
                    break

    for name, (kind, entries, _classname, depth) in stl.items():
        dtype = np.dtype(f">{kind}")
        keylen = (KEY_FIXED + len(_tstring("TBasket")) + len(_tstring(name))
                  + len(_tstring(treename)) + 19)
        for e0 in range(0, max(n_entries, 1), basket_entries):
            nev = min(basket_entries, n_entries - e0)
            if nev <= 0 and n_entries > 0:
                break
            blobs, offs, pos = [], [], 0
            for entry in entries[e0:e0 + nev]:
                if depth == 1:
                    v = np.asarray(entry, dtype)
                    body = struct.pack(">i", len(v)) + v.tobytes()
                else:
                    body = struct.pack(">i", len(entry)) + b"".join(
                        struct.pack(">i", len(v))
                        + np.asarray(v, dtype).tobytes()
                        for v in entry)
                if stl_memberwise:
                    head = struct.pack(">hh", 6 | K_MEMBERWISE, 6)
                else:
                    head = struct.pack(">h", 6)
                blob = (struct.pack(
                    ">I", (len(head) + len(body)) | K_BYTE_COUNT_MASK)
                    + head + body)
                offs.append(keylen + pos)
                blobs.append(blob)
                pos += len(blob)
            payload = b"".join(blobs)
            _write_basket(name, payload, len(payload), e0, nev, 0,
                          offsets=offs)
            if n_entries == 0:
                break

    # ---- TTree record ------------------------------------------------------
    # Build the payload tracking byte positions so leaf-count references
    # use the ROOT map convention (position of the object's byte-count
    # word + fKeylen + kMapOffset).
    tree_title = title or treename
    keylen_tree = (KEY_FIXED + len(_tstring("TTree")) + len(_tstring(treename))
                   + len(_tstring(tree_title)))

    leaf_pos = {}           # branch name -> map position of its leaf

    def _branch_blob(bname, kind, jagged_counter, counts, base_offset,
                     stl_class=None):
        """Serialized TBranch v13; registers its leaf position."""
        cls, _ = _LEAF[kind]
        code = _LEAF_CODE[kind]
        itemsize = np.dtype(f">{kind}").itemsize
        if stl_class is not None:
            cls, is_counter, leaf_title = "TLeafElement", False, bname
        elif bname in counters.values():
            leaf_title = f"{bname}/I"
            cls, is_counter = "TLeafI", True
        else:
            is_counter = False
            leaf_title = (f"{bname}[{jagged_counter}]/{code}"
                          if jagged_counter else f"{bname}/{code}")
        bk = baskets.get(bname, [])
        nb = len(bk)
        maxb = nb + 1
        has_offsets = stl_class or (jagged_counter and not is_counter)
        head = _tnamed(bname, leaf_title) + _versioned(
            2, struct.pack(">hh", 0, 1001))
        head += struct.pack(">iiii", 1, 32000,
                            1000 if has_offsets else 0,
                            nb)
        head += struct.pack(">q", sum(b[3] for b in bk))
        head += _iofeatures()
        head += struct.pack(">iii", 0, maxb, 0)
        tot = sum(b[1] for b in bk)
        head += struct.pack(">qqqq", n_entries, 0, tot, tot)
        head += _objarray([])                      # fBranches
        # fLeaves: one leaf, full object form; record its map position
        pre = base_offset + len(head)
        arr_head = (struct.pack(">I", 0)  # placeholder for bc, fixed below
                    + struct.pack(">h", 3) + _tobject() + _tstring("")
                    + struct.pack(">ii", 1, 0))
        leaf_map_pos = pre + len(arr_head) + keylen_tree + K_MAP_OFFSET
        maximum = 0
        cnt_ref = 0
        if jagged_counter and not is_counter:
            cnt_ref = leaf_pos[jagged_counter]
        if is_counter and counts is not None and len(counts):
            maximum = int(counts.max())
        if stl_class is not None:
            leaf = _obj_any_new(cls, _leaf_element_blob(bname, leaf_title))
        else:
            leaf = _obj_any_new(
                cls, _leaf_blob(cls, bname, leaf_title, 1, itemsize,
                                is_counter, cnt_ref, maximum,
                                unsigned=kind.startswith("u")))
        leaf_pos[bname] = leaf_map_pos
        arr_body = (struct.pack(">h", 3) + _tobject() + _tstring("")
                    + struct.pack(">ii", 1, 0) + leaf)
        head += _bc(arr_body)
        head += _objarray([])                      # fBaskets
        head += b"\x01" + np.array([b[1] for b in bk] + [0] * (maxb - nb),
                                   ">i4").tobytes()
        entries = [b[2] for b in bk] + [n_entries] + [0] * (maxb - nb - 1)
        head += b"\x01" + np.array(entries, ">i8").tobytes()
        head += b"\x01" + np.array([b[0] for b in bk] + [0] * (maxb - nb),
                                   ">i8").tobytes()
        head += _tstring("")
        return _versioned(13, head)

    payload = bytearray()
    payload += _tnamed(treename, tree_title)
    payload += _versioned(2, struct.pack(">hhh", 602, 1, 1))
    payload += _versioned(2, struct.pack(">hh", 0, 1001))
    payload += _versioned(2, struct.pack(">hhf", 1, 1, 1.0))
    payload += struct.pack(">qqqqq", n_entries, 0, 0, 0, 0)
    payload += struct.pack(">d", 1.0)
    payload += struct.pack(">iiiii", 0, 25, 0, 1000, 0)
    payload += struct.pack(">qqqqqq", 1000000000, 1000000000, 0, -300000000,
                           0, 1000000)
    payload += b"\x01" + b"\x01"                   # empty cluster arrays
    payload += _iofeatures()

    # fBranches TObjArray with full branch objects
    arr_prefix = (struct.pack(">h", 3) + _tobject() + _tstring("")
                  + struct.pack(">ii", len(order), 0))
    # position where branch objects start, within the full payload:
    # bc(4)+ver(2) of TTree + current payload + bc(4) of objarray + prefix
    blobs = []
    base = 4 + 2 + len(payload) + 4 + len(arr_prefix)
    for bname in order:
        if bname in stl:
            kind, _, classname, _depth = stl[bname]
            # members of the embedded TBranch start after: bc(4) +
            # newclass tag(4) + "TBranchElement\0"(15) + outer bc(4) +
            # outer version(2) + inner bc(4) + inner version(2)
            obj_head = 4 + 4 + len(b"TBranchElement\x00") + 4 + 2 + 4 + 2
            branch = _branch_blob(bname, kind, None, None, base + obj_head,
                                  stl_class=classname)
            # TBranchElement v10 members after the TBranch base:
            # fClassName, fParentName, fClonesName, fCheckSum,
            # fClassVersion(short), fID=-1, fType=0, fStreamerType=-1,
            # fMaximum, fBranchCount/fBranchCount2 (null)
            extra = (_tstring(classname) + _tstring("") + _tstring("")
                     + struct.pack(">Ih", 0, 6)
                     + struct.pack(">iiii", -1, 0, -1, 0)
                     + struct.pack(">II", 0, 0))
            blob = _obj_any_new("TBranchElement",
                                _versioned(10, branch + extra))
            blobs.append(blob)
            base += len(blob)
            continue
        if bname in counters.values():
            src = next(k for k, v in counters.items() if v == bname)
            kind, _, counts = "i4", None, norm[src][2]
            jc = None
        else:
            kind, _, counts = norm[bname]
            jc = counters.get(bname)
        # members start after: bc(4) + newclass tag(4) + "TBranch\0"(8)
        # + inner bc(4) + version(2)
        obj_head = 4 + 4 + len(b"TBranch\x00") + 4 + 2
        blob = _branch_blob(bname, kind, jc, counts, base + obj_head)
        blob = _obj_any_new("TBranch", blob)
        blobs.append(blob)
        base += len(blob)
    payload += _bc(arr_prefix + b"".join(blobs))

    # fLeaves: references to the leaves registered above
    lrefs = b"".join(struct.pack(">I", leaf_pos[b]) for b in order)
    payload += _bc(struct.pack(">h", 3) + _tobject() + _tstring("")
                   + struct.pack(">ii", len(order), 0) + lrefs)
    payload += struct.pack(">I", 0)                # fAliases
    payload += struct.pack(">i", 0)                # fIndexValues TArrayD
    payload += struct.pack(">i", 0)                # fIndex TArrayI
    payload += struct.pack(">I", 0)                # fTreeIndex
    payload += struct.pack(">I", 0)                # fFriends
    tree_payload = _versioned(20, bytes(payload))

    seek, nbytes, kl = w.add_record("TTree", treename, tree_title,
                                    tree_payload)
    assert kl == keylen_tree
    w.keys.append(w._key_header(nbytes, len(tree_payload), kl, 1, seek,
                                BEGIN, "TTree", treename, tree_title))

    si_payload = _versioned(5, _tobject() + _tstring("") +
                            struct.pack(">i", 0))
    seekinfo, nbytesinfo, _ = w.add_record("TList", "StreamerInfo",
                                           "Doubly linked list", si_payload,
                                           compress=False)
    w.finish(fname, title, seekinfo, nbytesinfo)
    with open(path, "wb") as f:
        f.write(w.image)
    return path


# ======================================================================
# Reader
# ======================================================================

class _Cursor:
    def __init__(self, buf, pos=0, origin=0):
        self.buf, self.pos, self.origin = buf, pos, origin
        self.refs = {}

    def field(self, fmt):
        val = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return val

    def fields(self, fmt):
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals

    def tstring(self):
        s, self.pos = _read_tstring(self.buf, self.pos)
        return s

    def cstring(self):
        end = self.buf.find(b"\x00", self.pos)
        if end < 0:
            raise CorruptRecordError(
                f"unterminated C string at offset {self.map_pos(self.pos)}")
        try:
            s = self.buf[self.pos:end].decode()
        except UnicodeDecodeError as e:
            raise CorruptRecordError(
                f"C string at offset {self.map_pos(self.pos)} is not valid "
                f"UTF-8 ({e})") from e
        self.pos = end + 1
        return s

    def bytecount(self):
        bc = self.field(">I")
        if not bc & K_BYTE_COUNT_MASK:
            raise CorruptRecordError(
                f"expected byte-count framing at offset "
                f"{self.map_pos(self.pos - 4)}, got 0x{bc:08x}")
        return (bc & ~K_BYTE_COUNT_MASK), self.pos

    def versioned(self):
        bc, start = self.bytecount()
        ver = self.field(">h")
        return ver, start + bc  # (version, end position)

    def map_pos(self, at):
        return at - self.origin + K_MAP_OFFSET


def _decompress(body, objlen, context=""):
    if len(body) == objlen:
        return body
    return decompress_record(body, objlen, context)


class _Key:
    __slots__ = ("nbytes", "objlen", "keylen", "seek", "classname", "name",
                 "title", "cycle", "trailer_pos")

    @classmethod
    def parse(cls, buf, pos):
        k = cls()
        if pos < 0 or pos + 18 > len(buf):
            raise TruncatedFileError(
                f"file ends inside a TKey header at offset {pos} "
                f"(file/buffer length {len(buf)})")
        (k.nbytes, version, k.objlen, _, k.keylen,
         k.cycle) = struct.unpack_from(">ihIIhh", buf, pos)
        if k.nbytes <= 0 or k.keylen <= 0:
            raise CorruptRecordError(
                f"TKey at offset {pos} has impossible sizes "
                f"(nbytes={k.nbytes}, keylen={k.keylen})")
        p = pos + 18
        seek_len = 16 if version > 1000 else 8
        if p + seek_len > len(buf):
            raise TruncatedFileError(
                f"file ends inside the TKey seek fields at offset {p}")
        if version > 1000:
            k.seek = struct.unpack_from(">q", buf, p)[0]
            p += 16
        else:
            k.seek = struct.unpack_from(">i", buf, p)[0]
            p += 8
        k.classname, p = _read_tstring(buf, p)
        k.name, p = _read_tstring(buf, p)
        k.title, p = _read_tstring(buf, p)
        k.trailer_pos = p
        return k

    def payload(self, buf):
        if self.seek + self.nbytes > len(buf):
            raise TruncatedFileError(
                f"{self.classname} record {self.name!r} promises bytes "
                f"[{self.seek}, {self.seek + self.nbytes}) but the file has "
                f"only {len(buf)} (truncated file?)")
        body = buf[self.seek + self.keylen:self.seek + self.nbytes]
        return _decompress(body, self.objlen,
                           f"{self.classname} record {self.name!r} at "
                           f"offset {self.seek}")


class Leaf:
    def __init__(self, classname, name, title, length, lentype, leafcount,
                 maximum, unsigned=False):
        self.classname, self.name, self.title = classname, name, title
        self.length, self.lentype = length, lentype
        self.leafcount, self.maximum = leafcount, maximum
        self.unsigned = unsigned

    @property
    def dtype(self):
        kind = _LEAF_BY_CLASS[self.classname]
        if self.unsigned and kind.startswith("i"):
            kind = "u" + kind[1:]       # fIsUnsigned (TLeaf streamer)
        return np.dtype(">" + kind)


class Branch:
    def __init__(self, name, title, entry_offset_len, leaves, basket_seeks,
                 basket_bytes, basket_entries, entries):
        self.name, self.title = name, title
        self.entry_offset_len = entry_offset_len
        self.leaves = leaves
        self.basket_seeks, self.basket_bytes = basket_seeks, basket_bytes
        self.basket_entries, self.entries = basket_entries, entries
        self.element_class = None       # set for TBranchElement (STL)


def _read_object_any(c, readers):
    first = c.field(">I")
    if first == 0:
        return None
    if not first & K_BYTE_COUNT_MASK:
        return c.refs.get(first) or c.refs.get(first - K_MAP_OFFSET)
    start = c.pos - 4
    end = c.pos + (first & ~K_BYTE_COUNT_MASK)
    tag = c.field(">I")
    if tag == K_NEW_CLASS_TAG:
        classname = c.cstring()
    elif tag & K_CLASS_MASK:
        classname = c.refs.get(tag & ~K_CLASS_MASK)
        if classname is None:
            classname = c.refs.get((tag & ~K_CLASS_MASK) - K_MAP_OFFSET)
    else:
        raise ValueError("unparseable object tag")
    if tag == K_NEW_CLASS_TAG:
        c.refs[c.map_pos(start + 4)] = classname  # class registered here
    obj = readers[classname](c) if classname in readers else None
    for key in (c.map_pos(start), c.map_pos(start) - K_MAP_OFFSET):
        c.refs[key] = obj
    c.pos = end
    return obj


def _skip_versioned(c):
    _, end = c.versioned()
    c.pos = end


def _read_tnamed(c):
    _, end = c.versioned()
    c.fields(">hII")
    name, title = c.tstring(), c.tstring()
    c.pos = end
    return name, title


def _read_leaf(c, classname):
    _, end = c.versioned()
    _, base_end = c.versioned()
    name, title = _read_tnamed(c)
    length, lentype, _ = c.fields(">iii")
    _, is_unsigned = c.fields(">BB")     # fIsRange, fIsUnsigned
    leafcount = _read_object_any(c, _LEAF_READERS)
    c.pos = base_end
    if classname in ("TLeafF",):
        _, maximum = c.fields(">ff")
    elif classname == "TLeafD":
        _, maximum = c.fields(">dd")
    elif classname == "TLeafL":
        _, maximum = c.fields(">qq")
    elif classname == "TLeafS":
        _, maximum = c.fields(">hh")
    elif classname == "TLeafB":
        _, maximum = c.fields(">bb")
    else:
        _, maximum = c.fields(">ii")
    c.pos = end
    return Leaf(classname, name, title, length, lentype, leafcount, maximum,
                unsigned=bool(is_unsigned))


def _read_leaf_element(c):
    """TLeafElement v1: TLeaf base + fID + fType."""
    _, end = c.versioned()
    _, base_end = c.versioned()
    name, title = _read_tnamed(c)
    length, lentype, _ = c.fields(">iii")
    c.fields(">BB")
    leafcount = _read_object_any(c, _LEAF_READERS)
    c.pos = end
    return Leaf("TLeafElement", name, title, length, lentype, leafcount, 0)


_LEAF_READERS = {n: (lambda c, n=n: _read_leaf(c, n))
                 for n in ("TLeafF", "TLeafD", "TLeafI", "TLeafL", "TLeafS",
                           "TLeafB", "TLeafO")}
_LEAF_READERS["TLeafElement"] = _read_leaf_element


def _read_objarray(c, readers):
    _, end = c.versioned()
    c.fields(">hII")
    c.tstring()
    size, _ = c.fields(">ii")
    out = [_read_object_any(c, readers) for _ in range(size)]
    c.pos = end
    return out


def _read_branch(c):
    ver, end = c.versioned()
    name, title = _read_tnamed(c)
    _skip_versioned(c)                               # TAttFill
    _, _, entry_offset_len, write_basket = c.fields(">iiii")
    c.field(">q")                                    # fEntryNumber
    if ver >= 13:
        _skip_versioned(c)                           # fIOFeatures
    _, max_baskets, _ = c.fields(">iii")
    entries, _, _, _ = c.fields(">qqqq")
    _read_objarray(c, _BRANCH_READERS)               # sub-branches
    leaves = _read_objarray(c, _LEAF_READERS)
    _read_objarray(c, {})                            # fBaskets (empty)
    c.pos += 1
    basket_bytes = np.frombuffer(c.buf, ">i4", max_baskets, c.pos).copy()
    c.pos += 4 * max_baskets + 1
    basket_entry = np.frombuffer(c.buf, ">i8", max_baskets, c.pos).copy()
    c.pos += 8 * max_baskets + 1
    basket_seek = np.frombuffer(c.buf, ">i8", max_baskets, c.pos).copy()
    c.pos += 8 * max_baskets
    c.tstring()
    c.pos = end
    nb = write_basket
    return Branch(name, title, entry_offset_len, leaves, basket_seek[:nb],
                  basket_bytes[:nb], basket_entry[:nb + 1], entries)


def _read_branch_element(c):
    """TBranchElement: TBranch base + STL/class members.  The branch's
    ``element_class`` drives STL decoding in :meth:`Tree.array`."""
    ver, end = c.versioned()
    br = _read_branch(c)
    classname = c.tstring()
    c.tstring()                                      # fParentName
    c.tstring()                                      # fClonesName
    c.field(">I")                                    # fCheckSum
    c.field(">h" if ver >= 10 else ">i")             # fClassVersion
    c.fields(">iiii")                                # fID/fType/fStreamer/fMax
    _read_object_any(c, _BRANCH_READERS)             # fBranchCount
    _read_object_any(c, _BRANCH_READERS)             # fBranchCount2
    c.pos = end
    br.element_class = classname
    return br


_BRANCH_READERS = {"TBranch": _read_branch,
                   "TBranchElement": _read_branch_element}


def _split_by_counts(flat, counts):
    """Slice ``flat`` into len(counts) consecutive views (the fast
    equivalent of ``np.split(flat, np.cumsum(counts)[:-1])`` for large
    piece counts)."""
    out, s = [], 0
    for c in counts.tolist():
        out.append(flat[s:s + c])
        s += c
    return out


def _decode_stl_py(payload, starts, depth, dtype):
    """Pure-Python decode of one basket's STL entries — the fallback
    when the native decoder (etl/rootnative.py) is unavailable.
    -> (flat values, outer counts, inner counts | None)."""
    isz = dtype.itemsize
    segs, outer, inner = [], [], []
    for start in starts.tolist():
        pos = int(start) + 4                     # skip bytecount word
        ver = struct.unpack_from(">h", payload, pos)[0]
        pos += 2
        if ver & K_MEMBERWISE:
            pos += 2                             # inner class version
        n = struct.unpack_from(">i", payload, pos)[0]
        pos += 4
        if n < 0:
            # match the native decoder: np.frombuffer would treat ANY
            # negative count as "all remaining bytes" — silent garbage
            raise ValueError(f"negative element count {n} in STL entry")
        if depth == 1:
            arr = np.frombuffer(payload, dtype, n, pos)
            segs.append(arr)
            outer.append(len(arr))
            continue
        for _ in range(n):
            m = struct.unpack_from(">i", payload, pos)[0]
            pos += 4
            if m < 0:
                raise ValueError(
                    f"negative element count {m} in STL inner vector")
            arr = np.frombuffer(payload, dtype, m, pos)
            pos += len(arr) * isz
            segs.append(arr)
            inner.append(len(arr))
        outer.append(n)
    flat = np.concatenate(segs) if segs else np.zeros(0, dtype)
    return (flat, np.asarray(outer, np.int64),
            np.asarray(inner, np.int64) if depth == 2 else None)


class Tree:
    """Parsed TTree: branch metadata + lazy basket reads."""

    def __init__(self, buf, key):
        self.buf = buf
        payload = key.payload(buf)
        c = _Cursor(payload, origin=-key.keylen)
        ver, _ = c.versioned()
        self.name, self.title = _read_tnamed(c)
        _skip_versioned(c)                           # TAttLine
        _skip_versioned(c)                           # TAttFill
        _skip_versioned(c)                           # TAttMarker
        self.num_entries = c.field(">q")
        c.fields(">qqqq" if ver >= 16 else ">qq")
        c.field(">d")
        _, _, _, _, ncluster = c.fields(">iiiii")
        c.fields(">qqqqqq")
        c.pos += 1 + 8 * ncluster + 1 + 8 * ncluster
        if ver >= 19:
            _skip_versioned(c)                       # fIOFeatures
        branches = _read_objarray(c, _BRANCH_READERS)
        self.branches = {b.name: b for b in branches if b is not None}

    def keys(self):
        return list(self.branches)

    def __contains__(self, name):
        return name in self.branches

    def array(self, name):
        """-> np.ndarray (flat branch), list of per-entry arrays (jagged
        leaf-list or vector<T>), or list of per-entry lists of arrays
        (vector<vector<T>>)."""
        br = self.branches[name]
        # Basket payloads are untrusted bytes: corrupted trailer fields
        # (fLast, fNevBuf, element counts) surface from numpy/struct as
        # bare ValueError/struct.error — convert them to the named
        # RootIOError family at this boundary.
        try:
            if br.element_class is not None:
                return self._stl_array(br)
            return self._leaf_array(br)
        except RootIOError:
            raise
        except (ValueError, struct.error, OverflowError, IndexError) as e:
            raise CorruptRecordError(
                f"branch {name!r}: basket decode failed on malformed data "
                f"({type(e).__name__}: {e})") from e

    def _leaf_jagged(self, br):
        """Decode a flat or counter-jagged leaf-list branch to
        ``(flat values, counts | None)`` (counts None for flat)."""
        leaf = br.leaves[0]
        dtype = leaf.dtype
        jagged = (leaf.leafcount is not None
                  or (br.entry_offset_len > 0 and "[" in leaf.title))
        datas, counts = [], []
        for seek, nbytes in zip(br.basket_seeks, br.basket_bytes):
            key = _Key.parse(self.buf, seek)
            fver, fbufsize, fnevbufsize, fnevbuf, flast, _ = \
                struct.unpack_from(">hiiiiB", self.buf, key.trailer_pos)
            payload = key.payload(self.buf)
            border = flast - key.keylen
            if not 0 <= border <= len(payload):
                raise CorruptRecordError(
                    f"branch {br.name!r}: basket at offset {seek} claims "
                    f"data border {border} outside its {len(payload)}-byte "
                    f"payload (corrupt fLast?)")
            datas.append(np.frombuffer(payload, dtype,
                                       border // dtype.itemsize, 0))
            if jagged and key.objlen > border:
                off = np.frombuffer(payload, ">i4", fnevbuf, border + 4)
                starts = (off - key.keylen) // dtype.itemsize
                n = np.diff(np.append(starts,
                                      border // dtype.itemsize))
                counts.append(n)
        flat = (np.concatenate(datas) if datas
                else np.zeros(0, dtype))
        if not jagged:
            return flat, None
        if counts:
            cnt = np.concatenate(counts)
        elif leaf.leafcount is not None:
            cnt = np.asarray(self.array(leaf.leafcount.name), np.int64)
        else:
            raise ValueError(f"cannot infer entry offsets for {br.name}")
        return flat, cnt

    def _leaf_array(self, br):
        """Decode a flat or counter-jagged leaf-list branch."""
        flat, cnt = self._leaf_jagged(br)
        if cnt is None:
            return flat
        # np.split semantics: zero counts still yield one (empty) piece
        return _split_by_counts(flat, cnt) if len(cnt) else [flat]

    def _stl_jagged(self, br):
        """Decode an STL TBranchElement (vector<T> / vector<vector<T>>)
        to ``(flat values, outer counts, inner counts | None)`` without
        building per-entry objects.  Uses the native decoder
        (etl/rootnative.py) when available; the pure-Python loop
        otherwise."""
        depth, dtype = _parse_stl(br.element_class)
        flats, outers, inners = [], [], []
        for seek, nbytes in zip(br.basket_seeks, br.basket_bytes):
            key = _Key.parse(self.buf, seek)
            _, _, _, fnevbuf, flast, _ = struct.unpack_from(
                ">hiiiiB", self.buf, key.trailer_pos)
            payload = key.payload(self.buf)
            border = flast - key.keylen
            offs = np.frombuffer(payload, ">i4", fnevbuf, border + 4)
            starts = offs.astype(np.int64) - key.keylen
            res = rootnative.decode_stl_basket(payload, starts, depth,
                                               dtype)
            if res is None:
                res = _decode_stl_py(payload, starts, depth, dtype)
            flat, outer, inner = res
            flats.append(flat)
            outers.append(outer)
            if depth == 2:
                inners.append(inner)
        native = dtype.newbyteorder("=")

        def cat(parts, dt):
            # single-basket fast path: the native decoder already emits
            # native byte order, so no copy is needed; np.concatenate
            # normalizes multi-basket '>'-dtype fallback pieces.
            if not parts:
                return np.zeros(0, dt)
            if len(parts) == 1:
                return np.ascontiguousarray(parts[0], dt)
            return np.concatenate(parts).astype(dt, copy=False)

        return (cat(flats, native), cat(outers, np.int64),
                cat(inners, np.int64) if depth == 2 else None)

    def _stl_array(self, br):
        """Decode an STL TBranchElement from its basket entry offsets:
        list of per-entry arrays (vector<T>) or list of per-entry lists
        of arrays (vector<vector<T>>)."""
        flat, outer, inner = self._stl_jagged(br)
        if inner is None:
            return _split_by_counts(flat, outer)
        vecs = _split_by_counts(flat, inner)
        out, s = [], 0
        for c in outer.tolist():
            out.append(vecs[s:s + c])
            s += c
        return out

    def array_jagged(self, name):
        """-> ``(flat values, outer counts, inner counts | None)``.

        The columnar form of :meth:`array` — no per-entry Python
        objects.  STL ``vector<T>`` and counter-jagged leaf-list
        branches return (flat, counts, None); ``vector<vector<T>>``
        returns all three (inner counts are per inner vector, grouped
        by the outer counts); flat branches return (values, None, None).
        """
        br = self.branches[name]
        try:
            if br.element_class is not None:
                return self._stl_jagged(br)
            flat, cnt = self._leaf_jagged(br)
            return flat, cnt, None
        except RootIOError:
            raise
        except (ValueError, struct.error, OverflowError, IndexError) as e:
            raise CorruptRecordError(
                f"branch {name!r}: basket decode failed on malformed data "
                f"({type(e).__name__}: {e})") from e

    def arrays(self, names=None):
        names = names or self.keys()
        return {n: self.array(n) for n in names}


class RootFile:
    """Minimal TFile reader (subset documented in the module docstring)."""

    def __init__(self, path):
        # memory-map rather than slurp: only the touched baskets' pages
        # are ever read, and no resident full-file copy is held
        self._file = open(path, "rb")
        try:
            import mmap
            self.buf = mmap.mmap(self._file.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty or unmappable file
            self.buf = self._file.read()
        if self.buf[:4] != MAGIC:
            raise RootIOError(f"{path}: not a ROOT file (bad magic "
                              f"{bytes(self.buf[:4])!r}, expected b'root')")
        if len(self.buf) < 64:
            raise TruncatedFileError(
                f"{path}: only {len(self.buf)} bytes — shorter than the "
                f"ROOT file header")
        version = struct.unpack_from(">i", self.buf, 4)[0]
        big = version > 1000000
        if big:
            (begin, end) = struct.unpack_from(">iq", self.buf, 8)
            nbytesname = struct.unpack_from(">i", self.buf, 36)[0]
        else:
            begin, end, _, _, _, nbytesname = struct.unpack_from(
                ">iiiiii", self.buf, 8)
        p = begin + nbytesname
        if p + 30 > len(self.buf):
            raise TruncatedFileError(
                f"{path}: file ends before the TDirectory record at "
                f"offset {p}")
        dver = struct.unpack_from(">h", self.buf, p)[0]
        p += 2 + 8
        if dver > 1000:
            # the >iiqqq fields span 32 bytes, 2 more than the p+30
            # check above (which covers the short-form directory)
            if p + 32 > len(self.buf):
                raise TruncatedFileError(
                    f"{path}: file ends inside the big-format TDirectory "
                    f"seek fields at offset {p}")
            _, _, _, _, seekkeys = struct.unpack_from(">iiqqq", self.buf, p)
        else:
            _, _, _, _, seekkeys = struct.unpack_from(">iiiii", self.buf, p)
        keyhdr = _Key.parse(self.buf, seekkeys)
        payload = keyhdr.payload(self.buf)
        if len(payload) < 4:
            raise CorruptRecordError(
                f"{path}: keys-list record decoded to {len(payload)} "
                f"bytes, too short for its key count")
        nkeys = struct.unpack_from(">i", payload, 0)[0]
        self.keylist = []
        pos = 4
        for _ in range(nkeys):
            k = _Key.parse(payload, pos)
            pos += k.keylen
            self.keylist.append(k)

    def keys(self):
        return [(k.name, k.classname) for k in self.keylist]

    def tree(self, name=None):
        for k in self.keylist:
            if k.classname == "TTree" and (name is None or k.name == name):
                return Tree(self.buf, k)
        raise KeyError(f"no TTree named {name!r}; keys: {self.keys()}")


def read_tree(path, name=None):
    return RootFile(path).tree(name)
