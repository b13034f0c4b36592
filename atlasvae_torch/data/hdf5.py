"""HDF5 files through h5py, or through a small pure-numpy subset without it.

``File(path, mode)`` returns ``h5py.File`` where h5py is installed.  Where
it is not, it returns a ``LiteFile``: a reader and writer of the subset of
HDF5 the port's data files use -- one root group of numeric datasets
(little-endian float32/float64/int32/int64, any rank) stored contiguously.
Files it writes are standard HDF5 that h5py reads; it reads those files and
h5py-written ones of the same subset (superblock version 0, version 1
object headers, contiguous layout).  Chunked or compressed datasets need
h5py.  A ``LiteFile`` opened for writing keeps its datasets in memory
(``resize`` and slice assignment work as in h5py) and writes the file when
it is closed.

Layout written (format specification, superblock version 0): superblock
with the root symbol-table entry; the root object header with a symbol
table message; the local heap of names; one group B-tree node; one
symbol-table node holding every dataset (group leaf K = 32, so at most 64
datasets); then each dataset's object header (dataspace, datatype, fill
value, contiguous layout) followed by its raw data.
"""

import mmap
import struct

import numpy as np

try:
    import h5py as _h5py
except ImportError:  # the lite subset below takes over
    _h5py = None

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 32       # symbol-table node holds up to 2 * _LEAF_K entries
_INTERNAL_K = 16   # group B-tree nodes hold up to 2 * _INTERNAL_K children
_ENTRY = 40        # symbol-table entry size with 8-byte offsets and lengths
_BTREE_NODE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
_SNOD = 8 + 2 * _LEAF_K * _ENTRY

# numpy dtype -> (class, bit-field bytes, properties) of the datatype message
_TYPES = {
    np.dtype("<f4"): (1, bytes([0x20, 31, 0]), struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)),
    np.dtype("<f8"): (1, bytes([0x20, 63, 0]), struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)),
    np.dtype("<i4"): (0, bytes([0x08, 0, 0]), struct.pack("<HH", 0, 32)),
    np.dtype("<i8"): (0, bytes([0x08, 0, 0]), struct.pack("<HH", 0, 64)),
}


def File(path, mode="r"):
    """``h5py.File`` when h5py is installed, else ``LiteFile``."""
    if _h5py is not None:
        return _h5py.File(path, mode)
    return LiteFile(path, mode)


def _pad8(b):
    return b + b"\0" * (-len(b) % 8)


def _message(mtype, body):
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages):
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _entry(name_offset, header_addr, cache_type=0, scratch=b"\0" * 16):
    return struct.pack("<QQI4x", name_offset, header_addr, cache_type) + scratch


class LiteDataset:
    """A dataset of a ``LiteFile``: array-like reads, h5py-like writes."""

    def __init__(self, array=None, reader=None, shape=None, dtype=None):
        self._array = array
        self._reader = reader
        self.shape = tuple(array.shape) if array is not None else tuple(shape)
        self.dtype = array.dtype if array is not None else np.dtype(dtype)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, index):
        if self._array is not None:
            return np.array(self._array[index])
        return np.array(self._reader()[index])

    def __setitem__(self, index, value):
        self._array[index] = value

    def resize(self, shape):
        shape = tuple(shape)
        grown = np.zeros(shape, self.dtype)
        keep = tuple(slice(0, min(a, b)) for a, b in zip(shape, self.shape))
        grown[keep] = self._array[keep]
        self._array, self.shape = grown, shape


class LiteFile:
    """Read ("r") or write ("w") the HDF5 subset described above."""

    def __init__(self, path, mode="r"):
        if mode not in ("r", "w"):
            raise ValueError(f"LiteFile supports modes 'r' and 'w', not {mode!r}")
        self.path, self.mode = str(path), mode
        self._datasets = {}
        self._raw = None
        if mode == "r":
            self._read_index()

    # ------------------------------------------------------------ mapping
    def keys(self):
        return self._datasets.keys()

    def __iter__(self):
        return iter(self._datasets)

    def __contains__(self, name):
        return name in self._datasets

    def __getitem__(self, name):
        return self._datasets[name]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def create_dataset(self, name, shape=None, dtype=None, data=None, maxshape=None,
                       chunks=None, compression=None):
        """Like h5py's; ``maxshape``, ``chunks`` and ``compression`` are
        accepted and ignored (datasets are stored whole, uncompressed)."""
        if self.mode != "w":
            raise ValueError("file not open for writing")
        if data is not None:
            array = np.array(data, dtype=dtype)
        else:
            array = np.zeros(shape, dtype=dtype or np.float32)
        array = array.astype(array.dtype.newbyteorder("<"), copy=False)
        if array.dtype not in _TYPES:
            raise TypeError(f"LiteFile stores {sorted(map(str, _TYPES))}, not {array.dtype}")
        self._datasets[name] = LiteDataset(array)
        return self._datasets[name]

    def close(self):
        if self.mode == "w" and self._datasets is not None:
            self._write()
        elif self.mode == "r" and self._raw is not None:
            self._raw.close()
            self._raw = None
        self._datasets = None

    # ------------------------------------------------------------ writing
    def _write(self):
        names = sorted(self._datasets, key=lambda n: n.encode())
        if len(names) > 2 * _LEAF_K:
            raise ValueError(f"LiteFile writes at most {2 * _LEAF_K} datasets")
        heap = b"\0" * 8
        name_offsets = {}
        for name in names:
            name_offsets[name] = len(heap)
            heap += _pad8(name.encode() + b"\0")
        root_addr = 96
        heap_addr = root_addr + 40  # root object header: prefix + symbol table message
        heap_data_addr = heap_addr + 32
        btree_addr = heap_data_addr + len(heap)
        snod_addr = btree_addr + _BTREE_NODE
        offset = snod_addr + _SNOD
        chunks, entries = [], []
        for name in names:
            array = self._datasets[name]._array
            header_len = len(self._dataset_header(array, 0))
            header = self._dataset_header(array, offset + header_len)
            entries.append(_entry(name_offsets[name], offset))
            blob = header + _pad8(np.ascontiguousarray(array).tobytes())
            chunks.append(blob)
            offset += len(blob)
        eof = offset

        root_header = _object_header([_message(0x11, struct.pack("<QQ", btree_addr, heap_addr))])
        superblock = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
                      + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
                      + _entry(0, root_addr, 1, struct.pack("<QQ", btree_addr, heap_addr)))
        # free-list head 1 is the library's "no free block" (H5HL_FREE_NULL)
        local_heap = b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack(
            "<QQQ", len(heap), 1, heap_data_addr) + heap
        last = name_offsets[names[-1]] if names else 0
        keys_children = struct.pack("<QQQ", 0, snod_addr, last)
        btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF) + keys_children
        btree += b"\0" * (_BTREE_NODE - len(btree))
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(entries)
        snod += b"\0" * (_SNOD - len(snod))
        with open(self.path, "wb") as f:
            for part in (superblock, root_header, local_heap, btree, snod, *chunks):
                f.write(part)

    @staticmethod
    def _dataset_header(array, data_addr):
        ndim = array.ndim
        space = struct.pack("<BBBx4x", 1, ndim, 1) + \
            struct.pack(f"<{ndim}Q", *array.shape) + struct.pack(f"<{ndim}Q", *array.shape)
        cls, bits, props = _TYPES[array.dtype]
        dtype = bytes([0x10 | cls]) + bits + struct.pack("<I", array.itemsize) + props
        fill = bytes([2, 2, 2, 0])  # version 2, late allocation, write if set, no value
        addr = data_addr if array.nbytes else _UNDEF
        layout = struct.pack("<BBQQ", 3, 1, addr, array.nbytes)
        return _object_header([_message(0x1, space), _message(0x3, dtype),
                               _message(0x5, fill), _message(0x8, layout)])

    # ------------------------------------------------------------ reading
    def _read_index(self):
        with open(self.path, "rb") as f:
            raw = self._raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if raw[:8] != _SIGNATURE or raw[8] != 0 or raw[13] != 8 or raw[14] != 8:
            raise OSError(f"{self.path}: not an HDF5 file with a version-0 superblock "
                          "and 8-byte offsets; read it with h5py")
        root_header = struct.unpack_from("<Q", raw, 64)[0]
        btree_addr = heap_addr = None
        for mtype, body in self._messages(root_header):
            if mtype == 0x11:
                btree_addr, heap_addr = struct.unpack_from("<QQ", body)
        if btree_addr is None:
            raise OSError(f"{self.path}: root group has no symbol table; read it with h5py")
        if raw[heap_addr:heap_addr + 4] != b"HEAP":
            raise OSError(f"{self.path}: bad local heap")
        heap_data = struct.unpack_from("<Q", raw, heap_addr + 24)[0]
        for name_off, header in self._walk_btree(btree_addr):
            end = raw.find(b"\0", heap_data + name_off)
            name = raw[heap_data + name_off:end].decode()
            self._datasets[name] = self._open_dataset(name, header)

    def _messages(self, addr):
        raw = self._raw
        version, _, n_msgs, _, size = struct.unpack_from("<BBHII", raw, addr)
        if version != 1:
            raise OSError(f"{self.path}: object header version {version}; read it with h5py")
        blocks = [(addr + 16, size)]
        out = []
        while blocks and len(out) < n_msgs:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and len(out) < n_msgs:
                mtype, msize = struct.unpack_from("<HH", raw, pos)
                body = raw[pos + 8:pos + 8 + msize]
                if mtype == 0x10:  # continuation: more messages elsewhere
                    blocks.append(struct.unpack_from("<QQ", body))
                out.append((mtype, body))
                pos += 8 + msize
        return out

    def _walk_btree(self, addr):
        raw = self._raw
        if raw[addr:addr + 4] != b"TREE":
            raise OSError(f"{self.path}: bad B-tree node")
        _, level, used = struct.unpack_from("<BBH", raw, addr + 4)
        for i in range(used):
            child = struct.unpack_from("<Q", raw, addr + 24 + 8 + 16 * i)[0]
            if level > 0:
                yield from self._walk_btree(child)
                continue
            if raw[child:child + 4] != b"SNOD":
                raise OSError(f"{self.path}: bad symbol-table node")
            count = struct.unpack_from("<H", raw, child + 6)[0]
            for j in range(count):
                name_off, header = struct.unpack_from("<QQ", raw, child + 8 + _ENTRY * j)
                yield name_off, header

    def _open_dataset(self, name, header):
        shape = dtype = layout = None
        for mtype, body in self._messages(header):
            if mtype == 0x1:
                version, ndim, flags = body[0], body[1], body[2]
                start = 8 if version == 1 else 4
                shape = struct.unpack_from(f"<{ndim}Q", body, start)
            elif mtype == 0x3:
                cls, size = body[0] & 0x0F, struct.unpack_from("<I", body, 4)[0]
                big = body[1] & 1
                if cls == 1 and size in (4, 8):
                    dtype = np.dtype(f"{'>' if big else '<'}f{size}")
                elif cls == 0 and size in (1, 2, 4, 8):
                    signed = "i" if body[1] & 0x08 else "u"
                    dtype = np.dtype(f"{'>' if big else '<'}{signed}{size}")
            elif mtype == 0x8:
                layout = body
        if shape is None or dtype is None or layout is None or layout[0] != 3 \
                or layout[1] != 1:
            raise OSError(f"{self.path}: dataset {name!r} is not a contiguous numeric "
                          "array (chunked or compressed?); read it with h5py")
        addr = struct.unpack_from("<Q", layout, 2)[0]
        path = self.path

        def reader():
            if int(np.prod(shape)) == 0:
                return np.zeros(shape, dtype)
            return np.memmap(path, dtype, "r", offset=addr, shape=shape)

        return LiteDataset(reader=reader, shape=shape, dtype=dtype)
