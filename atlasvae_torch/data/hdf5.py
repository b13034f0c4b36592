"""HDF5 files through h5py, or through a small pure-numpy subset without it.

``File(path, mode)`` returns ``h5py.File`` where h5py is installed.  Where
it is not, it returns a ``LiteFile``: a reader and writer of the subset of
HDF5 that the port's data files and Keras weight files use -- nested groups
of numeric datasets (little-endian float16/float32/float64, int8/16/32/64,
uint8/16/32/64, any rank, scalars too) and attributes on the file, its
groups and its datasets (numeric arrays and scalars of the same types,
fixed-length byte strings, scalar or 1-D; variable-length strings are read,
not written).  Files it writes are standard HDF5 that h5py reads; it reads
those files and h5py-written ones of the same subset (superblock version 0,
version 1 object headers, symbol-table groups), which is what h5py writes by
default and so what Keras 2 ``save_weights``, Keras 3 ``.weights.h5`` and
the ETL's data files hold.  It reads datasets stored contiguously and
chunked ones (a version 1 B-tree chunk index) through the filters h5py
writes for data: lzf (``data/lzf.py``, a C decoder built at first use),
deflate and shuffle, each chunk as its filter mask says (h5py's lzf is
optional: a chunk it cannot shrink is stored raw), edge chunks cropped,
unwritten chunks read as the fill value.  A leading-axis slice of a chunked
dataset decodes only the chunks it overlaps.  Other filters (fletcher32,
szip, nbit, scaleoffset) are refused by name when the file is opened.  A
``LiteFile`` opened for writing keeps its tree in memory (``resize`` and
slice assignment work as in h5py) and writes the file, contiguous and
uncompressed, when it is closed.

Paths work as in h5py: ``f["a/b/c"]`` looks a dataset up through its
groups, and ``create_dataset("encoder/dense/kernel:0", ...)`` creates the
groups on the way.  ``keys()``/``items()`` list a group in h5py's order,
by the names' bytes.  ``is_group`` is true for an ``h5py.Group`` and for a
``LiteGroup``.  Attribute values come back as h5py returns them: a
fixed-length string as ``np.bytes_`` (a 1-D one as an ``S`` array), a
variable-length one as ``str``, a numeric scalar as a numpy scalar.

Layout written (format specification, superblock version 0): superblock
with the root symbol-table entry; then each group, depth first, as its
object header (a symbol table message, then its attribute messages), the
local heap of its link names, its group B-tree nodes (the root first) and
its symbol-table nodes of up to 64 links each (group leaf K = 32; a B-tree
node takes up to 32 children, internal K = 16, and a group of more than
2,048 links gets B-tree levels above them), followed by each link in name
order: a dataset's object header (dataspace, datatype, fill value,
contiguous layout, attribute messages) and its raw data, or a subgroup laid
out the same way.  A file with only root-level datasets and no attributes
comes out byte for byte as the earlier flat-file writer wrote it.
"""

import mmap
import struct
import zlib

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
_VLEN_ELEMENT = 16  # sequence length, global heap collection address, object index

# numpy dtype -> (class, bit-field bytes, properties) of the datatype message
_FLOATS = {2: (15, (0, 16, 10, 5, 0, 10, 15)), 4: (31, (0, 32, 23, 8, 0, 23, 127)),
           8: (63, (0, 64, 52, 11, 0, 52, 1023))}   # sign bit; offset, precision, exponent, mantissa, bias
_TYPES = {np.dtype(f"<f{size}"): (1, bytes([0x20, sign, 0]), struct.pack("<HHBBBBI", *props))
          for size, (sign, props) in _FLOATS.items()}
_TYPES.update({np.dtype(f"<{kind}{size}"): (0, bytes([0x08 if kind == "i" else 0, 0, 0]),
                                            struct.pack("<HH", 0, 8 * size))
               for kind in "iu" for size in (1, 2, 4, 8)})
# filters of the filter pipeline message: those read, and the names of others
_LZF, _DEFLATE, _SHUFFLE = 32000, 1, 2
_FILTER_NAMES = {_DEFLATE: "deflate", _SHUFFLE: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset", _LZF: "lzf"}


def File(path, mode="r"):
    """``h5py.File`` when h5py is installed, else ``LiteFile``."""
    if _h5py is not None:
        return _h5py.File(path, mode)
    return LiteFile(path, mode)


def is_group(item):
    """True for a group of either library (``h5py.File`` and ``LiteFile``
    are groups too)."""
    if isinstance(item, LiteGroup):
        return True
    return _h5py is not None and isinstance(item, _h5py.Group)


class Empty:
    """An attribute with a null dataspace, as ``h5py.Empty``: a type, no
    value."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)
        self.shape = None

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


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


def _datatype(dtype):
    """Datatype message body: a numeric type of _TYPES, or a fixed-length
    null-padded ASCII string (what h5py writes for numpy ``S`` data)."""
    if dtype.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dtype.itemsize)
    cls, bits, props = _TYPES[dtype]
    return bytes([0x10 | cls]) + bits + struct.pack("<I", dtype.itemsize) + props


def _dataspace(shape):
    """Version 1 dataspace: rank 0 is a scalar; otherwise the sizes and,
    as h5py writes them, the same maximum sizes."""
    ndim = len(shape)
    if ndim == 0:
        return struct.pack("<BBBx4x", 1, 0, 0)
    return struct.pack("<BBBx4x", 1, ndim, 1) + struct.pack(f"<{ndim}Q", *shape) + \
        struct.pack(f"<{ndim}Q", *shape)


def _attribute_array(value):
    """An attribute value as the array h5py would store: byte strings as
    fixed-length ``S``, numbers as one of _TYPES (an empty list as an
    empty float64 array, as Keras 2 writes ``weight_names`` for layers
    with no weights)."""
    if isinstance(value, str) or (isinstance(value, np.ndarray) and value.dtype.kind in "UO"):
        raise TypeError("LiteFile writes byte strings, not str: encode the value "
                        "(h5py would store a str as a variable-length string)")
    array = np.asarray(value)
    if array.dtype.kind != "S":
        array = array.astype(array.dtype.newbyteorder("<"), copy=False)
        if array.dtype not in _TYPES:
            raise TypeError(f"LiteFile stores attributes of {sorted(map(str, _TYPES))} or "
                            f"byte strings, not {array.dtype}")
    return np.array(array, order="C")   # a scalar stays 0-d (ascontiguousarray would not)


def _attribute_message(name, array):
    """Version 1 attribute message (name, datatype and dataspace each
    padded to 8 bytes), as h5py writes into a version 1 object header."""
    encoded = name.encode() + b"\0"
    dtype, space = _datatype(array.dtype), _dataspace(array.shape)
    body = struct.pack("<BBHHH", 1, 0, len(encoded), len(dtype), len(space)) + \
        _pad8(encoded) + _pad8(dtype) + _pad8(space) + array.tobytes()
    return _message(0x0C, body)


class LiteAttrs:
    """The attributes of a LiteFile object: a mapping from name to value,
    in h5py's order (by the names' bytes).  Assignable where the file is
    open for writing."""

    def __init__(self, writable):
        self._writable = writable
        self._values = {}

    def __getitem__(self, name):
        value = self._values[name]
        if isinstance(value, Exception):
            raise value
        if isinstance(value, np.ndarray) and value.ndim == 0:
            return value[()]            # a scalar, as h5py returns it
        return value

    def __setitem__(self, name, value):
        if not self._writable:
            raise ValueError("file not open for writing")
        self._values[name] = _attribute_array(value)

    def __contains__(self, name):
        return name in self._values

    def __len__(self):
        return len(self._values)

    def __iter__(self):
        return iter(self.keys())

    def keys(self):
        return sorted(self._values, key=str.encode)

    def items(self):
        return [(name, self[name]) for name in self.keys()]

    def get(self, name, default=None):
        return self[name] if name in self._values else default

    def _messages(self):
        return [_attribute_message(name, self._values[name]) for name in self.keys()]


def _leading_rows(index, n):
    """``index`` on an array of ``n`` rows as (lo, hi, index into rows lo:hi),
    where its first part is an integer or a forward slice; else None."""
    parts = index if isinstance(index, tuple) else (index,)
    if not parts:
        return None
    first, rest = parts[0], parts[1:]
    if isinstance(first, (int, np.integer)) and not isinstance(first, (bool, np.bool_)):
        i = int(first) + (n if first < 0 else 0)
        if not 0 <= i < n:
            raise IndexError(f"index {int(first)} is out of range for {n} rows")
        return i, i + 1, (0,) + rest
    if isinstance(first, slice):
        start, stop, step = first.indices(n)
        if step > 0:
            stop = max(start, stop)
            return start, stop, (slice(0, stop - start, step),) + rest
    return None


class LiteDataset:
    """A dataset of a ``LiteFile``: array-like reads, h5py-like writes.  A
    chunked dataset read from a file (``chunks``, its ``_Chunks``) reads a
    leading-axis slice without the rest."""

    def __init__(self, array=None, reader=None, shape=None, dtype=None, name="", attrs=None,
                 chunks=None):
        self._array = array
        self._reader = reader
        self._chunks = chunks
        self.shape = tuple(array.shape) if array is not None else tuple(shape)
        self.dtype = array.dtype if array is not None else np.dtype(dtype)
        self.name = name
        self.attrs = attrs if attrs is not None else LiteAttrs(array is not None)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, index):
        if self._array is not None:
            value = self._array[index]
        elif self._chunks is not None:
            rows = _leading_rows(index, self.shape[0])
            if rows is None:
                value = self._chunks.read(0, self.shape[0])[index]
            else:
                lo, hi, within = rows
                value = self._chunks.read(lo, hi)[within]
        else:
            value = self._reader()[index]
        return value if isinstance(value, np.generic) else np.array(value)   # as h5py

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self[()], dtype=dtype)

    def __setitem__(self, index, value):
        self._array[index] = value

    def resize(self, shape):
        shape = tuple(shape)
        grown = np.zeros(shape, self.dtype)
        keep = tuple(slice(0, min(a, b)) for a, b in zip(shape, self.shape))
        grown[keep] = self._array[keep]
        self._array, self.shape = grown, shape


class LiteGroup:
    """A group of a ``LiteFile``: links to datasets and groups by name,
    path lookups, attributes."""

    def __init__(self, name, writable):
        self.name = name
        self._writable = writable
        self._links = {}
        self.attrs = LiteAttrs(writable)

    def keys(self):
        return sorted(self._links, key=str.encode)

    def items(self):
        return [(name, self._links[name]) for name in self.keys()]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._links)

    def _lookup(self, path):
        node = self
        for part in [p for p in str(path).split("/") if p]:
            if not isinstance(node, LiteGroup) or part not in node._links:
                return None
            node = node._links[part]
        return node

    def __contains__(self, path):
        return self._lookup(path) is not None

    def __getitem__(self, path):
        node = self._lookup(path)
        if node is None:
            raise KeyError(f"{path!r} is not in {self.name!r}")
        return node

    def get(self, path, default=None):
        node = self._lookup(path)
        return default if node is None else node

    def _parent_of(self, path):
        """The group that will hold ``path``'s last part (the groups on the
        way created, as h5py does), and that part."""
        if not self._writable:
            raise ValueError("file not open for writing")
        parts = [p for p in str(path).split("/") if p]
        if not parts:
            raise ValueError(f"empty name {path!r}")
        node = self
        for part in parts[:-1]:
            child = node._links.get(part)
            if child is None:
                child = node._links[part] = LiteGroup(f"{node.name.rstrip('/')}/{part}", True)
            elif not isinstance(child, LiteGroup):
                raise ValueError(f"{node.name.rstrip('/')}/{part} is a dataset, not a group")
            node = child
        if parts[-1] in node._links:
            raise ValueError(f"unable to create {path!r}: the name already exists")
        return node, parts[-1]

    def create_group(self, path):
        parent, name = self._parent_of(path)
        group = parent._links[name] = LiteGroup(f"{parent.name.rstrip('/')}/{name}", True)
        return group

    def create_dataset(self, path, shape=None, dtype=None, data=None, maxshape=None,
                       chunks=None, compression=None):
        """Like h5py's; ``maxshape``, ``chunks`` and ``compression`` are
        accepted and ignored (datasets are stored whole, uncompressed)."""
        parent, name = self._parent_of(path)
        if data is not None:
            array = np.array(data, dtype=dtype)
        else:
            array = np.zeros(shape, dtype=dtype or np.float32)
        array = array.astype(array.dtype.newbyteorder("<"), copy=False)
        if array.dtype not in _TYPES:
            raise TypeError(f"LiteFile stores {sorted(map(str, _TYPES))}, not {array.dtype}")
        dataset = parent._links[name] = LiteDataset(array, name=f"{parent.name.rstrip('/')}/{name}")
        return dataset


def _filter_pipeline(body):
    """[(id, name, client data)] of a filter pipeline message, versions 1
    and 2, in the order the filters were applied when writing."""
    version, count = body[0], body[1]
    if version not in (1, 2):
        raise OSError(f"filter pipeline message version {version}")
    pos = 8 if version == 1 else 2
    filters = []
    for _ in range(count):
        fid = struct.unpack_from("<H", body, pos)[0]
        if version == 1 or fid >= 256:
            name_size, _, n_values = struct.unpack_from("<HHH", body, pos + 2)
            pos += 8
        else:
            name_size = 0
            _, n_values = struct.unpack_from("<HH", body, pos + 2)
            pos += 6
        fname = bytes(body[pos:pos + name_size]).split(b"\0")[0].decode(errors="replace")
        pos += name_size + (-name_size % 8 if version == 1 else 0)
        values = struct.unpack_from(f"<{n_values}I", body, pos)
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        filters.append((fid, fname, values))
    return filters


def _fill_value(message, dtype):
    """The fill value of a fill value message (0x5, versions 1-3, or the old
    0x4) where it holds one of ``dtype``'s size, else 0."""
    if message is None:
        return 0
    mtype, body = message
    value = None
    if mtype == 0x4:
        value = body[4:4 + struct.unpack_from("<I", body)[0]]
    elif body[0] in (1, 2) and (body[0] == 1 or body[3]):
        value = body[8:8 + struct.unpack_from("<I", body, 4)[0]]
    elif body[0] == 3 and body[1] & 0x20:
        value = body[6:6 + struct.unpack_from("<I", body, 2)[0]]
    if value is None or len(value) != dtype.itemsize:
        return 0
    return np.frombuffer(bytes(value), dtype)[0]


def _unshuffle(data, size):
    """Undo the shuffle filter: byte k of every element was stored together,
    k = 0 .. size - 1; bytes past the last whole element stay as they are."""
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    head = np.frombuffer(data, np.uint8, count=n * size).reshape(size, n).T
    return head.tobytes() + bytes(data[n * size:])


class _Chunks:
    """The chunks of one chunked dataset: its chunk index (a version 1
    B-tree of type 1, walked when the file is opened), its filters, and the
    decoding of the chunks a row range overlaps.  ``decoded`` counts the
    chunks decoded so far."""

    def __init__(self, owner, name, shape, dtype, layout, filters, fill):
        rank = layout[2] - 1
        self.path, self.name = owner.path, name
        self.shape, self.dtype, self.filters, self.fill = shape, dtype, filters, fill
        self.chunk = struct.unpack_from(f"<{rank}I", layout, 11)
        element = struct.unpack_from("<I", layout, 11 + 4 * rank)[0]
        if rank != len(shape) or element != dtype.itemsize:
            raise OSError(f"{owner.path}: dataset {name!r}: its chunk layout does not "
                          "match its dataspace and datatype")
        self.nbytes = int(np.prod(self.chunk)) * dtype.itemsize
        self.decoded = 0
        self.index = []         # (offsets, stored size, filter mask, address)
        btree = struct.unpack_from("<Q", layout, 3)[0]
        raw, stack = owner._raw, ([btree] if btree != _UNDEF else [])
        key = 8 + 8 * (rank + 1)
        while stack:
            node = stack.pop()
            if raw[node:node + 4] != b"TREE" or raw[node + 4] != 1:
                raise OSError(f"{owner.path}: dataset {name!r}: bad chunk B-tree node")
            level, used = raw[node + 5], struct.unpack_from("<H", raw, node + 6)[0]
            pos = node + 24
            for _ in range(used):
                size, mask = struct.unpack_from("<II", raw, pos)
                offsets = struct.unpack_from(f"<{rank}Q", raw, pos + 8)
                child = struct.unpack_from("<Q", raw, pos + key)[0]
                pos += key + 8
                if level:
                    stack.append(child)
                else:
                    self.index.append((offsets, size, mask, child))
        self.index.sort()

    def _decode(self, stored, mask):
        data = stored
        for i in reversed(range(len(self.filters))):
            if mask >> i & 1:           # this filter was skipped for this chunk
                continue
            fid, _, values = self.filters[i]
            if fid == _LZF:
                from . import lzf
                data = lzf.decompress(data, self.nbytes)
            elif fid == _DEFLATE:
                data = zlib.decompress(data)
            else:
                data = _unshuffle(data, values[0] if values else self.dtype.itemsize)
        if len(data) != self.nbytes:
            raise OSError(f"{self.path}: dataset {self.name!r}: a chunk decoded to "
                          f"{len(data)} bytes, not {self.nbytes}")
        return np.frombuffer(data, self.dtype).reshape(self.chunk)

    def read(self, lo, hi):
        """Rows lo:hi as an array, decoding only the chunks they overlap."""
        shape, chunk = self.shape, self.chunk
        out = np.full((hi - lo,) + tuple(shape[1:]), self.fill, self.dtype)
        wanted = [c for c in self.index if c[0][0] < hi and c[0][0] + chunk[0] > lo]
        if not wanted:
            return out
        with open(self.path, "rb") as f:
            for offsets, size, mask, addr in wanted:
                f.seek(addr)
                try:
                    block = self._decode(f.read(size), mask)
                except (ValueError, zlib.error) as exc:
                    raise OSError(f"{self.path}: dataset {self.name!r}: the chunk at "
                                  f"{offsets} does not decode: {exc}") from None
                self.decoded += 1
                first = max(offsets[0], lo)
                last = min(offsets[0] + chunk[0], hi)
                src = [slice(first - offsets[0], last - offsets[0])]
                dst = [slice(first - lo, last - lo)]
                for o, c, n in zip(offsets[1:], chunk[1:], shape[1:]):
                    src.append(slice(0, min(c, n - o)))
                    dst.append(slice(o, min(o + c, n)))
                out[tuple(dst)] = block[tuple(src)]
        return out


def _btree_levels(last_keys):
    """The group B-tree over leaves whose last names sit at heap offsets
    ``last_keys``: a list of levels from the root down, each a list of
    nodes (the indices of its children in the level below, its keys).  A
    node's first key is the last name left of it (0, the empty name, at the
    left edge); each further key is its child's last name."""
    level = list(range(len(last_keys)))
    keys_of = list(last_keys)
    levels = []
    while True:
        nodes = []
        for i in range(0, len(level), 2 * _INTERNAL_K):
            children = level[i:i + 2 * _INTERNAL_K]
            first = keys_of[i - 1] if i else 0
            nodes.append((list(range(i, i + len(children))), [first] + keys_of[i:i + len(children)]))
        levels.insert(0, nodes)
        if len(nodes) == 1:
            return levels
        level = list(range(len(nodes)))
        keys_of = [keys[-1] for _, keys in nodes]


class LiteFile(LiteGroup):
    """Read ("r") or write ("w") the HDF5 subset described above."""

    def __init__(self, path, mode="r"):
        if mode not in ("r", "w"):
            raise ValueError(f"LiteFile supports modes 'r' and 'w', not {mode!r}")
        super().__init__("/", mode == "w")
        self.path, self.mode = str(path), mode
        self._closed = False
        self._raw = None
        if mode == "r":
            try:
                self._read_index()
            except BaseException:
                self.close()        # the map of a file it could not read
                raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self.mode == "w":
            self._write()
        elif self._raw is not None:
            self._raw.close()
            self._raw = None

    # ------------------------------------------------------------ writing
    def _write(self):
        root_addr = 96
        blob, (btree_addr, heap_addr) = self._group_blob(self, root_addr)
        eof = root_addr + len(blob)
        superblock = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
                      + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
                      + _entry(0, root_addr, 1, struct.pack("<QQ", btree_addr, heap_addr)))
        with open(self.path, "wb") as f:
            f.write(superblock)
            f.write(blob)

    def _group_blob(self, group, offset):
        """The bytes of ``group`` and everything under it, laid out from
        ``offset``; returns them and the group's (B-tree, heap) addresses."""
        names = group.keys()
        heap = b"\0" * 8
        name_offsets = {}
        for name in names:
            name_offsets[name] = len(heap)
            heap += _pad8(name.encode() + b"\0")
        leaves = [names[i:i + 2 * _LEAF_K] for i in range(0, len(names), 2 * _LEAF_K)] or [[]]
        levels = _btree_levels([name_offsets[leaf[-1]] if leaf else 0 for leaf in leaves])
        attributes = group.attrs._messages()
        header_len = len(_object_header([_message(0x11, bytes(16))] + attributes))
        heap_addr = offset + header_len
        heap_data_addr = heap_addr + 32
        btree_addr = heap_data_addr + len(heap)
        n_nodes = sum(len(level) for level in levels)
        snod_addr = btree_addr + n_nodes * _BTREE_NODE
        position = snod_addr + len(leaves) * _SNOD
        blobs, entries = [], []
        for name in names:
            child = group._links[name]
            if isinstance(child, LiteGroup):
                blob, addrs = self._group_blob(child, position)
                entries.append(_entry(name_offsets[name], position, 1, struct.pack("<QQ", *addrs)))
            else:
                blob = self._dataset_blob(child, position)
                entries.append(_entry(name_offsets[name], position))
            blobs.append(blob)
            position += len(blob)

        header = _object_header([_message(0x11, struct.pack("<QQ", btree_addr, heap_addr))]
                                + attributes)
        # free-list head 1 is the library's "no free block" (H5HL_FREE_NULL)
        local_heap = b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack(
            "<QQQ", len(heap), 1, heap_data_addr) + heap
        # the nodes, the root first: level by level from the top, each level's
        # children the next level's nodes (the bottom level's, the leaves)
        node_addr, addr = [], btree_addr
        for level in levels:
            node_addr.append([addr + i * _BTREE_NODE for i in range(len(level))])
            addr += len(level) * _BTREE_NODE
        node_addr.append([snod_addr + i * _SNOD for i in range(len(leaves))])
        btree = []
        for depth, level in enumerate(levels):
            height = len(levels) - 1 - depth
            for i, (children, keys) in enumerate(level):
                left = node_addr[depth][i - 1] if i else _UNDEF
                right = node_addr[depth][i + 1] if i + 1 < len(level) else _UNDEF
                node = b"TREE" + struct.pack("<BBHQQ", 0, height, len(children), left, right)
                node += struct.pack("<Q", keys[0]) + b"".join(
                    struct.pack("<QQ", node_addr[depth + 1][c], k)
                    for c, k in zip(children, keys[1:]))
                btree.append(node + b"\0" * (_BTREE_NODE - len(node)))
        snods, done = [], 0
        for leaf in leaves:
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(leaf)) + b"".join(
                entries[done:done + len(leaf)])
            snods.append(snod + b"\0" * (_SNOD - len(snod)))
            done += len(leaf)
        return b"".join([header, local_heap, *btree, *snods, *blobs]), (btree_addr, heap_addr)

    @staticmethod
    def _dataset_blob(dataset, offset):
        array, attributes = dataset._array, dataset.attrs._messages()
        header_len = len(LiteFile._dataset_header(array, 0, attributes))
        header = LiteFile._dataset_header(array, offset + header_len, attributes)
        return header + _pad8(np.ascontiguousarray(array).tobytes())

    @staticmethod
    def _dataset_header(array, data_addr, attributes=()):
        fill = bytes([2, 2, 2, 0])  # version 2, late allocation, write if set, no value
        addr = data_addr if array.nbytes else _UNDEF
        layout = struct.pack("<BBQQ", 3, 1, addr, array.nbytes)
        return _object_header([_message(0x1, _dataspace(array.shape)),
                               _message(0x3, _datatype(array.dtype)),
                               _message(0x5, fill), _message(0x8, layout), *attributes])

    # ------------------------------------------------------------ reading
    def _read_index(self):
        with open(self.path, "rb") as f:
            raw = self._raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if raw[:8] != _SIGNATURE or raw[8] != 0 or raw[13] != 8 or raw[14] != 8:
            raise OSError(f"{self.path}: not an HDF5 file with a version-0 superblock "
                          "and 8-byte offsets; read it with h5py")
        root_header = struct.unpack_from("<Q", raw, 64)[0]
        self._read_group(self, root_header)

    def _read_group(self, group, header):
        btree_addr = heap_addr = None
        for mtype, body in self._messages(header):
            if mtype == 0x11:
                btree_addr, heap_addr = struct.unpack_from("<QQ", body)
            elif mtype == 0x0C:
                self._read_attribute(group.attrs, body, group.name)
        if btree_addr is None:
            raise OSError(f"{self.path}: group {group.name!r} has no symbol table (a "
                          "new-style group, e.g. written with track_order); read it with h5py")
        raw = self._raw
        if raw[heap_addr:heap_addr + 4] != b"HEAP":
            raise OSError(f"{self.path}: bad local heap")
        heap_data = struct.unpack_from("<Q", raw, heap_addr + 24)[0]
        for name_off, child_header in self._walk_btree(btree_addr):
            end = raw.find(b"\0", heap_data + name_off)
            name = raw[heap_data + name_off:end].decode()
            path = f"{group.name.rstrip('/')}/{name}"
            messages = self._messages(child_header)
            if any(mtype == 0x11 for mtype, _ in messages):
                child = LiteGroup(path, False)
                self._read_group(child, child_header)
            else:
                child = self._open_dataset(path, messages)
            group._links[name] = child

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

    @staticmethod
    def _dataspace_of(body):
        """(shape, null) of a dataspace message; a scalar's shape is ()."""
        version, ndim = body[0], body[1]
        if version == 1:
            return struct.unpack_from(f"<{ndim}Q", body, 8), False
        return struct.unpack_from(f"<{ndim}Q", body, 4), body[3] == 2

    @staticmethod
    def _numeric_dtype(body):
        """The numpy dtype of a datatype message: an integer of 1, 2, 4 or 8
        bytes, or an IEEE float of 2, 4 or 8 bytes; else None."""
        cls, size = body[0] & 0x0F, struct.unpack_from("<I", body, 4)[0]
        order = ">" if body[1] & 1 else "<"
        if cls == 1 and size in _FLOATS:
            sign, props = _FLOATS[size]
            if body[2] == sign and struct.unpack_from("<HHBBBBI", body, 8) == props:
                return np.dtype(f"{order}f{size}")
            return None
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if body[1] & 0x08 else 'u'}{size}")
        return None

    def _open_dataset(self, name, messages):
        shape = dtype = layout = None
        filters, fill = [], None
        attrs = LiteAttrs(False)
        for mtype, body in messages:
            if mtype == 0x1:
                shape, _ = self._dataspace_of(body)
            elif mtype == 0x3:
                dtype = self._numeric_dtype(body)
            elif mtype == 0x8:
                layout = body
            elif mtype == 0x0B:
                filters = _filter_pipeline(body)
            elif mtype == 0x5 or (mtype == 0x4 and fill is None):
                fill = (mtype, body)
            elif mtype == 0x0C:
                self._read_attribute(attrs, body, name)
        if shape is None or dtype is None or layout is None or layout[0] != 3 \
                or layout[1] not in (1, 2):
            raise OSError(f"{self.path}: dataset {name!r} is not a numeric array stored "
                          "contiguously or in chunks; read it with h5py")
        for fid, fname, _ in filters:
            if fid not in (_LZF, _DEFLATE, _SHUFFLE):
                raise OSError(f"{self.path}: dataset {name!r} has the "
                              f"{_FILTER_NAMES.get(fid, fname or 'unknown')} filter ({fid}), "
                              "which LiteFile does not decode; read it with h5py")
        if layout[1] == 2:
            chunks = _Chunks(self, name, shape, dtype, layout, filters,
                             _fill_value(fill, dtype))
            return LiteDataset(chunks=chunks, shape=shape, dtype=dtype, name=name, attrs=attrs)
        if filters:
            raise OSError(f"{self.path}: dataset {name!r} is contiguous with filters")
        addr = struct.unpack_from("<Q", layout, 2)[0]
        path = self.path

        def reader():
            if int(np.prod(shape)) == 0:
                return np.zeros(shape, dtype)
            if not shape:
                return np.fromfile(path, dtype, count=1, offset=addr).reshape(())
            return np.memmap(path, dtype, "r", offset=addr, shape=shape)

        return LiteDataset(reader=reader, shape=shape, dtype=dtype, name=name, attrs=attrs)

    def _read_attribute(self, attrs, body, owner):
        """Decode one attribute message into ``attrs``; a value outside the
        subset is kept as the error its reading raises."""
        version = body[0]
        if version not in (1, 2, 3):
            raise OSError(f"{self.path}: attribute message version {version} on {owner!r}")
        name_size, type_size, space_size = struct.unpack_from("<HHH", body, 2)
        step = (lambda n: n + (-n % 8)) if version == 1 else (lambda n: n)
        pos = 9 if version == 3 else 8
        name = bytes(body[pos:pos + name_size]).split(b"\0")[0].decode()
        pos += step(name_size)
        type_body = body[pos:pos + type_size]
        pos += step(type_size)
        space_body = body[pos:pos + space_size]
        pos += step(space_size)
        try:
            if version > 1 and body[1] & 0x03:
                raise OSError("a shared datatype or dataspace")
            attrs._values[name] = self._attribute_value(type_body, space_body, body[pos:])
        except (OSError, ValueError, struct.error) as exc:
            attrs._values[name] = OSError(f"{self.path}: attribute {name!r} of {owner!r}: "
                                          f"{exc}; read it with h5py")

    def _attribute_value(self, type_body, space_body, data):
        shape, null = self._dataspace_of(space_body)
        cls, size = type_body[0] & 0x0F, struct.unpack_from("<I", type_body, 4)[0]
        count = int(np.prod(shape))
        if cls == 3:
            dtype = np.dtype(f"S{size}")
        elif cls == 9 and type_body[1] & 0x0F == 1:    # variable-length string
            dtype = None
        else:
            dtype = self._numeric_dtype(type_body)
            if dtype is None:
                raise OSError(f"datatype class {cls} of {size} bytes is outside the subset")
        if null:
            return Empty(dtype if dtype is not None else np.dtype(object))
        if dtype is None:
            strings = [self._global_heap_object(data, i).decode(
                "utf-8" if (type_body[1] >> 4) & 0x0F == 1 else "ascii") for i in range(count)]
            if not shape:
                return strings[0]
            return np.array(strings, dtype=object).reshape(shape)
        array = np.frombuffer(bytes(data[:count * dtype.itemsize]), dtype).reshape(shape)
        return array[()] if not shape else array.copy()

    def _global_heap_object(self, data, index):
        """Element ``index`` of a variable-length attribute: its bytes in
        the global heap collection it points to."""
        length, collection, object_index = struct.unpack_from(
            "<IQI", data, index * _VLEN_ELEMENT)
        raw = self._raw
        if raw[collection:collection + 4] != b"GCOL":
            raise OSError("bad global heap collection")
        end = collection + struct.unpack_from("<Q", raw, collection + 8)[0]
        pos = collection + 16
        while pos + 16 <= end:
            heap_index, _, size = struct.unpack_from("<HH4xQ", raw, pos)
            if heap_index == 0:
                break
            if heap_index == object_index:
                return bytes(raw[pos + 16:pos + 16 + min(size, length)])
            pos += 16 + size + (-size % 8)
        raise OSError(f"global heap object {object_index} not found")
