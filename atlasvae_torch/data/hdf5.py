"""HDF5 files through h5py, or through a small pure-numpy subset without it.

``File(path, mode)`` returns ``h5py.File`` where h5py is installed.  Where
it is not, it returns a ``LiteFile``: a reader and writer of the subset of
HDF5 that the port's data files and Keras weight files use -- nested groups
of numeric datasets (little-endian float32/float64/int32/int64, any rank,
scalars too) stored contiguously, and attributes on the file, its groups and
its datasets (numeric arrays and scalars, fixed-length byte strings, scalar
or 1-D; variable-length strings are read, not written).  Files it writes are
standard HDF5 that h5py reads; it reads those files and h5py-written ones of
the same subset (superblock version 0, version 1 object headers,
symbol-table groups, contiguous layout), which is what h5py writes by
default and so what Keras 2 ``save_weights`` and Keras 3 ``.weights.h5``
files hold.  Chunked or compressed datasets need h5py.  A ``LiteFile``
opened for writing keeps its tree in memory (``resize`` and slice
assignment work as in h5py) and writes the file when it is closed.

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
local heap of its link names, one group B-tree node and one symbol-table
node holding every link (group leaf K = 32, so at most 64 links a group),
followed by each link in name order: a dataset's object header (dataspace,
datatype, fill value, contiguous layout, attribute messages) and its raw
data, or a subgroup laid out the same way.  A file with only root-level
datasets and no attributes comes out byte for byte as the earlier
flat-file writer wrote it.
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
_VLEN_ELEMENT = 16  # sequence length, global heap collection address, object index

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


class LiteDataset:
    """A dataset of a ``LiteFile``: array-like reads, h5py-like writes."""

    def __init__(self, array=None, reader=None, shape=None, dtype=None, name="", attrs=None):
        self._array = array
        self._reader = reader
        self.shape = tuple(array.shape) if array is not None else tuple(shape)
        self.dtype = array.dtype if array is not None else np.dtype(dtype)
        self.name = name
        self.attrs = attrs if attrs is not None else LiteAttrs(array is not None)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, index):
        value = (self._array if self._array is not None else self._reader())[index]
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
        if len(names) > 2 * _LEAF_K:
            raise ValueError(f"{self.path}: group {group.name!r} has {len(names)} links; "
                             f"LiteFile writes at most {2 * _LEAF_K} a group (one "
                             "symbol-table node): write this file with h5py")
        heap = b"\0" * 8
        name_offsets = {}
        for name in names:
            name_offsets[name] = len(heap)
            heap += _pad8(name.encode() + b"\0")
        attributes = group.attrs._messages()
        header_len = len(_object_header([_message(0x11, bytes(16))] + attributes))
        heap_addr = offset + header_len
        heap_data_addr = heap_addr + 32
        btree_addr = heap_data_addr + len(heap)
        snod_addr = btree_addr + _BTREE_NODE
        position = snod_addr + _SNOD
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
        last = name_offsets[names[-1]] if names else 0
        keys_children = struct.pack("<QQQ", 0, snod_addr, last)
        btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF) + keys_children
        btree += b"\0" * (_BTREE_NODE - len(btree))
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(entries)
        snod += b"\0" * (_SNOD - len(snod))
        return b"".join([header, local_heap, btree, snod, *blobs]), (btree_addr, heap_addr)

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
        cls, size = body[0] & 0x0F, struct.unpack_from("<I", body, 4)[0]
        order = ">" if body[1] & 1 else "<"
        if cls == 1 and size in (4, 8):
            return np.dtype(f"{order}f{size}")
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if body[1] & 0x08 else 'u'}{size}")
        return None

    def _open_dataset(self, name, messages):
        shape = dtype = layout = None
        attrs = LiteAttrs(False)
        for mtype, body in messages:
            if mtype == 0x1:
                shape, _ = self._dataspace_of(body)
            elif mtype == 0x3:
                dtype = self._numeric_dtype(body)
            elif mtype == 0x8:
                layout = body
            elif mtype == 0x0C:
                self._read_attribute(attrs, body, name)
        if shape is None or dtype is None or layout is None or layout[0] != 3 \
                or layout[1] != 1:
            raise OSError(f"{self.path}: dataset {name!r} is not a contiguous numeric "
                          "array (chunked or compressed?); read it with h5py")
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
