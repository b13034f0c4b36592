"""Compression codecs for ROOT record/basket frames.

ROOT compresses each record as a sequence of framed chunks:
``algo(2) method(1) csize(3, LE) usize(3, LE)`` then ``csize`` bytes of
codec payload (ref tools/root_utils.py:16-28 gets all of this for free
via uproot; production ATLAS ntuples commonly use zlib or lz4).  The
codecs themselves:

* ``ZL`` — raw zlib stream.
* ``XZ`` — lzma.
* ``L4`` — an 8-byte **big-endian XXH64 checksum of the compressed
  block** followed by one LZ4 *block* (not the lz4 frame format);
  ``csize`` counts the checksum.  Decoded with ``lz4.block`` when that
  library is importable, else with the pure-Python block decoder below
  (the block format is a simple token/literal/match stream).  The
  writer emits spec-valid literals-only blocks, so lz4 output is
  readable by real ROOT without the library.
* ``ZS`` — zstandard frame, via the ``zstandard`` package; a clean
  named error when it is missing.

Everything here is re-derived from the public LZ4 block format and
XXH64 specifications (github.com/lz4/lz4/blob/dev/doc), not from any
reference code (the reference contains no compression code at all).
"""

import struct
import zlib

__all__ = [
    "RootIOError", "TruncatedFileError", "CorruptRecordError",
    "decompress_record", "compress_record", "xxh64",
    "lz4_block_decompress", "lz4_block_compress_literal",
]


class RootIOError(ValueError):
    """Base error for malformed / unsupported ROOT container data."""


class TruncatedFileError(RootIOError):
    """The file ends before a record it promises."""


class CorruptRecordError(RootIOError):
    """A record/basket payload fails to decode (bad stream or checksum)."""


# ---------------------------------------------------------------- XXH64
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _xxh64_fast():
    try:
        import xxhash
        return xxhash
    except ImportError:
        return None


def xxh64(data, seed=0):
    """XXH64 (the checksum ROOT stores on L4 frames): the ``xxhash``
    package when importable, else the pure-Python reference below
    (tested against the package as an independent oracle)."""
    fast = _xxh64_fast()
    if fast is not None:
        return fast.xxh64(bytes(data), seed=seed).intdigest()
    return _xxh64_py(data, seed)


def _xxh64_py(data, seed=0):
    """Pure-Python XXH64, re-derived from the public specification."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        while i + 32 <= n:
            lanes = struct.unpack_from("<4Q", data, i)
            v1 = _round(v1, lanes[0])
            v2 = _round(v2, lanes[1])
            v3 = _round(v3, lanes[2])
            v4 = _round(v4, lanes[3])
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = ((_rotl(h ^ _round(0, struct.unpack_from("<Q", data, i)[0]), 27)
              * _P1) + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h = ((_rotl(h ^ (struct.unpack_from("<I", data, i)[0] * _P1) & _M64,
                    23) * _P2) + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl(h ^ (data[i] * _P5) & _M64, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


# ------------------------------------------------------------ LZ4 block
def lz4_block_decompress(src, usize):
    """Decode one LZ4 *block* (token / literal-run / match stream)."""
    src = bytes(src)
    dst = bytearray()
    i, n = 0, len(src)
    try:
        while i < n:
            token = src[i]
            i += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = src[i]
                    i += 1
                    lit += b
                    if b != 255:
                        break
            if i + lit > n:
                raise CorruptRecordError(
                    "lz4 block: literal run extends past the block end")
            dst += src[i:i + lit]
            i += lit
            if i >= n:
                break  # final sequence carries literals only
            offset = src[i] | (src[i + 1] << 8)
            i += 2
            if offset == 0 or offset > len(dst):
                raise CorruptRecordError(
                    f"lz4 block: match offset {offset} outside the "
                    f"{len(dst)} decoded bytes")
            mlen = token & 15
            if mlen == 15:
                while True:
                    b = src[i]
                    i += 1
                    mlen += b
                    if b != 255:
                        break
            mlen += 4
            start = len(dst) - offset
            if offset >= mlen:
                dst += dst[start:start + mlen]
            else:  # overlapping match: the run repeats the offset pattern
                pattern = dst[start:]
                reps = -(-mlen // offset)
                dst += (pattern * reps)[:mlen]
    except IndexError:
        raise CorruptRecordError("lz4 block ends mid-sequence") from None
    if len(dst) != usize:
        raise CorruptRecordError(
            f"lz4 block decoded to {len(dst)} bytes, header promised {usize}")
    return bytes(dst)


def lz4_block_compress_literal(data):
    """Encode ``data`` as a single literals-only LZ4 sequence.

    Spec-valid (the final sequence of a block is literals-only by rule)
    and decodable by any conformant LZ4 decoder; no compression is
    attempted, which is fine for the writer's purpose — emitting files
    real ROOT can read — since callers pick lz4 for speed, not ratio.
    """
    data = bytes(data)
    n = len(data)
    if n < 15:
        return bytes([n << 4]) + data
    head = bytearray([0xF0])
    rest = n - 15
    while rest >= 255:
        head.append(255)
        rest -= 255
    head.append(rest)
    return bytes(head) + data


# ------------------------------------------------------- record framing
_HEADER = struct.Struct("2sB3s3s")
# Chunk bound such that csize (24-bit) holds the WORST-case compressed
# size for every codec.  The binding case is lz4 on incompressible
# input: n + ceil(n/255) + 16 literal-head bytes + 8 checksum bytes
# (native lz4.block bound; the pure-Python literals-only encoder is
# n + ceil((n-15)/255) + 1 + 8, slightly smaller).  At 0xFE0000
# (16,646,144) that overhead is ~65.3 kB against 131 kB of headroom;
# the old 0xFF0000 left only 65,535 bytes — 10 short of lz4's
# worst case, so a full incompressible chunk raised RootIOError.
_CHUNK_MAX = 0xFE0000


def _zstd():
    try:
        import zstandard
    except ImportError:
        raise RootIOError(
            "ZS (zstd) basket: the 'zstandard' package is required to "
            "decode it and is not importable") from None
    return zstandard


def _lz4_block():
    """lz4.block when importable, else None (pure-Python fallback)."""
    try:
        import lz4.block
        return lz4.block
    except ImportError:
        return None


def decompress_record(body, objlen, context=""):
    """Decode a compressed record body back to ``objlen`` raw bytes.

    ``body`` holds one or more framed chunks; a body whose length
    already equals ``objlen`` is stored uncompressed (callers check
    that before calling here).  ``context`` names the record for error
    messages.
    """
    where = f" in {context}" if context else ""
    out = b""
    pos = 0
    while pos < len(body) and len(out) < objlen:
        if pos + 9 > len(body):
            raise TruncatedFileError(
                f"compressed record{where} ends inside a 9-byte "
                f"chunk header")
        algo, _method, c3, u3 = _HEADER.unpack_from(body, pos)
        csize = int.from_bytes(c3, "little")
        usize = int.from_bytes(u3, "little")
        chunk = body[pos + 9:pos + 9 + csize]
        if len(chunk) < csize:
            raise TruncatedFileError(
                f"compressed record{where}: chunk promises {csize} bytes, "
                f"only {len(chunk)} present (truncated file?)")
        try:
            if algo == b"ZL":
                out += zlib.decompress(chunk)
            elif algo == b"XZ":
                import lzma
                out += lzma.decompress(chunk)
            elif algo == b"L4":
                if csize < 8:
                    raise CorruptRecordError(
                        f"L4 chunk{where} too short for its checksum")
                want = struct.unpack(">Q", chunk[:8])[0]
                block = chunk[8:]
                got = xxh64(block)
                if got != want:
                    raise CorruptRecordError(
                        f"L4 basket checksum mismatch{where}: stored "
                        f"{want:#018x}, computed {got:#018x}")
                native = _lz4_block()
                if native is not None:
                    out += native.decompress(block, uncompressed_size=usize)
                else:
                    out += lz4_block_decompress(block, usize)
            elif algo == b"ZS":
                zstandard = _zstd()
                out += zstandard.ZstdDecompressor().decompress(
                    chunk, max_output_size=usize)
            elif algo == b"CS":
                raise RootIOError(
                    f"CS (legacy ROOT zlib variant) basket{where} is not "
                    f"supported; re-compress the file with zlib/lz4/zstd")
            else:
                raise RootIOError(
                    f"unknown compression tag {algo!r}{where}; supported: "
                    f"ZL (zlib), XZ (lzma), L4 (lz4), ZS (zstd)")
        except RootIOError:
            raise
        except Exception as exc:  # zlib.error, lzma errors, zstd errors
            raise CorruptRecordError(
                f"{algo.decode(errors='replace')} chunk{where} failed to "
                f"decode: {exc}") from exc
        pos += 9 + csize
    if len(out) < objlen:
        raise CorruptRecordError(
            f"record{where} decoded to {len(out)} bytes, key promises "
            f"{objlen} (truncated or corrupt)")
    return out[:objlen]


def compress_record(payload, codec):
    """Frame ``payload`` as compressed chunks with the given codec
    ('zlib' | 'lz4' | 'zstd').  Chunks stay below the 24-bit size field
    with headroom for worst-case expansion."""
    out = b""
    for i in range(0, len(payload), _CHUNK_MAX):
        chunk = payload[i:i + _CHUNK_MAX]
        if codec == "zlib":
            algo, method, c = b"ZL", 8, zlib.compress(chunk, 1)
        elif codec == "lz4":
            native = _lz4_block()
            if native is not None:
                block = native.compress(chunk, store_size=False)
            else:
                block = lz4_block_compress_literal(chunk)
            algo, method = b"L4", 1
            c = struct.pack(">Q", xxh64(block)) + block
        elif codec == "zstd":
            zstandard = _zstd()
            algo, method = b"ZS", 1
            c = zstandard.ZstdCompressor(level=1).compress(chunk)
        else:
            raise ValueError(f"unknown codec {codec!r}")
        if len(c) > 0xFFFFFF:
            raise RootIOError("compressed chunk exceeded the 24-bit "
                              "size field")
        out += (_HEADER.pack(algo, method, len(c).to_bytes(3, "little"),
                             len(chunk).to_bytes(3, "little")) + c)
    return out
