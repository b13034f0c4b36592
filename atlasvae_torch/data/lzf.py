"""LZF decompression for the chunks of h5py's lzf filter (id 32000).

Two decoders of liblzf's format: ``decompress_native``, the C one of
``native/lzf_decode.cpp`` (built with g++ at first use), and
``decompress_plain``, the same decoder in Python.  ``decompress`` takes the
C one and falls back to the plain one, with a warning, only where the C one
cannot be built; ``backend()`` says which one it takes.

The format: a control byte below 32 starts a literal run of (ctrl + 1)
bytes; any other is a back-reference of length (ctrl >> 5) + 2 (a length
field of 7 extended by the next byte) at an offset of
((ctrl & 31) << 8) + the byte after that + 1 behind the output position.
"""

import ctypes
import warnings

import numpy as np

from .. import native

_NATIVE_ERRORS = {-1: "the output would pass its size", -2: "a token reaches past the input",
                  -3: "a back-reference points before the output"}
_warned = False


def decompress_plain(data, out_size):
    """``data`` decompressed into at most ``out_size`` bytes, in Python."""
    src = bytes(data)
    out = bytearray(out_size)
    ip = op = 0
    end = len(src)
    while ip < end:
        ctrl = src[ip]
        ip += 1
        if ctrl < 32:
            length = ctrl + 1
            if op + length > out_size:
                raise ValueError(f"LZF: {_NATIVE_ERRORS[-1]}")
            if ip + length > end:
                raise ValueError(f"LZF: {_NATIVE_ERRORS[-2]}")
            out[op:op + length] = src[ip:ip + length]
            ip += length
            op += length
            continue
        length = ctrl >> 5
        if length == 7:
            if ip >= end:
                raise ValueError(f"LZF: {_NATIVE_ERRORS[-2]}")
            length += src[ip]
            ip += 1
        if ip >= end:
            raise ValueError(f"LZF: {_NATIVE_ERRORS[-2]}")
        back = ((ctrl & 31) << 8) + src[ip] + 1
        ip += 1
        length += 2
        if back > op:
            raise ValueError(f"LZF: {_NATIVE_ERRORS[-3]}")
        if op + length > out_size:
            raise ValueError(f"LZF: {_NATIVE_ERRORS[-1]}")
        start = op - back
        if back >= length:
            out[op:op + length] = out[start:start + length]
        else:               # the copy overlaps what it writes: the last `back` bytes repeat
            pattern = bytes(out[start:op])
            out[op:op + length] = (pattern * (length // back + 1))[:length]
        op += length
    return bytes(out[:op])


def _library():
    lib = native.load("lzf_decode")
    if lib is not None and not hasattr(lib, "_typed"):
        lib.lzf_decompress.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                       ctypes.c_void_p, ctypes.c_longlong]
        lib.lzf_decompress.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def decompress_native(data, out_size):
    """``data`` decompressed by the C decoder, or None where it cannot be
    built."""
    lib = _library()
    if lib is None:
        return None
    src = bytes(data)
    out = np.empty(out_size, np.uint8)
    n = lib.lzf_decompress(src, len(src), out.ctypes.data, out_size)
    if n < 0:
        raise ValueError(f"LZF: {_NATIVE_ERRORS.get(n, f'error {n}')}")
    return out[:n].tobytes()


def backend():
    """"native" where the C decoder builds and loads, else "plain"."""
    return "native" if _library() is not None else "plain"


def decompress(data, out_size):
    """The C decoder's output, or the plain one's where the C one cannot be
    built (warned once: it is far slower)."""
    global _warned
    out = decompress_native(data, out_size)
    if out is not None:
        return out
    if not _warned:
        _warned = True
        warnings.warn("the C LZF decoder could not be built "
                      f"({native.error('lzf_decode')}); LZF chunks are decoded in Python",
                      RuntimeWarning, stacklevel=2)
    return decompress_plain(data, out_size)
