"""ctypes bridge to the native STL basket decoder (native/rootio_decode.cpp).

The pure-Python decoder in :mod:`atlasvae_torch.etl.rootio` parses one
header per entry/inner-vector with ``struct.unpack_from`` — ~12 µs per
entry, which makes basket decode the bottleneck of the ROOT→HDF5
conversion at the reference's 10M-event design scale (the reference pays
the same cost inside uproot's compiled basket interpreters, ref
tools/root_utils.py:16-28).  :mod:`atlasvae_torch.native` builds the C++
decoder at first use with g++ into the port's build directory and this
module exposes ``decode_stl_basket`` and ``final_jets_native``; each
returns None where no library can be built, and its caller then takes the
Python path, which is the plain version the tests hold it to.
``native_calls`` counts the calls that went through the library.
"""

import ctypes
import os

import numpy as np

from .. import native

native_calls = {"decode_stl_basket": 0, "final_jets_native": 0}

_ERRORS = {
    -1: "entry header reaches past the basket payload",
    -2: "negative element count",
    -3: "element data reaches past the basket payload",
    -4: "decoded size exceeds the payload bound "
        "(overlapping entry offsets?)",
}

_I64P = ctypes.POINTER(ctypes.c_longlong)
_U8P = ctypes.POINTER(ctypes.c_ubyte)


def load_lib():
    """The decoder's library (built at first use; thread-safe, as the first
    decode may happen inside read_root_files's file thread pool), or None
    where it cannot be built."""
    lib = native.load("rootio_decode")
    if lib is None or hasattr(lib, "_typed"):
        return lib
    lib.rio_decode_stl.argtypes = [
        _U8P, ctypes.c_longlong,            # payload, plen
        _I64P, ctypes.c_longlong,           # starts, n_entries
        ctypes.c_int, ctypes.c_int,         # depth, isz
        _U8P, ctypes.c_longlong, _I64P,     # flat, flat_cap, flat_len
        _I64P,                              # outer
        _I64P, ctypes.c_longlong, _I64P,    # inner, inner_cap, n_inner
        _I64P,                              # err_entry
    ]
    lib.rio_decode_stl.restype = ctypes.c_longlong
    _DP = ctypes.POINTER(ctypes.c_double)
    _U16P = ctypes.POINTER(ctypes.c_ushort)
    lib.rio_final_jets.argtypes = [
        _DP, _DP, _DP,                    # pt, eta, phi
        ctypes.c_longlong, ctypes.c_longlong,   # J, C
        _U16P, _U16P, _U16P, _U16P,       # flat, E, pt_calo, m_calo
    ]
    lib.rio_final_jets.restype = ctypes.c_longlong
    lib.rio_d2h.argtypes = [_DP, ctypes.c_longlong, _U16P]
    lib.rio_d2h.restype = None
    lib._typed = True
    return lib


def decode_stl_basket(payload, starts, depth, dtype):
    """Decode one basket's STL entries natively.

    payload: decompressed basket bytes; starts: int64 byte offsets of
    each entry's bytecount word; depth: 1 or 2; dtype: big-endian
    element dtype.

    Returns ``(flat, outer, inner)`` — flat is a 1-D array of ``dtype``
    in NATIVE byte order (the decoder byteswaps while copying),
    outer/inner are int64 counts (inner is None for depth 1) — or None
    when the native library is unavailable.  Malformed input raises
    ValueError (converted to the named ``CorruptRecordError`` family at
    rootio's decode boundary).
    """
    lib = load_lib()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    n_entries = len(starts)
    plen = len(buf)
    flat = np.empty(plen, np.uint8)
    outer = np.zeros(max(n_entries, 1), np.int64)
    inner_cap = plen // 4 + 1 if depth == 2 else 1
    inner = np.empty(inner_cap, np.int64)
    flat_len = ctypes.c_longlong(0)
    n_inner = ctypes.c_longlong(0)
    err_entry = ctypes.c_longlong(-1)
    code = lib.rio_decode_stl(
        buf.ctypes.data_as(_U8P), plen,
        starts.ctypes.data_as(_I64P), n_entries,
        int(depth), int(dtype.itemsize),
        flat.ctypes.data_as(_U8P), plen, ctypes.byref(flat_len),
        outer.ctypes.data_as(_I64P),
        inner.ctypes.data_as(_I64P), inner_cap, ctypes.byref(n_inner),
        ctypes.byref(err_entry))
    if code != 0:
        raise ValueError(
            f"STL basket entry {err_entry.value}: "
            f"{_ERRORS.get(code, f'decode error {code}')}")
    native_calls["decode_stl_basket"] += 1
    # copy the decoded slices so the payload-sized scratch buffers are
    # freed immediately (headers are ~10-30% of a basket; holding the
    # full plen buffer per branch adds up at 10M-event scale)
    flat = flat[:flat_len.value].copy().view(dtype.newbyteorder("="))
    outer = outer[:n_entries]
    return flat, outer, (inner[:n_inner.value].copy()
                         if depth == 2 else None)


def final_jets_native(pt, eta, phi, n_workers=None):
    """Fused jet canonicalization (native/rootio_decode.cpp
    ``rio_final_jets``): (J, C) constituent (pt, eta, phi) ->
    ``{"constituents": (J, C*4) float16, "E"/"pt_calo"/"m_calo": (J,)
    float16}`` matching the numpy pipeline in
    :mod:`atlasvae_torch.etl.lorentz` to <=1 float16 ulp (accumulation-order
    rounding at halfway points; see the kernel header for the exact
    contract) (the native path exists because the
    numpy version's ~20 full-block float64 temporaries dominate
    convert() wall time; ref tools/root_utils.py:55-90 pays the same
    cost as a 32-process PyROOT fan-out).

    Returns None when the native library is unavailable.  Rows are
    processed in ``n_workers`` thread chunks (default: cpu count; the
    kernel releases the GIL).
    """
    lib = load_lib()
    if lib is None:
        return None
    pt = np.ascontiguousarray(pt, np.float64)
    eta = np.ascontiguousarray(eta, np.float64)
    phi = np.ascontiguousarray(phi, np.float64)
    if pt.ndim != 2 or pt.shape != eta.shape or pt.shape != phi.shape:
        raise ValueError("final_jets_native expects matching (J, C) arrays")
    n_jets, n_const = pt.shape
    if n_const == 0:
        return None                          # kernel requires C > 0
    flat = np.empty((n_jets, n_const * 4), np.float16)
    e_out = np.empty(n_jets, np.float16)
    ptc = np.empty(n_jets, np.float16)
    mc = np.empty(n_jets, np.float16)
    _DP = ctypes.POINTER(ctypes.c_double)
    _U16P = ctypes.POINTER(ctypes.c_ushort)

    def _run(lo, hi):
        code = lib.rio_final_jets(
            pt[lo:hi].ctypes.data_as(_DP), eta[lo:hi].ctypes.data_as(_DP),
            phi[lo:hi].ctypes.data_as(_DP), hi - lo, n_const,
            flat[lo:hi].ctypes.data_as(_U16P),
            e_out[lo:hi].ctypes.data_as(_U16P),
            ptc[lo:hi].ctypes.data_as(_U16P),
            mc[lo:hi].ctypes.data_as(_U16P))
        if code != 0:
            raise ValueError(f"rio_final_jets error {code}")

    n_workers = max(1, min(n_workers or (os.cpu_count() or 1),
                           n_jets or 1))
    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        bounds = np.linspace(0, n_jets, n_workers + 1).astype(int)
        with ThreadPoolExecutor(n_workers) as pool:
            list(pool.map(lambda i: _run(bounds[i], bounds[i + 1]),
                          range(n_workers)))
    else:
        _run(0, n_jets)
    native_calls["final_jets_native"] += 1
    return {"constituents": flat, "E": e_out, "pt_calo": ptc, "m_calo": mc}
