"""K4: the staged Sinkhorn EMD as a hand-written CUDA kernel.

``emd_sinkhorn`` launches ``csrc/emd_sinkhorn.cu`` on contiguous float32
CUDA tensors, by one of two routes that ``route`` picks from the jet's
width n:

* the register route (n <= 128): each pair's Gibbs kernel K cut into 2-D
  tiles held in registers, the cost matrix built once and kept in shared
  memory; a warp or half of one per pair at n <= 32, 256 threads at
  n = 100;
* the wide route (128 < n <= ``MAX_CONST``): one CTA per pair, K in shared
  memory, the cost matrix recomputed from the coordinates.

It computes what ``ops.emd._sinkhorn_emd``, its plain version, computes;
``ops.emd._emd_batch`` chooses between the two by the tensors' device.
Evaluation only, as the TPU kernel it replaces (``atlasvae/ops/emd_pallas.py``):
no gradient.
"""

import ctypes
import functools

import torch

from . import cuda_build

# Kernel launches made by emd_sinkhorn on the register route and on the wide
# route (reset and read by chip_smoke.py).
launches = 0
wide_launches = 0

# The register route's tiles: the widest jet each instantiation of
# emd_tile_kernel takes (EmdTile* in csrc/emd_sinkhorn.cu).
TILES = (8, 16, 20, 32, 64, 112, 128)

# The wide route's CTA keeps 14 vectors of n (rounded up to 4) and an
# n x (n|1) matrix in at most 227 KB of shared memory (emd_smem_bytes in
# csrc/emd_sinkhorn.cu).
SMEM_LIMIT = 232448


def smem_bytes(n):
    return 4 * (14 * ((n + 3) & ~3) + n * (n | 1))


MAX_CONST = max(n for n in range(1, 512) if smem_bytes(n) <= SMEM_LIMIT)
ROUTES = ("tiles", "wide")


def route(n):
    """("tiles", tile) for the register route's smallest tile that holds n
    constituents, ("wide", None) above the largest; raises outside 1..MAX_CONST."""
    if not 1 <= n <= MAX_CONST:
        raise ValueError(f"emd_sinkhorn: {n} constituents (the wide route's K needs "
                         f"{smem_bytes(n)} bytes of shared memory); the kernel takes 1 to at "
                         f"most {MAX_CONST} ({SMEM_LIMIT} bytes a CTA)")
    for tile in TILES:
        if n <= tile:
            return "tiles", tile
    return "wide", None


@functools.cache
def _entries():
    lib = cuda_build.load("emd_sinkhorn")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_double]
    tiles, wide = lib.atlasvae_emd_sinkhorn_tiles, lib.atlasvae_emd_sinkhorn_wide
    tiles.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
    wide.argtypes = args + [ctypes.c_void_p]
    tiles.restype = wide.restype = ctypes.c_int
    return tiles, wide


def emd_sinkhorn(p, q, r_param=1.0, n_iters=100, eps_final=0.01, n_stages=10, force_route=None):
    """EMD of each jet pair of ``p``, ``q`` (B, n, 3) in (pt, y, phi) -> (B,).
    Raises on anything the kernel does not take; never runs another path.
    ``force_route`` ("tiles" or "wide") runs a route other than ``route(n)``
    picks, where it takes n: for tests and timings only."""
    global launches, wide_launches
    for name, t in (("p", p), ("q", q)):
        if t.device.type != "cuda" or t.device != p.device:
            raise ValueError(f"emd_sinkhorn: {name} must be a CUDA tensor on {p.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"emd_sinkhorn: {name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError("emd_sinkhorn records no gradient (evaluation only)")
    if p.dim() != 3 or p.shape[2] != 3 or q.shape != p.shape:
        raise ValueError(f"emd_sinkhorn: p and q must both be (B, n, 3), got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    batch, n = p.shape[0], p.shape[1]
    if batch < 1 or n < 1:
        raise ValueError(f"emd_sinkhorn: empty batch or jet, shape {tuple(p.shape)}")
    which, tile = route(n)
    if force_route == "wide":
        which, tile = "wide", None
    elif force_route == "tiles" and which != "tiles":
        raise ValueError(f"emd_sinkhorn: the register route takes at most {TILES[-1]} "
                         f"constituents, got {n}")
    elif force_route not in (None, "tiles", "wide"):
        raise ValueError(f"emd_sinkhorn: force_route must be one of {ROUTES}, got {force_route!r}")
    if n_iters < 0 or n_stages < 1 or not eps_final > 0 or not r_param > 0:
        raise ValueError(f"emd_sinkhorn: n_iters {n_iters}, n_stages {n_stages}, eps_final "
                         f"{eps_final}, r_param {r_param} out of range")
    n_stages = max(1, min(int(n_stages), int(n_iters)))
    out = torch.empty((batch,), device=p.device, dtype=torch.float32)
    tiles_fn, wide_fn = _entries()
    args = (p.data_ptr(), q.data_ptr(), out.data_ptr(), batch, n, float(r_param), int(n_iters),
            n_stages, float(eps_final))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = tiles_fn(*args, tile, stream) if which == "tiles" else wide_fn(*args, stream)
    cuda_build.check(err, f"emd_sinkhorn kernel ({which} route)")
    if which == "tiles":
        launches += 1
    else:
        wide_launches += 1
    return out
