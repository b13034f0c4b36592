"""K4: the staged Sinkhorn EMD as a hand-written CUDA kernel.

``emd_sinkhorn`` launches ``csrc/emd_sinkhorn.cu`` on contiguous float32
CUDA tensors, by one of three routes that ``route`` picks from the jet's
width n, one for every n >= 1:

* the register route (n <= 128): each pair's Gibbs kernel K cut into 2-D
  tiles held in registers, the cost matrix built once and kept in shared
  memory; a warp or half of one per pair at n <= 32, 256 threads at
  n = 100;
* the cluster route (128 < n <= ``CLUSTER_MAX``): a thread-block cluster of
  2, 4 or 8 CTAs per pair, the least that holds n (``CLUSTERS``), each CTA
  holding a block of K's rows in the register route's tiles; the column
  sums cross the cluster through distributed shared memory;
* the wide route (n > ``CLUSTER_MAX``, any width): one CTA of 256 threads
  per pair, K in a scratch buffer in device memory allocated here.

It computes what ``ops.emd._sinkhorn_emd``, its plain version, computes;
``ops.emd._emd_batch`` chooses between the two by the tensors' device.
Evaluation only, as the TPU kernel it replaces (``atlasvae/ops/emd_pallas.py``):
no gradient.
"""

import ctypes
import functools

import torch

from . import cuda_build

# Kernel launches made by emd_sinkhorn on each route (reset and read by
# chip_smoke.py).
launches = 0
cluster_launches = 0
wide_launches = 0

# The register route's tiles: the widest jet each instantiation of
# emd_tile_kernel takes (EmdTile* in csrc/emd_sinkhorn.cu).
TILES = (8, 16, 20, 32, 64, 112, 128)
# The cluster route's (CTAs a pair, widest jet) (EmdCluster* in
# csrc/emd_sinkhorn.cu): 4 CTAs hold 255 constituents, the most the data's
# uint8 counts give.
CLUSTERS = ((2, 176), (4, 256), (8, 352))
CLUSTER_MAX = CLUSTERS[-1][1]
ROUTES = ("tiles", "cluster", "wide")
# Per-constituent vectors the wide route keeps beside K (kVectors).
WIDE_VECTORS = 14


def wide_scratch_floats(n):
    """Floats of device scratch a pair on the wide route: the vectors
    (each rounded up to 4) and the n x n Gibbs kernel
    (``wide_scratch_floats`` in csrc/emd_sinkhorn.cu)."""
    return WIDE_VECTORS * ((n + 3) & ~3) + n * n


def cluster_size(n):
    """The least cluster of ``CLUSTERS`` that holds n constituents."""
    for size, widest in CLUSTERS:
        if n <= widest:
            return size
    raise ValueError(f"emd_sinkhorn: the cluster route takes at most {CLUSTER_MAX} "
                     f"constituents, got {n}")


def route(n):
    """("tiles", tile) for the register route's smallest tile that holds n
    constituents, ("cluster", size) above the largest tile, ("wide", None)
    above ``CLUSTER_MAX``; raises for n < 1."""
    if n < 1:
        raise ValueError(f"emd_sinkhorn: a jet needs at least 1 constituent slot, got {n}")
    for tile in TILES:
        if n <= tile:
            return "tiles", tile
    if n <= CLUSTER_MAX:
        return "cluster", cluster_size(n)
    return "wide", None


@functools.cache
def _entries():
    lib = cuda_build.load("emd_sinkhorn")
    problem = [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.c_double]
    pointers = [ctypes.c_void_p] * 3
    tiles, cluster = lib.atlasvae_emd_sinkhorn_tiles, lib.atlasvae_emd_sinkhorn_cluster
    wide = lib.atlasvae_emd_sinkhorn_wide
    tiles.argtypes = cluster.argtypes = pointers + problem + [ctypes.c_int, ctypes.c_void_p]
    wide.argtypes = pointers + [ctypes.c_void_p] + problem + [ctypes.c_void_p]
    tiles.restype = cluster.restype = wide.restype = ctypes.c_int
    return {"tiles": tiles, "cluster": cluster, "wide": wide}


def _forced(n, force_route):
    """The route and its size that ``force_route`` asks for at width n."""
    if force_route not in ROUTES:
        raise ValueError(f"emd_sinkhorn: force_route must be one of {ROUTES}, got {force_route!r}")
    if force_route == "tiles":
        which, tile = route(n)
        if which != "tiles":
            raise ValueError(f"emd_sinkhorn: the register route takes at most {TILES[-1]} "
                             f"constituents, got {n}")
        return which, tile
    if force_route == "cluster":
        return "cluster", cluster_size(n)
    return "wide", None


def emd_sinkhorn(p, q, r_param=1.0, n_iters=100, eps_final=0.01, n_stages=10, force_route=None):
    """EMD of each jet pair of ``p``, ``q`` (B, n, 3) in (pt, y, phi) -> (B,).
    Raises on anything the kernel does not take; never runs another path.
    ``force_route`` ("tiles", "cluster" or "wide") runs a route other than
    ``route(n)`` picks, where it takes n: for tests and timings only."""
    global launches, cluster_launches, wide_launches
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
    which, size = route(n) if force_route is None else _forced(n, force_route)
    if n_iters < 0 or n_stages < 1 or not eps_final > 0 or not r_param > 0:
        raise ValueError(f"emd_sinkhorn: n_iters {n_iters}, n_stages {n_stages}, eps_final "
                         f"{eps_final}, r_param {r_param} out of range")
    n_stages = max(1, min(int(n_stages), int(n_iters)))
    out = torch.empty((batch,), device=p.device, dtype=torch.float32)
    problem = (batch, n, float(r_param), int(n_iters), n_stages, float(eps_final))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "wide":
            scratch = torch.empty((batch * wide_scratch_floats(n),), device=p.device,
                                  dtype=torch.float32)
            err = _entries()["wide"](p.data_ptr(), q.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), *problem, stream)
        else:
            err = _entries()[which](p.data_ptr(), q.data_ptr(), out.data_ptr(), *problem, size,
                                    stream)
    cuda_build.check(err, f"emd_sinkhorn kernel ({which} route)")
    if which == "tiles":
        launches += 1
    elif which == "cluster":
        cluster_launches += 1
    else:
        wide_launches += 1
    return out
