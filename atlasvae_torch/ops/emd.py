"""Energy mover's distance and per-jet KS statistics on tensors.

Counterpart of ``atlasvae/ops/emd.py``:

* ``emd_pairs``: entropic-regularised optimal transport (staged Sinkhorn
  with an annealed epsilon) between the (pt, y, phi) constituent clouds of
  paired jets, with the total-pt difference penalty
  EMD = <plan, DeltaR / R> + |sum pt_P - sum pt_Q|; the plan is
  Altschuler-rounded onto the transport polytope before costing.  On CUDA
  tensors it runs the hand-written kernel (``ops/emd_cuda.py``), on CPU
  tensors ``_sinkhorn_emd``, the kernel's plain version.
* ``ks_pairs``: the exact two-sample KS statistic between paired rows.

Both take arrays or tensors and return numpy arrays; a tensor is scored on
the device it lies on.  With a ``mesh``, the jet axis is split over its
``data`` ranks (``_shard_rows``): per-jet programs are independent, so
each rank scores its block and one gather puts the result back together.
"""

import math

import numpy as np
import torch

from ..parallel.mesh import axis_size, gather, shard_leading
from ..utils.tensors import as_float_tensor
from . import emd_cuda

_CHUNK = 50_000
# Per-call device scratch budget of the Sinkhorn batch, as in the JAX
# package: the plain version holds about 4 live (n, n) float32 blocks a jet.
_EMD_BUDGET_BYTES = 2 << 30


def _scalar(value, like):
    """A 0-dim float32 tensor beside ``like``: a division by it is a true
    division on every device (by a Python number, CUDA multiplies by the
    reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _pairwise_cost(p, q, r_param):
    """DeltaR / R between constituent clouds (B, n, 3) x (B, m, 3) in
    (pt, y, phi), the phi difference wrapped to [-pi, pi) -> (B, n, m)."""
    dy = p[:, :, None, 1] - q[:, None, :, 1]
    dphi = p[:, :, None, 2] - q[:, None, :, 2]
    # floored modulo, as jnp.mod: the result takes the divisor's sign
    dphi = torch.remainder(dphi + math.pi, 2 * math.pi) - math.pi
    return torch.sqrt(dy ** 2 + dphi ** 2) / _scalar(r_param, p)


def _sinkhorn_emd(p, q, r_param, n_iters, eps_final, n_stages=10):
    """Staged exp-domain (epsilon-scaling) Sinkhorn EMD of a batch of jet
    pairs, (B, n, 3) x (B, m, 3) -> (B,): the plain version of the CUDA
    kernel.

    Epsilon anneals from 10x to 1x ``eps_final`` over ``n_stages`` blocks.
    Within a stage the Gibbs kernel K = exp((f + g - C) / eps) is fixed
    and u = a / (K v), v = b / (K^T u) iterate from 1; the duals are
    absorbed into (f, g) at the stage's end.  The final plan is masked to
    live constituents and rounded onto the transport polytope (Altschuler
    et al. 2017: rows, then columns, then the deficits as a rank-one term),
    so the cost is that of a feasible plan.
    """
    pt_p = torch.clamp(p[:, :, 0], min=0.0)
    pt_q = torch.clamp(q[:, :, 0], min=0.0)
    sum_p = pt_p.sum(dim=1)
    sum_q = pt_q.sum(dim=1)
    # balanced problem on normalised masses + extra-mass penalty
    a = pt_p / torch.clamp(sum_p, min=1e-30)[:, None]
    b = pt_q / torch.clamp(sum_q, min=1e-30)[:, None]
    cost = _pairwise_cost(p, q, r_param)
    mask_a = (pt_p > 0).to(torch.float32)
    mask_b = (pt_q > 0).to(torch.float32)

    n_stages = max(1, min(n_stages, n_iters))
    base, rem = divmod(n_iters, n_stages)
    f = torch.zeros_like(a)
    g = torch.zeros_like(b)
    for s in range(n_stages):
        # the last stage runs at exactly eps_final, the plan's epsilon
        eps = eps_final * (1.0 + 9.0 * (1.0 - (s + 1.0) / n_stages))
        K = torch.exp((f[:, :, None] + g[:, None, :] - cost) / _scalar(eps, p))
        u, v = torch.ones_like(a), torch.ones_like(b)
        for _ in range(base + (1 if s < rem else 0)):
            u = a / torch.clamp((K * v[:, None, :]).sum(dim=2), min=1e-30)
            v = b / torch.clamp((K * u[:, :, None]).sum(dim=1), min=1e-30)
        f = f + eps * torch.log(torch.clamp(u, min=1e-30))
        g = g + eps * torch.log(torch.clamp(v, min=1e-30))
    plan = torch.exp((-cost + f[:, :, None] + g[:, None, :]) / _scalar(eps_final, p))
    plan = plan * mask_a[:, :, None] * mask_b[:, None, :]
    r = plan.sum(dim=2)
    plan = plan * torch.clamp(a / torch.clamp(r, min=1e-30), max=1.0)[:, :, None]
    c = plan.sum(dim=1)
    plan = plan * torch.clamp(b / torch.clamp(c, min=1e-30), max=1.0)[:, None, :]
    err_a = a - plan.sum(dim=2)
    err_b = b - plan.sum(dim=1)
    deficit = torch.clamp(err_a.abs().sum(dim=1), min=1e-30)
    plan = plan + err_a[:, :, None] * err_b[:, None, :] / deficit[:, None, None]
    transport = (plan * cost).sum(dim=(1, 2)) * torch.minimum(sum_p, sum_q)
    return transport + (sum_p - sum_q).abs()


def _emd_batch(p, q, r_param, n_iters, eps_final):
    """The hand-written kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if p.device.type == "cpu":
        return _sinkhorn_emd(p, q, r_param, n_iters, eps_final)
    return emd_cuda.emd_sinkhorn(p, q, r_param, n_iters, eps_final)


def _shard_rows(mesh, fn, a, b):
    """``fn(a, b)`` of paired (n, ...) tensors with the row axis split over
    the mesh's ``data`` ranks: n zero-padded up to a multiple of the ranks,
    each rank computing its block, the blocks gathered and the padding
    rows dropped."""
    n = len(a)
    pad = -n % axis_size(mesh, "data")
    if pad:
        a, b = (torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in (a, b))
    a, b = shard_leading(mesh, (a, b), "data")
    return gather(mesh, fn(a.contiguous(), b.contiguous()))[:n]


def emd_pairs(jets_p, jets_q, r_param=1.0, n_iters=100, eps_final=0.01, device="cuda",
              mesh=None):
    """EMD between paired jets -> numpy (n_jets,); inputs (n_jets, n_const,
    3) in (pt, y, phi) from ``atlasvae_torch.data.jets_3v``.  Tensors are
    scored where they lie, arrays on ``device``, in chunks of the JAX
    package's size, the chunk times the ``data`` ranks under a ``mesh``
    (the scratch budget is a device's)."""
    jets_p = as_float_tensor(jets_p, device)
    jets_q = as_float_tensor(jets_q, jets_p.device)
    chunk = max(1, min(_CHUNK * 8, _EMD_BUDGET_BYTES // (16 * max(jets_p.shape[1], 1) ** 2)))
    batch = lambda a, b: _emd_batch(a, b, r_param, n_iters, eps_final)
    if mesh is not None:
        chunk *= axis_size(mesh, "data")
        batch = lambda a, b, one=batch: _shard_rows(mesh, one, a, b)
    out = [batch(jets_p[i:i + chunk].contiguous(), jets_q[i:i + chunk].contiguous()).cpu().numpy()
           for i in range(0, len(jets_p), chunk)]
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def _ks_batch(p, q):
    """One co-sort of the merged sample with +1/n and -1/m step payloads:
    the running sum is the ECDF difference after each merged value.  A run
    of equal values is an evaluation point only at its last element
    (right-continuous ECDFs, scipy's tie semantics)."""
    n, m = p.shape[1], q.shape[1]
    vals = torch.cat([p, q], dim=1)
    steps = torch.cat([torch.full_like(p, 1.0 / n), torch.full_like(q, -1.0 / m)], dim=1)
    vals_s, order = torch.sort(vals, dim=1, stable=True)
    cum = torch.cumsum(torch.gather(steps, 1, order), dim=1)
    boundary = torch.cat([vals_s[:, 1:] != vals_s[:, :-1],
                          torch.ones((len(vals), 1), dtype=torch.bool, device=vals.device)],
                         dim=1)
    return torch.where(boundary, cum.abs(), 0.0).amax(dim=1)


def ks_pairs(p, q, device="cuda", mesh=None):
    """Two-sample KS statistic per paired row -> numpy (rows,); exact, as
    ``scipy.stats.ks_2samp``'s statistic.  ``mesh`` shards the row axis as
    ``emd_pairs`` does."""
    p = as_float_tensor(p, device)
    q = as_float_tensor(q, p.device)
    chunk = _CHUNK * 8
    batch = _ks_batch
    if mesh is not None:
        chunk *= axis_size(mesh, "data")
        batch = lambda a, b: _shard_rows(mesh, _ks_batch, a, b)
    out = [batch(p[i:i + chunk], q[i:i + chunk]).cpu().numpy()
           for i in range(0, len(p), chunk)]
    return np.concatenate(out) if out else np.zeros(0, np.float32)
