"""VAE training steps: one data load at a time, its batches in a Python loop.

Counterpart of ``atlasvae/train/step.py``.  A load (up to ~1e6 jets) is
packed into (n_batches, batch, ...) arrays on the host, moved to the
device once (``LoadCache`` keeps it there across epochs), and its batches
are stepped through without a host round trip: each batch's metrics stay
on the device and the host reads them once per load, as the JAX package's
``lax.scan`` does.  Semantics kept:

* the gradient of the **sum** of per-sample losses, padded rows masked by
  ``valid``;
* the gradient guard: non-finite -> 0, then clip to +-1e6;
* Adam as ``optax.adam(1.0)`` computes it, then the update times ``lr``
  (``Adam``), so the plateau schedule only changes a host float.

The parameters of a run live as views of one flat tensor
(``TrainState``): one gradient concatenation, one guard and one Adam update
over all leaves per step.

Data parallelism (``mesh``): each rank steps its rows of every batch
(``LoadCache.get(..., mesh)`` copies only those to its device), draws the
reparameterization noise at the global batch shape and keeps its rows
(``global_noise``), and sums the flat gradient over the mesh's ``data``
ranks with one all-reduce before the guard and Adam, as the JAX package's
``psum`` does; so every rank holds the same parameters and the run
reproduces the single-device step up to the order of the sums.
"""

import math
import os

import numpy as np
import torch

from ..losses import get_losses
from ..models.vae import clip_values
from ..parallel.mesh import all_sum, axis_rank, axis_size, shard_batch
from .checkpoint import tree_flatten, tree_unflatten


def clip_gradients(grads, max_val=1e6):
    """The gradient guard: non-finite -> 0, then clip to +-max_val."""
    return clip_values(grads, max_val)


class Adam:
    """``optax.adam(1.0)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on a flat
    float32 tensor, with the finished update multiplied by ``lr``.

    Written out in the order XLA evaluates optax's update on the CPU:
    mu = fma(g, 1-b1, b1*mu), nu = fma(g*g, 1-b2, b2*nu),
    u = mu / ((1 - b1^t) * (sqrt(nu / (1 - b2^t)) + eps)), then
    p = fma(u, -lr, p).  ``torch.optim.Adam`` folds lr and the bias
    corrections in another order and is not used.  The step count is a
    host integer; the bias corrections are float32 values computed on the
    host.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, n, device, count=0, mu=None, nu=None):
        self.count = int(count)
        self.mu = torch.zeros(n, device=device) if mu is None else mu
        self.nu = torch.zeros(n, device=device) if nu is None else nu

    @classmethod
    def from_trees(cls, count, mu, nu, device):
        """Adam state from moment trees in the parameter tree's layout."""
        flat = lambda tree: torch.cat([torch.as_tensor(np.asarray(leaf, np.float32)).reshape(-1)
                                       for leaf in tree_flatten(tree)]).to(device)
        mu, nu = flat(mu), flat(nu)
        return cls(mu.numel(), device, count, mu, nu)

    @staticmethod
    def _bias_correction(decay, count):
        return float(np.float32(1) - np.float32(math.pow(np.float32(decay), count)))

    def step(self, params, grads, lr):
        """Update the flat ``params`` in place from the flat ``grads``."""
        self.count += 1
        bc1 = self._bias_correction(self.b1, self.count)
        bc2 = self._bias_correction(self.b2, self.count)
        self.mu.mul_(self.b1).add_(grads, alpha=1 - self.b1)
        self.nu.mul_(self.b2).add_(grads * grads, alpha=1 - self.b2)
        denom = torch.sqrt(self.nu / bc2).add_(self.eps).mul_(bc1)
        params.add_(self.mu / denom, alpha=-float(np.float32(lr)))


class TrainState:
    """A parameter tree whose leaves are views of one flat float32 tensor
    (each view a leaf that autograd differentiates), with its Adam state."""

    def __init__(self, params, adam=None):
        leaves = tree_flatten(params)
        device = leaves[0].device
        self.flat = torch.cat([leaf.detach().reshape(-1).to(torch.float32)
                               for leaf in leaves])
        views, start = [], 0
        for leaf in leaves:
            views.append(self.flat[start:start + leaf.numel()].view(leaf.shape)
                         .requires_grad_())
            start += leaf.numel()
        self.leaves = views
        self.params = tree_unflatten(params, views)
        self.adam = adam if adam is not None else Adam(self.flat.numel(), device)

    def detached(self):
        """The parameter tree, detached from autograd (copies)."""
        return tree_unflatten(self.params, [v.detach().clone() for v in self.leaves])


def global_noise(generator, latent, rows, n_shards, shard, oe_type, device):
    """The latent draws of one batch of ``n_shards * rows`` rows, as the
    single-device step draws them from ``generator`` (background, then OoD
    unless the OE term is 'KLD', which runs no OoD sample), each cut to this
    shard's ``rows``: data-parallel runs then reproduce the single-device
    draws exactly."""
    shape = (n_shards * rows, latent)
    rows_of = slice(shard * rows, (shard + 1) * rows)
    noise_bkg = torch.randn(shape, generator=generator, device=device)[rows_of]
    if oe_type == "KLD":
        return noise_bkg, None
    return noise_bkg, torch.randn(shape, generator=generator, device=device)[rows_of]


def make_vae_step_fns(oe_type="KLD", beta=0.0, lamb=0.0, margin=0.0, activation="relu",
                      mesh=None, data_axis="data"):
    """Build (train_on_load, valid_losses).

    Both take a load's batches shaped (n_batches, batch, ...) with a
    (n_batches, batch) float ``valid`` mask for tail padding, and optional
    ``noise = (noise_bkg, noise_ood)`` each (n_batches, batch, latent)
    holding the reparameterization draws (the external-noise hook); without
    it the draws come from ``generator``.  With ``mesh``, ``batches`` and
    ``noise`` are this rank's rows, and the metrics and gradients are summed
    over the ``data_axis`` ranks.
    """
    n_shards = 1 if mesh is None else axis_size(mesh, data_axis)
    shard = 0 if mesh is None else axis_rank(mesh, data_axis)

    def batch_losses(params, generator, noise, bkg_x, ood_x, bkg_w, ood_w, valid):
        if noise is None and mesh is not None:
            latent = params["encoder"]["mean"]["b"].shape[0]
            noise = global_noise(generator, latent, bkg_x.shape[0], n_shards, shard, oe_type,
                                 bkg_x.device)
        mse, kld, oe, total = get_losses(params, bkg_x, ood_x, bkg_w, ood_w, generator,
                                         oe_type, beta, lamb, margin, activation, noise)
        total = total * valid
        loss = total.sum()
        metrics = torch.stack([(mse * valid).sum(), (kld * valid).sum(),
                               (oe * valid).sum(), loss, valid.sum()]).detach()
        return loss, metrics

    def _noise(noise, i):
        return None if noise is None else (noise[0][i], noise[1][i])

    def _summed(metrics):
        metrics = torch.stack(metrics)
        return metrics if mesh is None else all_sum(mesh, metrics, data_axis)

    def train_on_load(state, lr, generator, batches, noise=None):
        """One Adam step per batch; returns the (n_batches, 5) metrics
        (sum mse*v, kld*v, oe*v, total, v) on the device."""
        out = []
        for i in range(batches[0].shape[0]):
            loss, metrics = batch_losses(state.params, generator, _noise(noise, i),
                                         *(b[i] for b in batches))
            grads = torch.autograd.grad(loss, state.leaves, allow_unused=True,
                                        materialize_grads=True)
            with torch.no_grad():
                flat = torch.cat([g.reshape(-1) for g in grads])
                if mesh is not None:
                    all_sum(mesh, flat, data_axis)
                state.adam.step(state.flat, clip_gradients(flat), lr)
            out.append(metrics)
        return _summed(out)

    def valid_losses(params, generator, batches, noise=None):
        """(n_batches, 2) metrics (sum total, sum valid) on the device."""
        out = []
        with torch.no_grad():
            for i in range(batches[0].shape[0]):
                _, m = batch_losses(params, generator, _noise(noise, i),
                                    *(b[i] for b in batches))
                out.append(m[3:])
        return _summed(out)

    return train_on_load, valid_losses


def batch_load(sample_x, ood_x, sample_w, ood_w, batch_size, n_devices=1):
    """Host-side packing: pad a load to whole (device-divisible) batches and
    reshape to (n_batches, batch, ...) + validity mask."""
    n = len(sample_x)
    batch_size = int(batch_size)
    batch_size = max(n_devices, batch_size - batch_size % n_devices)
    n_batches = max(1, -(-n // batch_size))
    padded = n_batches * batch_size
    valid = np.zeros(padded, dtype=np.float32)
    valid[:n] = 1.0

    def pack(arr):
        arr = np.asarray(arr, dtype=np.float32)
        out = np.zeros((padded,) + arr.shape[1:], dtype=np.float32)
        out[:n] = arr
        return out.reshape((n_batches, batch_size) + arr.shape[1:])

    return (pack(sample_x), pack(ood_x), pack(sample_w), pack(ood_w),
            valid.reshape(n_batches, batch_size))


def to_device(batches, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(b)).to(device) for b in batches)


class LoadCache:
    """Device-resident cache of packed training loads.

    Keyed by the *identity* of the host sample dicts plus the batch
    geometry: when an epoch re-presents the same load objects (a
    single-load epoch, cached by data/generator.py), the host packing and
    the host-to-device copy are both skipped.  Samples are treated as
    immutable once handed to the trainer.  Cached bytes are bounded by
    ``ATLASVAE_DEVICE_CACHE_GB`` (default 4 GB); insertion beyond the budget
    evicts oldest first, and a load larger than the whole budget is moved
    to the device for this use only.
    """

    def __init__(self, device, budget_bytes=None):
        if budget_bytes is None:
            budget_bytes = int(float(os.environ.get("ATLASVAE_DEVICE_CACHE_GB", "4")) * 1e9)
        self.device = torch.device(device)
        self.budget = budget_bytes
        self._entries = {}  # key -> (sample_refs, device_batches, nbytes)
        self._total = 0

    def get(self, samples, geometry, build, mesh=None, data_axis="data"):
        """Device batches for (samples, geometry); ``build`` makes the
        packed numpy batches on a miss.  With ``mesh``, only this rank's
        rows of each batch (``shard_batch`` over ``data_axis``) are kept and
        copied, as the JAX package's ``device_put_load`` commits a load
        sharded over the mesh."""
        key = tuple(id(s) for s in samples) + (geometry,)
        entry = self._entries.get(key)
        if entry is not None and all(a is b for a, b in zip(entry[0], samples)):
            return entry[1]
        host = build()
        if mesh is not None:
            host = shard_batch(mesh, host, data_axis)
        nbytes = sum(b.nbytes for b in host)
        batches = to_device(host, self.device)
        if nbytes > self.budget:
            return batches
        while self._total + nbytes > self.budget and self._entries:
            old_key = next(iter(self._entries))
            self._total -= self._entries.pop(old_key)[2]
        self._entries[key] = (samples, batches, nbytes)
        self._total += nbytes
        return batches
