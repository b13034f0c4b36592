"""Device meshes over ``torch.distributed`` ranks, and their shard and
gather helpers.

Counterpart of ``atlasvae/parallel/mesh.py``.  The JAX package runs one
controller over a ``jax.sharding.Mesh`` of every chip; the port runs one
process per device, a rank of a ``torch.distributed`` group, and its mesh
is a ``DeviceMesh`` over the group's ranks with the JAX package's named
dimensions:

* ``data``: batch and event sharding (data parallelism); gradients are
  summed with an all-reduce over the axis' group;
* ``config``: an ensemble's configurations, each rank training its share
  with no collective;
* ``model``: tensor parallelism of the hidden dense layers (``tp.py``).

A JAX array is global; a port tensor is the rank's own.  So ``shard_*``
return this rank's block, and ``gather`` puts a sharded result back
together on every rank, wherever a JAX function returns one whole.
Building a mesh needs an initialized group (``multihost.initialize``, a
CLI's ``--n_devices``, or torchrun), and every rank of it builds the mesh:
making its sub-groups is a collective.  The mesh's device type follows the
group's backend ("cuda" for NCCL, "cpu" for gloo); gloo also carries CUDA
tensors, which is how two ranks share one card.
"""

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(axes=(("data", -1),), devices=None):
    """A mesh from (name, size) pairs over ``devices``, the group's ranks
    (default: every rank); a size of -1 absorbs the rest."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a torch.distributed group: initialize one "
                           "first (parallel.multihost.initialize, or a CLI's --n_devices)")
    ranks = np.arange(dist.get_world_size()) if devices is None else np.asarray(devices)
    names = [a[0] for a in axes]
    sizes = [a[1] for a in axes]
    known = int(np.prod([s for s in sizes if s != -1])) or 1
    sizes = [len(ranks) // known if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != len(ranks):
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {len(ranks)} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.as_tensor(ranks).reshape(sizes),
                      mesh_dim_names=tuple(names))


def data_parallel_mesh(n_devices=None):
    """A 1-D ``data`` mesh over the first ``n_devices`` ranks (default:
    all)."""
    n = n_devices or dist.get_world_size()
    return make_mesh((("data", n),), range(n))


def config_mesh(n_devices=None):
    """A 1-D ``config`` mesh: each rank trains its share of an ensemble's
    configurations with no collective (the multi-device form of the
    reference's Slurm job array, ref OE-VAE/sbatch.sh:13-16)."""
    n = n_devices or dist.get_world_size()
    return make_mesh((("config", n),), range(n))


def axis_size(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis):
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def is_writer(mesh):
    """Whether this process writes files, prints results and draws: the
    only process without a mesh, rank 0 with one."""
    return mesh is None or dist.get_rank() == 0


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _block(x, mesh, axis, dim):
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} is not a multiple of the {axis!r} "
                         f"mesh axis size {n}")
    k = size // n
    return x[(slice(None),) * dim + (slice(r * k, (r + 1) * k),)]


def shard_leading(mesh, tree, axis="config"):
    """This rank's block of the leading axis of every leaf (tensors or
    arrays) of a stacked tree."""
    return _map(lambda x: _block(x, mesh, axis, 0), tree)


def shard_batch(mesh, tree, axis="data", batch_dim=1):
    """This rank's block of dimension ``batch_dim`` of every leaf (a load is
    laid out (n_batches, batch, ...), ``train/step.py``)."""
    return _map(lambda x: _block(x, mesh, axis, batch_dim), tree)


def replicate(mesh, tree):
    """Every rank's copy of ``tree`` (tensors) made equal to the first mesh
    rank's, by a broadcast over the mesh's ranks."""
    src = int(mesh.mesh.flatten()[0])
    group = mesh.get_group() if mesh.ndim == 1 else None

    def put(x):
        x = x.detach().clone().contiguous()
        dist.broadcast(x, src, group=group)
        return x
    return _map(put, tree)


def barrier(mesh):
    """Wait for every rank (nothing to wait for without a mesh)."""
    if mesh is not None:
        dist.barrier()


def all_sum(mesh, tensor, axis="data"):
    """Sum ``tensor`` in place over the ranks of ``axis`` (the JAX
    package's ``psum``); returns it."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return tensor


def gather(mesh, value, axis="data", dim=0):
    """A result sharded over ``axis``, whole on every rank, in rank order: a
    tensor's blocks (one shape on every rank) concatenated along ``dim``, a
    list's items concatenated."""
    group = mesh.get_group(axis)
    parts = [None] * axis_size(mesh, axis)
    if isinstance(value, torch.Tensor):
        value = value.contiguous()
        parts = [torch.empty_like(value) for _ in parts]
        dist.all_gather(parts, value, group=group)
        return torch.cat(parts, dim)
    dist.all_gather_object(parts, value, group=group)
    return [item for part in parts for item in part]
