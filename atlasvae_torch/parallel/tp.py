"""Tensor-parallel layouts for the VAE's dense stacks (a data x model mesh).

Counterpart of ``atlasvae/parallel/tp.py``.  The flagship models are narrow
MLPs, so data parallelism is the production layout; this is the ``model``
axis for wide configurations and for checking multi-device layouts.  Hidden
dense kernels are sharded on their output dimension (``w`` is (in, out) in
both packages, so ``Shard(1)``) and their biases likewise, where the output
divides by the axis size; everything else is replicated.

The JAX package lets GSPMD insert the collectives.  Here the product is
column-parallel by hand: each rank multiplies by its columns of a sharded
layer and an explicit ``all_gather`` over the ``model`` ranks rebuilds the
layer's output, whose backward keeps the rank's columns (every ``model``
rank computes the same thing downstream of the gather, so its gradient
there is the whole one); backward, the layer's input gradient is summed
over the ``model`` ranks, each of whose columns gives a share of it.  The step runs the plain PyTorch path, as the JAX
TP step runs XLA and no Pallas kernel.
"""

import torch
import torch.distributed as dist

from ..losses import get_losses
from ..models.mlp import _ACTIVATIONS
from ..models.vae import clip_values, reparameterize
from ..train.step import TrainState, clip_gradients, global_noise
from .mesh import all_sum, axis_rank, axis_size, shard_leading


def _map_hidden(fn, tree, hidden=False):
    """``fn(in_hidden_stack, leaf)`` over a parameter tree."""
    if isinstance(tree, dict):
        return {k: _map_hidden(fn, v, hidden or k == "hidden") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_hidden(fn, v, hidden) for v in tree)
    return fn(hidden, tree)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, ``specs`` shaped like it with one
    placement tuple a leaf."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def tp_param_shardings(mesh, params, axis="model"):
    """The DTensor placements of every leaf (a tuple, one per mesh
    dimension): hidden kernels sharded on their output dimension and hidden
    biases on theirs where it divides by the ``axis`` size, the rest
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    n = axis_size(mesh, axis)
    dim = mesh.mesh_dim_names.index(axis)

    def spec(hidden, leaf):
        placements = [Replicate()] * mesh.ndim
        if hidden and leaf.shape[-1] % n == 0:
            placements[dim] = Shard(leaf.ndim - 1)
        return tuple(placements)
    return _map_hidden(spec, params)


class _SumGradOverModel(torch.autograd.Function):
    """The input of a column-parallel layer: unchanged forward; backward,
    each rank's columns give only their share of the input's gradient, so
    the shares are summed over the ``model`` ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """The column blocks of the ``model`` ranks side by side; the backward
    keeps this rank's block of the (identical) downstream gradient."""

    @staticmethod
    def forward(ctx, y, group, n, rank):
        ctx.n, ctx.rank = n, rank
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=1)[ctx.rank].contiguous(), None, None, None


def make_tp_train_step(mesh, oe_type="KLD", beta=0.0, lamb=0.0, margin=0.0, activation="relu",
                       data_axis="data", model_axis="model", lr=1e-3):
    """One data x model training step: the batch split over ``data_axis``,
    the hidden layers over ``model_axis``; the loss bank, its gradient
    summed over the data ranks, the gradient guard and Adam times ``lr``.

    ``step(params, adam, generator, bkg_x, ood_x, bkg_w, ood_w) -> (params,
    adam, loss)``: ``params`` full tensors or the DTensors a previous step
    returned; ``adam`` the rank's ``train.step.Adam`` over its shards (None:
    fresh); the batch whole on every rank (its rows divisible by the data
    ranks); the noise drawn from ``generator`` at the batch's shape, as the
    single-device step draws it.  Returns the parameters as DTensors laid
    out by ``tp_param_shardings``, the Adam state and the batch's summed
    loss.  Every rank of the mesh calls it with the same arguments.
    """
    from torch.distributed.tensor import DTensor, Shard
    group = mesh.get_group(model_axis)
    n_model, r_model = axis_size(mesh, model_axis), axis_rank(mesh, model_axis)
    n_data, r_data = axis_size(mesh, data_axis), axis_rank(mesh, data_axis)
    act = _ACTIVATIONS[activation]

    def local(leaf, placements):
        if isinstance(leaf, DTensor):
            return leaf.to_local()
        for mesh_dim, p in enumerate(placements):
            if isinstance(p, Shard):
                k = leaf.shape[p.dim] // mesh.size(mesh_dim)
                leaf = leaf.narrow(p.dim, mesh.get_local_rank(mesh_dim) * k, k)
        return leaf

    def stack(layers, sharded, x):
        for lyr, cut in zip(layers, sharded):
            if cut:
                x = _SumGradOverModel.apply(x, group)
            x = act(x @ lyr["w"] + lyr["b"])
            if cut:
                x = _GatherColumns.apply(x, group, n_model, r_model)
        return x

    def step(params, adam, generator, bkg_x, ood_x, bkg_w, ood_w):
        specs = tp_param_shardings(mesh, params, model_axis)
        cut = {part: [isinstance(s["w"][mesh.mesh_dim_names.index(model_axis)], Shard)
                      for s in specs[part]["hidden"]] for part in ("encoder", "decoder")}
        state = TrainState(_zip_map(local, params, specs), adam)

        def encode(p, x, activation=activation):
            h = stack(p["encoder"]["hidden"], cut["encoder"], x)
            return (h @ p["encoder"]["mean"]["w"] + p["encoder"]["mean"]["b"],
                    h @ p["encoder"]["logvar"]["w"] + p["encoder"]["logvar"]["b"])

        def apply(p, x, generator=None, activation=activation, noise=None):
            z_mean, z_log_var = encode(p, x)
            z = reparameterize(z_mean, z_log_var, noise, generator)
            h = stack(p["decoder"]["hidden"], cut["decoder"], z)
            return clip_values(h @ p["decoder"]["out"]["w"] + p["decoder"]["out"]["b"]), \
                z_mean, z_log_var

        bkg_x, ood_x, bkg_w, ood_w = shard_leading(mesh, (bkg_x, ood_x, bkg_w, ood_w),
                                                   data_axis)
        latent = state.params["encoder"]["mean"]["b"].shape[0]
        noise = global_noise(generator, latent, len(bkg_x), n_data, r_data, oe_type,
                             bkg_x.device)
        total = get_losses(state.params, bkg_x, ood_x, bkg_w, ood_w, generator, oe_type, beta,
                           lamb, margin, activation, noise, forward=(encode, apply))[3]
        loss = total.sum()
        grads = torch.autograd.grad(loss, state.leaves, allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            summed = all_sum(mesh, torch.cat([g.reshape(-1) for g in grads] + [loss[None]]),
                             data_axis)
            state.adam.step(state.flat, clip_gradients(summed[:-1]), lr)
        out = _zip_map(lambda leaf, placements: DTensor.from_local(
            leaf.detach().clone(), mesh, placements, run_check=False),
            state.params, specs)
        return out, state.adam, summed[-1]

    return step
