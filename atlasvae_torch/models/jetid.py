"""Supervised jet classifier: multi-branch CNN/FCN -> softmax.

Counterpart of ``atlasvae/models/jetid.py``: images grouped by shape into
shared multi-channel conv towers (Conv + MaxPool + ReLU + Dropout per
block), a flat constituents branch, a scalars branch, concatenated into a
trunk of dense layers and a softmax head.  Kernels given as 3-tuples select
3-D towers over (h, w, n_images) volumes.

The parameter tree, its leaf order and every layout are the JAX package's:
convolutions are channels-last with (*kernel, c_in, c_out) weights, a tower
is flattened as (h, w, c), so a ``model.npz`` of either package loads in the
other.  The first block of a 2-D tower is ``ops.fused_conv``: kernels K5 and
K6 on the card, their plain versions on the CPU; shapes its gate refuses
(3-D towers, more than 512 taps) and every later block run
``conv2d_valid`` + ``maxpool_same`` + ReLU, as they do in the JAX package.
Dropout draws from an explicit ``torch.Generator``, one mask per layer.
"""

import dataclasses
import math

import torch

from ..ops.fused_conv import conv2d_valid, fused_conv1_pool_relu, supported
from ..ops.pooling import maxpool_same
from .mlp import init_mlp, init_dense, dense_apply


@dataclasses.dataclass(frozen=True)
class JetIDConfig:
    n_classes: int = 2
    scalars: tuple = ()            # names of scalar branches (shape (d,))
    scalar_dims: tuple = ()
    images: tuple = ()             # names of image branches (shape (h, w))
    image_shapes: tuple = ()
    constituent_dim: int = 0       # flat constituents branch width (0 = off)
    nn_type: str = "FCN"           # 'CNN' or 'FCN'
    fcn_neurons: tuple = (200, 200)
    branch_neurons: tuple = (200,)
    cnn_maps: tuple = (100, 100)
    cnn_kernels: tuple = ((3, 3), (3, 3))
    cnn_pools: tuple = ((2, 2), (2, 2))
    # per-shape overrides ((shape, maps, kernels, pools), ...); kernels of
    # length 3 select the 3-D tower
    cnn_by_shape: tuple = ()
    dropout: float = 0.1
    activation: str = "leaky_relu"
    l2: float = 0.0                # kernel L2 strength, applied in the training loss
    # the port computes in float32 only (K5/K6 are float32 kernels)
    compute_dtype: str = "float32"


def _shape_groups(config):
    """Images grouped by shape, first-appearance order: one shared
    multi-channel tower per distinct shape."""
    groups = {}
    for name, shape in zip(config.images, config.image_shapes):
        groups.setdefault(tuple(shape), []).append(name)
    return list(groups.items())


def _shape_cnn(config, shape):
    """(maps, kernels, pools, rank) for a tower shape, honouring per-shape
    overrides: 3-D towers when every kernel has >= 3 entries, else 2-D;
    kernels and pools are padded with 1s / truncated to that rank."""
    maps, kernels, pools = config.cnn_maps, config.cnn_kernels, config.cnn_pools
    for entry in config.cnn_by_shape:
        if tuple(entry[0]) == tuple(shape):
            maps, kernels, pools = entry[1], entry[2], entry[3]
            break
    rank = 3 if all(len(k) >= 3 for k in kernels) else 2
    kernels = tuple((tuple(k) + (1, 1))[:rank] for k in kernels)
    pools = tuple((tuple(p) + (1, 1))[:rank] for p in pools)
    return tuple(maps), kernels, pools, rank


def _tower_key(shape):
    return "x".join(str(s) for s in shape)


def _init_conv(generator, kernel, c_in, c_out, device):
    """Conv kernel (*spatial, c_in, c_out), glorot-uniform, zero bias."""
    limit = math.sqrt(6.0 / (math.prod(kernel) * (c_in + c_out)))
    u = torch.rand(tuple(kernel) + (c_in, c_out), generator=generator, device=generator.device)
    return {"w": ((2.0 * u - 1.0) * limit).to(device=device, dtype=torch.float32).contiguous(),
            "b": torch.zeros((c_out,), device=device, dtype=torch.float32)}


def _tower_volumes(config, shape, n_names):
    """(c_in, spatial) before each block of a tower and after its last:
    VALID convs, SAME (ceil) pools.  2-D towers carry the same-shape images
    as channels, 3-D towers as the depth axis of one channel."""
    maps_list, kernels, pools, rank = _shape_cnn(config, shape)
    if rank == 2:
        spatial, c_in = [shape[0], shape[1]], n_names
    else:
        spatial, c_in = [shape[0], shape[1], n_names], 1
    steps = [(c_in, tuple(spatial))]
    for maps, kern, pool in zip(maps_list, kernels, pools):
        for d in range(rank):
            spatial[d] = spatial[d] - kern[d] + 1
            if spatial[d] <= 0:
                raise ValueError(f"conv tower for shape {shape}: kernel {kern} does not fit "
                                 f"the remaining volume (dim {d})")
            spatial[d] = -(-spatial[d] // pool[d])
        steps.append((maps, tuple(spatial)))
    return steps


def tower_flat_width(config, shape, n_names):
    """Flattened output width of one conv tower."""
    c_out, spatial = _tower_volumes(config, shape, n_names)[-1]
    return math.prod(spatial) * c_out


def init_jetid(generator, config, device="cuda"):
    """The classifier's parameter tree; every draw from ``generator``."""
    params = {}
    concat_dim = 0
    glorot = ("glorot_uniform", "zeros", device)
    if config.images and config.nn_type == "CNN":
        towers = {}
        for shape, names in _shape_groups(config):
            maps_list, kernels, _, _ = _shape_cnn(config, shape)
            steps = _tower_volumes(config, shape, len(names))
            towers[_tower_key(shape)] = [
                _init_conv(generator, kern, steps[i][0], maps, device)
                for i, (maps, kern) in enumerate(zip(maps_list, kernels))]
            concat_dim += tower_flat_width(config, shape, len(names))
        params["towers"] = towers
    elif config.images:
        concat_dim += sum(math.prod(s) for s in config.image_shapes)
    if config.constituent_dim:
        params["constituents"] = init_mlp(
            generator, [config.constituent_dim] + list(config.branch_neurons), *glorot)
        concat_dim += config.branch_neurons[-1]
    if config.scalar_dims:
        params["scalars"] = init_mlp(
            generator, [sum(config.scalar_dims)] + list(config.branch_neurons), *glorot)
        concat_dim += config.branch_neurons[-1]
    params["head"] = init_mlp(generator, [concat_dim] + list(config.fcn_neurons), *glorot)
    params["out"] = init_dense(generator, config.fcn_neurons[-1], config.n_classes, *glorot)
    return params


def concat_segments(config):
    """Ordered ``(label, width)`` segments of the trunk's input:
    shape-grouped towers in first-appearance order (or per-image flattens in
    FCN mode), then constituents, then scalars."""
    segs = []
    if config.images and config.nn_type == "CNN":
        for shape, names in _shape_groups(config):
            segs.append(("tower:" + _tower_key(shape),
                         tower_flat_width(config, shape, len(names))))
    elif config.images:
        for name, shape in zip(config.images, config.image_shapes):
            segs.append(("image:" + name, math.prod(shape)))
    if config.constituent_dim:
        segs.append(("constituents", config.branch_neurons[-1]))
    if config.scalar_dims:
        segs.append(("scalars", config.branch_neurons[-1]))
    return segs


def _dropout(x, rate, generator, train):
    """Inverted dropout; each call draws its own mask from ``generator``."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _conv_tower(convs, x, pools, rank, dropout, generator, train):
    """``x`` arrives channels-last: (N, h, w, c) for 2-D towers,
    (N, h, w, d, 1) for 3-D towers.  Returns the (h, w, c) flatten."""
    for i, conv in enumerate(convs):
        pool = tuple(pools[i])
        if i == 0 and rank == 2 and supported(x.shape, conv["w"].shape, pool):
            # first block only: its backward gives no gradient for x, which
            # is input data here by construction
            x = fused_conv1_pool_relu(x, conv["w"], conv["b"], pool)
        else:
            x = torch.relu(maxpool_same(conv2d_valid(x, conv["w"]) + conv["b"], pool))
        x = _dropout(x, dropout, generator, train)
    return x.reshape(x.shape[0], -1)


def _dense_stack(layers, x, dropout, generator, train):
    """Dense > ReLU > Dropout per layer."""
    for layer in layers:
        x = _dropout(torch.relu(dense_apply(layer, x)), dropout, generator, train)
    return x


def l2_penalty(params):
    """Sum of squared kernels over every hidden Dense/Conv layer (biases and
    the softmax output layer are excluded).  Multiply by config.l2."""
    def kernels(node):
        if isinstance(node, dict):
            for key in sorted(node):
                if key == "w" and isinstance(node[key], torch.Tensor):
                    yield node[key]
                else:
                    yield from kernels(node[key])
        elif isinstance(node, (list, tuple)):
            for sub in node:
                yield from kernels(sub)

    leaves = [w for name in sorted(params) if name != "out" for w in kernels(params[name])]
    return torch.stack([w.square().sum() for w in leaves]).sum()


def jetid_apply(params, config, inputs, generator=None, train=False):
    """Forward pass -> class probabilities.  ``inputs`` is a dict of tensors
    keyed by branch name ('constituents', scalar names, image names) on the
    parameters' device; same-shape images are stacked on the channel axis
    into one tower.  ``generator`` draws the dropout masks when ``train``."""
    if config.compute_dtype != "float32":
        raise NotImplementedError(f"compute_dtype {config.compute_dtype!r}: the port computes "
                                  "in float32 (ROADMAP Queue 1 item 9, bf16 compute)")
    if train and config.dropout and generator is None:
        raise ValueError("jetid_apply(train=True) with dropout needs a torch.Generator")
    branches = []
    if config.images and config.nn_type == "CNN":
        for shape, names in _shape_groups(config):
            x = torch.stack([inputs[n] for n in names], dim=-1)   # (N, h, w, n_images)
            _, _, pools, rank = _shape_cnn(config, shape)
            if rank == 3:
                x = x.unsqueeze(-1)   # the image stack becomes the depth axis
            branches.append(_conv_tower(params["towers"][_tower_key(shape)], x, pools, rank,
                                        config.dropout, generator, train))
    elif config.images:
        for name in config.images:
            branches.append(inputs[name].reshape(inputs[name].shape[0], -1))
    if config.constituent_dim:
        h = inputs["constituents"].reshape(inputs["constituents"].shape[0], -1)
        branches.append(_dense_stack(params["constituents"], h, config.dropout, generator,
                                     train))
    if config.scalar_dims:
        h = torch.cat([inputs[name].reshape(inputs[name].shape[0], -1)
                       for name in config.scalars], dim=-1)
        branches.append(_dense_stack(params["scalars"], h, config.dropout, generator, train))
    h = torch.cat(branches, dim=-1) if len(branches) > 1 else branches[0]
    h = _dense_stack(params["head"], h, config.dropout, generator, train)
    return torch.softmax(dense_apply(params["out"], h), dim=-1)
