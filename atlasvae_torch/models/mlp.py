"""Dense stacks as plain dicts of tensors.

Counterpart of ``atlasvae/models/mlp.py``.  A layer is {'w': (in, out),
'b': (out,)}, the JAX package's layout (not ``nn.Linear``'s (out, in)), so
weights move between the two packages unchanged.  Every random draw comes
from an explicit ``torch.Generator``.
"""

import math

import torch

from ..ops.activations import leaky_relu0, relu


def _he_normal(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device) * \
        math.sqrt(2.0 / shape[0])


def _glorot_uniform(generator, shape):
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * limit


_KERNEL_INITS = {"he_normal": _he_normal, "glorot_uniform": _glorot_uniform}


def init_dense(generator, in_dim, out_dim, kernel_init="he_normal", bias_init="zeros",
               device="cuda"):
    """One dense layer.  Hidden layers use he_normal kernels and
    standard-normal biases; output heads glorot_uniform kernels and zero
    biases (as atlasvae.models.mlp.init_dense)."""
    w = _KERNEL_INITS[kernel_init](generator, (in_dim, out_dim))
    if bias_init == "normal":
        b = torch.randn((out_dim,), generator=generator, device=generator.device)
    else:
        b = torch.zeros((out_dim,))
    return {"w": w.to(device=device, dtype=torch.float32).contiguous(),
            "b": b.to(device=device, dtype=torch.float32).contiguous()}


def dense_apply(layer, x):
    return x @ layer["w"] + layer["b"]


def init_mlp(generator, dims, kernel_init="he_normal", bias_init="normal", device="cuda"):
    """Stack of dense layers with sizes dims[0] -> dims[1] -> ... -> dims[-1]."""
    return [init_dense(generator, dims[i], dims[i + 1], kernel_init, bias_init, device)
            for i in range(len(dims) - 1)]


_ACTIVATIONS = {
    "relu": relu,
    "leaky_relu": leaky_relu0,  # the reference's leaky_relu has slope 0
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
}


def mlp_apply(layers, x, activation="relu", final_activation=None):
    """Apply a dense stack; ``activation`` between layers, and
    ``final_activation`` (default: same) on the last layer's output."""
    act = _ACTIVATIONS[activation]
    last = _ACTIVATIONS[final_activation] if final_activation else act
    for i, layer in enumerate(layers):
        x = dense_apply(layer, x)
        x = last(x) if i == len(layers) - 1 else act(x)
    return x
