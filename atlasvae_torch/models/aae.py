"""Adversarial autoencoder: AE + 3-class discriminator.

Counterpart of ``atlasvae/models/aae.py`` with the same parameter tree
({'encoder': {'hidden', 'out'}, 'decoder': {'hidden', 'out'},
'discriminator': {'hidden', 'out'}}, dense ``w`` as (in, out)), so weights
move between the two packages unchanged.  Keras-default inits
(glorot_uniform kernels, zero biases); the latent and the reconstruction
end in ReLU, the discriminator in a softmax over {0: QCD, 1: reconstructed
QCD, 2: OoD}.  The products are ``torch.matmul`` (``models/mlp.py``): the
JAX package runs them as plain XLA, with no Pallas kernel.
"""

import dataclasses

import torch

from ..ops.activations import relu
from .mlp import init_mlp, init_dense, dense_apply, mlp_apply


@dataclasses.dataclass(frozen=True)
class AAEConfig:
    input_dim: int = 12
    ae_layers: tuple = (100, 100, 100)
    disc_layers: tuple = (100, 100, 3)
    activation: str = "relu"


def init_aae(generator, config, device="cuda"):
    """Random AAE parameters drawn from ``generator``."""
    hidden = list(config.ae_layers[:-1])
    latent = config.ae_layers[-1]
    glorot = ("glorot_uniform", "zeros", device)
    return {
        "encoder": {
            "hidden": init_mlp(generator, [config.input_dim] + hidden, *glorot),
            "out": init_dense(generator, hidden[-1] if hidden else config.input_dim,
                              latent, *glorot),
        },
        "decoder": {
            "hidden": init_mlp(generator, [latent] + hidden[::-1], *glorot),
            "out": init_dense(generator, hidden[0] if hidden else latent,
                              config.input_dim, *glorot),
        },
        "discriminator": {
            "hidden": init_mlp(generator, [config.input_dim] + list(config.disc_layers[:-1]),
                               *glorot),
            "out": init_dense(generator, config.disc_layers[-2], config.disc_layers[-1],
                              *glorot),
        },
    }


def ae_apply(params, x, activation="relu"):
    """Autoencoder forward: ReLU latent, ReLU reconstruction."""
    h = mlp_apply(params["encoder"]["hidden"], x, activation)
    z = relu(dense_apply(params["encoder"]["out"], h))
    h = mlp_apply(params["decoder"]["hidden"], z, activation)
    return relu(dense_apply(params["decoder"]["out"], h))


def discriminator_apply(params, x, activation="relu"):
    """3-class softmax probabilities."""
    h = mlp_apply(params["discriminator"]["hidden"], x, activation)
    return torch.softmax(dense_apply(params["discriminator"]["out"], h), dim=-1)
