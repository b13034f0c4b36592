"""Variational autoencoder: encoder -> (mu, log sigma^2) -> reparameterize -> decoder.

Counterpart of ``atlasvae/models/vae.py`` with the same parameter tree
({'encoder': {'hidden', 'mean', 'logvar'}, 'decoder': {'hidden', 'out'}}).
With ReLU activations ``encode`` goes through ``fused_encoder`` and, when
autograd records, ``decode`` through ``fused_decoder`` (ops/fused_vae.py:
K2 forward, K3 backward on a CUDA tensor); with grad disabled (scoring
under ``torch.inference_mode``) ``decode`` runs the fused dense-stack
kernel K1 (ops/fused_mlp.py).  On a CPU tensor every one of them runs its
plain version.
"""

import dataclasses

import torch

from .mlp import init_mlp, init_dense, dense_apply, mlp_apply
from ..ops.fused_mlp import fused_mlp_apply
from ..ops.fused_vae import fused_encoder, fused_decoder


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    fc_layers: tuple = (80, 40, 20, 10)
    input_dim: int = 12
    activation: str = "relu"


def init_vae(generator, config, device="cuda"):
    """Random VAE parameters drawn from ``generator`` (he_normal hidden
    kernels with standard-normal biases, glorot_uniform heads)."""
    hidden = list(config.fc_layers[:-1])
    latent = config.fc_layers[-1]
    enc_dims = [config.input_dim] + hidden
    dec_dims = [latent] + hidden[::-1]
    head_in = hidden[-1] if hidden else config.input_dim
    return {
        "encoder": {
            "hidden": init_mlp(generator, enc_dims, "he_normal", "normal", device),
            "mean": init_dense(generator, head_in, latent, "glorot_uniform", "zeros", device),
            "logvar": init_dense(generator, head_in, latent, "glorot_uniform", "zeros",
                                 device),
        },
        "decoder": {
            "hidden": init_mlp(generator, dec_dims, "he_normal", "normal", device),
            "out": init_dense(generator, dec_dims[-1], config.input_dim,
                              "glorot_uniform", "zeros", device),
        },
    }


def clip_values(x, max_val=1e6):
    """Non-finite -> 0, then clip to [-max_val, max_val]."""
    x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.clamp(x, -max_val, max_val)


def encode(params, x, activation="relu"):
    if activation == "relu":
        return fused_encoder(params["encoder"], x)
    h = mlp_apply(params["encoder"]["hidden"], x, activation)
    return dense_apply(params["encoder"]["mean"], h), dense_apply(params["encoder"]["logvar"], h)


def reparameterize(z_mean, z_log_var, noise=None, generator=None):
    """z = mean + clip(exp(logvar / 2)) * noise; ``noise`` is drawn from
    ``generator`` when not given."""
    sigma = clip_values(torch.exp(z_log_var / 2))
    if noise is None:
        if generator is None:
            raise ValueError("reparameterize needs explicit noise or a torch.Generator")
        noise = torch.randn(z_mean.shape, generator=generator, device=z_mean.device,
                            dtype=z_mean.dtype)
    return z_mean + sigma * noise


def decode(params, z, activation="relu"):
    dec = params["decoder"]
    if activation == "relu":
        if torch.is_grad_enabled():
            return fused_decoder(dec, z)
        return fused_mlp_apply(dec["hidden"] + [dec["out"]], z)
    return dense_apply(dec["out"], mlp_apply(dec["hidden"], z, activation))


def vae_apply(params, x, generator=None, activation="relu", sample=True, noise=None):
    """Full forward pass -> (reconstruction, z_mean, z_log_var).

    ``noise``: an explicit standard-normal draw for the latent sample;
    otherwise it is drawn from ``generator``."""
    z_mean, z_log_var = encode(params, x, activation)
    z = reparameterize(z_mean, z_log_var, noise, generator) if sample else z_mean
    reconstructed = clip_values(decode(params, z, activation))
    return reconstructed, z_mean, z_log_var
