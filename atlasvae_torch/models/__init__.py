from .mlp import init_dense, init_mlp, mlp_apply, dense_apply
from .vae import (
    VAEConfig, init_vae, encode, decode, reparameterize, vae_apply, clip_values,
)

__all__ = [
    "init_dense", "init_mlp", "mlp_apply", "dense_apply",
    "VAEConfig", "init_vae", "encode", "decode", "reparameterize", "vae_apply",
    "clip_values",
]
