from .mlp import init_dense, init_mlp, mlp_apply, dense_apply
from .vae import (
    VAEConfig, init_vae, encode, decode, reparameterize, vae_apply, clip_values,
)
from .jetid import (JetIDConfig, init_jetid, jetid_apply, l2_penalty, concat_segments,
                    tower_flat_width)

__all__ = [
    "JetIDConfig", "init_jetid", "jetid_apply", "l2_penalty", "concat_segments",
    "tower_flat_width",
    "init_dense", "init_mlp", "mlp_apply", "dense_apply",
    "VAEConfig", "init_vae", "encode", "decode", "reparameterize", "vae_apply",
    "clip_values",
]
