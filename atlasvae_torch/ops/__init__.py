from .fused_mlp import fused_mlp_apply, fused_mlp_plain
from .fused_vae import stack_forward, stack_forward_plain, fused_encoder

__all__ = ["fused_mlp_apply", "fused_mlp_plain", "stack_forward",
           "stack_forward_plain", "fused_encoder"]
