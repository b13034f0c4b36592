from .vae_losses import kld_loss

__all__ = ["kld_loss"]
