from .vae_losses import reconstruction_loss, kld_loss, oe_loss, get_losses

__all__ = ["reconstruction_loss", "kld_loss", "oe_loss", "get_losses"]
