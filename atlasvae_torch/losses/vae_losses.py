"""VAE losses.  This slice carries only the latent KLD that the scoring
path's Latent metric needs; the loss bank (reconstruction, outlier
exposure, totals) comes with the training slice.

Counterpart of ``atlasvae/losses/vae_losses.py``.
"""

import torch

from ..models.vae import clip_values


def kld_loss(z_mean, z_log_var):
    """-mean(1 + log_var - clip(exp(log_var)) - mean^2) / 2 per sample."""
    z_exp = clip_values(torch.exp(z_log_var))
    return -torch.mean(1 + z_log_var - z_exp - z_mean ** 2, dim=-1) / 2
