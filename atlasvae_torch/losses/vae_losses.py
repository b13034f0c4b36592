"""VAE training losses: reconstruction + beta*KLD + lambda*outlier-exposure.

Counterpart of ``atlasvae/losses/vae_losses.py``, per-sample vectors as
there:

* reconstruction: MSE (OE types MSE/MSE-margin) or MAE (MAE/MAE-margin/KLD),
  mean over features;
* KLD: -mean(1 + log_var - exp(log_var) - mean^2)/2, exp clipped to 1e6;
* OE: KLD gap relu(KLD_bkg - KLD_OoD + margin), or the reconstruction gap
  through a sigmoid (MSE/MAE) or relu(gap + margin) (the -margin types);
* total: w*recon + beta*w*KLD + lambda*w_OoD*OE.

The background forward runs once and feeds both the reconstruction term
and the OE gap, as in the JAX package.
"""

import torch

from ..models.vae import clip_values, encode, vae_apply
from ..ops.activations import relu


def reconstruction_loss(x, x_hat, oe_type):
    if oe_type in ("MSE", "MSE-margin"):
        return torch.mean((x - x_hat) ** 2, dim=-1)
    return torch.mean(torch.abs(x - x_hat), dim=-1)


def kld_loss(z_mean, z_log_var):
    """-mean(1 + log_var - clip(exp(log_var)) - mean^2) / 2 per sample."""
    z_exp = clip_values(torch.exp(z_log_var))
    return -torch.mean(1 + z_log_var - z_exp - z_mean ** 2, dim=-1) / 2


def oe_loss(recon_bkg_loss, kld_bkg, params, x_ood, oe_type, margin, generator=None,
            activation="relu", noise=None, forward=(encode, vae_apply)):
    """Outlier-exposure term: for 'KLD' the gap between latent KLDs,
    otherwise between reconstruction losses."""
    encode_fn, apply_fn = forward
    if oe_type == "KLD":
        z_mean_ood, z_log_var_ood = encode_fn(params, x_ood, activation)
        return relu(kld_bkg - kld_loss(z_mean_ood, z_log_var_ood) + margin)
    recon_ood, _, _ = apply_fn(params, x_ood, generator, activation, noise=noise)
    gap = recon_bkg_loss - reconstruction_loss(x_ood, recon_ood, oe_type)
    if oe_type in ("MSE", "MAE"):
        return torch.sigmoid(gap)
    return relu(gap + margin)  # MSE-margin / MAE-margin


def get_losses(params, bkg_x, ood_x, bkg_w, ood_w, generator=None, oe_type="KLD",
               beta=0.0, lamb=0.0, margin=0.0, activation="relu", noise=None,
               forward=(encode, vae_apply)):
    """Per-sample loss vectors (MSE, KLD, OE, total).

    ``noise``: optional (noise_bkg, noise_ood) explicit latent draws;
    otherwise both are drawn from ``generator``, background first.
    ``forward``: the (encode, vae_apply) pair the losses run, the model's
    own by default (``parallel/tp.py`` passes its column-parallel pair)."""
    noise_bkg, noise_ood = noise if noise is not None else (None, None)
    recon, z_mean, z_log_var = forward[1](params, bkg_x, generator, activation,
                                          noise=noise_bkg)
    raw_recon = reconstruction_loss(bkg_x, recon, oe_type)
    raw_kld = kld_loss(z_mean, z_log_var)
    loss_mse = raw_recon * bkg_w
    loss_kld = raw_kld * bkg_w * beta
    loss_oe = oe_loss(raw_recon, raw_kld, params, ood_x, oe_type, margin, generator,
                      activation, noise_ood, forward)
    loss_oe = loss_oe * ood_w * lamb
    total = loss_mse + loss_kld + loss_oe
    return loss_mse, loss_kld, loss_oe, total
