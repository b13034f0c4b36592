"""Per-jet anomaly discriminants on tensors.

Counterpart of ``atlasvae/eval/metrics.py``: MSE, MAE, MARE, KLD, JSD,
X-S and Inputs over (jets, features) tensors on their own device, the
encoder-KLD Latent metric (through the stack-forward kernel on CUDA),
``loss_mapping`` and ``compute_metric_bank``.  EMD treats each row as a
constituent cloud and KSD as a sample (``ops/emd.py``: the hand-written
Sinkhorn kernel on CUDA); with a ``mesh`` their jet axis is split over the
``data`` ranks.  Scores come back as numpy arrays.
"""

import numpy as np
import torch

from ..data.jets import jets_3v
from ..losses.vae_losses import kld_loss
from ..models.vae import encode
from ..ops.emd import emd_pairs, ks_pairs
from ..utils.tensors import as_float_tensor

METRIC_NAMES = ("MSE", "MAE", "MARE", "KLD", "JSD", "X-S", "Inputs", "Latent",
                "EMD", "KSD")

_CHUNK = 1_000_000


def _kld_terms(p, q):
    """Elementwise p*log2(p/q) with the reference's nan_to_num guard: NaN
    terms (0*log(0/0)) drop to 0, +/-inf terms (q == 0 with p != 0)
    saturate to the float max."""
    return torch.nan_to_num(p * torch.log2(p / q))


def _metric_kernel(p, q, metric):
    if metric in ("Inputs", "Inputs_scaled"):
        return torch.mean(p, dim=1)
    if metric == "MSE":
        return torch.mean((p - q) ** 2, dim=1)
    if metric == "MAE":
        return torch.mean(torch.abs(p - q), dim=1)
    if metric == "MARE":
        return torch.mean(torch.abs(p - q) / p, dim=1)
    # sums are re-saturated: several float-max terms overflow f32 to inf,
    # which would turn into NaN in loss_mapping's x/(|x|+1)
    if metric == "KLD":
        return torch.nan_to_num(torch.sum(_kld_terms(p, q), dim=1))
    if metric == "JSD":
        m = (p + q) / 2
        return torch.nan_to_num(torch.sum((_kld_terms(p, m) + _kld_terms(q, m)) / 2, dim=1))
    if metric == "X-S":
        return torch.nan_to_num(torch.sum(_kld_terms(p, p * q), dim=1))
    raise ValueError(f"unknown metric {metric!r}")


def loss_function(p, q, n_dims=3, metric="MAE", x_losses=None, multiloss=True,
                  device="cuda", mesh=None):
    """One discriminant over (true, predicted) matrices -> numpy (jets,).
    Tensors are scored on their own device; arrays on ``device``.  EMD
    reads each row as ``n_dims``-component constituents; ``mesh`` shards
    EMD's and KSD's jet axis."""
    p = as_float_tensor(p, device)
    q = as_float_tensor(q, p.device)
    if metric == "EMD":
        # on the model's input as it is fed, scaled constituents included
        out = emd_pairs(jets_3v(p, n_dims), jets_3v(q, n_dims), mesh=mesh)
    elif metric == "KSD":
        out = ks_pairs(p, q, mesh=mesh)
    else:
        out = np.concatenate([
            _metric_kernel(p[i:i + _CHUNK], q[i:i + _CHUNK], metric).cpu().numpy()
            for i in range(0, len(p), _CHUNK)
        ]) if len(p) else np.zeros(0, np.float32)
    if multiloss and x_losses is not None:
        x_losses[metric] = out
        return None
    return out


def _latent_kernel(params, x):
    z_mean, z_log_var = encode(params, x)
    kld = kld_loss(z_mean, z_log_var)
    return torch.where(torch.isfinite(kld), kld, torch.zeros((), device=kld.device))


def latent_loss(x_true, params, chunk=100_000, device="cuda"):
    """Encoder KLD per jet, in chunks of ``chunk`` jets."""
    x_true = as_float_tensor(x_true, device)
    if not len(x_true):
        return np.zeros(0, np.float32)
    return np.concatenate([
        _latent_kernel(params, x_true[i:i + chunk].contiguous()).cpu().numpy()
        for i in range(0, len(x_true), chunk)
    ])


def loss_mapping(x):
    """Map any loss distribution into [0, 1] (same branch structure as
    atlasvae.eval.metrics.loss_mapping)."""
    x = np.asarray(x)
    if np.all((x >= 0) & (x <= 1)):
        return x
    if np.all((x >= -1) & (x <= 0)):
        return x + 1
    if np.all(x >= 0):
        return x / (np.abs(x) + 1)
    if np.all(x <= 0):
        return x / (np.abs(x) + 1) + 1
    return (x / (np.abs(x) + 1) + 1) / 2


def compute_metric_bank(x_true, x_pred, params=None, metrics=("Latent", "MAE", "KLD", "JSD"),
                        n_dims=3, sample=None, normal_losses=True, device="cuda", mesh=None):
    """Every requested metric in turn -> {name: numpy (jets,)}; ``mesh``
    shards the EMD/KSD jet axis over its ``data`` ranks (each rank calls
    with the same arguments)."""
    x_losses = {}
    for metric in metrics:
        if metric == "Latent":
            if params is not None:
                x_losses["Latent"] = latent_loss(x_true, params, device=device)
        elif metric == "Inputs":
            if sample is not None and "constituents" in sample:
                x_losses["Inputs"] = loss_function(sample["constituents"], x_pred, n_dims,
                                                   "Inputs", multiloss=False, device=device)
            x_losses["Inputs_scaled"] = loss_function(x_true, x_pred, n_dims,
                                                      "Inputs_scaled", multiloss=False,
                                                      device=device)
        else:
            x_losses[metric] = loss_function(x_true, x_pred, n_dims, metric,
                                             multiloss=False, device=device, mesh=mesh)
    if normal_losses:
        x_losses = {k: loss_mapping(v) for k, v in x_losses.items()}
    return x_losses
