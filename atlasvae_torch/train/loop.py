"""VAE training loop: epochs over streamed loads, plateau LR, checkpoints.

Counterpart of ``atlasvae/train/loop.py``, same control flow:

* epoch metrics are weighted per-sample means over the epoch's loads;
* validation runs every epoch, in batches of up to ``valid_batch_size``;
* the history is pickled every epoch, and appended to across restarts when
  ``model_in`` or a full-state file is there;
* plateau controller on 'Train loss': patience 3, factor 2, min_delta 1e-3,
  min_lr 1e-4, saving the best weights;
* ``state_file``: params, Adam moments and count, lr, plateau count and the
  noise generator's state, written every epoch and resumed bit for bit.

The reparameterization noise comes from one ``torch.Generator`` on the
training device, seeded with ``seed``.
"""

import os
import time

import numpy as np
import torch

from .checkpoint import (save_weights, save_history, load_history, save_pytree, load_pytree,
                         tree_flatten)
from .step import make_vae_step_fns, batch_load, LoadCache, TrainState, Adam, to_device


def features(sample):
    """Assemble the model input matrix from a sample dict: constituents,
    then HLVs, whichever are present (tensors or arrays)."""
    if "constituents" in sample and "HLVs" in sample:
        parts = [sample["constituents"], sample["HLVs"]]
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, dim=1)
        return np.hstack(parts)
    if "constituents" in sample:
        return sample["constituents"]
    return sample["HLVs"]


def _state_tree(state, lr, count, generator):
    return {"params": state.params, "adam_count": torch.tensor(state.adam.count),
            "adam_mu": state.adam.mu, "adam_nu": state.adam.nu,
            "lr": torch.tensor(lr, dtype=torch.float64), "count": torch.tensor(count),
            "generator": generator.get_state()}


def train_model(params, train_sample, valid_sample, oe_type="KLD", n_epochs=1,
                batch_size=5000, beta=0.0, lamb=0.0, margin=0.0, lr=1e-3, hist_file=None,
                model_in=None, model_out=None, seed=0, activation="relu",
                valid_batch_size=int(1e6), state_file=None, noise_source=None):
    """Train the VAE on the device its ``params`` lie on; returns (params,
    history).

    ``train_sample``/``valid_sample`` iterate (bkg_sample, ood_sample) load
    pairs (a BatchGenerator or a list of such pairs).

    ``noise_source``: optional deterministic reparameterization-noise
    injector, ``noise_source(phase, epoch, load_idx, n_batches, batch) ->
    (noise_bkg, noise_ood)`` each shaped (n_batches, batch, latent), phase
    "train" or "valid"; it replaces the generator's draws so a run can
    share its latent draws with another framework.
    """
    device = tree_flatten(params)[0].device
    state = TrainState(params)
    lr = float(lr)
    train_on_load, valid_losses = make_vae_step_fns(oe_type, beta, lamb, margin, activation)

    history = {"MSE": []}
    if beta != 0:
        history["KLD"] = []
    if lamb != 0:
        history["OE"] = []
    history.update({"Train loss": [], "Valid loss": []})
    resuming_state = state_file and os.path.isfile(state_file)
    if hist_file and os.path.isfile(hist_file) and \
            (resuming_state or (model_in and os.path.isfile(model_in))):
        history = load_history(hist_file)

    generator = torch.Generator(device).manual_seed(seed)
    count = 0
    if resuming_state:
        saved = load_pytree(state_file, _state_tree(state, lr, count, generator))
        adam = Adam(state.flat.numel(), device, int(saved["adam_count"]), saved["adam_mu"],
                    saved["adam_nu"])
        state = TrainState(saved["params"], adam)
        lr, count = float(saved["lr"]), int(saved["count"])
        generator.set_state(saved["generator"])
        if count < 0:  # terminal marker written when the schedule stopped
            print(f"Training already terminated by the plateau schedule "
                  f"(state file {state_file}) — not resuming past it")
            return state.detached(), history
        print(f"Resuming full train state from {state_file} "
              f"(lr={lr:g}, plateau count={count})")
    load_cache = LoadCache(device)
    print("STARTING TRAINING (loads/epoch: %d)" % len(train_sample))
    for epoch in range(n_epochs):
        start_time = time.time()
        print("\nEpoch %d/%d:" % (epoch + 1, n_epochs))
        sums = np.zeros(4)
        n_seen = 0.0
        # defined before the load loop: an epoch with zero loads still
        # finishes with zeroed metrics
        losses = {k: 0.0 for k in history if k != "Valid loss"}
        for load_idx, (bkg_sample, ood_sample) in enumerate(train_sample):
            batches = load_cache.get(
                (bkg_sample, ood_sample), (batch_size, 1),
                lambda: batch_load(features(bkg_sample), features(ood_sample),
                                   bkg_sample["weights"], ood_sample["weights"], batch_size))
            noise = None
            if noise_source is not None:
                noise = to_device(noise_source("train", epoch, load_idx,
                                               *batches[0].shape[:2]), device)
            metrics = train_on_load(state, lr, generator, batches, noise).cpu().numpy()
            sums += metrics[:, :4].sum(axis=0)
            n_seen += metrics[:, 4].sum()
            d = n_seen if n_seen > 0 else 1.0  # all-padding load guard
            losses = {"MSE": sums[0] / d}
            if beta != 0:
                losses["KLD"] = sums[1] / d
            if lamb != 0:
                losses["OE"] = sums[2] / d
            losses["Train loss"] = sums[3] / d
            ticker = "  ".join(f"{k} = {v:4.3e}" for k, v in losses.items())
            print(f"Batches {int(metrics[:, 4].sum() // max(batch_size, 1))}: "
                  f"mean losses  -->  {ticker}", flush=True)
        valid_sum, valid_n = 0.0, 0.0
        for load_idx, (bkg_sample, ood_sample) in enumerate(valid_sample):
            vbs = min(valid_batch_size, len(bkg_sample["weights"]))
            batches = load_cache.get(
                (bkg_sample, ood_sample), (vbs, 1),
                lambda: batch_load(features(bkg_sample), features(ood_sample),
                                   bkg_sample["weights"], ood_sample["weights"], vbs))
            noise = None
            if noise_source is not None:
                noise = to_device(noise_source("valid", epoch, load_idx,
                                               *batches[0].shape[:2]), device)
            metrics = valid_losses(state.params, generator, batches, noise).cpu().numpy()
            valid_sum += metrics[:, 0].sum()
            valid_n += metrics[:, 1].sum()
        losses["Valid loss"] = valid_sum / max(valid_n, 1)
        print(f"Valid loss = {losses['Valid loss']:4.3e}  "
              f"({time.time() - start_time:.1f}s)")
        for k in history:
            history[k] = list(history[k]) + [float(losses[k]) if k in losses else 0.0]
        if hist_file:
            save_history(history, hist_file)
        # a resumed run has prior history to compare against, so its first
        # epoch checkpoints too (a fresh run skips epoch 0: history[:-1] is
        # empty)
        if epoch > 0 or len(history["Train loss"]) > 1:
            lr, count = model_checkpoint(state.params, lr, history, model_out, count)
        if state_file:
            # count = -1 records termination, so a rerun does not resume
            # training past the schedule's stop decision
            save_pytree(state_file, _state_tree(state, lr, -1 if count is None else count,
                                                generator))
        if count is None:
            break
    return state.detached(), history


def model_checkpoint(params, lr, history, model_out, count, metric="Train loss",
                     patience=3, factor=2, min_delta=1e-3, min_lr=1e-4):
    """Best-metric checkpointing + LR plateau + early stop.  Returns
    (new_lr, count); count None terminates training."""
    hist = history[metric]
    if hist[-1] < np.min(hist[:-1]) - min_delta:
        print(f"{metric} improved from {np.min(hist[:-1]):4.2f} to "
              f"{hist[-1]:4.2f}"
              + (f"  -->  saving model weights to {model_out}" if model_out else ""))
        if model_out:
            save_weights(params, model_out)
        count = 0
    elif hist[-1] > np.min(hist[-(patience + 1):-1]) - min_delta:
        count += 1
    if count >= patience:
        print(f"No improvement for {count} epochs  -->  ", end="", flush=True)
        if lr < min_lr:
            print("terminating training")
            return lr, None
        new_lr = lr / factor
        print(f"reducing learning rate from {lr} to {new_lr}")
        return new_lr, 0
    return lr, count
