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

``train_lanes`` is the epoch loop; ``train_model`` runs it on one lane and
``train/ensemble.py`` on G lanes that share every load's device batches.
With a ``mesh``, every rank runs ``train_model`` on the whole sample and
steps its rows of each batch (``train/step.py``; ``batch_load`` rounds the
batch down to a multiple of the ``data`` ranks), and rank 0 alone writes
the history, checkpoints and state file.

The reparameterization noise comes from one ``torch.Generator`` on the
training device, seeded with ``seed``.
"""

import os
import time

import numpy as np
import torch

from ..parallel.mesh import axis_size, is_writer, shard_batch
from .checkpoint import save_weights, save_history, load_history, save_pytree, load_pytree
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


def new_history(beta, lamb):
    """An empty history with ``train_model``'s keys for these weights."""
    history = {"MSE": []}
    if beta != 0:
        history["KLD"] = []
    if lamb != 0:
        history["OE"] = []
    history.update({"Train loss": [], "Valid loss": []})
    return history


class Lane:
    """One configuration under training: its step functions, parameters and
    Adam (``TrainState``), lr, plateau count, noise generator, history and
    files.  ``count`` -1 in a state tree records that the plateau schedule
    stopped the lane."""

    def __init__(self, params, oe_type, beta, lamb, margin, activation, lr, seed,
                 hist_file=None, model_out=None, noise_source=None, tag="", mesh=None):
        self.state = TrainState(params)
        self.device = self.state.flat.device
        self.mesh = mesh
        self.train_on_load, self.valid_losses = make_vae_step_fns(oe_type, beta, lamb, margin,
                                                                  activation, mesh)
        self.beta, self.lamb, self.lr, self.count, self.stopped = beta, lamb, float(lr), 0, False
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.history = new_history(beta, lamb)
        self.hist_file, self.model_out, self.noise_source, self.tag = \
            hist_file, model_out, noise_source, tag

    def state_tree(self):
        return {"params": self.state.params, "adam_count": torch.tensor(self.state.adam.count),
                "adam_mu": self.state.adam.mu, "adam_nu": self.state.adam.nu,
                "lr": torch.tensor(self.lr, dtype=torch.float64),
                "count": torch.tensor(-1 if self.stopped else self.count),
                "generator": self.generator.get_state()}

    def load_state(self, saved):
        adam = Adam(self.state.flat.numel(), self.device, int(saved["adam_count"]),
                    saved["adam_mu"], saved["adam_nu"])
        self.state = TrainState(saved["params"], adam)
        self.lr, self.count = float(saved["lr"]), int(saved["count"])
        self.stopped = self.count < 0
        self.generator.set_state(saved["generator"])

    def noise(self, phase, epoch, load_idx, batches):
        if self.noise_source is None:
            return None
        rows = batches[0].shape[1] * (1 if self.mesh is None else axis_size(self.mesh, "data"))
        noise = self.noise_source(phase, epoch, load_idx, batches[0].shape[0], rows)
        if self.mesh is not None:
            noise = shard_batch(self.mesh, tuple(noise))
        return to_device(noise, self.device)

    def losses(self, sums, n_seen):
        d = n_seen if n_seen > 0 else 1.0  # all-padding load guard
        losses = {"MSE": sums[0] / d}
        if self.beta != 0:
            losses["KLD"] = sums[1] / d
        if self.lamb != 0:
            losses["OE"] = sums[2] / d
        losses["Train loss"] = sums[3] / d
        return losses


def train_model(params, train_sample, valid_sample, oe_type="KLD", n_epochs=1,
                batch_size=5000, beta=0.0, lamb=0.0, margin=0.0, lr=1e-3, hist_file=None,
                model_in=None, model_out=None, mesh=None, seed=0, activation="relu",
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

    ``mesh``: a ``data`` mesh (``parallel.data_parallel_mesh``) to train
    over, every rank calling with the same arguments.
    """
    lane = Lane(params, oe_type, beta, lamb, margin, activation, lr, seed, hist_file, model_out,
                noise_source, mesh=mesh)
    resuming_state = state_file and os.path.isfile(state_file)
    if hist_file and os.path.isfile(hist_file) and \
            (resuming_state or (model_in and os.path.isfile(model_in))):
        lane.history = load_history(hist_file)
    if resuming_state:
        lane.load_state(load_pytree(state_file, lane.state_tree()))
        if lane.stopped:  # terminal marker written when the schedule stopped
            print(f"Training already terminated by the plateau schedule "
                  f"(state file {state_file}) — not resuming past it")
            return lane.state.detached(), lane.history
        print(f"Resuming full train state from {state_file} "
              f"(lr={lane.lr:g}, plateau count={lane.count})")
    print("STARTING TRAINING (loads/epoch: %d)" % len(train_sample))
    train_lanes([lane], train_sample, valid_sample, n_epochs, batch_size, valid_batch_size,
                (lambda: save_pytree(state_file, lane.state_tree()))
                if state_file and is_writer(mesh) else None)
    return lane.state.detached(), lane.history


def train_lanes(lanes, train_sample, valid_sample, n_epochs, batch_size,
                valid_batch_size=int(1e6), save_state=None, all_stopped=None):
    """The single implementation of the VAE epoch loop, over one lane
    (``train_model``) or several (``train/ensemble.py``).  The lanes share
    each load's device batches (one ``LoadCache``); every load is stepped
    lane after lane, and each lane accumulates its metrics as a run of its
    own would.  A lane the plateau schedule has stopped takes no further
    step or validation.  ``save_state()`` runs after every epoch; the loop
    ends early once ``all_stopped()`` (default: every lane has stopped)."""
    if all_stopped is None:
        all_stopped = lambda: all(lane.stopped for lane in lanes)
    load_cache = LoadCache(lanes[0].device)
    mesh = lanes[0].mesh
    n_devices = 1 if mesh is None else axis_size(mesh, "data")
    writer = is_writer(mesh)
    for epoch in range(n_epochs):
        start_time = time.time()
        print("\nEpoch %d/%d:" % (epoch + 1, n_epochs))
        live = [lane for lane in lanes if not lane.stopped]
        sums = [np.zeros(4) for _ in live]
        n_seen = [0.0] * len(live)
        for load_idx, (bkg_sample, ood_sample) in enumerate(train_sample):
            batches = load_cache.get(
                (bkg_sample, ood_sample), (batch_size, n_devices),
                lambda: batch_load(features(bkg_sample), features(ood_sample),
                                   bkg_sample["weights"], ood_sample["weights"], batch_size,
                                   n_devices), mesh)
            for i, lane in enumerate(live):
                metrics = lane.train_on_load(lane.state, lane.lr, lane.generator, batches,
                                             lane.noise("train", epoch, load_idx, batches))
                metrics = metrics.cpu().numpy()
                sums[i] += metrics[:, :4].sum(axis=0)
                n_seen[i] += metrics[:, 4].sum()
                ticker = "  ".join(f"{k} = {v:4.3e}"
                                   for k, v in lane.losses(sums[i], n_seen[i]).items())
                print(f"{lane.tag}Batches {int(metrics[:, 4].sum() // max(batch_size, 1))}: "
                      f"mean losses  -->  {ticker}", flush=True)
        valid_sum, valid_n = [0.0] * len(live), [0.0] * len(live)
        for load_idx, (bkg_sample, ood_sample) in enumerate(valid_sample):
            vbs = min(valid_batch_size, len(bkg_sample["weights"]))
            batches = load_cache.get(
                (bkg_sample, ood_sample), (vbs, n_devices),
                lambda: batch_load(features(bkg_sample), features(ood_sample),
                                   bkg_sample["weights"], ood_sample["weights"], vbs,
                                   n_devices), mesh)
            for i, lane in enumerate(live):
                metrics = lane.valid_losses(lane.state.params, lane.generator, batches,
                                            lane.noise("valid", epoch, load_idx, batches))
                metrics = metrics.cpu().numpy()
                valid_sum[i] += metrics[:, 0].sum()
                valid_n[i] += metrics[:, 1].sum()
        for lane in lanes:
            if lane not in live:
                print(f"{lane.tag}[stopped]")
        for i, lane in enumerate(live):
            losses = lane.losses(sums[i], n_seen[i])
            losses["Valid loss"] = valid_sum[i] / max(valid_n[i], 1)
            print(f"{lane.tag}Valid loss = {losses['Valid loss']:4.3e}  "
                  f"({time.time() - start_time:.1f}s)")
            # a resumed history may carry keys this run does not produce
            # (KLD saved with beta != 0, resumed with beta == 0): pad with 0.0
            for k in lane.history:
                lane.history[k] = list(lane.history[k]) + [float(losses[k]) if k in losses
                                                           else 0.0]
            if lane.hist_file and writer:
                save_history(lane.history, lane.hist_file)
            # a resumed run has prior history to compare against, so its
            # first epoch checkpoints too (a fresh run skips epoch 0:
            # history[:-1] is empty)
            if epoch > 0 or len(lane.history["Train loss"]) > 1:
                lane.lr, count = model_checkpoint(lane.state.params, lane.lr, lane.history,
                                                  lane.model_out if writer else None,
                                                  lane.count)
                lane.stopped = count is None
                lane.count = lane.count if count is None else count
        if save_state:
            # a stopped lane's count is saved as -1, so that a rerun does not
            # resume training past the schedule's stop decision
            save_state()
        if all_stopped():
            break


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
