"""Adversarial-autoencoder training: the 3-phase GAN cycle.

Counterpart of ``atlasvae/train/aae_loop.py``.  Per cycle: AE epochs
(weighted MAE reconstruction + lamb * the OE sigmoid gap on (QCD, OoD)
pairs), Disc epochs (3-class weighted sparse CE on {QCD: 0, reconstructed
QCD: 1, OoD: 2}), AAE epochs (the AE losses + beta * the CE of the frozen
discriminator on reconstructions labelled {QCD: 0, OoD: 1}); 100 AE epochs
in the first cycle, 0 after, 5 Disc and 5 AAE epochs in every cycle.

The AE subtree ({'encoder', 'decoder'}) and the discriminator subtree each
live as views of one flat float32 buffer (``TrainState``), so a step's
gradient, guard and update are a few launches over the subtree, not one per
leaf.  One ``GanAdam`` spans both subtrees with one step count, as the
reference's single Adam instance does.  A load is moved to the device once
and its batches are stepped through in a Python loop; each phase-epoch's
metrics stay on the device and the host reads them once, when the
phase-epoch ends.  The history keeps the reference's semantics: the last
batch of an AE epoch; the last batch's loss and the epoch's mean accuracy of
a Disc epoch; the batch mean of an AAE epoch, with the real 3-class
discriminator loss and accuracy on the epoch's last batch after it.

Data parallelism (``mesh``): each rank steps its rows of every batch.  A
weighted mean's gradient term is the rank's weighted sum over the global
weight sum (the weight sums of a phase-epoch's batches are all-reduced once
when it starts), so the all-reduced gradient is the global one; the metrics
are those terms summed over the ranks, once when the phase-epoch ends.  Only
the trained subtree's gradient is reduced.
"""

import os
import pickle
import time

import numpy as np
import torch

from ..models.aae import ae_apply, discriminator_apply
from ..parallel.mesh import all_sum, axis_size, is_writer, shard_batch
from .checkpoint import (save_pytree, load_pytree, tree_flatten, tree_unflatten,
                         sniff_weights_format)
from .keras_import import load_keras_aae
from .step import TrainState, clip_gradients

AE_KEYS = ("encoder", "decoder")
DISC_KEYS = ("discriminator",)


def _subtree(params, keys):
    return {k: params[k] for k in keys}


class GanAdam:
    """The reference's legacy Keras Adam shared by the three phases, on flat
    float32 subtrees.

    One step count for every phase: the first Disc step after 100 AE epochs
    runs at t = (AE steps) + 1.  Moments per subtree; a step updates only
    its own subtree's, so the frozen subtree's moments pass through.  The
    update is the legacy formula with eps outside the bias correction,
    u = -alpha * m / (sqrt(v) + eps), alpha = sqrt(1 - b2^t) / (1 - b1^t),
    then p += lr * u.  Written in the order XLA evaluates the JAX package's
    ``make_gan_optimizer`` on the CPU, which it matches bit for bit:
    m = fma(b1, m, (1-b1)*g), v = fma(b2, v, ((1-b2)*g)*g) (torch's
    ``add`` with ``alpha`` is one fused multiply-add), p = fma(u, lr, p);
    alpha in float32 on the host (``powf``); the square root correctly
    rounded (through float64: torch's float32 ``sqrt`` on the CPU is not).
    """

    b1, b2, eps = 0.9, 0.999, 1e-7

    def __init__(self, sizes, device):
        self.count = 0
        self.mu = {key: torch.zeros(n, device=device) for key, n in sizes.items()}
        self.nu = {key: torch.zeros(n, device=device) for key, n in sizes.items()}

    @classmethod
    def alpha(cls, count):
        t = np.float32(count)
        one = np.float32(1)
        return np.sqrt(one - np.float32(cls.b2) ** t) / (one - np.float32(cls.b1) ** t)

    def step(self, key, params, grads, lr):
        """Update the flat ``params`` of subtree ``key`` in place from its
        flat ``grads``, advancing the shared count."""
        self.count += 1
        alpha = float(self.alpha(self.count))
        mu = (grads * (1 - self.b1)).add_(self.mu[key], alpha=self.b1)
        nu = (grads * (1 - self.b2)).mul_(grads).add_(self.nu[key], alpha=self.b2)
        self.mu[key], self.nu[key] = mu, nu
        denom = torch.sqrt(nu.double()).float().add_(self.eps)
        params.add_((mu * -alpha).div_(denom), alpha=lr)


def _frozen(state):
    """The subtree's parameters as views of its flat buffer that autograd
    does not track."""
    return tree_unflatten(state.params, [leaf.detach() for leaf in state.leaves])


def _mae(x, y):
    return torch.mean(torch.abs(x - y), dim=-1)


def _wmean(loss, w, den=None):
    """sum(loss * w) over ``den``, the weight sum (by default ``w``'s)."""
    return torch.sum(loss * w) / torch.clamp(torch.sum(w) if den is None else den, min=1e-30)


def _sparse_ce(probs, labels):
    p = probs.gather(1, labels[:, None])[:, 0]
    return -torch.log(torch.clamp(p, min=1e-7))


def _accuracy(probs, labels, w, den=None):
    return _wmean((torch.argmax(probs, dim=1) == labels).to(w.dtype), w, den)


def _labels(counts, device):
    return torch.cat([torch.full((n,), c, dtype=torch.int64, device=device)
                      for c, n in enumerate(counts)])


def _ae_losses(params, bkg_x, ood_x, bkg_w, ood_w, activation, dens=(None, None)):
    recon_bkg = ae_apply(params, bkg_x, activation)
    recon_ood = ae_apply(params, ood_x, activation)
    mae_bkg, mae_ood = _mae(bkg_x, recon_bkg), _mae(ood_x, recon_ood)
    qcd = _wmean(mae_bkg, bkg_w, dens[0])
    oe = _wmean(torch.sigmoid(mae_bkg - mae_ood), ood_w, dens[1])
    ood_mae = _wmean(mae_ood, ood_w, dens[1]).detach()   # 'OoD-AE Loss', a metric only
    return qcd, oe, ood_mae, recon_bkg, recon_ood


def disc_batch_loss(params, bkg_x, ood_x, bkg_w, ood_w, activation="relu", den=None):
    """The discriminator's weighted CE and accuracy on {QCD: 0,
    reconstructed QCD: 1, OoD: 2}; ``den``: their weight sum (by default
    this batch's)."""
    recon_bkg = ae_apply(params, bkg_x, activation)
    x = torch.cat([bkg_x, recon_bkg, ood_x])
    w = torch.cat([bkg_w, bkg_w, ood_w])
    labels = _labels((len(bkg_w), len(bkg_w), len(ood_w)), w.device)
    probs = discriminator_apply(params, x, activation)
    return _wmean(_sparse_ce(probs, labels), w, den), _accuracy(probs, labels, w, den)


def _descend(loss, state, key, lr, mesh=None):
    """One guarded ``GanAdam`` step of subtree ``key`` down ``loss``, its
    gradient summed over the ``data`` ranks under a ``mesh``."""
    grads = torch.autograd.grad(loss, state.leaves, materialize_grads=True)
    with torch.no_grad():
        flat = torch.cat([g.reshape(-1) for g in grads])
        if mesh is not None:
            all_sum(mesh, flat)
        state.adam.step(key, state.flat, clip_gradients(flat), lr)


def make_aae_step_fns(lamb=0.0, beta=0.0, activation="relu", lr=1.0, mesh=None):
    """Build (ae_epoch, disc_epoch, aae_epoch).  Each takes the AE and the
    discriminator ``TrainState`` (sharing one ``GanAdam`` as their
    ``adam``, keyed 'ae' and 'disc'), a batch order
    ``perm`` and the load's device batches (bkg_x, ood_x, bkg_w, ood_w),
    each (n_batches, batch, ...), steps through the batches in that order
    and returns its per-batch metrics on the device: AE (n, 4) [QCD, OE,
    total, OoD MAE]; Disc (n, 2) [loss, accuracy]; AAE ((n, 6) [QCD, OE,
    total, fooling CE, fooling accuracy, OoD MAE], and the 3-class
    discriminator's [loss, accuracy] on batch ``perm[-1]`` after the
    epoch's updates).  With ``mesh``, ``batches`` are this rank's rows and
    the metrics the global values."""
    lr = float(lr)

    def weight_sums(batches):
        """Per batch (bkg, OoD, Disc, fooling) weight sums: None each on one
        device (every weighted mean sums its own weights), the global sums
        with a ``mesh``."""
        if mesh is None:
            return [(None,) * 4] * batches[0].shape[0]
        bkg, ood = all_sum(mesh, torch.stack([batches[2].sum(1), batches[3].sum(1)], 1)).unbind(1)
        return list(zip(bkg, ood, 2 * bkg + ood, bkg + ood))

    def summed(metrics):
        return metrics if mesh is None else all_sum(mesh, metrics)

    def ae_epoch(ae, disc, perm, batches):
        rest = _frozen(disc)
        dens = weight_sums(batches)
        out = []
        for i in perm:
            batch = tuple(b[i] for b in batches)
            qcd, oe, ood_mae, _, _ = _ae_losses({**ae.params, **rest}, *batch, activation,
                                                dens[i][:2])
            total = qcd + lamb * oe
            _descend(total, ae, "ae", lr, mesh)
            out.append(torch.stack([qcd, oe, total, ood_mae]).detach())
        return summed(torch.stack(out))

    def disc_epoch(ae, disc, perm, batches):
        rest = _frozen(ae)
        dens = weight_sums(batches)
        out = []
        for i in perm:
            loss, acc = disc_batch_loss({**rest, **disc.params}, *(b[i] for b in batches),
                                        activation=activation, den=dens[i][2])
            _descend(loss, disc, "disc", lr, mesh)
            out.append(torch.stack([loss, acc]).detach())
        return summed(torch.stack(out))

    def aae_epoch(ae, disc, perm, batches):
        frozen = _frozen(disc)
        dens = weight_sums(batches)
        out = []
        for i in perm:
            bkg_x, ood_x, bkg_w, ood_w = (b[i] for b in batches)
            qcd, oe, ood_mae, recon_bkg, recon_ood = _ae_losses(
                {**ae.params, **frozen}, bkg_x, ood_x, bkg_w, ood_w, activation, dens[i][:2])
            # the frozen discriminator judges every reconstruction with the
            # fooling labels {QCD: 0, OoD: 1}
            w_all = torch.cat([bkg_w, ood_w])
            labels = _labels((len(bkg_w), len(ood_w)), w_all.device)
            probs = discriminator_apply(frozen, torch.cat([recon_bkg, recon_ood]), activation)
            d_ce = _wmean(_sparse_ce(probs, labels), w_all, dens[i][3])
            d_acc = _accuracy(probs, labels, w_all, dens[i][3])
            total = qcd + lamb * oe + beta * d_ce
            _descend(total, ae, "ae", lr, mesh)
            out.append(torch.stack([qcd, oe, total, d_ce, d_acc, ood_mae]).detach())
        with torch.no_grad():
            disc_m = torch.stack(disc_batch_loss({**_frozen(ae), **frozen},
                                                 *(b[perm[-1]] for b in batches),
                                                 activation=activation, den=dens[perm[-1]][2]))
        return summed(torch.stack(out)), summed(disc_m)

    return ae_epoch, disc_epoch, aae_epoch


def pack_load(sample, batch_size, device, feature_key=None, mesh=None):
    """One load, a (bkg, OoD) pair of sample dicts, as the device batches
    (bkg_x, ood_x, bkg_w, ood_w), each (n_batches, batch_size, ...), the
    tail padded with zero-weight rows.  ``feature_key=None`` stacks the
    constituents and HLVs the model was sized with.  With ``mesh``, only
    this rank's rows of each batch are copied to the device."""
    bkg_sample, ood_sample = sample if isinstance(sample, tuple) else (sample["bkg"],
                                                                       sample["OoD"])
    if feature_key is None:
        from .loop import features
        bkg_x = np.asarray(features(bkg_sample), np.float32)
        ood_x = np.asarray(features(ood_sample), np.float32)
    else:
        bkg_x = np.asarray(bkg_sample[feature_key], np.float32)
        ood_x = np.asarray(ood_sample[feature_key], np.float32)
    bkg_w = np.asarray(bkg_sample["weights"], np.float32)
    ood_w = np.asarray(ood_sample["weights"], np.float32)
    n = len(bkg_x)
    n_batches = int(np.ceil(n / batch_size))
    pad = n_batches * batch_size - n
    if pad:
        bkg_x = np.concatenate([bkg_x, np.zeros((pad,) + bkg_x.shape[1:], np.float32)])
        ood_x = np.concatenate([ood_x, np.zeros((pad,) + ood_x.shape[1:], np.float32)])
        bkg_w = np.concatenate([bkg_w, np.zeros(pad, np.float32)])
        ood_w = np.concatenate([ood_w, np.zeros(pad, np.float32)])
    shape = (n_batches, batch_size)
    host = tuple(a.reshape(shape + a.shape[1:]) for a in (bkg_x, ood_x, bkg_w, ood_w))
    if mesh is not None:
        host = shard_batch(mesh, host)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)


def gan_states(params, device):
    """The AE and the discriminator ``TrainState`` of ``params``, sharing one
    fresh ``GanAdam`` (keyed 'ae' and 'disc')."""
    ae_tree, disc_tree = _subtree(params, AE_KEYS), _subtree(params, DISC_KEYS)
    size = lambda tree: sum(leaf.numel() for leaf in tree_flatten(tree))
    adam = GanAdam({"ae": size(ae_tree), "disc": size(disc_tree)}, device)
    return TrainState(ae_tree, adam), TrainState(disc_tree, adam)


def train_aae(params, train_generator, n_cycles, batch_size, output_dir,
              model_out="AAE.npz", hist_file="history.pkl", ae_weights="",
              lamb=0.0, beta=0.0, lr=1e-6, seed=0, feature_key=None, mesh=None):
    """The full cycle schedule on the device the ``params`` lie on.

    Uses one load, ``train_generator[0]``, padded with zero-weight rows to
    whole batches; the batch order of each phase-epoch is the next
    permutation of ``np.random.default_rng(seed)``, so it is the JAX
    package's.  ``ae_weights`` names the AE subtree's file under
    ``output_dir``, an npz cache or a Keras AE file (the reference's
    ``AE.save_weights``), told apart by its signature: loaded when present
    (the first cycle's 100 AE epochs are then skipped), written as an npz
    after the first cycle's AE epochs when their last 'AE Loss' is below
    100 (else RuntimeError, as the reference aborts).  Writes ``hist_file``
    (the reference's {series: [(cycle, epoch, value)]} pickle) and
    ``model_out`` (npz) under ``output_dir``.  ``mesh``: a ``data`` mesh
    to train over, every rank calling with the same arguments; the batch is
    rounded down to a multiple of its ranks, and rank 0 alone writes.
    Returns (params, loss_history).
    """
    if mesh is not None:
        # even per-rank shards, as MirroredStrategy splits its global batch
        # (ref jet-ID/classifier.py:136-138)
        n_shards = axis_size(mesh, "data")
        batch_size = max(n_shards, batch_size - batch_size % n_shards)
    writer = is_writer(mesh)
    ae_path = os.path.join(output_dir, ae_weights) if ae_weights else None
    device = tree_flatten(params)[0].device
    epoch_dict = {"AE": np.full(n_cycles, 0), "Disc": np.full(n_cycles, 5),
                  "AAE": np.full(n_cycles, 5)}
    if n_cycles > 0:
        epoch_dict["AE"][0] = 100

    batches = pack_load(train_generator[0], batch_size, device, feature_key, mesh)
    n_batches = batches[0].shape[0]

    if ae_path and os.path.isfile(ae_path):
        print("\nLoading pre-trained AE file from:", ae_path)
        if sniff_weights_format(ae_path) == "keras":
            ae = _subtree(load_keras_aae(ae_path, params), AE_KEYS)
        else:
            ae = load_pytree(ae_path, _subtree(params, AE_KEYS))
        params = {**params, **ae}
        epoch_dict["AE"][0] = epoch_dict["AE"][1] if n_cycles > 1 else 0
    ae, disc = gan_states(params, device)
    ae_epoch, disc_epoch, aae_epoch = make_aae_step_fns(lamb, beta, lr=float(lr), mesh=mesh)

    loss_history = {k: [] for k in ["QCD-AE Loss", "OoD-AE Loss", "OE Loss",
                                    "AE Loss", "Disc Loss", "Disc Accuracy"]}
    rng = np.random.default_rng(seed)
    epoch_counter = 0
    for cycle in range(n_cycles):
        print(f"\n*** CYCLE {cycle + 1}/{n_cycles} ***")
        # (a) AE
        n_epochs = int(epoch_dict["AE"][cycle])
        if n_epochs:
            print("TRAINING AUTOENCODER")
        start = time.time()
        for epoch in range(n_epochs):
            m = ae_epoch(ae, disc, rng.permutation(n_batches), batches).cpu().numpy()[-1]
            epoch_counter += 1
            loss_history["QCD-AE Loss"].append((cycle + 1, epoch_counter, float(m[0])))
            if lamb != 0:
                loss_history["OoD-AE Loss"].append((cycle + 1, epoch_counter, float(m[3])))
                loss_history["OE Loss"].append((cycle + 1, epoch_counter, float(m[1])))
            loss_history["AE Loss"].append((cycle + 1, epoch_counter, float(m[2])))
            if (epoch + 1) % 10 == 0 or epoch + 1 == n_epochs:
                print(f"Epoch {epoch + 1}/{n_epochs}: AE Loss = {m[2]:4.3e} "
                      f"({time.time() - start:.1f}s)")
        if cycle == 0 and n_epochs and ae_path and not os.path.isfile(ae_path):
            last_ae = loss_history["AE Loss"][-1][2]
            if last_ae < 100:
                print("Saving pre-trained AE file to:", ae_path)
                if writer:
                    save_pytree(ae_path, ae.params)
            else:
                raise RuntimeError(f"first-cycle AE loss {last_ae} >= 100 "
                                   "(the reference aborts here)")

        # (b) discriminator
        n_epochs = int(epoch_dict["Disc"][cycle])
        if n_epochs:
            print("TRAINING DISCRIMINATOR")
        start = time.time()
        for epoch in range(n_epochs):
            m = disc_epoch(ae, disc, rng.permutation(n_batches), batches).cpu().numpy()
            disc_loss_v = float(m[-1, 0])
            acc_v = float(m[:, 1].mean())
            epoch_counter += 1
            loss_history["Disc Loss"].append((cycle + 1, epoch_counter, disc_loss_v))
            loss_history["Disc Accuracy"].append((cycle + 1, epoch_counter, acc_v))
            print(f"Epoch {epoch + 1}/{n_epochs}: Disc Loss = {disc_loss_v:4.3e} "
                  f"Acc = {100 * acc_v:4.1f}% ({time.time() - start:.1f}s)")

        # (c) AAE with the frozen discriminator
        n_epochs = int(epoch_dict["AAE"][cycle])
        if n_epochs:
            print("TRAINING AAE")
        start = time.time()
        for epoch in range(n_epochs):
            metrics, disc_m = aae_epoch(ae, disc, rng.permutation(n_batches), batches)
            m = metrics.cpu().numpy().mean(axis=0)
            disc_m = disc_m.cpu().numpy()
            epoch_counter += 1
            loss_history["QCD-AE Loss"].append((cycle + 1, epoch_counter, float(m[0])))
            if lamb != 0:
                loss_history["OoD-AE Loss"].append((cycle + 1, epoch_counter, float(m[5])))
                loss_history["OE Loss"].append((cycle + 1, epoch_counter, float(m[1])))
            # 'AE Loss' leaves out the beta * CE fooling term
            loss_history["AE Loss"].append(
                (cycle + 1, epoch_counter, float(m[0] + lamb * m[1])))
            loss_history["Disc Loss"].append((cycle + 1, epoch_counter, float(disc_m[0])))
            loss_history["Disc Accuracy"].append((cycle + 1, epoch_counter, float(disc_m[1])))
            print(f"Epoch {epoch + 1}/{n_epochs}: AAE Loss = {m[2]:4.3e} "
                  f"D_Loss = {m[3]:4.3e} D_Accuracy = {100 * m[4]:4.1f}% "
                  f"Disc Loss = {disc_m[0]:4.3e} ({time.time() - start:.1f}s)")

    params = {**ae.detached(), **disc.detached()}
    if hist_file and writer:
        with open(os.path.join(output_dir, hist_file) if output_dir else hist_file,
                  "wb") as f:
            pickle.dump(loss_history, f)
    if model_out and writer:
        save_pytree(os.path.join(output_dir, model_out) if output_dir else model_out, params)
    return params, loss_history
