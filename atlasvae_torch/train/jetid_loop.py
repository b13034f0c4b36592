"""Supervised jet-ID training: batches in a Python loop, Keras-callback
semantics around the epochs.

Counterpart of ``atlasvae/train/jetid_loop.py``:

* weighted sparse categorical cross-entropy (one-hot mask-and-sum, floor
  1e-7) with optional class weights and per-sample weights, plus the kernel
  L2 term in the training **and** the validation loss;
* the gradient guard, then Adam as ``optax.adam(1.0)`` times ``lr``
  (``train/step.py``), on parameters kept as views of one flat tensor;
* best-checkpoint + plateau (lr x 0.5 after 5 waits, min_delta 1e-6) + early
  stop (restoring the best weights) + stop on NaN, all watching one
  ``monitor`` series ('loss' / 'accuracy' / 'val_loss' / 'val_accuracy');
* ``state_file``: parameters, best parameters, Adam state, lr, the callback
  counters and the dropout generator's state, written every epoch and
  resumed bit for bit;
* ``config.compute_dtype`` "bfloat16": ``jetid_apply`` casts the float32
  parameters at each call, so gradients, Adam's state, the checkpoints and
  the state file stay float32.  cuDNN's TF32 and cuBLAS's bfloat16
  reduced-precision sums are held off around every epoch and prediction
  (``strict_precision``).

A load is packed on the host into (n_batches, batch, ...) arrays with
zero-weight tail padding and kept on the device across epochs
(``LoadCache``).  Dropout masks come from one ``torch.Generator`` on the
training device, seeded with ``seed``.

``train_kfold_vmapped`` keeps the JAX package's signature for its
fold-vmapped program and runs the folds (or feature-removal lanes) one
after another through ``train_classifier_streaming`` on that program's
batch grid.

Data parallelism (``mesh``, the reference's ``MirroredStrategy``, ref
jet-ID/models.py:69-81): each rank steps its rows of every batch (the batch
rounded down to a multiple of the ``data`` ranks); a rank's loss is its
cross-entropy sum over the global weight sum plus the L2 term over the
ranks, so the all-reduced gradient is the global one, as the JAX package's
``psum`` gives it.  Each rank draws its own dropout masks (its generator
seeded with ``seed + (rank << 32)``; the JAX package folds the replica
index into the key); with dropout 0 the run equals the single-device run
up to the order of the sums.  Rank 0 alone writes checkpoints and the state
file, which holds rank 0's dropout stream: a resumed run restores it on
every rank.
"""

import contextlib
import os
import time

import numpy as np
import torch

from ..models.jetid import jetid_apply, l2_penalty
from ..parallel.mesh import all_sum, axis_rank, axis_size, is_writer, shard_batch
from .checkpoint import save_pytree, load_pytree, tree_flatten
from .step import Adam, LoadCache, TrainState, clip_gradients, to_device

MONITORS = ("loss", "val_loss", "accuracy", "val_accuracy")


def _true_class_prob(probs, labels):
    """probs[i, labels[i]] as a masked sum over the classes."""
    classes = torch.arange(probs.shape[1], device=probs.device)
    return (probs * (labels[:, None] == classes).to(probs.dtype)).sum(dim=1)


def _ce_sum(probs, labels, weights):
    return (-torch.log(torch.clamp_min(_true_class_prob(probs, labels), 1e-7)) * weights).sum()


def _ce_loss(probs, labels, weights):
    """Weighted mean cross-entropy of class probabilities."""
    return _ce_sum(probs, labels, weights) / torch.clamp_min(weights.sum(), 1e-30)


def _correct_sum(probs, labels, weights):
    return ((probs.argmax(dim=1) == labels) * weights).sum()


@contextlib.contextmanager
def strict_precision():
    """cuDNN in full float32 for the convolutions inside the block (its
    default, TF32, keeps about three decimal digits), and cuBLAS's bfloat16
    products summed in float32, as JAX sums a bfloat16 dot (its default lets
    split-K partial sums round to bfloat16).  Both flags are restored on
    exit, and cuDNN's other settings are kept as the caller left them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


def batch_loss(params, config, inputs, labels, weights, generator, mesh=None):
    """(training loss of one batch, its [loss, accuracy] metrics).  With
    ``mesh``, the batch is this rank's rows: the loss is the rank's share
    of the global one, the metrics the global values."""
    probs = jetid_apply(params, config, inputs, generator=generator, train=True)
    if mesh is not None:
        num = _ce_sum(probs, labels, weights)
        sums = all_sum(mesh, torch.stack([weights.sum(), num.detach(),
                                          _correct_sum(probs.detach(), labels, weights)]))
        den = torch.clamp_min(sums[0], 1e-30)
        reg = config.l2 * l2_penalty(params) if config.l2 else 0.0
        loss = num / den + reg / axis_size(mesh, "data")
        return loss, torch.stack([sums[1] / den + reg, sums[2] / den]).detach()
    loss = _ce_loss(probs, labels, weights)
    if config.l2:
        loss = loss + config.l2 * l2_penalty(params)
    accuracy = _correct_sum(probs.detach(), labels, weights) / torch.clamp_min(weights.sum(), 1e-30)
    return loss, torch.stack([loss.detach(), accuracy])


def train_epoch(state, config, lr, generator, inputs, labels, weights, mesh=None):
    """One Adam step per batch of a packed load; returns the (n_batches, 2)
    [loss, accuracy] metrics on the device.  With ``mesh``, the load is this
    rank's rows and the gradients are summed over the ``data`` ranks."""
    out = []
    with strict_precision():
        for i in range(labels.shape[0]):
            loss, metrics = batch_loss(state.params, config, {k: v[i] for k, v in inputs.items()},
                                       labels[i], weights[i], generator, mesh)
            grads = torch.autograd.grad(loss, state.leaves, allow_unused=True,
                                        materialize_grads=True)
            with torch.no_grad():
                flat = torch.cat([g.reshape(-1) for g in grads])
                if mesh is not None:
                    all_sum(mesh, flat)
                state.adam.step(state.flat, clip_gradients(flat), lr)
            out.append(metrics)
    return torch.stack(out)


def eval_epoch(params, config, inputs, labels, weights, mesh=None):
    """(n_batches, 3) per batch: the weighted cross-entropy sum with the L2
    term times the weight sum, the weight sum, the weighted count of correct
    jets; with ``mesh``, summed over the ``data`` ranks' rows."""
    out = []
    with torch.no_grad(), strict_precision():
        reg = config.l2 * l2_penalty(params) if config.l2 else 0.0
        for i in range(labels.shape[0]):
            probs = jetid_apply(params, config, {k: v[i] for k, v in inputs.items()})
            w = weights[i]
            out.append(torch.stack([_ce_sum(probs, labels[i], w) + reg * w.sum(), w.sum(),
                                    _correct_sum(probs, labels[i], w)]))
    out = torch.stack(out)
    return out if mesh is None else all_sum(mesh, out)


def _pack(inputs, labels, weights, batch_size):
    """Host-side packing: whole batches with zero-weight tail padding, as
    (inputs dict, labels, weights) shaped (n_batches, batch, ...)."""
    n = len(labels)
    n_batches = max(1, -(-n // batch_size))
    padded = n_batches * batch_size

    def pad(a):
        a = np.asarray(a)
        out = np.zeros((padded,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out.reshape((n_batches, batch_size) + a.shape[1:])

    w = np.zeros(padded, np.float32)
    w[:n] = weights
    return ({k: pad(v) for k, v in inputs.items()}, pad(np.asarray(labels).astype(np.int32)),
            w.reshape(n_batches, batch_size))


def _packed_arrays(inputs, labels, weights, batch_size):
    """``_pack`` as a flat tuple (inputs in key order, labels, weights) for
    the device copy, and its inverse."""
    packed, lab, w = _pack(inputs, labels, weights, batch_size)
    return tuple(np.asarray(packed[k], np.float32) for k in sorted(packed)) + (lab, w)


def _unflatten(keys, arrays):
    return dict(zip(sorted(keys), arrays[:-2])), arrays[-2], arrays[-1]


def train_classifier(params, config, inputs, labels, valid_inputs, valid_labels,
                     epochs=100, batch_size=5000, lr=1e-3, patience=10,
                     class_weight=None, sample_weight=None, model_out=None,
                     seed=0, verbose=True, state_file=None, mesh=None, monitor="val_loss"):
    """Fit the classifier on an in-memory sample, on the device its
    ``params`` lie on; returns (best params, history dict)."""
    weights = np.ones(len(labels), np.float32) if sample_weight is None \
        else np.asarray(sample_weight, np.float32)
    if class_weight is not None:
        weights = weights * np.asarray([class_weight[int(l)] for l in labels], np.float32)
    return train_classifier_streaming(
        params, config, lambda: [(inputs, labels, weights)], valid_inputs, valid_labels,
        epochs, batch_size, lr, patience, model_out, seed, verbose, state_file=state_file,
        mesh=mesh, monitor=monitor)


def _state_tree(state, best_params, lr, best_val, lr_wait, stop_wait, generator, monitor):
    return {"params": state.params, "best": best_params,
            "adam_count": torch.tensor(state.adam.count), "adam_mu": state.adam.mu,
            "adam_nu": state.adam.nu, "lr": torch.tensor(lr, dtype=torch.float64),
            "best_val": torch.tensor(best_val, dtype=torch.float64),
            "lr_wait": torch.tensor(lr_wait), "stop_wait": torch.tensor(stop_wait),
            "generator": generator.get_state(),
            "monitor": torch.tensor(MONITORS.index(monitor))}


def train_classifier_streaming(params, config, load_iter_fn, valid_inputs, valid_labels,
                               epochs=10, batch_size=5000, lr=1e-3, patience=10,
                               model_out=None, seed=0, verbose=True, min_delta=1e-6,
                               state_file=None, mesh=None, monitor="val_loss"):
    """The single implementation of the epoch loop.  ``load_iter_fn()``
    returns an iterable of (inputs, labels, weights) loads per epoch
    (weights None: ones).  ``mesh``: a ``data`` mesh to train over, every
    rank calling with the same arguments."""
    device = tree_flatten(params)[0].device
    state = TrainState(params)
    lr = float(lr)
    batch_size = int(batch_size)
    n_shards = 1 if mesh is None else axis_size(mesh, "data")
    writer = is_writer(mesh)
    if mesh is not None:
        # even per-rank shards, as MirroredStrategy splits its global batch
        # (ref jet-ID/classifier.py:136-138)
        batch_size = max(n_shards, batch_size - batch_size % n_shards)
    history = {"loss": [], "val_loss": [], "accuracy": [], "val_accuracy": []}
    if monitor not in history:
        raise ValueError(f"monitor {monitor!r}: pick one of {list(history)}")
    sign = -1.0 if "accuracy" in monitor else 1.0   # higher is better for the accuracy pair
    v_batch = min(batch_size, len(valid_labels))
    if mesh is not None:
        v_batch = max(n_shards, v_batch - v_batch % n_shards)
    v_host = _packed_arrays(valid_inputs, valid_labels, np.ones(len(valid_labels), np.float32),
                            v_batch)
    if mesh is not None:
        v_host = shard_batch(mesh, v_host)
    v_inputs, v_labels, v_weights = _unflatten(valid_inputs, to_device(v_host, device))
    generator = torch.Generator(device).manual_seed(
        seed + (0 if mesh is None else axis_rank(mesh, "data") << 32))
    best_val, best_params, lr_wait, stop_wait = np.inf, state.detached(), 0, 0
    if state_file and os.path.isfile(state_file):
        saved = load_pytree(state_file, _state_tree(state, best_params, lr, 0.0, 0, 0,
                                                    generator, monitor))
        was = MONITORS[int(saved["monitor"])]
        if was != monitor:
            # best_val is a sign-flipped score in the saved series' units;
            # comparing it against another series corrupts every callback
            raise ValueError(
                f"{state_file} was trained monitoring {was!r}; resuming with "
                f"monitor={monitor!r} would compare incompatible scores — pass the same "
                "--metrics or start a fresh state file")
        adam = Adam(state.flat.numel(), device, int(saved["adam_count"]), saved["adam_mu"],
                    saved["adam_nu"])
        state, best_params = TrainState(saved["params"], adam), saved["best"]
        lr, best_val = float(saved["lr"]), float(saved["best_val"])
        lr_wait, stop_wait = int(saved["lr_wait"]), int(saved["stop_wait"])
        generator.set_state(saved["generator"])
        if stop_wait >= patience:   # the stop decision was already recorded
            print(f"Training already early-stopped (state file {state_file})"
                  " — returning best weights")
            return best_params, history
        print(f"Resuming full classifier state from {state_file} "
              f"(lr={lr:g}, best {monitor}={sign * best_val:.4f})")
    load_cache = LoadCache(device)
    for epoch in range(epochs):
        start = time.time()
        sums = np.zeros(2)
        n_loads = 0
        for inputs, labels, weights in load_iter_fn():
            # keyed on (inputs, labels) alone when the weights default to
            # ones: a fresh np.ones every epoch would defeat the cache
            samples = (inputs, labels) if weights is None else (inputs, labels, weights)
            ones = np.ones(len(labels), np.float32) if weights is None else weights
            batches = load_cache.get(
                samples, batch_size,
                lambda: _packed_arrays(inputs, labels, ones, batch_size), mesh)
            metrics = train_epoch(state, config, lr, generator,
                                  *_unflatten(inputs, batches), mesh).cpu().numpy()
            if not np.isfinite(metrics).all():
                print("NaN loss encountered — terminating training")
                return best_params, history
            sums += metrics.mean(axis=0)
            n_loads += 1
        vm = eval_epoch(state.params, config, v_inputs, v_labels, v_weights, mesh).cpu().numpy()
        val_loss = vm[:, 0].sum() / vm[:, 1].sum()
        history["loss"].append(float(sums[0] / max(n_loads, 1)))
        history["accuracy"].append(float(sums[1] / max(n_loads, 1)))
        history["val_loss"].append(float(val_loss))
        history["val_accuracy"].append(float(vm[:, 2].sum() / vm[:, 1].sum()))
        if verbose:
            print(f"Epoch {epoch + 1}/{epochs}: loss={history['loss'][-1]:.4f} "
                  f"acc={100 * history['accuracy'][-1]:.2f}% "
                  f"val_loss={val_loss:.4f} ({time.time() - start:.1f}s)")
        score = sign * history[monitor][-1]
        if score < best_val - min_delta:   # checkpoint the best
            best_val, best_params = score, state.detached()
            lr_wait = stop_wait = 0
            if model_out and writer:
                save_pytree(model_out, best_params)
        else:
            lr_wait += 1
            stop_wait += 1
            if lr_wait >= 5:   # plateau
                lr *= 0.5
                if verbose:
                    print(f"Reducing learning rate to {lr}")
                lr_wait = 0
        if state_file and writer:
            # written before any break, so that the state records the stop
            # decision and a rerun resumes as already stopped
            save_pytree(state_file, _state_tree(state, best_params, lr, best_val, lr_wait,
                                                stop_wait, generator, monitor))
        if stop_wait >= patience:
            if verbose:
                print("Early stopping — restoring best weights")
            break
    return best_params, history


def train_kfold_vmapped(params_list, config, fold_loads, fold_valids, epochs=100,
                        batch_size=5000, lr=1e-3, patience=10, model_outs=None, seed=0,
                        verbose=True, min_delta=1e-6, monitor="val_loss"):
    """Train k folds, each on its own (inputs, labels, weights) sample in
    ``fold_loads`` and validated on its own in ``fold_valids``; returns
    (best params a fold, histories).

    The JAX package trains the folds as one vmapped program on a common
    batch grid.  Here each fold is one ``train_classifier_streaming`` run,
    fold after fold, with that grid's batch size ``bs = min(batch_size,
    n_max)`` over the largest fold, every fold's dropout seeded with
    ``seed``, and the Keras-callback semantics a fold (best checkpoint in
    ``model_outs``, lr x 0.5 after 5 waits, early stop).  The folds share no
    data, so batching them buys nothing here.  A fold's batches are its own
    ``ceil(n / bs)``: the all-padding tail batches that the JAX package masks
    into bit-exact no-ops are not built, and a stopped fold takes no further
    step (the JAX package's freeze at lr=0).  Unlike the JAX package, a
    non-finite training metric ends only the fold that met it, and the
    validation is unweighted, as ``train_classifier``'s: the weights of
    ``fold_valids`` must be ones (every caller's are).
    """
    if any(not np.all(np.asarray(w) == 1) for _, _, w in fold_valids):
        raise ValueError("train_kfold_vmapped validates unweighted: fold_valids' weights "
                         "must be ones")
    bs = min(int(batch_size), max(len(labels) for _, labels, _ in fold_loads))
    best, histories = [], []
    for f, (params, (inputs, labels, weights), (v_inputs, v_labels, _)) in enumerate(
            zip(params_list, fold_loads, fold_valids)):
        if verbose:
            print(f"Fold {f + 1}/{len(fold_loads)}:")
        fold_best, history = train_classifier_streaming(
            params, config, lambda load=(inputs, labels, weights): [load], v_inputs, v_labels,
            epochs, bs, lr, patience, model_outs[f] if model_outs else None, seed, verbose,
            min_delta, monitor=monitor)
        best.append(fold_best)
        histories.append(history)
    return best, histories


def predict_classifier(params, config, inputs, batch_size=20_000):
    """Class probabilities of a host sample, in chunks on the parameters'
    device; returns a float32 numpy array whatever the compute dtype."""
    device = tree_flatten(params)[0].device
    n = len(next(iter(inputs.values())))
    out = []
    with torch.no_grad(), strict_precision():
        for i in range(0, n, batch_size):
            chunk = {k: torch.from_numpy(np.ascontiguousarray(
                np.asarray(v)[i:i + batch_size], np.float32)).to(device)
                for k, v in inputs.items()}
            out.append(jetid_apply(params, config, chunk).cpu().numpy())
    return np.concatenate(out)
