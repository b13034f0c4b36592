"""Training-history plot (ref OE-VAE/plots.py:946-963).

Counterpart of ``atlasvae/plotting/history.py``; it reads the history
pickles that ``train/loop.py`` writes in the JAX package's format."""

import pickle

import numpy as np

from .backend import pyplot


def plot_history(hist_file, output_dir, first_epoch=0, x_step=10):
    print("PLOTTING TRAINING HISTORY:")
    if isinstance(hist_file, dict):
        losses = hist_file
    else:
        with open(hist_file, "rb") as f:   # written by this program's training loop
            losses = pickle.load(f)
    plt = pyplot()
    # AAE histories hold (cycle, epoch_counter, value) tuples
    # (ref OE-AAE/aae.py:171); plot value vs epoch_counter for those.
    tuple_fmt = any(len(v) and isinstance(v[0], (tuple, list)) for v in losses.values())
    fig = plt.figure(figsize=(13, 8))
    axes = plt.gca()
    axes.grid(True)
    if tuple_fmt:
        last = 1
        for key, entries in losses.items():
            if not entries:
                continue
            xs = [e[1] for e in entries]
            ys = [e[2] for e in entries]
            plt.plot(xs, ys, label=key, lw=2)
            last = max(last, max(xs))
        plt.xlim(1, last)
    else:
        epochs = np.arange(1 + first_epoch, len(next(iter(losses.values()))) + 1)
        if len(epochs) <= 1:
            plt.close(fig)
            return
        for key, loss in losses.items():
            plt.plot(epochs, loss[first_epoch:], label=key, lw=2)
        plt.xlim(1, epochs[-1])
        plt.xticks(np.append(1, np.arange(x_step, epochs[-1] + x_step, x_step)))
        train = np.asarray(losses["Train loss"])
        if len(train) > 1 and np.isfinite(train[1:]).all():
            plt.ylim(0, min(50, float(np.max(train[1:]))))
    plt.xlabel("Epoch", fontsize=25)
    plt.ylabel("Loss", fontsize=25)
    plt.legend(loc="upper right", fontsize=18)
    file_name = str(output_dir) + "/train_history.png"
    print("Saving training history  to:", file_name)
    plt.savefig(file_name)
    plt.close(fig)
