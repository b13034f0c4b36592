"""Parameter trees to and from npz, in the JAX package's format, and the
training history.

Counterpart of ``atlasvae/train/checkpoint.py``: leaves are stored as
``leaf_<i>`` in the order ``jax.tree_util.tree_flatten`` gives them, which
visits dict keys **sorted** (decoder before encoder, b before w, logvar
before mean) and lists in order.  So a ``model.npz`` written by the JAX
package's ``save_weights`` loads here unchanged, and back.  The history is
a pickled dict of lists of plain floats, which the JAX package's
``load_history`` reads.
"""

import os
import pickle

import numpy as np
import torch


def tree_flatten(tree):
    """Leaves of a tree of dicts/lists/tuples in JAX's order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_flatten(sub)]
    return [tree]


def tree_unflatten(template, leaves):
    """Rebuild ``template``'s structure from ``leaves`` (in tree_flatten
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_flatten(tree)])


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree):
    flat = tree_flatten(tree)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(flat)})
    os.replace(tmp, path)


def load_pytree(path, template):
    """Load leaves into ``template``'s structure; each leaf becomes a
    tensor on the template leaf's device and must have its shape."""
    flat = tree_flatten(template)
    with np.load(path) as data:
        if len(data.files) != len(flat):
            raise ValueError(f"{path}: {len(data.files)} leaves, template has {len(flat)}")
        leaves = []
        for i, ref in enumerate(flat):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, "
                                 f"template {tuple(ref.shape)}")
            leaves.append(torch.as_tensor(arr, dtype=ref.dtype).to(ref.device).contiguous())
    return tree_unflatten(template, leaves)


def sniff_weights_format(path):
    """'keras' (the HDF5 signature) or 'npz' (a zip's), read from the file's
    first bytes whatever its name: a ``--model_out model.h5`` run keeps npz
    checkpoints under the .h5 name until the Keras export at its end
    replaces them, so a resume from a half-finished run meets npz bytes
    there."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"\x89HDF"):
        return "keras"
    if magic.startswith(b"PK"):
        return "npz"
    raise ValueError(f"{path}: neither a Keras HDF5 weight file nor an npz pytree "
                     "checkpoint (unrecognized file signature)")


def save_weights(params, path):
    save_pytree(path, params)


def load_weights(path, template):
    return load_pytree(path, template)


def save_history(history, path):
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump({key: [float(v) for v in vals] for key, vals in history.items()}, f)
    os.replace(tmp, path)  # rewritten every epoch; resume reads it back


def load_history(path):
    with open(path, "rb") as f:
        return pickle.load(f)
