"""Parameter trees out as Keras legacy HDF5 weight files.

Counterpart of ``atlasvae/train/keras_export.py``, the reverse of
``keras_import``: a model trained here goes back to the reference's own
Keras code through ``model.load_weights('model.h5')``.  Files are written
through ``data/hdf5.py``: h5py where it is installed, ``LiteFile`` where it
is not (the machine with the card).

The layout is **Keras 2 legacy** (root attributes ``layer_names``,
``backend``, ``keras_version``; a group a layer with a ``weight_names``
attribute), which Keras 2 and Keras 3 both load from ``.h5`` paths.
Legacy loading is positional: weight names are cosmetic, but the group
order must be ``model.layers``'s and the order inside a group
``layer.weights``'s.  The orders are the reference architectures':

* VAE (subclassed): layers ``encoder`` then ``decoder``; encoder weights
  are the hidden denses in stack order then ``dense_mean`` /
  ``dense_log_var``; the decoder's its hidden denses then
  ``dense_output``.
* AAE (functional): ``AUTOENCODER`` (ENCODER denses then DECODER denses,
  each component's output dense last) then ``DISCRIMINATOR``.
* jet-ID (flat functional graph): a group per conv/dense layer, named as
  a fresh Keras process names them (``conv2d``/``conv2d_1``/...,
  ``dense``/``dense_1``/...) in creation order -- conv towers, then the
  constituents branch, the scalars branch, the trunk, the softmax head --
  and listed in Keras's graph-depth order, so positional ``load_weights``
  maps every layer, multi-tower graphs too; ``by_name=True`` loading works
  as well.

Every leaf is written as float32: the bf16 jet-ID's master weights are
float32, and those are what the file holds.
"""

import numpy as np
import torch

from ..data import hdf5

__all__ = ["maybe_export_keras", "export_keras_vae", "export_keras_aae", "export_keras_jetid"]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float32)


def _write_keras2(path, groups):
    """Write {layer_name: [(weight_path, array), ...]} in the legacy Keras 2
    ``save_weights`` layout, the JAX package's ``_write_keras2``'s."""
    with hdf5.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([name.encode() for name in groups])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.11.0"
        for layer, weights in groups.items():
            g = f.create_group(layer)
            g.attrs["weight_names"] = np.array([n.encode() for n, _ in weights])
            for name, arr in weights:
                g.create_dataset(name, data=_to_np(arr))


def _wpair(prefix, layer):
    return [(f"{prefix}/kernel:0", layer["w"]), (f"{prefix}/bias:0", layer["b"])]


def _dense_name(i):
    """Keras auto-name for the i-th Dense created in a fresh process."""
    return "dense" if i == 0 else f"dense_{i}"


def maybe_export_keras(params, model_out, kind, config=None):
    """A ``--model_out model.h5`` run ends with a Keras-loadable file: where
    ``model_out`` names an .h5/.hdf5 path, replace the staged npz checkpoint
    with the Keras export and return True; False (nothing written) for an
    npz output.  ``config`` (jet-ID only) enables the multi-image concat
    rewrite."""
    if not model_out or not str(model_out).endswith((".h5", ".hdf5")):
        return False
    if kind == "jetid":
        export_keras_jetid(params, model_out, config)
    else:
        {"vae": export_keras_vae, "aae": export_keras_aae}[kind](params, model_out)
    return True


def export_keras_vae(params, path):
    """An ``init_vae`` tree as the reference VAE's ``model.h5``, loadable
    positionally by its ``load_weights`` and back through
    ``keras_import.load_keras_vae``."""
    enc, dec = params["encoder"], params["decoder"]
    n = 0
    enc_w = []
    for layer in enc["hidden"]:
        enc_w += _wpair(f"autoencoder/encoder/{_dense_name(n)}", layer)
        n += 1
    enc_w += _wpair("autoencoder/encoder/dense_mean", enc["mean"])
    enc_w += _wpair("autoencoder/encoder/dense_log_var", enc["logvar"])
    dec_w = []
    for layer in dec["hidden"]:
        dec_w += _wpair(f"autoencoder/decoder/{_dense_name(n)}", layer)
        n += 1
    dec_w += _wpair("autoencoder/decoder/dense_output", dec["out"])
    _write_keras2(path, {"encoder": enc_w, "decoder": dec_w})


def export_keras_aae(params, path, include_discriminator=True):
    """An ``init_aae`` tree as the reference's ``AAE.h5`` (AUTOENCODER and
    DISCRIMINATOR groups) or, with ``include_discriminator=False``, as the
    AE-only file ``AE.save_weights(AE_weights)`` writes, which the
    reference's ``--AE_weights`` resume loads."""
    n = 0
    ae_w = []
    for comp, name in ((params["encoder"], "ENCODER"), (params["decoder"], "DECODER")):
        for layer in list(comp["hidden"]) + [comp["out"]]:
            ae_w += _wpair(f"AUTOENCODER/{name}/{_dense_name(n)}", layer)
            n += 1
    groups = {"AUTOENCODER": ae_w}
    if include_discriminator:
        disc = params["discriminator"]
        disc_w = []
        for layer in list(disc["hidden"]) + [disc["out"]]:
            disc_w += _wpair(f"DISCRIMINATOR/{_dense_name(n)}", layer)
            n += 1
        groups["DISCRIMINATOR"] = disc_w
    _write_keras2(path, groups)


def export_keras_jetid(params, path, config=None):
    """An ``init_jetid`` tree as the reference jet-ID ``model.h5``: a group
    a conv/dense layer, auto-named in creation order and listed in graph-
    depth order (below), back through ``keras_import.load_keras_jetid``,
    which sorts by name.

    ``config`` (the ``JetIDConfig``) rewrites the trunk's first kernel from
    this model's concat layout into the reference graph's (tower set order,
    FCN pixel interleave), so the loaded model computes what this one does;
    without it the weights land on the right layers but multi-image concat
    rows may be permuted.

    Depth (Keras: the longest op path to the output; layers listed deepest
    first, ties in traversal order): a conv block is Conv > MaxPool >
    LeakyReLU > Dropout (4 ops), a branch or trunk dense group Dense >
    LeakyReLU > Dropout (3), then the concat and the float32 softmax head.
    Towers are traversed in the order of ``set(shapes)``, as the reference
    builds them; a process whose set order differed would fail on a shape,
    not load the wrong layer.
    """
    towers = params.get("towers", {})
    # tower keys are "HxW[xD]" shape strings (models/jetid.py _tower_key)
    shapes = {k: tuple(int(s) for s in k.split("x")) for k in towers}
    set_order = list(set(shapes.values()))       # the reference's tower order
    ordered = sorted(towers, key=lambda k: set_order.index(shapes[k]))

    if config is not None:
        from ..models.jetid import reference_concat_permutation
        perm = reference_concat_permutation(config)
        if perm is not None:
            trunk = params["head"][0] if params.get("head") else params["out"]
            permuted = {"w": _to_np(trunk["w"])[perm], "b": trunk["b"]}
            if params.get("head"):
                params = {**params, "head": [permuted] + list(params["head"][1:])}
            else:
                params = {**params, "out": permuted}

    n_trunk = len(params["head"])
    counters = {}
    entries = []                                 # (depth, created, name, layer)

    def add(kind, depth, layer):
        i = counters.get(kind, 0)
        counters[kind] = i + 1
        name = kind if i == 0 else f"{kind}_{i}"
        entries.append((depth, len(entries), name, layer))

    for k in ordered:
        n_blocks = len(towers[k])
        for j, conv in enumerate(towers[k]):
            kind = "conv3d" if conv["w"].ndim == 5 else "conv2d"
            add(kind, 4 * (n_blocks - j) + 3 * n_trunk + 2, conv)
    for comp in ("constituents", "scalars"):
        stack = params.get(comp, [])
        for m, layer in enumerate(stack):
            add("dense", 3 * (len(stack) - 1 - m) + 3 * n_trunk + 4, layer)
    for i, layer in enumerate(params["head"]):
        add("dense", 3 * (n_trunk - i), layer)
    add("dense", 0, params["out"])

    entries.sort(key=lambda e: (-e[0], e[1]))
    _write_keras2(path, {name: _wpair(name, layer) for _, _, name, layer in entries})
