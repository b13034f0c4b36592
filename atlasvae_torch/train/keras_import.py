"""Keras weight files into parameter trees.

Counterpart of ``atlasvae/train/keras_import.py``.  Runs of the reference
leave Keras weight checkpoints (``vae.save_weights(model_out)``, default
``model.h5``; the AAE trainer's combined ``AAE.h5`` and its ``AE.h5``); a
user moving one here names it in ``--model_in`` (or ``--AE_weights``).  The
file is read through ``data/hdf5.py``: h5py where it is installed,
``LiteFile`` where it is not (the machine with the card), with no
TensorFlow.

Two layouts on disk:

* **Keras 2 legacy HDF5** (what the reference's TF 2.x wrote): root
  attribute ``layer_names``; a group a layer whose ``weight_names``
  attribute lists paths like ``encoder/dense/kernel:0``, the datasets
  stored at those paths inside the group;
* **Keras 3 ``.weights.h5``**: groups nested along the attribute path
  (``encoder/denses/dense_1``), each layer's variables under a ``vars``
  group (``vars/0`` kernel, ``vars/1`` bias).

Both become ``path/kernel`` + ``path/bias`` entries, matched by the
reference architectures' layer names: the ``dense_mean`` /
``dense_log_var`` / ``dense_output`` heads and ``dense[_N]`` hidden stacks
under ``encoder`` / ``decoder`` (OE-VAE); the ``ENCODER`` / ``DECODER`` /
``DISCRIMINATOR`` components whose last dense layer is the output layer
(OE-AAE); conv towers by kernel signature and dense layers by creation
order (jet-ID).  Keras kernels are (in, out) for dense layers and HWIO for
convolutions, the port's own layouts, so nothing is transposed.  Leaves
come back as float32 tensors on the template leaves' device, as
``load_pytree`` returns them; a file the port cannot map raises a
ValueError naming the file and what it lacks.
"""

import re

import numpy as np
import torch

from ..data import hdf5
from .checkpoint import load_pytree, sniff_weights_format

__all__ = ["read_keras_weights", "sniff_weights_format", "load_params_auto", "load_keras_vae",
           "load_keras_aae", "load_keras_jetid"]


def _text(name):
    return name.decode() if isinstance(name, bytes) else name


def _normalize_keras2(f):
    """Legacy save_weights layout -> {name/kernel|bias: array}."""
    named = {}
    for layer_name in [_text(n) for n in f.attrs["layer_names"]]:
        group = f[layer_name]
        for wname in [_text(n) for n in group.attrs.get("weight_names", [])]:
            named[re.sub(r":\d+$", "", wname)] = np.asarray(group[wname])
    return named


def _normalize_keras3(f):
    """Keras 3 .weights.h5 layout -> {name/kernel|bias: array}."""
    named = {}

    def walk(group, prefix):
        for key, item in group.items():
            if hdf5.is_group(item):
                if key == "vars":
                    for _, var in sorted(item.items(), key=lambda kv: kv[0]):
                        arr = np.asarray(var)
                        kind = "kernel" if arr.ndim >= 2 else "bias"
                        named[f"{prefix}/{kind}"] = arr
                else:
                    walk(item, f"{prefix}/{key}" if prefix else key)

    walk(f, "")
    return named


def read_keras_weights(path):
    """A Keras weight HDF5 file (either layout) as a flat {normalized name:
    array} dict."""
    with hdf5.File(path, "r") as f:
        try:
            if "layer_names" in f.attrs:
                return _normalize_keras2(f)
            return _normalize_keras3(f)
        except KeyError as exc:
            raise ValueError(f"{path}: a Keras weight file that lacks {exc}") from exc


def load_params_auto(path, template, kind, config=None):
    """Weights from either format, told apart by the file's signature:
    Keras HDF5 (trained by the reference or exported by ``keras_export``)
    or an npz pytree.  ``kind`` picks the Keras layer mapping: 'vae' |
    'aae' | 'jetid'; ``config`` (jet-ID only) enables the multi-image
    concat rewrite of the trunk kernel (``load_keras_jetid``)."""
    if sniff_weights_format(path) == "keras":
        if kind == "jetid":
            return load_keras_jetid(path, template, config)
        return {"vae": load_keras_vae, "aae": load_keras_aae}[kind](path, template)
    return load_pytree(path, template)


def _dense_pairs(named):
    """Pair each */kernel with its */bias -> {path: (kernel, bias)}."""
    pairs = {}
    for name, arr in named.items():
        if name.endswith("/kernel"):
            path = name[: -len("/kernel")]
            bias = named.get(path + "/bias")
            if bias is None:
                raise ValueError(f"kernel without bias at {path!r}")
            pairs[path] = (arr, bias)
    return pairs


def _suffix_index(path):
    """Creation index of an auto-named Keras layer: dense -> 0, dense_7 -> 7
    (last path segment)."""
    m = re.search(r"_(\d+)$", path.rsplit("/", 1)[-1])
    return int(m.group(1)) if m else 0


def _layer_kind(path):
    """The Keras class prefix of an auto-named layer: conv3d_2 -> conv3d."""
    return re.sub(r"_\d+$", "", path.rsplit("/", 1)[-1])


def _leaf(array, like):
    return torch.as_tensor(np.asarray(array, np.float32)).to(like.device).contiguous()


def _assign(layer, kernel, bias, path):
    want_w, want_b = tuple(layer["w"].shape), tuple(layer["b"].shape)
    if tuple(kernel.shape) != want_w or tuple(bias.shape) != want_b:
        raise ValueError(
            f"shape mismatch at {path!r}: file has kernel{tuple(kernel.shape)}"
            f"/bias{tuple(bias.shape)}, model expects {want_w}/{want_b}"
            " — check --FC_layers / input dims match the training run")
    return {"w": _leaf(kernel, layer["w"]), "b": _leaf(bias, layer["b"])}


def _in_component(path, component):
    return component.lower() in [s.lower() for s in path.split("/")]


def load_keras_vae(path, template):
    """An OE-VAE ``model.h5`` onto an ``init_vae`` tree."""
    pairs = _dense_pairs(read_keras_weights(path))
    out = {"encoder": {"hidden": list(template["encoder"]["hidden"])},
           "decoder": {"hidden": list(template["decoder"]["hidden"])}}
    enc_hidden, dec_hidden = [], []
    for p, (k, b) in pairs.items():
        leaf = p.rsplit("/", 1)[-1]
        if leaf == "dense_mean":
            out["encoder"]["mean"] = _assign(template["encoder"]["mean"], k, b, p)
        elif leaf == "dense_log_var":
            out["encoder"]["logvar"] = _assign(template["encoder"]["logvar"], k, b, p)
        elif leaf == "dense_output":
            out["decoder"]["out"] = _assign(template["decoder"]["out"], k, b, p)
        elif _in_component(p, "encoder"):
            enc_hidden.append((p, k, b))
        elif _in_component(p, "decoder"):
            dec_hidden.append((p, k, b))
        else:
            raise ValueError(f"unrecognized layer {p!r} in {path}")
    for dst, src, comp in ((out["encoder"]["hidden"], enc_hidden, "encoder"),
                           (out["decoder"]["hidden"], dec_hidden, "decoder")):
        src.sort(key=lambda t: _suffix_index(t[0]))
        if len(src) != len(dst):
            raise ValueError(f"{path}: {len(src)} hidden dense layers under "
                             f"{comp}, model expects {len(dst)}")
        for i, (p, k, b) in enumerate(src):
            dst[i] = _assign(dst[i], k, b, p)
    for head, layer in (("mean", "dense_mean"), ("logvar", "dense_log_var")):
        if head not in out["encoder"]:
            raise ValueError(f"{path}: no {layer} layer found")
    if "out" not in out["decoder"]:
        raise ValueError(f"{path}: no dense_output layer found")
    return {"encoder": {k: out["encoder"][k] for k in template["encoder"]},
            "decoder": {k: out["decoder"][k] for k in template["decoder"]}}


def _load_component(pairs, component, template, path):
    """A functional AAE component: its dense layers in creation order, the
    last one the output layer."""
    found = sorted(((p, k, b) for p, (k, b) in pairs.items() if _in_component(p, component)),
                   key=lambda t: _suffix_index(t[0]))
    want = len(template["hidden"]) + 1
    if len(found) != want:
        raise ValueError(f"{path}: {len(found)} dense layers under "
                         f"{component}, model expects {want}")
    hidden = [_assign(template["hidden"][i], k, b, p)
              for i, (p, k, b) in enumerate(found[:-1])]
    p, k, b = found[-1]
    return {"hidden": hidden, "out": _assign(template["out"], k, b, p)}


def load_keras_jetid(path, template, config=None):
    """A jet-ID ``model.h5`` (the reference's flat functional graph) onto
    an ``init_jetid`` tree.

    Dense layers are created in a fixed order -- constituents branch,
    scalars branch, trunk, softmax head -- so they are assigned by their
    Keras auto-name suffix, shapes checked.  Conv towers are matched by
    their kernel-shape signature (the reference builds its towers in
    ``set`` order, so the file's tower order is not the model's); two
    towers with the same signature cannot be told apart and raise.  Conv
    layers are ordered within their class (conv2d, conv3d), so a model with
    2-D and 3-D towers loads too, which the JAX package's importer refuses.

    ``config`` (the ``JetIDConfig``) rewrites the trunk's first kernel rows
    from the reference graph's concat layout into this model's
    (``models/jetid.py::reference_concat_permutation``), so a multi-image
    model computes what the file's did.  Without it, single-image and
    single-tower files, whose layouts agree, still load exactly.
    """
    pairs = _dense_pairs(read_keras_weights(path))
    dense = sorted(((p, k, b) for p, (k, b) in pairs.items() if k.ndim == 2),
                   key=lambda t: _suffix_index(t[0]))
    # each conv class in creation order: Keras numbers conv2d and conv3d
    # layers apart, so a tower's blocks stay adjacent where both kinds are
    # in the file (the JAX package sorts by the number alone, interleaves
    # them, and then matches no 3-D tower beside a 2-D one)
    convs = sorted(((p, k, b) for p, (k, b) in pairs.items() if k.ndim > 2),
                   key=lambda t: (_layer_kind(t[0]), _suffix_index(t[0])))
    out = {}

    if "towers" in template:
        remaining = list(convs)
        out["towers"] = {}
        for tower_name, t_convs in template["towers"].items():
            want = [tuple(c["w"].shape) for c in t_convs]
            starts = [i for i in range(len(remaining) - len(want) + 1)
                      if [tuple(k.shape) for _, k, _ in remaining[i:i + len(want)]] == want]
            if not starts:
                raise ValueError(f"{path}: no conv run matches tower {tower_name!r} "
                                 f"(expected kernel shapes {want})")
            if len(starts) > 1:
                raise ValueError(f"{path}: conv towers with identical kernel signatures "
                                 f"({tower_name!r}) cannot be matched by weights alone — "
                                 "use the .npz pytree checkpoint format instead")
            i = starts[0]
            run, remaining = (remaining[i:i + len(want)],
                              remaining[:i] + remaining[i + len(want):])
            out["towers"][tower_name] = [
                _assign(t_convs[j], k, b, p) for j, (p, k, b) in enumerate(run)]
        if remaining:
            raise ValueError(f"{path}: {len(remaining)} conv layers in file "
                             "not matched by any tower in the model config")
    elif convs:
        raise ValueError(f"{path}: file contains conv layers but the model "
                         "config has no CNN towers (check --NN_type)")

    stacks = [(comp, list(template[comp])) for comp in ("constituents", "scalars", "head")
              if comp in template]
    stacks.append(("out", [template["out"]]))
    want = sum(len(s) for _, s in stacks)
    if len(dense) != want:
        raise ValueError(f"{path}: {len(dense)} dense layers in file, model "
                         f"expects {want} — check branch/FCN_neurons config")
    i = 0
    for comp, layers in stacks:
        mapped = []
        for layer in layers:
            p, k, b = dense[i]
            mapped.append(_assign(layer, k, b, p))
            i += 1
        out[comp] = mapped if comp != "out" else mapped[0]

    if config is not None:
        # reference concat row r feeds this model's concat position perm[r]:
        # scatter the file's trunk kernel rows into this layout
        from ..models.jetid import reference_concat_permutation
        perm = reference_concat_permutation(config)
        if perm is not None:
            trunk = out["head"][0]
            w = torch.empty_like(trunk["w"])
            w[torch.as_tensor(perm, device=w.device)] = trunk["w"]
            out["head"][0] = {"w": w, "b": trunk["b"]}
    return {k: out[k] for k in template}


def load_keras_aae(path, template):
    """An OE-AAE ``model.h5`` / ``AAE.h5`` onto an ``init_aae`` tree: the
    combined file (ENCODER + DECODER + DISCRIMINATOR), or an AE-only file
    (``AE.h5``, the reference's ``--AE_weights``), which leaves the
    discriminator at the template's values."""
    pairs = _dense_pairs(read_keras_weights(path))
    out = {
        "encoder": _load_component(pairs, "ENCODER", template["encoder"], path),
        "decoder": _load_component(pairs, "DECODER", template["decoder"], path),
    }
    if any(_in_component(p, "DISCRIMINATOR") for p in pairs):
        out["discriminator"] = _load_component(
            pairs, "DISCRIMINATOR", template["discriminator"], path)
    else:
        out["discriminator"] = template["discriminator"]
    return {k: out[k] for k in template}
