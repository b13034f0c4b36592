"""Keras weight files: ``atlasvae_torch/train/keras_import.py`` and
``keras_export.py`` against the JAX package's, both ways, bit for bit, with
h5py and with ``LiteFile`` forced (``hdf5._h5py`` set to None, as on the
machine with the card; the JAX package always writes and reads through
h5py).

* JAX ``export_keras_*`` -> the port's ``load_keras_*``: equal to JAX's own
  ``load_keras_*`` leaf for leaf, and to the weights exported.
* The port's export -> JAX's ``read_keras_weights`` / ``load_keras_*``: equal
  to the port's weights, with the JAX export's ``layer_names`` and groups.
* The jet-ID configs of ``tests/test_keras_export.py`` (single tower,
  multi-tower, 3-D towers, FCN with images), where
  ``reference_concat_permutation`` equals JAX's.
* A Keras 2 file as the reference wrote it (weightless layers with an empty
  ``weight_names``), the error paths, and the signature sniffing that tells
  an npz staged under an .h5 name from a Keras file.
"""

import jax
import numpy as np
import pytest
import torch

from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae.models.aae import AAEConfig as JaxAAEConfig, init_aae as jax_init_aae
from atlasvae.models import jetid as jax_jetid
from atlasvae.train import keras_export as jax_export, keras_import as jax_import
from atlasvae.train.checkpoint import save_pytree as jax_save_pytree
from atlasvae_torch.data import hdf5
from atlasvae_torch.interop import params_from_jax, params_to_numpy
from atlasvae_torch.models import jetid
from atlasvae_torch.models import VAEConfig, init_vae
from atlasvae_torch.models.aae import AAEConfig, init_aae
from atlasvae_torch.train import keras_export, keras_import
from atlasvae_torch.train.checkpoint import tree_flatten

JETID_CONFIGS = {
    "single_tower": dict(
        n_classes=2, scalars=("scalars",), scalar_dims=(16,), images=("image",),
        image_shapes=((13, 11),), nn_type="CNN", fcn_neurons=(32,), branch_neurons=(16,),
        cnn_maps=(8, 8), cnn_kernels=((3, 3), (3, 3)), cnn_pools=((2, 2), (2, 2)),
        dropout=0.0),
    "multi_tower": dict(
        n_classes=2, scalars=("scalars",), scalar_dims=(16,), images=("img_a", "img_b", "img_c"),
        image_shapes=((13, 11), (13, 11), (9, 7)), constituent_dim=20, nn_type="CNN",
        fcn_neurons=(32,), branch_neurons=(16,),
        cnn_by_shape=(((13, 11), (8, 8), ((3, 3), (3, 3)), ((2, 2), (2, 2))),
                      ((9, 7), (6, 6), ((3, 3), (3, 3)), ((2, 2), (2, 2)))),
        dropout=0.0),
    "towers_3d": dict(
        n_classes=3, scalars=("scalars",), scalar_dims=(16,), images=("img_a", "img_b", "img_c"),
        image_shapes=((8, 7), (8, 7), (13, 11)), nn_type="CNN", fcn_neurons=(32, 24),
        branch_neurons=(16,),
        cnn_by_shape=(((8, 7), (6, 6), ((2, 2, 2), (2, 2, 1)), ((2, 2, 1), (2, 2, 1))),
                      ((13, 11), (8, 8), ((3, 3), (3, 3)), ((2, 2), (2, 2)))),
        dropout=0.0),
    "fcn_images": dict(
        n_classes=2, scalars=("scalars",), scalar_dims=(16,), images=("img_a", "img_b"),
        image_shapes=((5, 4), (5, 4)), nn_type="FCN", fcn_neurons=(24,), branch_neurons=(16,),
        dropout=0.0),
}


@pytest.fixture(params=["h5py", "lite"])
def backend(request, monkeypatch):
    """The port's HDF5 library: h5py, or LiteFile as where h5py is missing."""
    if request.param == "lite":
        monkeypatch.setattr(hdf5, "_h5py", None)
    return request.param


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def same_leaves(port_tree, jax_tree):
    """The port's tree and a JAX tree: the same leaves, bit for bit, in the
    order both packages flatten them; the port's leaves float32 on the CPU."""
    got, want = tree_flatten(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def record_keras_calls(monkeypatch):
    """Record, in call order, each ``load_params_auto`` call's (arguments,
    result) and each ``maybe_export_keras`` call's (model_out, params): the
    CLIs' tests read what a run loaded and exported."""
    loads, exports = [], []
    load, export = keras_import.load_params_auto, keras_export.maybe_export_keras

    def recorded_load(*args, **kwargs):
        loads.append((args, load(*args, **kwargs)))
        return loads[-1][1]

    def recorded_export(params, model_out, *args, **kwargs):
        exports.append((model_out, params))
        return export(params, model_out, *args, **kwargs)

    monkeypatch.setattr(keras_import, "load_params_auto", recorded_load)
    monkeypatch.setattr(keras_export, "maybe_export_keras", recorded_export)
    return loads, exports


def _layer_names(path):
    import h5py
    with h5py.File(path, "r") as f:
        return [n.decode() for n in f.attrs["layer_names"]], \
            {k: [n.decode() for n in f[k].attrs["weight_names"]] for k in f}


def _both_ways(tmp_path, kind, jax_params, port_template, jax_template, export_kwargs=(),
               config=None):
    """Both directions for one family: JAX's file into the port (equal to
    JAX's own import), the port's file into JAX (the same names and groups as
    JAX's file); returns the port's import of JAX's file and JAX's import of
    the port's."""
    export_kwargs = dict(export_kwargs)
    jax_path, port_path = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    load = lambda module, path, template: (
        module.load_keras_jetid(path, template, config[module is keras_import])
        if kind == "jetid" else getattr(module, f"load_keras_{kind}")(path, template))
    jax_args = (config[False],) if kind == "jetid" else ()
    getattr(jax_export, f"export_keras_{kind}")(jax_params, jax_path, *jax_args, **export_kwargs)
    got = load(keras_import, jax_path, port_template)
    same_leaves(got, load(jax_import, jax_path, jax_template))

    port_params = params_from_jax(_numpy(jax_params), "cpu")
    port_args = (config[True],) if kind == "jetid" else ()
    getattr(keras_export, f"export_keras_{kind}")(port_params, port_path, *port_args,
                                                  **export_kwargs)
    back = load(jax_import, port_path, jax_template)
    read = jax_import.read_keras_weights
    assert sorted(read(port_path)) == sorted(read(jax_path))
    assert _layer_names(port_path) == _layer_names(jax_path)
    with open(port_path, "rb") as f:
        assert f.read(8) == b"\x89HDF\r\n\x1a\n"
    return got, back


def test_vae_both_ways(tmp_path, backend):
    jax_params = jax_init_vae(jax.random.PRNGKey(7), JaxVAEConfig(fc_layers=(8, 6, 4),
                                                                  input_dim=12))
    template = init_vae(torch.Generator().manual_seed(1), VAEConfig(fc_layers=(8, 6, 4),
                                                                    input_dim=12), device="cpu")
    jax_template = jax_init_vae(jax.random.PRNGKey(8), JaxVAEConfig(fc_layers=(8, 6, 4),
                                                                    input_dim=12))
    got, back = _both_ways(tmp_path, "vae", jax_params, template, jax_template)
    same_leaves(got, jax_params)
    same_leaves(got, back)
    auto = keras_import.load_params_auto(str(tmp_path / "port.h5"), template, "vae")
    same_leaves(auto, jax_params)


@pytest.mark.parametrize("include_discriminator", [True, False])
def test_aae_both_ways(tmp_path, backend, include_discriminator):
    cfg = dict(input_dim=12, ae_layers=(10, 10, 5), disc_layers=(7, 7, 3))
    jax_params = jax_init_aae(jax.random.PRNGKey(3), JaxAAEConfig(**cfg))
    template = init_aae(torch.Generator().manual_seed(4), AAEConfig(**cfg), device="cpu")
    jax_template = params_to_numpy(template)
    got, back = _both_ways(tmp_path, "aae", jax_params, template, jax_template,
                           {"include_discriminator": include_discriminator})
    want = dict(_numpy(jax_params))
    if not include_discriminator:       # an AE-only file leaves the template's discriminator
        want["discriminator"] = jax_template["discriminator"]
        assert got["discriminator"] is template["discriminator"]
    same_leaves(got, want)
    same_leaves(got, back)


@pytest.mark.parametrize("name", sorted(JETID_CONFIGS))
def test_jetid_both_ways(tmp_path, backend, name):
    jax_config = jax_jetid.JetIDConfig(**JETID_CONFIGS[name])
    config = jetid.JetIDConfig(**JETID_CONFIGS[name])
    want_perm = jax_jetid.reference_concat_permutation(jax_config)
    perm = jetid.reference_concat_permutation(config)
    assert (perm is None) == (want_perm is None)
    assert (perm is not None) == (name in ("multi_tower", "fcn_images"))
    if perm is not None:
        assert perm.dtype == np.int64
        np.testing.assert_array_equal(perm, want_perm)
    jax_params = jax_jetid.init_jetid(jax.random.PRNGKey(23), jax_config)
    template = jetid.init_jetid(torch.Generator().manual_seed(0), config, device="cpu")
    if name == "towers_3d":
        # Keras numbers conv2d and conv3d layers apart; the JAX importer
        # sorts them by the number alone, interleaves the two towers and
        # refuses the file, where the port sorts within each class
        for exporter, params in ((jax_export, jax_params),
                                 (keras_export, params_from_jax(_numpy(jax_params), "cpu"))):
            path = str(tmp_path / f"{exporter.__name__.split('.')[0]}.h5")
            exporter.export_keras_jetid(params, path, {jax_export: jax_config}.get(exporter,
                                                                                  config))
            with pytest.raises(ValueError, match="no conv run matches tower '8x7'"):
                jax_import.load_keras_jetid(path, jax_params, jax_config)
            same_leaves(keras_import.load_keras_jetid(path, template, config), jax_params)
        assert _layer_names(str(tmp_path / "atlasvae.h5")) == \
            _layer_names(str(tmp_path / "atlasvae_torch.h5"))
        return
    got, back = _both_ways(tmp_path, "jetid", jax_params, template, params_to_numpy(template),
                           config={False: jax_config, True: config})
    same_leaves(got, jax_params)
    same_leaves(got, back)


def _wpair(prefix, rng, d_in, d_out):
    return [(f"{prefix}/kernel:0", rng.normal(size=(d_in, d_out)).astype(np.float32)),
            (f"{prefix}/bias:0", rng.normal(size=d_out).astype(np.float32))]


def test_keras2_file_as_the_reference_wrote_it(tmp_path, backend):
    """Every layer in ``layer_names``, weightless ones with an empty
    ``weight_names``, fixed-width name arrays: read by the port as by JAX."""
    import h5py
    rng = np.random.default_rng(1)
    layers = {"input_1": [], "encoder": (_wpair("vae/encoder/dense", rng, 12, 8)
                                         + _wpair("vae/encoder/dense_1", rng, 8, 6)
                                         + _wpair("vae/encoder/dense_mean", rng, 6, 4)
                                         + _wpair("vae/encoder/dense_log_var", rng, 6, 4)),
              "dropout": [], "decoder": (_wpair("vae/decoder/dense_2", rng, 4, 6)
                                         + _wpair("vae/decoder/dense_3", rng, 6, 8)
                                         + _wpair("vae/decoder/dense_output", rng, 8, 12))}
    path = str(tmp_path / "model.h5")
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in layers], dtype="S64")
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.11.0"
        for layer, weights in layers.items():
            g = f.create_group(layer)
            g.attrs["weight_names"] = np.array([n.encode() for n, _ in weights], dtype="S128") \
                if weights else np.array([])
            for n, arr in weights:
                g.create_dataset(n, data=arr)
    named = keras_import.read_keras_weights(path)
    want = jax_import.read_keras_weights(path)
    assert list(named) == list(want)
    for key in want:
        np.testing.assert_array_equal(named[key], want[key])
    template = init_vae(torch.Generator().manual_seed(0), VAEConfig(fc_layers=(8, 6, 4),
                                                                    input_dim=12), device="cpu")
    jax_template = jax_init_vae(jax.random.PRNGKey(0), JaxVAEConfig(fc_layers=(8, 6, 4),
                                                                    input_dim=12))
    same_leaves(keras_import.load_keras_vae(path, template),
                 jax_import.load_keras_vae(path, jax_template))


def _bad_vae(tmp_path):
    rng = np.random.default_rng(3)
    groups = {"encoder": (_wpair("vae/encoder/dense", rng, 12, 9)        # 9 != 8
                          + _wpair("vae/encoder/dense_mean", rng, 9, 4)
                          + _wpair("vae/encoder/dense_log_var", rng, 9, 4)),
              "decoder": _wpair("vae/decoder/dense_output", rng, 4, 12)}
    path = str(tmp_path / "bad.h5")
    jax_export._write_keras2(path, groups)
    make = lambda init, cfg, key: init(key, cfg(fc_layers=(8, 4), input_dim=12))
    return path, ("vae",), make(jax_init_vae, JaxVAEConfig, jax.random.PRNGKey(0)), \
        init_vae(torch.Generator().manual_seed(0), VAEConfig(fc_layers=(8, 4), input_dim=12),
                 device="cpu"), "shape mismatch"


def _twin_towers(tmp_path):
    """Two image shapes whose towers have the same kernel signature."""
    cfg = dict(n_classes=2, images=("a", "b"), image_shapes=((13, 11), (9, 7)), nn_type="CNN",
               fcn_neurons=(8,), cnn_maps=(4,), cnn_kernels=((3, 3),), cnn_pools=((2, 2),),
               dropout=0.0)
    jax_params = jax_jetid.init_jetid(jax.random.PRNGKey(1), jax_jetid.JetIDConfig(**cfg))
    path = str(tmp_path / "twins.h5")
    jax_export.export_keras_jetid(jax_params, path)
    return path, ("jetid",), jax_params, jetid.init_jetid(
        torch.Generator().manual_seed(0), jetid.JetIDConfig(**cfg), device="cpu"), \
        "identical kernel signatures"


def _convs_under_fcn(tmp_path):
    cnn = JETID_CONFIGS["single_tower"]
    fcn = dict(cnn, nn_type="FCN")
    path = str(tmp_path / "cnn.h5")
    jax_export.export_keras_jetid(
        jax_jetid.init_jetid(jax.random.PRNGKey(2), jax_jetid.JetIDConfig(**cnn)), path)
    return path, ("jetid",), jax_jetid.init_jetid(jax.random.PRNGKey(3),
                                                  jax_jetid.JetIDConfig(**fcn)), \
        jetid.init_jetid(torch.Generator().manual_seed(0), jetid.JetIDConfig(**fcn),
                         device="cpu"), "conv layers"


@pytest.mark.parametrize("case", [_bad_vae, _twin_towers, _convs_under_fcn],
                         ids=["shape_mismatch", "identical_towers", "convs_under_fcn"])
def test_error_paths_raise_as_in_jax(tmp_path, backend, case):
    path, (kind,), jax_template, template, match = case(tmp_path)
    with pytest.raises(ValueError, match=match) as jax_error:
        getattr(jax_import, f"load_keras_{kind}")(path, jax_template)
    with pytest.raises(ValueError, match=match) as port_error:
        keras_import.load_params_auto(path, template, kind)
    assert str(port_error.value) == str(jax_error.value)


def test_signature_not_name_tells_the_formats_apart(tmp_path, backend):
    """npz bytes under an .h5 name (a --model_out model.h5 run before its
    export) load as npz; a Keras file under an .npz name as Keras; anything
    else, and a Keras file that lacks a layer, raise naming the file."""
    jax_params = jax_init_vae(jax.random.PRNGKey(5), JaxVAEConfig())
    template = init_vae(torch.Generator().manual_seed(0), VAEConfig(), device="cpu")
    staged, keras, text = (str(tmp_path / n) for n in ("staged.h5", "keras.npz", "notes.h5"))
    jax_save_pytree(staged, jax_params)
    jax_export.export_keras_vae(jax_params, keras)
    (tmp_path / "notes.h5").write_text("not weights")
    for path, kind in ((staged, "npz"), (keras, "keras")):
        assert keras_import.sniff_weights_format(path) == jax_import.sniff_weights_format(path) \
            == kind
        same_leaves(keras_import.load_params_auto(path, template, "vae"), jax_params)
    with pytest.raises(ValueError, match="notes.h5.*unrecognized file signature"):
        keras_import.load_params_auto(text, template, "vae")
    missing = str(tmp_path / "missing.h5")
    with hdf5.File(missing, "w") as f:
        f.attrs["layer_names"] = np.array([b"encoder", b"decoder"])
        f.create_group("encoder").attrs["weight_names"] = np.array([b"x/kernel:0"])
    with pytest.raises(ValueError, match="missing.h5: a Keras weight file that lacks"):
        keras_import.load_keras_vae(missing, template)
