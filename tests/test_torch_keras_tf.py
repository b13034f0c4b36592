"""Real Keras (the installed TensorFlow's) against the port's Keras files,
with ``LiteFile`` doing every read and write (``hdf5._h5py`` set to None,
as on the machine with the card):

* a Keras 3 ``.weights.h5`` of the reference VAE, written by
  ``model.save_weights``, read by the port: the same weights bit for bit,
  and the port's forward equal to tf.keras's;
* the port's VAE and multi-tower jet-ID exports loaded by the reference
  models' ``load_weights``: the same weights, and tf.keras's forward equal
  to the port's.

Forwards agree within rtol 1e-5 / atol 1e-5, the bar of
``tests/test_keras_export.py``; weights exactly.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from tensorflow.keras import layers, models  # noqa: E402

from atlasvae.models import jetid as jax_jetid  # noqa: E402
from atlasvae_torch.data import hdf5  # noqa: E402
from atlasvae_torch.models import VAEConfig, init_vae, jetid  # noqa: E402
from atlasvae_torch.models.vae import decode, encode  # noqa: E402
from atlasvae_torch.train import keras_export, keras_import  # noqa: E402
from test_keras_export import _golden_inputs, _reference_multi_cnn  # noqa: E402
from test_torch_keras import JETID_CONFIGS  # noqa: E402

FC, INPUT_DIM = (8, 6, 4), 12
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def lite(monkeypatch):
    monkeypatch.setattr(hdf5, "_h5py", None)


def _reference_vae():
    """The reference OE-VAE's subclassed encoder/decoder (layer names
    dense_mean, dense_log_var, dense_output), called on the mean path."""

    class Encoder(layers.Layer):
        def __init__(self):
            super().__init__(name="encoder")
            self.denses = [layers.Dense(n, activation="relu") for n in FC[:-1]]
            self.dense_mean = layers.Dense(FC[-1])
            self.dense_log_var = layers.Dense(FC[-1])

        def call(self, x):
            for d in self.denses:
                x = d(x)
            return self.dense_mean(x), self.dense_log_var(x)

    class Decoder(layers.Layer):
        def __init__(self):
            super().__init__(name="decoder")
            self.denses = [layers.Dense(n, activation="relu") for n in FC[:-1][::-1]]
            self.dense_output = layers.Dense(INPUT_DIM)

        def call(self, x):
            for d in self.denses:
                x = d(x)
            return self.dense_output(x)

    class VAE(models.Model):
        def __init__(self):
            super().__init__(name="autoencoder")
            self.encoder = Encoder()
            self.decoder = Decoder()

        def call(self, x):
            z_mean, z_log_var = self.encoder(x)
            return self.decoder(z_mean), z_log_var

    return VAE()


def _vae_layers(model, params):
    """(tf layer, port leaf pair) for every dense layer of the VAE."""
    enc, dec = model.encoder, model.decoder
    return (list(zip(enc.denses, params["encoder"]["hidden"]))
            + [(enc.dense_mean, params["encoder"]["mean"]),
               (enc.dense_log_var, params["encoder"]["logvar"])]
            + list(zip(dec.denses, params["decoder"]["hidden"]))
            + [(dec.dense_output, params["decoder"]["out"])])


def _check_vae(model, params, x):
    for layer, leaf in _vae_layers(model, params):
        np.testing.assert_array_equal(layer.kernel.numpy(), leaf["w"].numpy())
        np.testing.assert_array_equal(layer.bias.numpy(), leaf["b"].numpy())
    tf_recon, tf_log_var = model(x)
    with torch.no_grad():
        z_mean, z_log_var = encode(params, torch.from_numpy(x))
        recon = decode(params, z_mean)
    np.testing.assert_allclose(recon.numpy(), np.asarray(tf_recon), **TOL)
    np.testing.assert_allclose(z_log_var.numpy(), np.asarray(tf_log_var), **TOL)


def test_keras3_weights_file_loads_into_the_port(tmp_path):
    x = np.random.default_rng(0).normal(size=(32, INPUT_DIM)).astype(np.float32)
    model = _reference_vae()
    model(x)
    path = str(tmp_path / "model.weights.h5")
    model.save_weights(path)
    template = init_vae(torch.Generator().manual_seed(0),
                        VAEConfig(fc_layers=FC, input_dim=INPUT_DIM), device="cpu")
    _check_vae(model, keras_import.load_params_auto(path, template, "vae"), x)


def test_reference_vae_loads_the_port_export(tmp_path):
    x = np.random.default_rng(1).normal(size=(32, INPUT_DIM)).astype(np.float32)
    params = init_vae(torch.Generator().manual_seed(11),
                      VAEConfig(fc_layers=FC, input_dim=INPUT_DIM), device="cpu")
    path = str(tmp_path / "model.h5")
    keras_export.export_keras_vae(params, path)
    model = _reference_vae()
    model(x)
    model.load_weights(path)
    _check_vae(model, params, x)


def test_reference_jetid_loads_the_port_export(tmp_path):
    """Two conv towers in an order the reference's ``set`` iteration changes,
    constituents and scalars branches: positional ``load_weights`` with the
    trunk rows in the reference's concat layout."""
    config = jetid.JetIDConfig(**JETID_CONFIGS["multi_tower"])
    params = jetid.init_jetid(torch.Generator().manual_seed(23), config, device="cpu")
    path = str(tmp_path / "model.h5")
    keras_export.export_keras_jetid(params, path, config)
    shapes, inputs = _golden_inputs(config, np.random.default_rng(3))
    model, names = _reference_multi_cnn(jax_jetid.JetIDConfig(**JETID_CONFIGS["multi_tower"]),
                                        shapes)
    model.load_weights(path)
    tf_out = np.asarray(model([inputs[n] for n in names]))
    # the towers' kernel signatures differ, so each conv layer is found by it
    ours_by_shape = {tuple(c["w"].shape): c for t in params["towers"].values() for c in t}
    convs = [l for l in model.layers if isinstance(l, layers.Conv2D)]
    assert sorted(tuple(l.kernel.shape) for l in convs) == sorted(ours_by_shape)
    for layer in convs:
        conv = ours_by_shape[tuple(layer.kernel.shape)]
        np.testing.assert_array_equal(layer.kernel.numpy(), conv["w"].numpy())
        np.testing.assert_array_equal(layer.bias.numpy(), conv["b"].numpy())
    with torch.no_grad():
        ours = jetid.jetid_apply(params, config, {k: torch.from_numpy(v)
                                                  for k, v in inputs.items()})
    np.testing.assert_allclose(ours.numpy(), tf_out, **TOL)
