"""``atlasvae_torch/plotting/extras.py`` and ``pedagogy.py`` against the
JAX package's on the same inputs, made from a seed (tests/test_plotting.py
drives the JAX package's).

Every figure is recorded where it is saved, through ``Figure.savefig``
(``tests/plot_record.py``'s records): both sides save the same files, with
every plotted array within rtol 1e-5 / atol 1e-6.  The t-SNE map itself is
sklearn's and magnifies a 1e-7 gap of its input, so ``TSNE`` is replaced by
a fixed map and the array handed to it, the encoder means, is held to the
encoder's bar (1e-5 of its largest magnitude, tests/test_torch_vae.py)."""

import contextlib
import os
import pickle

import jax
import numpy as np
import pytest
import sklearn.manifold
import torch
from matplotlib.figure import Figure

import atlasvae.plotting.extras as jax_extras
import atlasvae.plotting.pedagogy as jax_pedagogy
from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.plotting import extras, pedagogy
from plot_record import assert_same_plots, record_figure
from torch_gaps import assert_close

CPU = torch.device("cpu")


@contextlib.contextmanager
def saved(root):
    """{file name relative to root: record} of every figure saved inside; a
    file saved again is recorded again under its name and "#<k>"."""
    records = {}
    real = Figure.savefig

    def savefig(fig, fname, *args, **kwargs):
        name = os.path.relpath(str(fname), str(root))
        again = sum(key.split("#")[0] == name for key in records)
        records[f"{name}#{again}" if again else name] = record_figure(fig)
        open(fname, "wb").close()

    Figure.savefig = savefig
    try:
        yield records
    finally:
        Figure.savefig = real


def _both(tmp_path, port_call, jax_call):
    """Run each side into its own folder; return (port records, JAX
    records, port result, JAX result)."""
    out = {}
    for side, call in (("port", port_call), ("jax", jax_call)):
        folder = tmp_path / side
        folder.mkdir(exist_ok=True)
        with saved(folder) as records:
            result = call(str(folder))
        out[side] = records, result
    return out["port"][0], out["jax"][0], out["port"][1], out["jax"][1]


def _labels(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n)


def test_tsne_embedding_hands_tsne_the_jax_encoder_means(tmp_path, monkeypatch):
    jparams = jax_init_vae(jax.random.PRNGKey(4), JaxVAEConfig(fc_layers=(16, 8, 4),
                                                               input_dim=12))
    params = params_from_jax(jparams, CPU)
    x = np.random.default_rng(1).normal(0, 1, (300, 12)).astype(np.float32)
    y = _labels(300, 2)
    handed = []

    class FixedTSNE:
        def __init__(self, **kwargs):
            assert kwargs == dict(n_components=2, random_state=0, perplexity=30,
                                  learning_rate=100.0)

        def fit_transform(self, z):
            handed.append(np.asarray(z))
            return np.stack([np.arange(len(z)), np.arange(len(z))[::-1]], 1).astype(float)

    monkeypatch.setattr(sklearn.manifold, "TSNE", FixedTSNE)
    got, want, emb, jax_emb = _both(
        tmp_path, lambda d: extras.tsne_embedding(y, x, params, d, max_points=250, device=CPU),
        lambda d: jax_extras.tsne_embedding(y, x, jparams, d, max_points=250))
    assert_close(handed[0], handed[1], "encoder means", atol=1e-5 * np.abs(handed[1]).max())
    assert handed[0].shape == (250, 4)
    assert_same_plots(got, want)
    np.testing.assert_array_equal(emb, jax_emb)
    # the pickle cache: a second call reads it and runs no TSNE
    again = extras.tsne_embedding(y, x, params, str(tmp_path / "port"), max_points=250,
                                  device=CPU)
    np.testing.assert_array_equal(again, emb)
    assert len(handed) == 2


def test_combine_roc_curves_bin_meshgrid_and_ks_distance(tmp_path):
    r = np.random.default_rng(5)
    rates_file = tmp_path / "pos_rates.pkl"
    with open(rates_file, "wb") as f:
        pickle.dump({"fpr": np.linspace(0, 1, 40), "tpr": np.sqrt(np.linspace(0, 1, 40))}, f)
    pos = {"A": (np.linspace(1e-3, 1, 30), np.linspace(0.3, 1, 30)), "B": str(rates_file)}
    z = r.uniform(1, 3, (2, 3))
    z[1, 2] = -1
    got, want, _, _ = _both(
        tmp_path,
        lambda d: (extras.combine_roc_curves(pos, d),
                   extras.bin_meshgrid([0, 1, 2.5], [0, 1], z, f"{d}/grid.png")),
        lambda d: (jax_extras.combine_roc_curves(pos, d),
                   jax_extras.bin_meshgrid([0, 1, 2.5], [0, 1], z, f"{d}/grid.png")))
    assert sorted(got) == ["ROC_curves.png", "grid.png"]
    assert_same_plots(got, want)
    a, b = r.normal(0, 1, 500), r.normal(0.3, 1, 400)
    wa, wb = r.uniform(0.5, 2, 500), r.uniform(0.5, 2, 400)
    assert extras.ks_distance(a, b, wa, wb) == jax_extras.ks_distance(a, b, wa, wb)
    assert extras.ks_distance(a, b) == jax_extras.ks_distance(a, b)


@pytest.mark.parametrize("n_dims", [4, 3])
def test_pt_reconstruction_matches_jax(tmp_path, n_dims):
    r = np.random.default_rng(6)
    n, n_const = 400, 10
    x_true = r.normal(0, 20, (n, n_const * n_dims)).astype(np.float32)
    if n_dims == 4:
        block = x_true.reshape(n, n_const, 4)
        block[..., 0] = np.linalg.norm(block[..., 1:], axis=-1) + 1.0     # E above |p|
    x_pred = (x_true + r.normal(0, 2, x_true.shape)).astype(np.float32)
    y = _labels(n, 7)
    w = r.uniform(0.5, 2, n).astype(np.float32)
    got, want, _, _ = _both(
        tmp_path,
        lambda d: extras.pt_reconstruction(x_true, x_pred, y, w, d, n_bins=50, n_dims=n_dims,
                                           device=CPU),
        lambda d: jax_extras.pt_reconstruction(x_true, x_pred, y, w, d, n_bins=50,
                                               n_dims=n_dims))
    assert sorted(got) == ["pt_reconstruction.png"]
    assert_same_plots(got, want)


def test_deco_example_and_cal_images_match_jax(tmp_path):
    r = np.random.default_rng(8)
    n = 3000
    sample = {"m": r.uniform(30, 500, n).astype(np.float32),
              "pt": r.uniform(450, 1100, n).astype(np.float32),
              "weights": np.ones(n, np.float32)}
    y = np.where(r.random(n) < 0.2, 0, 1)
    loss = np.clip(r.beta(2, 2, n) + (y == 0) * 0.15, 0, 1)
    images = r.gamma(1.0, 1.0, (200, 9, 7))
    labels = r.integers(0, 3, 200)
    got, want, flat, jax_flat = _both(
        tmp_path,
        lambda d: (pedagogy.cal_images(images, labels, d),
                   pedagogy.cal_images(images, labels, d, mode="std"),
                   pedagogy.deco_example(y, sample, loss, d))[-1],
        lambda d: (jax_pedagogy.cal_images(images, labels, d),
                   jax_pedagogy.cal_images(images, labels, d, mode="std"),
                   jax_pedagogy.deco_example(y, sample, loss, d))[-1])
    assert sorted(got) == ["cal_images_mean.png", "cal_images_std.png", "deco_example.png"]
    assert_same_plots(got, want)
    np.testing.assert_array_equal(flat, jax_flat)


def test_deco_walkthrough_matches_jax(tmp_path):
    got, want, files, jax_files = _both(
        tmp_path, lambda d: pedagogy.deco_walkthrough(d, extras=True),
        lambda d: jax_pedagogy.deco_walkthrough(d, extras=True))
    assert [os.path.basename(f) for f in files] == [os.path.basename(f) for f in jax_files]
    assert len(got) == 16
    assert_same_plots(got, want)


def test_jetid_debug_plots_match_jax(tmp_path):
    r = np.random.default_rng(9)
    tracks = r.normal(0, 0.01, (300, 12, 5))
    tracks[r.uniform(size=(300, 12)) > 0.6] = 0
    labels = r.integers(0, 3, 300)
    raw = {"pt": r.lognormal(6, 0.4, 500)}
    trans = {"pt": (raw["pt"] - raw["pt"].mean()) / raw["pt"].std()}
    vertex = r.integers(0, 8, 400)

    def draw(module, d):
        outs = [module.plot_vertex(vertex, d), module.plot_scalars(raw, trans, "pt", d)]
        for var in ("efrac", "deta", "d0"):
            outs.append(module.plot_tracks(tracks, labels, var, d))
        return outs

    got, want, outs, jax_outs = _both(tmp_path, lambda d: draw(pedagogy, d),
                                      lambda d: draw(jax_pedagogy, d))
    assert sorted(got) == ["scalars_pt.png", "tracks_d0.png", "tracks_deta.png",
                           "tracks_efrac.png", "tracks_number.png", "tracks_number.png#1",
                           "tracks_number.png#2", "tracks_vertex.png"]
    assert_same_plots(got, want)
