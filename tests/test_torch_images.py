"""The jet-ID data path of the port against the JAX package: constituent
images and ``make_sample``.

``constituent_images`` bins each constituent by a float -> int truncation of
(delta-eta, delta-phi) around the jet axis, after arctanh, arctan2, sin/cos
sums and a modulo: where a constituent lies within the two libraries'
rounding of a pixel edge it lands in the neighbouring pixel.  So the result
is stated as: the pixel index equal for all but a counted handful of
constituents (at most 1 in 1,000 on synthetic jets, measured 2 of 12,000;
of constituents placed within 3 ulps of a pixel edge on purpose, at most 5
in 100, measured 2.5, each into the pixel next door), their pt weights
within rtol 1e-6, and the images of every jet whose constituents all agree
within rtol 1e-5 / atol 1e-6 of the image's scale (several constituents sum
into one pixel, in slot order on both sides).  ``make_sample``: every key equal to rtol 1e-6, labels and
shuffling order exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from atlasvae.data import jets as jax_jets, make_sample as jax_make_sample
from atlasvae_torch.data import constituent_images, jets, make_sample

CPU = torch.device("cpu")
MAX_MOVED_SHARE = 1e-3


def _synthetic_jets(rng, n_jets, n_const, n_dims):
    """Boosted jets off the origin: constituents scattered around an axis,
    falling pt, zero-padded tails."""
    eta0 = rng.uniform(-2, 2, (n_jets, 1))
    phi0 = rng.uniform(-np.pi, np.pi, (n_jets, 1))     # jets across the -pi/pi seam too
    eta = eta0 + rng.normal(0, 0.35, (n_jets, n_const))
    phi = phi0 + rng.normal(0, 0.35, (n_jets, n_const))
    pt = rng.exponential(30.0, (n_jets, n_const)) + 0.5
    live = rng.integers(1, n_const + 1, (n_jets, 1))
    pt = pt * (np.arange(n_const)[None, :] < live)
    px, py, pz = pt * np.cos(phi), pt * np.sin(phi), pt * np.sinh(eta)
    parts = [np.sqrt(px ** 2 + py ** 2 + pz ** 2)] if n_dims == 4 else []
    flat = np.stack(parts + [px, py, pz], axis=-1).reshape(n_jets, -1)
    return flat.astype(np.float32)


def _edge_jets(rng, n_jets, n_pixels, n_dims):
    """One hard constituent fixes the axis; the others sit within a few ulps
    of pixel edges of the grid around it."""
    n_const = 12
    edges = (np.arange(n_pixels + 1) / n_pixels * 2 - 1)
    eta = rng.choice(edges, (n_jets, n_const)) * (1 + rng.integers(-3, 4, (n_jets, n_const))
                                                   * np.finfo(np.float32).eps)
    phi = rng.choice(edges, (n_jets, n_const)) * (1 + rng.integers(-3, 4, (n_jets, n_const))
                                                   * np.finfo(np.float32).eps)
    pt = np.full((n_jets, n_const), 1e-3)
    eta[:, 0] = phi[:, 0] = 0.0
    pt[:, 0] = 1e4
    px, py, pz = pt * np.cos(phi), pt * np.sin(phi), pt * np.sinh(eta)
    parts = [np.sqrt(px ** 2 + py ** 2 + pz ** 2)] if n_dims == 4 else []
    return np.stack(parts + [px, py, pz], axis=-1).reshape(n_jets, -1).astype(np.float32)


def _check_images(flat, n_pixels, n_dims, extent=1.0, max_moved_share=MAX_MOVED_SHARE):
    idx_ref, w_ref = (np.asarray(a) for a in
                      jax_jets._image_bins(jnp.asarray(flat), n_pixels, extent, n_dims))
    idx, w = (a.numpy() for a in jets._image_bins(torch.from_numpy(flat), n_pixels, extent,
                                                  n_dims))
    np.testing.assert_allclose(w, w_ref, rtol=1e-6, atol=0)
    moved = (idx != idx_ref) & (w_ref > 0)
    assert moved.mean() <= max_moved_share, f"{moved.sum()} of {moved.size} constituents moved"
    # a moved constituent is in the pixel next door, never further
    assert np.abs(idx // n_pixels - idx_ref // n_pixels)[moved].max(initial=0) <= 1
    assert np.abs(idx % n_pixels - idx_ref % n_pixels)[moved].max(initial=0) <= 1

    want = np.asarray(jax_jets.constituent_images(flat, n_pixels, extent, n_dims))
    got = constituent_images(flat, n_pixels, extent, n_dims, device=CPU)
    assert got.shape == want.shape == (len(flat), n_pixels, n_pixels)
    assert got.dtype == np.float32
    same = ~moved.any(axis=1)
    scale = want.max()
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=1e-6 * scale)
    # every jet keeps its pt, wherever a constituent landed
    np.testing.assert_allclose(got.sum(axis=(1, 2)), want.sum(axis=(1, 2)), rtol=1e-5)
    return int(moved.sum())


@pytest.mark.parametrize("n_dims", [3, 4])
def test_constituent_images_match_jax_on_synthetic_jets(rng, n_dims):
    flat = _synthetic_jets(rng, 600, 20, n_dims)
    moved = _check_images(flat, 16, n_dims)
    print(f"moved on synthetic jets: {moved}")


@pytest.mark.parametrize("n_dims", [3, 4])
def test_constituent_images_match_jax_near_pixel_edges(rng, n_dims):
    flat = _edge_jets(rng, 500, 16, n_dims)
    moved = _check_images(flat, 16, n_dims, max_moved_share=0.05)
    print(f"moved near edges: {moved} of {flat.shape[0] * 11}")


def test_constituent_images_other_grid_and_padding_only_jets(rng):
    flat = _synthetic_jets(rng, 64, 8, 3)
    flat[:5] = 0.0                                  # jets of padding alone: empty images
    _check_images(flat, 9, 3, extent=0.8)
    got = constituent_images(flat, 9, 0.8, 3, device=CPU)
    assert not got[:5].any()


def test_constituent_images_sum_slots_in_order_on_every_call(rng):
    """Several constituents in one pixel: the same bits on a second call."""
    flat = _synthetic_jets(rng, 200, 40, 3)
    a = constituent_images(flat, 4, device=CPU, n_dims=3)
    b = constituent_images(flat, 4, device=CPU, n_dims=3)
    np.testing.assert_array_equal(a, b)


def test_constituent_images_refuse_a_ragged_width():
    with pytest.raises(ValueError, match="multiple"):
        constituent_images(np.zeros((2, 10), np.float32), n_dims=3, device=CPU)


@pytest.mark.parametrize("shuffling", [False, True])
def test_make_sample_matches_jax_key_by_key(synth_dir, shuffling):
    bkg = str(synth_dir / "synthetic_QCD-Geneva.h5")
    sig = str(synth_dir / "synthetic_top-Geneva.h5")
    args = (bkg, sig, 700, 500, ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)'], 20, 3,
            "ON", "ON")
    want = jax_make_sample(*args, shuffling=shuffling, verbose=False)
    got = make_sample(*args, shuffling=shuffling, verbose=False, device=CPU)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got["JZW"], want["JZW"])
    np.testing.assert_array_equal(got["constituents"], want["constituents"])
    assert set(np.unique(got["JZW"] == -1)) == {False, True}    # both classes present
