"""The jet-ID sample-weight schemes and the streaming helpers of
atlasvae_torch against the JAX package's.

``get_sample_weights`` (bkg_ratio, flattening, match2class, match2max),
``upsampling`` and ``downsampling`` are host numpy in both packages: the same
sample gives the same weights and bins, and the same seed the same picked
indices, bit for bit.  ``index_ranges`` cuts ``cli/jetid.py --generator
ON``'s chunks; ``multi_cuts`` and ``_blank_column`` (``feature_removal``'s
column blanking) are exact; ``merge_samples`` and ``split_sample`` are library parity (no
CLI of either package calls them): ranges and splits are exact; a merged sample, read through ``data/hdf5.py`` and prepared by the
port's ``load_data``, is held to ``load_data``'s bar of rtol 1e-6 (constituent
sums in torch; tests/test_torch_data.py).
"""

import numpy as np
import pytest

from atlasvae.data import loader as jax_loader, registry as jax_registry
from atlasvae.eval import jetid_eval as jax_eval
from atlasvae.utils import chunks as jax_chunks
from atlasvae_torch.data import loader, registry
from atlasvae_torch.eval import jetid_eval
from atlasvae_torch.utils import chunks

SCHEMES = ("bkg_ratio", "flattening", "match2class", "match2max")


def _sample(rng, n=3000, n_classes=3):
    """Jets of three classes with their own (pt, eta) shapes; eta as the
    synthetic files store it (rljet_eta), and a few other columns."""
    labels = rng.integers(0, n_classes, n)
    pt = rng.lognormal(6.0 + 0.2 * labels, 0.5).astype(np.float32)
    eta = rng.normal(0.0, 1.0 + 0.2 * labels).astype(np.float32)
    sample = {"pt": pt, "rljet_eta": eta, "m": rng.uniform(30, 300, n).astype(np.float32),
              "HLVs": rng.normal(size=(n, 4)).astype(np.float32)}
    return sample, labels


def _equal_samples(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("bkg_ratio", [None, 1.5])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sample_weight_schemes_match_jax(rng, scheme, bkg_ratio):
    sample, labels = _sample(rng)
    got, got_bins = jetid_eval.get_sample_weights(sample, labels, scheme, bkg_ratio)
    want, want_bins = jax_eval.get_sample_weights(sample, labels, scheme, bkg_ratio)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and got.shape == (len(labels),)
    for key in ("pt", "eta"):
        np.testing.assert_array_equal(got_bins[key], want_bins[key])
    assert jetid_eval.get_sample_weights(sample, labels, "none") == (None, None)


@pytest.mark.parametrize("hist", ["pt", "eta"])
def test_one_dimensional_weight_histograms_match_jax(rng, hist):
    sample, labels = _sample(rng, n_classes=2)
    got, _ = jetid_eval.get_sample_weights(sample, labels, "flattening", 1.0, hist=hist)
    want, _ = jax_eval.get_sample_weights(sample, labels, "flattening", 1.0, hist=hist)
    np.testing.assert_array_equal(got, want)


def test_a_zero_ratio_degenerates_alike(rng):
    """The CLIs' default --bkg_ratio 0 gives non-finite weights in both
    packages; the CLIs then train unweighted."""
    sample, labels = _sample(rng, n_classes=2)
    with np.errstate(divide="ignore", invalid="ignore"):
        got, _ = jetid_eval.get_sample_weights(sample, labels, "flattening", 0)
        want, _ = jax_eval.get_sample_weights(sample, labels, "flattening", 0)
    np.testing.assert_array_equal(got, want)
    assert not np.isfinite(got).any()


@pytest.mark.parametrize("seed", [0, 7])
def test_upsampling_picks_the_same_jets(rng, seed):
    sample, labels = _sample(rng, n=1200, n_classes=2)
    bins = [0, 300, 500, 800, 1500, 1e5]
    indices = np.digitize(sample["pt"], bins) - 1
    hist_sig = np.histogram(sample["pt"][labels == 0], bins)[0]
    hist_bkg = np.histogram(sample["pt"][labels != 0], bins)[0]
    total = np.maximum(hist_sig, hist_bkg) * 1.3
    args = (sample, labels, bins, indices, hist_sig, hist_bkg, total, total)
    got, got_labels = jetid_eval.upsampling(*args, seed=seed)
    want, want_labels = jax_eval.upsampling(*args, seed=seed)
    _equal_samples(got, want)
    np.testing.assert_array_equal(got_labels, want_labels)
    assert len(got_labels) > len(labels)


@pytest.mark.parametrize("bkg_ratio", [None, 2.0])
def test_downsampling_splits_alike(rng, bkg_ratio):
    sample, labels = _sample(rng, n=1500, n_classes=2)
    sample["pt"] = rng.uniform(0, 520, len(labels)).astype(np.float32)
    got = jetid_eval.downsampling(sample, labels, bkg_ratio, seed=3)
    want = jax_eval.downsampling(sample, labels, bkg_ratio, seed=3)
    for a, b in zip(got, want):
        if isinstance(b, dict):
            _equal_samples(a, b)
        else:
            np.testing.assert_array_equal(a, b)
    assert len(got[1]) + len(got[3]) == len(labels)


def test_index_ranges_match_jax():
    cases = [(10, 3, None, 0), (100, 10, 30, 0), (7, 10, None, 0), (50, 4, None, 10),
             (0, 10, None, 0), (5, 10, 5, 5), (100_000, 10, 20_000, 0), (1_000_003, 10, None, 0)]
    for max_val, n_bins, bin_size, min_val in cases:
        got = chunks.index_ranges(max_val, n_bins, bin_size, min_val)
        want = jax_chunks.index_ranges(max_val, n_bins, bin_size, min_val)
        assert [tuple(map(int, r)) for r in got] == [tuple(map(int, r)) for r in want]


@pytest.fixture()
def both_registries(synth_dir):
    for name in ("QCD-Geneva", "top-Geneva"):
        registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
        jax_registry.register_file(name, synth_dir / f"synthetic_{name}.h5")
    return ["QCD-Geneva", "top-Geneva"]


@pytest.mark.parametrize("idx", [(3500, 5200), (100, 900), (4000, 8000)])
def test_merge_samples_across_two_files_matches_jax(both_registries, idx):
    """Global index ranges that span the two 4,000-event files, sit in the
    first, and fill the second."""
    kwargs = dict(cuts=['(sample["m"] >= 30)'], n_const=20, n_dims=3, constituents="ON",
                  hlvs="ON", verbose=False)
    got = loader.merge_samples(both_registries, idx, device="cpu", **kwargs)
    want = jax_loader.merge_samples(both_registries, idx, **kwargs)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="selects no rows"):
        loader.merge_samples(both_registries, (9000, 9100), device="cpu", **kwargs)


def test_split_sample_matches_jax(rng):
    n = 500
    sample = {"JZW": rng.choice([-1.0, 0.0, 3.0], n).astype(np.float32),
              "pt": rng.uniform(100, 900, n).astype(np.float32),
              "HLVs": rng.normal(size=(n, 3)).astype(np.float32)}
    for got, want in zip(loader.split_sample(sample), jax_loader.split_sample(sample)):
        _equal_samples(got, want)
    bkg, sig = loader.split_sample(sample)
    assert (sig["JZW"] == -1).all() and (bkg["JZW"] != -1).all()
    assert len(sig["pt"]) + len(bkg["pt"]) == n


@pytest.mark.parametrize("multi", [True, False])
@pytest.mark.parametrize("n_classes", [2, 3])
def test_multi_cuts_match_jax(rng, n_classes, multi):
    labels = rng.integers(0, n_classes, 2000)
    probs = rng.dirichlet(np.ones(n_classes), 2000).astype(np.float32)
    got = jetid_eval.multi_cuts(labels, probs, step=0.2, multi=multi)
    want = jax_eval.multi_cuts(labels, probs, step=0.2, multi=multi)
    assert got.shape == want.shape == (5 ** (n_classes - multi), n_classes + 1)
    np.testing.assert_array_equal(got, want)


def test_blank_column_matches_jax(rng):
    inputs = {"HLVs": rng.normal(size=(50, 3)).astype(np.float32),
              "constituents": rng.normal(size=(50, 6)).astype(np.float64)}
    for i in range(4):
        got, want = jetid_eval._blank_column(inputs, i), jax_eval._blank_column(inputs, i)
        _equal_samples(got, want)
        assert all(v.dtype == np.float32 for v in got.values())
    assert inputs["HLVs"][:, 0].any()     # the caller's arrays are left as they were
