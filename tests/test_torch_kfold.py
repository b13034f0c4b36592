"""``train_kfold_vmapped`` and ``cross_valid`` of the port against its own
sequential folds and against the JAX package.

* Folds against the port's ``train_classifier`` a fold, with dropout on:
  folds of unequal size, so that the common batch grid gives the smallest
  fold all-padding tail batches, which it must skip (no step, no dropout
  draw); class weights; early stopping.  Histories, best weights and the
  checkpoint files equal bit for bit.
* Lanes against the JAX package's ``train_kfold_vmapped`` at dropout 0 from
  the same weights (``interop``), on an FCN and on a small CNN (whose conv
  block runs K5/K6's plain versions on the CPU): the bars of
  tests/test_ensemble.py, weights rtol 5e-4 / atol 1e-4; the loss and
  accuracy series at tests/test_torch_jetid_train.py's rtol 2e-5.
* ``cross_valid`` on the same ``model_<fold>.npz`` files as the JAX
  package's: probabilities rtol 2e-5 / atol 2e-5 (the whole-model bar of
  tests/test_tf_parity.py), -1 where no fold scores an event, and as wide as
  the model's classes.
"""

import jax
import numpy as np
import pytest
import torch

from atlasvae.eval import jetid_eval as jax_eval
from atlasvae.models import jetid as jax_jetid
from atlasvae.train import jetid_loop as jax_loop
from atlasvae_torch.eval import jetid_eval
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.models import jetid
from atlasvae_torch.train import jetid_loop
from atlasvae_torch.train.checkpoint import save_pytree, tree_flatten

CONFIGS = {
    "cnn": dict(n_classes=2, scalars=("HLVs",), scalar_dims=(5,), images=("images",),
                image_shapes=((10, 10),), nn_type="CNN", fcn_neurons=(12, 8),
                branch_neurons=(8,), cnn_maps=(5, 4), dropout=0.0, l2=1e-4),
    "fcn": dict(n_classes=2, scalars=("HLVs",), scalar_dims=(5,), constituent_dim=12,
                nn_type="FCN", fcn_neurons=(12, 8), branch_neurons=(8,), dropout=0.0, l2=1e-4),
}
WEIGHT_RTOL, WEIGHT_ATOL = 5e-4, 1e-4
SERIES_RTOL = 2e-5
PROB_TOL = 2e-5
# train and validation rows a fold: unequal, so that the 100-row grid of the
# largest fold (5 batches) leaves the last fold 2 all-padding tail batches
FOLD_ROWS = [(500, 250), (430, 120), (260, 180)]


def _sample(kwargs, n, rng):
    labels = rng.integers(0, 2, n)
    shift = (1.0 - 2.0 * labels)[:, None]
    inputs = {"HLVs": (rng.normal(size=(n, 5)) + 0.8 * shift).astype(np.float32)}
    if kwargs.get("constituent_dim"):
        inputs["constituents"] = (rng.normal(size=(n, kwargs["constituent_dim"]))
                                  + 0.5 * shift).astype(np.float32)
    for name, shape in zip(kwargs.get("images", ()), kwargs.get("image_shapes", ())):
        x = np.abs(rng.normal(size=(n,) + shape)) * (rng.random((n,) + shape) < 0.12)
        x[labels == 0, :5] *= 2.0
        inputs[name] = x.astype(np.float32)
    return inputs, labels


def _folds(kwargs, seed, class_weight=None):
    rng = np.random.default_rng(seed)
    loads, valids = [], []
    for n_train, n_valid in FOLD_ROWS:
        inputs, labels = _sample(kwargs, n_train, rng)
        weights = np.ones(n_train, np.float32) if class_weight is None else \
            np.asarray([class_weight[int(l)] for l in labels], np.float32)
        loads.append((inputs, labels, weights))
        v_inputs, v_labels = _sample(kwargs, n_valid, rng)
        valids.append((v_inputs, v_labels, np.ones(n_valid, np.float32)))
    return loads, valids


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a), tree_flatten(b)))


@pytest.mark.parametrize("patience,monitor", [(10, "val_loss"), (1, "val_accuracy")])
@pytest.mark.parametrize("name", ["fcn", "cnn"])
def test_lanes_equal_sequential_train_classifier(tmp_path, name, patience, monitor):
    cfg = jetid.JetIDConfig(**dict(CONFIGS[name], dropout=0.2))
    class_weight = {0: 1.5, 1: 0.75}
    loads, valids = _folds(CONFIGS[name], 3, class_weight)
    init = lambda f: jetid.init_jetid(torch.Generator().manual_seed(f), cfg, device="cpu")
    kw = dict(epochs=5, batch_size=100, lr=3e-3, patience=patience, seed=5, verbose=False,
              monitor=monitor)
    lane_outs = [str(tmp_path / f"lane_{f}.npz") for f in range(3)]
    best, histories = jetid_loop.train_kfold_vmapped([init(f) for f in range(3)], cfg, loads,
                                                     valids, model_outs=lane_outs, **kw)
    for f, ((inputs, labels, weights), (v_inputs, v_labels, _)) in enumerate(zip(loads, valids)):
        out = str(tmp_path / f"seq_{f}.npz")
        want, history = jetid_loop.train_classifier(init(f), cfg, inputs, labels, v_inputs,
                                                    v_labels, sample_weight=weights,
                                                    model_out=out, **kw)
        assert histories[f] == history, f"fold {f}"
        assert _equal_trees(best[f], want), f"fold {f}"
        with np.load(lane_outs[f]) as a, np.load(out) as b:
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
    if patience == 1:   # folds stopped early, after unequal numbers of epochs
        assert len({len(h["loss"]) for h in histories}) > 1


@pytest.mark.parametrize("name", ["fcn", "cnn"])
def test_lanes_match_jax_train_kfold_vmapped(name):
    jcfg, cfg = (module.JetIDConfig(**CONFIGS[name]) for module in (jax_jetid, jetid))
    loads, valids = _folds(CONFIGS[name], 7)
    jparams = [jax_jetid.init_jetid(jax.random.PRNGKey(f), jcfg) for f in range(1, 4)]
    kw = dict(epochs=3, batch_size=100, lr=2e-3, verbose=False)
    want, want_hist = jax_loop.train_kfold_vmapped(jparams, jcfg, loads, valids, **kw)
    got, got_hist = jetid_loop.train_kfold_vmapped(
        [params_from_jax(jax.tree.map(np.asarray, p), "cpu") for p in jparams], cfg, loads,
        valids, **kw)
    for f in range(3):
        for key, series in want_hist[f].items():
            np.testing.assert_allclose(got_hist[f][key], series, rtol=SERIES_RTOL,
                                       err_msg=f"fold {f} {key}")
        for a, b in zip(tree_flatten(got[f]), jax.tree_util.tree_leaves(want[f])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=WEIGHT_RTOL,
                                       atol=WEIGHT_ATOL, err_msg=f"fold {f}")


def test_cross_valid_matches_jax(tmp_path):
    """Three folds of a 3-class model on a sample that holds 2 classes."""
    kwargs = dict(CONFIGS["fcn"], n_classes=3)
    jcfg, cfg = jax_jetid.JetIDConfig(**kwargs), jetid.JetIDConfig(**kwargs)
    inputs, labels = _sample(kwargs, 700, np.random.default_rng(2))
    for fold in range(1, 4):
        save_pytree(str(tmp_path / f"model_{fold}.npz"),
                    jetid.init_jetid(torch.Generator().manual_seed(fold), cfg, device="cpu"))
    sample = {"eventNumber": np.arange(700) + 5, **inputs}
    template = jetid.init_jetid(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = jetid_eval.cross_valid(sample, labels, cfg, str(tmp_path), 3, template)
    want = jax_eval.cross_valid(sample, labels, jcfg, str(tmp_path), 3,
                                jax_jetid.init_jetid(jax.random.PRNGKey(0), jcfg))
    assert got.shape == want.shape == (700, 3) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=PROB_TOL, atol=PROB_TOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    # an event that no fold holds (eventNumber % 3 matches no fold) keeps -1
    sample["eventNumber"] = np.where(np.arange(700) < 10, 0.5, sample["eventNumber"])
    with_gap = jetid_eval.cross_valid(sample, labels, cfg, str(tmp_path), 3, template)
    assert (with_gap[:10] == -1.0).all() and np.array_equal(with_gap[10:], got[10:])


def test_unknown_monitor_is_refused():
    cfg = jetid.JetIDConfig(**CONFIGS["fcn"])
    loads, valids = _folds(CONFIGS["fcn"], 1)
    with pytest.raises(ValueError, match="monitor"):
        jetid_loop.train_kfold_vmapped(
            [jetid.init_jetid(torch.Generator().manual_seed(0), cfg, device="cpu")] * 3, cfg,
            loads, valids, epochs=1, monitor="auc")


def test_weighted_validation_is_refused():
    cfg = jetid.JetIDConfig(**CONFIGS["fcn"])
    loads, valids = _folds(CONFIGS["fcn"], 1)
    inputs, labels, weights = valids[0]
    valids[0] = (inputs, labels, 2.0 * weights)
    with pytest.raises(ValueError, match="unweighted"):
        jetid_loop.train_kfold_vmapped(
            [jetid.init_jetid(torch.Generator().manual_seed(0), cfg, device="cpu")] * 3, cfg,
            loads, valids, epochs=1)
