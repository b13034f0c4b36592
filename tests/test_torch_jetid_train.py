"""atlasvae_torch.train.jetid_loop against atlasvae.train.jetid_loop.

The JAX package initialises the weights, ``interop.params_from_jax`` carries
them across, and the same numpy samples go through both trainers at
``dropout=0`` (JAX draws its dropout masks from threefry, the port from a
``torch.Generator``: with dropout on the port is tested alone).

Tolerances, measured over several runs (XLA's CPU reductions are not the
same bits from run to run, tests/test_jetid.py):

* first-step gradients: each leaf within 2e-4 of its largest value, the bar
  of tests/test_fused_conv.py for the conv block's gradients (measured
  2.7e-7);
* 3-epoch loss and accuracy series of ``train_classifier``: rtol 2e-5
  (measured 2.3e-7 on the losses, the same in three runs; the accuracies,
  counts over the jets, were equal);
* trained weights: each leaf within 1e-4 of its largest value (measured
  3.4e-7);
* ``predict_classifier`` on the same weights: rtol 2e-5 / atol 2e-5, the
  whole-model bar of tests/test_tf_parity.py (measured 1.2e-7);
* callback decisions, packing, resume, host evaluation functions: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atlasvae.eval import jetid_eval as jax_eval
from atlasvae.models import jetid as jax_jetid
from atlasvae.plotting.performance import background_rejection as jax_background_rejection
from atlasvae.train import jetid_loop as jax_loop
from atlasvae_torch.eval import jetid_eval
from atlasvae_torch.interop import params_from_jax, params_to_numpy
from atlasvae_torch.models import jetid
from atlasvae_torch.plotting.performance import background_rejection
from atlasvae_torch.train import jetid_loop
from atlasvae_torch.train.checkpoint import load_pytree, tree_flatten

GRAD_TOL = 2e-4
SERIES_RTOL = 2e-5
WEIGHT_TOL = 1e-4
PROB_TOL = 2e-5

CONFIGS = {
    "cnn": dict(n_classes=2, scalars=("HLVs",), scalar_dims=(5,), images=("images",),
                image_shapes=((10, 10),), nn_type="CNN", fcn_neurons=(12, 8),
                branch_neurons=(8,), cnn_maps=(5, 4), dropout=0.0, l2=1e-4),
    "fcn": dict(n_classes=2, scalars=("HLVs",), scalar_dims=(5,), constituent_dim=12,
                nn_type="FCN", fcn_neurons=(12, 8), branch_neurons=(8,), dropout=0.0, l2=1e-4),
}


def _pair(name, **over):
    kwargs = dict(CONFIGS[name], **over)
    return jax_jetid.JetIDConfig(**kwargs), jetid.JetIDConfig(**kwargs)


def _sample(cfg, n, seed):
    """Two classes that differ in every branch; sparse images."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    shift = (1.0 - 2.0 * labels)[:, None]
    inputs = {"HLVs": (rng.normal(size=(n, 5)) + 0.8 * shift).astype(np.float32)}
    if cfg.constituent_dim:
        inputs["constituents"] = (rng.normal(size=(n, cfg.constituent_dim))
                                  + 0.5 * shift).astype(np.float32)
    for name, shape in zip(cfg.images, cfg.image_shapes):
        x = np.abs(rng.normal(size=(n,) + tuple(shape))) * (rng.random((n,) + tuple(shape)) < 0.12)
        x[labels == 0, :5] *= 2.0
        inputs[name] = x.astype(np.float32)
    return inputs, labels


def _init(jcfg, seed=0):
    jparams = jax_jetid.init_jetid(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _leaf_gap(got_tree, want_tree):
    """Largest |got - want| over a leaf's largest |want|, over the leaves."""
    worst = 0.0
    for got, want in zip(tree_flatten(params_to_numpy(got_tree)),
                         jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want_tree))):
        assert got.shape == want.shape
        worst = max(worst, float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)))
    return worst


@pytest.mark.parametrize("name", ["cnn", "fcn"])
def test_first_step_gradients_match_jax(name):
    jcfg, cfg = _pair(name)
    jparams, params = _init(jcfg)
    inputs, labels = _sample(cfg, 50, seed=1)
    weights = np.random.default_rng(2).uniform(0.5, 1.5, 50).astype(np.float32)

    def jax_loss(p):
        probs = jax_jetid.jetid_apply(p, jcfg, inputs, train=True)
        return jax_loop._ce_loss(probs, jnp.asarray(labels), jnp.asarray(weights)) \
            + jcfg.l2 * jax_jetid.l2_penalty(p)

    want_loss, want = jax.value_and_grad(jax_loss)(jparams)
    leaves = [leaf.requires_grad_() for leaf in tree_flatten(params)]
    loss, metrics = jetid_loop.batch_loss(
        params, cfg, {k: torch.from_numpy(v) for k, v in inputs.items()},
        torch.from_numpy(labels), torch.from_numpy(weights), None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    assert float(metrics[0]) == float(loss.detach())
    for got, ref in zip(grads, jax.tree_util.tree_leaves(want)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max()


def test_ce_loss_matches_jax_and_floors_the_probability(rng):
    probs = rng.dirichlet([1, 1, 1], 40).astype(np.float32)
    probs[0] = [0.0, 1.0, 0.0]                       # log(0) floored at 1e-7
    labels = rng.integers(0, 3, 40)
    labels[0] = 0
    weights = rng.uniform(0, 2, 40).astype(np.float32)
    want = float(jax_loop._ce_loss(jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(weights)))
    got = float(jetid_loop._ce_loss(torch.from_numpy(probs), torch.from_numpy(labels),
                                    torch.from_numpy(weights)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    zero = float(jetid_loop._ce_loss(torch.from_numpy(probs), torch.from_numpy(labels),
                                     torch.zeros(40)))
    assert zero == 0.0                                # an all-padding batch: 0 / 1e-30


def test_pack_pads_the_tail_with_zero_weight(rng):
    inputs = {"a": rng.normal(size=(11, 3)).astype(np.float32)}
    labels = rng.integers(0, 2, 11)
    weights = rng.uniform(1, 2, 11).astype(np.float32)
    want = jax_loop._pack(inputs, labels, weights, 4)
    got = jetid_loop._pack(inputs, labels, weights, 4)
    np.testing.assert_array_equal(got[0]["a"], want[0]["a"])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].shape == (3, 4) and got[2][2, 3] == 0.0 and got[1].dtype == np.int32


@pytest.mark.parametrize("class_weight", [None, {0: 1.7, 1: 0.6}], ids=["unit", "class_weights"])
@pytest.mark.parametrize("name", ["cnn", "fcn"])
def test_train_classifier_matches_jax(tmp_path, name, class_weight):
    jcfg, cfg = _pair(name)
    jparams, params = _init(jcfg)
    inputs, labels = _sample(cfg, 230, seed=3)         # 230 = 4 batches of 64, a ragged tail
    v_inputs, v_labels = _sample(cfg, 120, seed=4)     # validation batch min(64, 120), padded
    kwargs = dict(epochs=3, batch_size=64, lr=2e-3, class_weight=class_weight, verbose=False,
                  monitor="val_loss")
    jbest, jhist = jax_loop.train_classifier(jparams, jcfg, inputs, labels, v_inputs, v_labels,
                                             model_out=str(tmp_path / "jax.npz"), **kwargs)
    best, hist = jetid_loop.train_classifier(params, cfg, inputs, labels, v_inputs, v_labels,
                                             model_out=str(tmp_path / "port.npz"), **kwargs)
    assert set(hist) == set(jhist) == {"loss", "val_loss", "accuracy", "val_accuracy"}
    for key in jhist:
        assert len(hist[key]) == 3
        np.testing.assert_allclose(hist[key], jhist[key], rtol=SERIES_RTOL, err_msg=key)
    assert hist["loss"][-1] < hist["loss"][0]
    assert _leaf_gap(best, jbest) <= WEIGHT_TOL
    # the checkpoint is the best epoch's weights, in the other package's format
    saved = load_pytree(str(tmp_path / "jax.npz"), best)
    assert _leaf_gap(saved, jbest) == 0.0
    on_disk = load_pytree(str(tmp_path / "port.npz"), best)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(on_disk), tree_flatten(best)))

    want = jax_loop.predict_classifier(jbest, jcfg, v_inputs)
    carried = params_from_jax(jax.tree.map(np.asarray, jbest), device="cpu")
    got = jetid_loop.predict_classifier(carried, cfg, v_inputs, batch_size=50)   # ragged chunks
    assert got.shape == want.shape == (120, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PROB_TOL, atol=PROB_TOL)


@pytest.mark.parametrize("monitor", ["loss", "val_accuracy"])
def test_callback_decisions_match_jax(capsys, monitor):
    """lr = 0 freezes the weights, so no epoch after the first improves the
    monitor: the plateau halves lr after 5 waits and the early stop ends
    the run after ``patience`` = 7, the same epochs in both packages."""
    jcfg, cfg = _pair("fcn")
    jparams, params = _init(jcfg)
    inputs, labels = _sample(cfg, 64, seed=5)
    kwargs = dict(epochs=12, batch_size=32, lr=0.0, patience=7, verbose=True, monitor=monitor)
    _, jhist = jax_loop.train_classifier(jparams, jcfg, inputs, labels, inputs, labels, **kwargs)
    jax_out = capsys.readouterr().out
    best, hist = jetid_loop.train_classifier(params, cfg, inputs, labels, inputs, labels,
                                             **kwargs)
    out = capsys.readouterr().out
    assert len(hist["loss"]) == len(jhist["loss"]) == 8
    pick = lambda text: [l for l in text.splitlines() if l.startswith(("Reducing", "Early"))]
    assert pick(out) == pick(jax_out) == ["Reducing learning rate to 0.0",
                                          "Early stopping — restoring best weights"]
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(best), tree_flatten(params)))


def test_best_weights_are_the_monitored_minimum():
    """A large lr makes the validation loss turn: the returned weights are
    those of its lowest epoch, not the last."""
    _, cfg = _pair("fcn")
    params = jetid.init_jetid(torch.Generator().manual_seed(0), cfg, device="cpu")
    inputs, labels = _sample(cfg, 96, seed=6)
    v_inputs, v_labels = _sample(cfg, 64, seed=7)
    best, hist = jetid_loop.train_classifier(params, cfg, inputs, labels, v_inputs, v_labels,
                                             epochs=12, batch_size=32, lr=0.05, verbose=False)
    arg = int(np.argmin(hist["val_loss"]))
    assert arg < 11, hist["val_loss"]
    vm = jetid_loop.eval_epoch(best, cfg, *jetid_loop._unflatten(v_inputs, tuple(
        torch.from_numpy(a) for a in jetid_loop._packed_arrays(
            v_inputs, v_labels, np.ones(64, np.float32), 32)))).numpy()
    np.testing.assert_allclose(vm[:, 0].sum() / vm[:, 1].sum(), hist["val_loss"][arg], rtol=1e-6)


def test_state_file_resume_equals_an_uninterrupted_run(tmp_path):
    """With dropout on: the generator's state resumes too."""
    _, cfg = _pair("cnn", dropout=0.2)
    inputs, labels = _sample(cfg, 100, seed=8)
    v_inputs, v_labels = _sample(cfg, 40, seed=9)
    fresh = lambda: jetid.init_jetid(torch.Generator().manual_seed(3), cfg, device="cpu")
    run = lambda params, epochs, state: jetid_loop.train_classifier(
        params, cfg, inputs, labels, v_inputs, v_labels, epochs=epochs, batch_size=50, lr=1e-3,
        verbose=False, state_file=state, seed=11)
    whole, whole_hist = run(fresh(), 4, None)
    state = str(tmp_path / "state.npz")
    _, first_hist = run(fresh(), 2, state)
    resumed, second_hist = run(fresh(), 2, state)
    assert first_hist["loss"] + second_hist["loss"] == whole_hist["loss"]
    assert first_hist["val_loss"] + second_hist["val_loss"] == whole_hist["val_loss"]
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(resumed), tree_flatten(whole)))
    with pytest.raises(ValueError, match="monitoring 'val_loss'"):
        jetid_loop.train_classifier(fresh(), cfg, inputs, labels, v_inputs, v_labels, epochs=1,
                                    batch_size=50, verbose=False, state_file=state,
                                    monitor="accuracy")
    with pytest.raises(ValueError, match="pick one of"):
        run_bad = jetid_loop.train_classifier
        run_bad(fresh(), cfg, inputs, labels, v_inputs, v_labels, epochs=1, monitor="auc")


def test_a_recorded_early_stop_is_not_trained_past(tmp_path, capsys):
    _, cfg = _pair("fcn")
    inputs, labels = _sample(cfg, 64, seed=5)
    state = str(tmp_path / "state.npz")
    fresh = lambda: jetid.init_jetid(torch.Generator().manual_seed(3), cfg, device="cpu")
    kwargs = dict(epochs=6, batch_size=32, lr=0.0, patience=2, verbose=False, state_file=state)
    _, hist = jetid_loop.train_classifier(fresh(), cfg, inputs, labels, inputs, labels, **kwargs)
    assert len(hist["loss"]) == 3
    _, again = jetid_loop.train_classifier(fresh(), cfg, inputs, labels, inputs, labels, **kwargs)
    assert again["loss"] == [] and "already early-stopped" in capsys.readouterr().out


def test_nan_loss_stops_training(capsys):
    _, cfg = _pair("fcn")
    params = jetid.init_jetid(torch.Generator().manual_seed(0), cfg, device="cpu")
    inputs, labels = _sample(cfg, 64, seed=5)
    inputs["HLVs"][3, 2] = np.nan
    best, hist = jetid_loop.train_classifier(params, cfg, inputs, labels, inputs, labels,
                                             epochs=3, batch_size=32, verbose=False)
    assert hist["loss"] == [] and "NaN loss" in capsys.readouterr().out
    assert all(torch.isfinite(leaf).all() for leaf in tree_flatten(best))


def test_host_evaluation_functions_match_their_originals(rng, capsys):
    n = 400
    labels = rng.integers(0, 3, n)
    probs = rng.dirichlet([1, 1, 1], n)
    probs[:5] = [0.25, 0.5, 0.25]
    sample = {"JZW": np.where(labels == 0, -1.0, labels - 1.0),
              "weights": rng.uniform(0.5, 2, n), "m": rng.uniform(30, 300, n)}
    np.testing.assert_array_equal(jetid_eval.make_labels(sample), jax_eval.make_labels(sample))
    np.testing.assert_array_equal(jetid_eval.make_labels({"labels": labels}), labels)
    for ratio in (0, 1, 2.5):
        assert jetid_eval.get_class_weight(labels, ratio) == jax_eval.get_class_weight(labels, ratio)
    assert jetid_eval.get_class_weight(labels % 2, 0) is None
    assert jetid_eval.valid_accuracy(labels, probs) == jax_eval.valid_accuracy(labels, probs)
    for a, b in zip(jetid_eval.compo_matrix(labels, (), probs),
                    jax_eval.compo_matrix(labels, (), probs)):
        np.testing.assert_array_equal(a, b)
    for bkg in ("bkg", 1, 2):
        got = jetid_eval.discriminant(sample, labels, probs, (0,), bkg)
        want = jax_eval.discriminant(sample, labels, probs, (0,), bkg)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert all(np.array_equal(got[0][k], want[0][k]) for k in want[0])
    two = jetid_eval.discriminant(sample, labels % 2, probs[:, :2])
    np.testing.assert_array_equal(two[2], probs[:, 0])

    _, y, disc = jetid_eval.discriminant(sample, labels, probs)
    w = sample["weights"][:len(y)]
    capsys.readouterr()
    want = jax_background_rejection(y, disc, w)
    jax_lines = capsys.readouterr().out
    got = background_rejection(y, disc, w, device="cpu")
    assert capsys.readouterr().out == jax_lines
    assert set(got) == {90, 80, 70}
    for eff in want:
        np.testing.assert_allclose(got[eff], want[eff], rtol=1e-6)
