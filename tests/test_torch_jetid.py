"""atlasvae_torch.models.jetid against atlasvae.models.jetid.

The JAX package initialises the weights; ``interop.params_from_jax`` carries
them across leaf by leaf (both packages keep one tree and one layout:
channels-last images, (*kernel, c_in, c_out) conv weights, an (h, w, c)
flatten), and the same numpy inputs go through both ``jetid_apply``s.

Tolerances.  Probabilities: rtol 2e-5 / atol 2e-5, the bar of
tests/test_tf_parity.py for the whole model (measured: 3e-7 at most; the
convolutions are two libraries' and sum their taps in their own orders).
``l2_penalty``: rtol 1e-6.  Shapes, segment tables and the npz round trip:
exact.  Dropout draws from another generator than JAX's and is tested on the
port alone.
"""

import numpy as np
import pytest
import torch

import jax

from atlasvae.models import jetid as jax_jetid
from atlasvae.train import checkpoint as jax_checkpoint
from atlasvae_torch.interop import params_from_jax, params_to_numpy
from atlasvae_torch.models import jetid
from atlasvae_torch.train import checkpoint

TOL = 2e-5

CONFIGS = {
    # two same-shape images share one two-channel tower; a second shape gets its own
    "cnn2d": dict(n_classes=2, scalars=("HLVs",), scalar_dims=(6,),
                  images=("a", "b", "c"), image_shapes=((12, 9), (12, 9), (8, 8)),
                  nn_type="CNN", fcn_neurons=(20, 12), branch_neurons=(16,),
                  cnn_maps=(6, 5), dropout=0.0),
    # pools of 3 with a low-side pad; three classes
    "cnn2d_pool3": dict(n_classes=3, images=("a",), image_shapes=((13, 11),), nn_type="CNN",
                        fcn_neurons=(10,), cnn_maps=(4, 3), cnn_kernels=((3, 2), (2, 2)),
                        cnn_pools=((3, 3), (2, 2)), dropout=0.0),
    # kernels of length 3: the image stack is the depth axis of a 3-D tower
    "cnn3d": dict(n_classes=2, images=("a", "b", "c"),
                  image_shapes=((9, 9), (9, 9), (9, 9)), nn_type="CNN", fcn_neurons=(10,),
                  cnn_maps=(4, 3), cnn_kernels=((3, 3, 2), (2, 2, 1)),
                  cnn_pools=((2, 2, 1), (2, 2, 2)), dropout=0.0),
    # per-shape override beside the defaults
    "by_shape": dict(n_classes=2, images=("a", "b"), image_shapes=((10, 10), (7, 7)),
                     nn_type="CNN", fcn_neurons=(10,), cnn_maps=(4, 3),
                     cnn_by_shape=(((7, 7), (5,), ((2, 2),), ((4, 4),)),), dropout=0.0),
    "fcn": dict(n_classes=2, scalars=("HLVs",), scalar_dims=(6,), constituent_dim=15,
                nn_type="FCN", fcn_neurons=(20, 12), branch_neurons=(16,), dropout=0.0),
    # FCN mode flattens each image as it is
    "fcn_images": dict(n_classes=2, images=("a", "b"), image_shapes=((5, 4), (3, 3)),
                       constituent_dim=9, nn_type="FCN", fcn_neurons=(8,),
                       branch_neurons=(7,), dropout=0.0),
}


def _pair(name, **over):
    kwargs = dict(CONFIGS[name], **over)
    return jax_jetid.JetIDConfig(**kwargs), jetid.JetIDConfig(**kwargs)


def _inputs(rng, cfg, n=7, sparse=True):
    out = {}
    for name, shape in zip(cfg.images, cfg.image_shapes):
        x = np.abs(rng.normal(size=(n,) + tuple(shape))).astype(np.float32)
        if sparse:   # jet images: a few lit pixels
            x = x * (rng.random(x.shape) < 0.15)
        out[name] = x.astype(np.float32)
    for name, dim in zip(cfg.scalars, cfg.scalar_dims):
        out[name] = rng.normal(size=(n, dim)).astype(np.float32)
    if cfg.constituent_dim:
        out["constituents"] = rng.normal(size=(n, cfg.constituent_dim)).astype(np.float32)
    return out


def _carry(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _random_biases(rng, jparams):
    """Zero-initialised biases would hide a bias that is dropped or misplaced."""
    return jax.tree.map(lambda a: np.asarray(a) if a.ndim > 1 else
                        rng.normal(0, 0.1, a.shape).astype(np.float32), jparams)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jetid_apply_matches_jax(rng, name):
    jcfg, cfg = _pair(name)
    jparams = _random_biases(rng, jax_jetid.init_jetid(jax.random.PRNGKey(3), jcfg))
    params = _carry(jparams)
    inputs = _inputs(rng, cfg)
    want = np.asarray(jax_jetid.jetid_apply(jparams, jcfg, inputs))
    got = jetid.jetid_apply(params, cfg, {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.shape == want.shape == (7, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_shapes_segments_and_penalty_match_jax(rng, name):
    jcfg, cfg = _pair(name)
    jparams = jax_jetid.init_jetid(jax.random.PRNGKey(0), jcfg)
    params = jetid.init_jetid(torch.Generator().manual_seed(0), cfg, device="cpu")
    jleaves = jax.tree_util.tree_leaves(jparams)
    leaves = checkpoint.tree_flatten(params)
    assert [tuple(l.shape) for l in leaves] == [tuple(l.shape) for l in jleaves]
    assert jax.tree_util.tree_structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree_util.tree_structure(params_to_numpy(params))
    assert jetid.concat_segments(cfg) == jax_jetid.concat_segments(jcfg)
    assert sum(w for _, w in jetid.concat_segments(cfg)) == params["head"][0]["w"].shape[0]
    for shape, names in (jetid._shape_groups(cfg) if cfg.nn_type == "CNN" else ()):
        assert jetid.tower_flat_width(cfg, shape, len(names)) == \
            jax_jetid.tower_flat_width(jcfg, shape, len(names))
        assert jetid._shape_cnn(cfg, shape) == jax_jetid._shape_cnn(jcfg, shape)
    # glorot-uniform kernels inside their limit, zero biases
    for leaf in leaves:
        if leaf.dim() == 1:
            assert not leaf.any()
        else:
            fan = leaf[..., 0, 0].numel() * (leaf.shape[-2] + leaf.shape[-1])
            assert 0 < float(leaf.abs().max()) <= np.sqrt(6.0 / fan) * (1 + 1e-6)
    np.testing.assert_allclose(float(jetid.l2_penalty(_carry(jparams))),
                               float(jax_jetid.l2_penalty(jparams)), rtol=1e-6)


def test_l2_penalty_leaves_out_biases_and_the_output_layer(rng):
    _, cfg = _pair("cnn2d")
    params = jetid.init_jetid(torch.Generator().manual_seed(1), cfg, device="cpu")
    before = float(jetid.l2_penalty(params))
    params["out"]["w"] += 10.0
    for leaf in checkpoint.tree_flatten(params):
        if leaf.dim() == 1:
            leaf += 3.0
    assert float(jetid.l2_penalty(params)) == before
    params["towers"]["12x9"][1]["w"] += 1.0
    assert float(jetid.l2_penalty(params)) > before


def test_init_is_reproducible_from_the_generator_seed():
    _, cfg = _pair("cnn2d")
    a = jetid.init_jetid(torch.Generator().manual_seed(5), cfg, device="cpu")
    b = jetid.init_jetid(torch.Generator().manual_seed(5), cfg, device="cpu")
    c = jetid.init_jetid(torch.Generator().manual_seed(6), cfg, device="cpu")
    flat = checkpoint.tree_flatten
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not all(torch.equal(x, y) for x, y in zip(flat(a), flat(c)))


def test_a_kernel_that_does_not_fit_is_refused():
    with pytest.raises(ValueError, match="does not fit"):
        jetid.init_jetid(torch.Generator().manual_seed(0),
                         jetid.JetIDConfig(images=("a",), image_shapes=((4, 4),),
                                           nn_type="CNN"), device="cpu")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", ["cnn2d", "fcn"])
def test_model_npz_loads_in_the_other_package(rng, tmp_path, name, direction):
    jcfg, cfg = _pair(name)
    jparams = _random_biases(rng, jax_jetid.init_jetid(jax.random.PRNGKey(9), jcfg))
    template = jetid.init_jetid(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = str(tmp_path / "model.npz")
    inputs = _inputs(rng, cfg)
    want = np.asarray(jax_jetid.jetid_apply(jparams, jcfg, inputs))
    if direction == "jax_to_port":
        jax_checkpoint.save_pytree(path, jparams)
        params = checkpoint.load_pytree(path, template)
        got = jetid.jetid_apply(params, cfg, {k: torch.from_numpy(v)
                                              for k, v in inputs.items()}).numpy()
    else:
        checkpoint.save_pytree(path, _carry(jparams))
        loaded = jax_checkpoint.load_pytree(path, jax_jetid.init_jetid(jax.random.PRNGKey(0),
                                                                       jcfg))
        for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        got = np.asarray(jax_jetid.jetid_apply(loaded, jcfg, inputs))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_dropout_properties(rng):
    """Kept share and scaling, a mask of its own per layer, none at
    train=False, the same masks from the same seed."""
    gen = torch.Generator().manual_seed(0)
    x = torch.ones((200, 500))
    y = jetid._dropout(x, 0.25, gen, train=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.tensor(1 / 0.75))
    y2 = jetid._dropout(x, 0.25, gen, train=True)
    assert not torch.equal(y2 != 0, kept)                 # the next layer's mask differs
    assert jetid._dropout(x, 0.25, gen, train=False) is x
    assert jetid._dropout(x, 0.0, gen, train=True) is x

    _, cfg = _pair("cnn2d", dropout=0.3)
    params = jetid.init_jetid(torch.Generator().manual_seed(1), cfg, device="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(rng, cfg, n=16).items()}
    run = lambda seed, train=True: jetid.jetid_apply(
        params, cfg, inputs, generator=torch.Generator().manual_seed(seed), train=train)
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), jetid.jetid_apply(params, cfg, inputs))
    with pytest.raises(ValueError, match="Generator"):
        jetid.jetid_apply(params, cfg, inputs, train=True)


def test_bfloat16_compute_is_refused(rng):
    _, cfg = _pair("fcn", compute_dtype="bfloat16")
    params = jetid.init_jetid(torch.Generator().manual_seed(1), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        jetid.jetid_apply(params, cfg, {k: torch.from_numpy(v)
                                        for k, v in _inputs(rng, cfg).items()})


def test_first_block_takes_the_fused_function_only_where_supported(rng, monkeypatch):
    """2-D towers whose first block the gate admits go through
    fused_conv1_pool_relu (K5/K6 on the card); 3-D towers and blocks of more
    than 512 taps take the plain chain."""
    calls = []
    real = jetid.fused_conv1_pool_relu
    monkeypatch.setattr(jetid, "fused_conv1_pool_relu",
                        lambda *a, **k: calls.append(tuple(a[0].shape)) or real(*a, **k))
    for name, want in (("cnn2d", [(7, 12, 9, 2), (7, 8, 8, 1)]), ("cnn3d", []), ("fcn", [])):
        calls.clear()
        _, cfg = _pair(name)
        params = jetid.init_jetid(torch.Generator().manual_seed(1), cfg, device="cpu")
        jetid.jetid_apply(params, cfg, {k: torch.from_numpy(v)
                                        for k, v in _inputs(rng, cfg).items()})
        assert calls == want
    images = tuple(f"i{k}" for k in range(60))
    wide = jetid.JetIDConfig(images=images, image_shapes=((8, 8),) * 60, nn_type="CNN",
                             cnn_maps=(3,), cnn_kernels=((3, 3),), cnn_pools=((2, 2),),
                             fcn_neurons=(4,), dropout=0.0)
    calls.clear()
    params = jetid.init_jetid(torch.Generator().manual_seed(1), wide, device="cpu")
    out = jetid.jetid_apply(params, wide, {n: torch.zeros((2, 8, 8)) for n in images})
    assert calls == [] and out.shape == (2, 2)          # 3*3*60 = 540 taps > 512
