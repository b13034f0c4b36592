"""NaN and inf through the port as through the JAX package.

The same seeded numpy inputs, with NaN, +inf or -inf planted, go through the
JAX package and through the port on the CPU (the kernels' plain versions).
Each output and gradient must be NaN, +inf and -inf at the same elements
(the training step's guard zeroes every element that is not finite, so
these patterns decide which weights a step updates), and its finite values
must stay within the bar the finite-input tests hold it to:

* the max pool and the activations: exact (tests/test_torch_pooling.py);
* the loss bank: per-sample losses rtol 1e-5 with atol 1e-5 of the
  largest, gradients per leaf rtol 1e-5 with atol 1e-5 of the leaf's
  largest (tests/test_torch_losses.py);
* mlp_apply and the AAE: 1e-6 of the largest (tests/test_torch_aae.py);
  jet-ID gradients 2e-4 of the leaf's largest
  (tests/test_torch_jetid_train.py);
* K1-K3's plain versions: atol 1e-5, rtol 1e-5
  (tests/test_torch_fused_vae_bwd.py); K4's rtol 2e-5, atol 1e-6
  (tests/test_torch_emd.py); K5's 2e-6 and K6's 2e-4
  (tests/test_torch_fused_conv.py).

The reference is the JAX package's default path (XLA); K1-K3 and K5/K6 are
also held against its Pallas kernels in interpret mode, which agree with it
here (K3's ``g * (a > 0)`` gives what XLA's selecting ``jax.nn.relu``
gradient gives: 0, not NaN, for a non-finite g under an off ReLU).  XLA on
the CPU flushes denormals (ROADMAP, Known divergences), so no input here is
one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlasvae.losses import get_losses as jax_get_losses
from atlasvae.models import ae_apply as jax_ae_apply, discriminator_apply as jax_disc_apply
from atlasvae.models import jetid as jax_jetid
from atlasvae.models.mlp import mlp_apply as jax_mlp_apply
from atlasvae.ops import emd as jax_emd
from atlasvae.ops import fused_conv as jax_fused_conv
from atlasvae.ops import fused_mlp_apply as jax_fused_mlp_apply
from atlasvae.ops import fused_vae as jax_fused_vae
from atlasvae.ops.pooling import maxpool_same as jax_maxpool_same
from atlasvae.train import jetid_loop as jax_jetid_loop
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.losses import get_losses
from atlasvae_torch.models import ae_apply, discriminator_apply, jetid
from atlasvae_torch.models.mlp import mlp_apply
from atlasvae_torch.ops import emd, fused_conv, fused_mlp, fused_vae
from atlasvae_torch.ops.activations import leaky_relu0, relu
from atlasvae_torch.ops.pooling import maxpool_same
from atlasvae_torch.train import aae_loop, jetid_loop
from atlasvae_torch.train.checkpoint import tree_flatten
from nonfinite_stacks import NEAR_MAX, plant_inside, route_stack

NAN, INF = float("nan"), float("inf")
BAD = [NAN, INF, -INF]
BAD_IDS = ["nan", "inf", "-inf"]


def _np(a):
    if hasattr(a, "detach"):
        a = a.detach().numpy()
    return np.asarray(a, np.float64)


def same_nonfinite(got, want, what, rtol=0.0, atol=0.0):
    """NaN, +inf and -inf at the same elements; the finite values within
    atol + rtol |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    for name, test in (("NaN", np.isnan), ("+inf", np.isposinf), ("-inf", np.isneginf)):
        g, w = test(got), test(want)
        if not np.array_equal(g, w):
            at = tuple(int(i) for i in np.argwhere(g != w)[0])
            raise AssertionError(f"{what}: {name} at {int(g.sum())} elements, the reference's at "
                                 f"{int(w.sum())}; first apart at {at}: got {got[at]!r}, want "
                                 f"{want[at]!r}")
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=what)


def _dense(rng, k, n):
    return {"w": (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
            "b": (0.1 * rng.normal(size=n)).astype(np.float32)}


def _mlp(rng, dims):
    return [_dense(rng, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def _both(tree):
    """A numpy tree as the JAX package's arrays and as the port's tensors."""
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, device="cpu")


def _leaf_bar(want, rel):
    finite = np.abs(_np(want))[np.isfinite(_np(want))]
    return rel * (finite.max() if finite.size else 0.0)


# ------------------------------------------------------------ the max pool

POOL_CASES = {
    # (input shape (N, *spatial, M), pool, the window holding the plant)
    "2x2": ((2, 4, 6, 3), (2, 2), (1, 2)),
    "3x2": ((2, 8, 7, 2), (3, 2), (1, 1)),       # SAME pads a row and a column, high side
    "3d": ((1, 4, 5, 4, 2), (2, 2, 2), (1, 0, 1)),
}


@functools.partial(jax.jit, static_argnums=2)
def _jax_pool(z, g, pool):
    want, vjp = jax.vjp(lambda v: jax_maxpool_same(v, pool), z)
    return want, vjp(g)[0]


def _pool_pair(z, g, pool):
    tz = torch.tensor(z, requires_grad=True)
    out = maxpool_same(tz, pool)
    out.backward(torch.tensor(g))
    return (out, tz.grad) + _jax_pool(jnp.asarray(z), jnp.asarray(g), pool)


@pytest.mark.parametrize("bad", BAD, ids=BAD_IDS)
@pytest.mark.parametrize("case,position", [(c, p) for c, (_, pool, _) in POOL_CASES.items()
                                           for p in range(int(np.prod(pool)))])
def test_maxpool_same_carries_a_plant_at_every_window_position(rng, case, position, bad):
    """NaN, wherever it lies in its window, is the window's value and routes
    no gradient; +inf is the maximum wherever it lies; -inf loses.  The
    whole window ties at 0 (a jet image) beside the plant, so the tie rule
    (the first position) decides the rest."""
    shape, pool, window = POOL_CASES[case]
    z = rng.normal(size=shape).astype(np.float32)
    z[0, 1:] = 0.0   # image 0 ties everywhere but the plant
    offset = np.unravel_index(position, pool)
    at = (0,) + tuple(w * p + o for w, p, o in zip(window, pool, offset)) + (1,)
    z[at] = bad
    g = rng.normal(size=tuple(-(-s // p) for s, p in zip(shape[1:-1], pool))).astype(np.float32)
    g = np.broadcast_to(g[None, ..., None], (shape[0],) + g.shape + (shape[-1],)).copy()
    out, gz, want, want_gz = _pool_pair(z, g, pool)
    same_nonfinite(out, want, f"{case} pool values")
    same_nonfinite(gz, want_gz, f"{case} pool gradient")
    assert np.isnan(_np(out)[(0,) + tuple(window) + (1,)]) == (bad != bad)


def test_maxpool_same_routes_an_all_minus_inf_window_to_its_first_real_position(rng):
    """A window of -inf values beside SAME padding: the gradient goes to its
    first real position, as the JAX package's z == y does, not to a padding
    cell (which the forward pads with -inf too)."""
    z = rng.normal(size=(1, 7, 4, 2)).astype(np.float32)   # pool 3: pads one row each side
    z[0, :2, :2, 0] = -INF                                  # window (0, 0), its real rows
    g = rng.normal(size=(1, 3, 2, 2)).astype(np.float32)
    out, gz, want, want_gz = _pool_pair(z, g, (3, 2))
    same_nonfinite(out, want, "values")
    same_nonfinite(gz, want_gz, "gradient")
    assert float(gz[0, 0, 0, 0]) == float(g[0, 0, 0, 0])


# ------------------------------------------------------------ activations

ACT_X = np.array([NAN, -1.0, 0.0, -0.0, 2.0, INF, -INF, 1e-30], np.float32)


@pytest.mark.parametrize("g_kind", ["one", "inf", "nan"])
@pytest.mark.parametrize("name", ["relu", "leaky_relu"])
def test_activation_gradient_at_nan_and_zero(name, g_kind):
    """relu: g where x > 0, 0 at NaN and at 0 (torch.relu passes g at NaN);
    leaky_relu with slope 0: g where x >= 0 (1 at 0), 0 x g elsewhere."""
    mine, ref = {"relu": (relu, jax.nn.relu),
                 "leaky_relu": (leaky_relu0, lambda v: jax.nn.leaky_relu(v, 0.0))}[name]
    g = np.full_like(ACT_X, {"one": 1.0, "inf": INF, "nan": NAN}[g_kind])
    x = torch.tensor(ACT_X, requires_grad=True)
    y = mine(x)
    y.backward(torch.tensor(g))
    want, vjp = jax.vjp(ref, jnp.asarray(ACT_X))
    np.testing.assert_array_equal(_np(y), _np(want))
    np.testing.assert_array_equal(_np(x.grad), _np(vjp(jnp.asarray(g))[0]))
    bits = lambda v: v.detach().view(torch.int32)
    old = torch.relu(torch.tensor(ACT_X))   # torch.relu's bits wherever the input is finite
    finite = torch.isfinite(torch.tensor(ACT_X))
    assert torch.equal(bits(y)[finite], bits(old)[finite])


# ------------------------------------------------------------ the loss bank

LOSS_N = 16


@pytest.fixture(scope="module")
def vae():
    """The canonical 12 -> 80/40/20 -> 10 VAE, random weights."""
    rng = np.random.default_rng(4)
    return _both({"encoder": {"hidden": _mlp(rng, (12, 80, 40, 20)), "mean": _dense(rng, 20, 10),
                              "logvar": _dense(rng, 20, 10)},
                  "decoder": {"hidden": _mlp(rng, (10, 20, 40, 80)), "out": _dense(rng, 80, 12)}})


@functools.partial(jax.jit, static_argnums=0)
def _jax_losses_and_gradient(oe_type, params, x, ood, w, w_ood, noise):
    def total(p):
        losses = jax_get_losses(p, x, ood, w, w_ood, jax.random.PRNGKey(0), oe_type, noise=noise,
                                beta=2.0, lamb=5.0, margin=1.0)
        return losses[3].sum(), losses
    (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
    return losses, grads


@pytest.mark.parametrize("bad", [NAN, INF], ids=["nan", "inf"])
@pytest.mark.parametrize("oe_type", ["KLD", "MSE-margin"])
def test_loss_bank_gradient_with_a_non_finite_ood_row(rng, vae, oe_type, bad):
    jparams, params = vae
    x = rng.normal(size=(LOSS_N, 12)).astype(np.float32)
    ood = (rng.normal(size=(LOSS_N, 12)) + 0.7).astype(np.float32)
    ood[5, 3] = bad
    w = rng.uniform(0.5, 1.5, LOSS_N).astype(np.float32)
    w_ood = rng.uniform(0.5, 1.5, LOSS_N).astype(np.float32)
    noise = tuple(rng.standard_normal((LOSS_N, 10)).astype(np.float32) for _ in range(2))
    hyper = dict(beta=2.0, lamb=5.0, margin=1.0)

    want, want_grads = _jax_losses_and_gradient(
        oe_type, jparams, *(jnp.asarray(a) for a in (x, ood, w, w_ood)),
        tuple(jnp.asarray(n) for n in noise))
    want_grads = jax.tree_util.tree_leaves(want_grads)
    leaves = [leaf.requires_grad_() for leaf in tree_flatten(params)]
    t = torch.from_numpy
    got = get_losses(params, t(x), t(ood), t(w), t(w_ood), None, oe_type,
                     noise=tuple(t(n) for n in noise), **hyper)
    for name, a, b in zip(("MSE", "KLD", "OE", "total"), got, want):
        same_nonfinite(a, b, f"{oe_type} {name} losses", rtol=1e-5, atol=_leaf_bar(b, 1e-5))
    grads = torch.autograd.grad(got[3].sum(), leaves)
    assert any(np.isnan(_np(g)).any() for g in want_grads)
    for i, (g, ref) in enumerate(zip(grads, want_grads)):
        same_nonfinite(g, ref, f"{oe_type} gradient leaf {i}", rtol=1e-5,
                       atol=_leaf_bar(ref, 1e-5))


# ------------------------------------------------------- mlp, AAE, jet-ID

@pytest.mark.parametrize("activation", ["relu", "leaky_relu"])
def test_mlp_apply_with_a_nan_row(rng, activation):
    dims = (6, 9, 7, 4)
    layers = [{"w": (rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32),
               "b": rng.normal(size=dims[i + 1]).astype(np.float32)} for i in range(3)]
    x = rng.normal(size=(10, 6)).astype(np.float32)
    x[3, 2] = NAN
    x[7, 0] = -INF
    g = rng.normal(size=(10, 4)).astype(np.float32)

    def jax_f(ls):
        return jax_mlp_apply(ls, jnp.asarray(x), activation)

    want, vjp = jax.jit(lambda ls: jax.vjp(jax_f, ls))(jax.tree.map(jnp.asarray, layers))
    want_grads = jax.tree_util.tree_leaves(vjp(jnp.asarray(g))[0])
    tl = [{k: torch.tensor(v, requires_grad=True) for k, v in l.items()} for l in layers]
    out = mlp_apply(tl, torch.from_numpy(x), activation)
    grads = torch.autograd.grad(out, [l[k] for l in tl for k in sorted(l)], torch.from_numpy(g))
    same_nonfinite(out, want, "mlp_apply", rtol=1e-6, atol=_leaf_bar(want, 1e-6))
    for i, (a, b) in enumerate(zip(grads, want_grads)):
        same_nonfinite(a, b, f"mlp_apply gradient {i}", rtol=1e-5, atol=_leaf_bar(b, 1e-5))


def test_aae_step_gradients_with_a_nan_row(rng):
    """The AE phase's loss (QCD MAE + lamb x the OE sigmoid) and the
    discriminator's CE with one background row NaN: the gradients of both."""
    jparams, params = _both({
        "encoder": {"hidden": _mlp(rng, (12, 32)), "out": _dense(rng, 32, 16)},
        "decoder": {"hidden": _mlp(rng, (16, 32)), "out": _dense(rng, 32, 12)},
        "discriminator": {"hidden": _mlp(rng, (12, 20)), "out": _dense(rng, 20, 3)}})
    bkg = rng.normal(size=(12, 12)).astype(np.float32)
    bkg[4, 1] = NAN
    ood = (rng.normal(size=(12, 12)) + 2).astype(np.float32)
    w, w_ood = (rng.uniform(0.5, 1.5, 12).astype(np.float32) for _ in range(2))

    def jax_ae_loss(p):
        mae_b = jnp.mean(jnp.abs(bkg - jax_ae_apply(p, bkg)), axis=-1)
        mae_o = jnp.mean(jnp.abs(ood - jax_ae_apply(p, ood)), axis=-1)
        return jnp.sum(mae_b * w) / jnp.sum(w) + \
            2.0 * jnp.sum(jax.nn.sigmoid(mae_b - mae_o) * w_ood) / jnp.sum(w_ood)

    def jax_disc_loss(p):
        x = jnp.concatenate([bkg, jax_ae_apply(p, bkg), ood])
        labels = jnp.concatenate([jnp.zeros(12, int), jnp.ones(12, int), jnp.full(12, 2)])
        weights = jnp.concatenate([w, w, w_ood])
        probs = jax_disc_apply(p, x)
        ce = -jnp.log(jnp.maximum(jnp.sum(probs * jax.nn.one_hot(labels, 3), axis=1), 1e-7))
        return jnp.sum(ce * weights) / jnp.sum(weights)

    t = torch.from_numpy
    for what, jax_loss, port_loss in (
            ("AE", jax_ae_loss, lambda: sum(v * c for v, c in zip(
                aae_loop._ae_losses(params, t(bkg), t(ood), t(w), t(w_ood), "relu")[:2],
                (1.0, 2.0)))),
            ("discriminator", jax_disc_loss, lambda: aae_loop.disc_batch_loss(
                params, t(bkg), t(ood), t(w), t(w_ood))[0])):
        want = jax.tree_util.tree_leaves(jax.jit(jax.grad(jax_loss))(jparams))
        leaves = [leaf.requires_grad_() for leaf in tree_flatten(params)]
        grads = torch.autograd.grad(port_loss(), leaves, allow_unused=True)
        for i, (g, ref) in enumerate(zip(grads, want)):
            g = torch.zeros_like(leaves[i]) if g is None else g
            same_nonfinite(g, ref, f"{what} gradient leaf {i}", rtol=1e-5,
                           atol=_leaf_bar(ref, 1e-5))
    recon = ae_apply(params, t(bkg))
    same_nonfinite(recon, jax_ae_apply(jparams, bkg), "reconstruction", rtol=1e-6,
                   atol=_leaf_bar(recon, 1e-6))
    same_nonfinite(discriminator_apply(params, t(bkg)), jax_disc_apply(jparams, bkg),
                   "probabilities", rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("plant", ["image", "hlv"])
def test_jetid_step_gradients_with_a_nan_jet(rng, plant):
    """The jet-ID CNN's first step: its first block is K5/K6's plain version
    (conv + maxpool_same + relu), the second the plain pool; one jet has a
    NaN pixel or a NaN HLV."""
    kwargs = dict(n_classes=2, scalars=("HLVs",), scalar_dims=(5,), images=("images",),
                  image_shapes=((10, 10),), nn_type="CNN", fcn_neurons=(12, 8),
                  branch_neurons=(8,), cnn_maps=(5, 4), dropout=0.0, l2=1e-4)
    jcfg, cfg = jax_jetid.JetIDConfig(**kwargs), jetid.JetIDConfig(**kwargs)
    shapes = jax.eval_shape(lambda key: jax_jetid.init_jetid(key, jcfg), jax.random.PRNGKey(0))
    jparams, params = _both(jax.tree.map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]) or 1))
        .astype(np.float32), shapes))
    n = 12
    labels = rng.integers(0, 2, n)
    images = (np.abs(rng.normal(size=(n, 10, 10))) * (rng.random((n, 10, 10)) < 0.3))
    inputs = {"HLVs": rng.normal(size=(n, 5)).astype(np.float32),
              "images": images.astype(np.float32)}
    if plant == "image":
        inputs["images"][3, 4, 5] = NAN
    else:
        inputs["HLVs"][3, 2] = NAN
    weights = rng.uniform(0.5, 1.5, n).astype(np.float32)

    def jax_loss(p):
        probs = jax_jetid.jetid_apply(p, jcfg, inputs, train=True)
        return jax_jetid_loop._ce_loss(probs, jnp.asarray(labels), jnp.asarray(weights)) \
            + jcfg.l2 * jax_jetid.l2_penalty(p)

    want = jax.tree_util.tree_leaves(jax.jit(jax.grad(jax_loss))(jparams))
    leaves = [leaf.requires_grad_() for leaf in tree_flatten(params)]
    loss, _ = jetid_loop.batch_loss(params, cfg, {k: torch.from_numpy(v) for k, v in inputs.items()},
                                    torch.from_numpy(labels), torch.from_numpy(weights), None)
    grads = torch.autograd.grad(loss, leaves)
    assert any(np.isnan(_np(g)).any() for g in want)
    for i, (g, ref) in enumerate(zip(grads, want)):
        same_nonfinite(g, ref, f"jet-ID gradient leaf {i}", rtol=2e-4, atol=_leaf_bar(ref, 2e-4))


# ------------------------------------------------- K1-K6's plain versions

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _stack(rng, dims, head_dims):
    def pair(k, m):
        return ((rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32),
                rng.normal(size=(m,)).astype(np.float32))
    return [pair(dims[i], dims[i + 1]) for i in range(len(dims) - 1)], \
        [pair(dims[-1], m) for m in head_dims]


def _plant_rows(x, bad):
    """Row 2 all bad at one element, row 5 at two; the rest finite."""
    x[2, 1] = bad
    x[5, 0] = x[5, -1] = bad
    return x


@pytest.mark.parametrize("bad", BAD, ids=BAD_IDS)
@pytest.mark.parametrize("final", ["linear", "relu"])
def test_k1_plain_carries_a_plant_as_the_pallas_kernel(rng, bad, final):
    dims = (10, 20, 40, 12)
    hidden, _ = _stack(rng, dims, ())
    layers = [{"w": w, "b": b} for w, b in hidden]
    x = _plant_rows(rng.normal(size=(24, 10)).astype(np.float32), bad)
    want = jax_fused_mlp_apply(layers, x, final_activation=final)
    got = fused_mlp.fused_mlp_apply([{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
                                    torch.from_numpy(x), final_activation=final)
    same_nonfinite(got, want, "K1", **KERNEL_TOL)


def _jax_pairs(pairs):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs]


def _torch_pairs(pairs):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in pairs]


def _xla_stack(x, hidden, heads):
    """The JAX package's default path: jax.nn.relu hidden layers, linear heads."""
    h = x
    for w, b in hidden:
        h = jax.nn.relu(h @ w + b)
    return tuple(h @ w + b for w, b in heads)


@pytest.mark.parametrize("bad", BAD, ids=BAD_IDS)
def test_k2_plain_carries_a_plant_as_the_pallas_kernel(rng, bad):
    hidden, heads = _stack(rng, (12, 20, 9), (5, 5))
    x = _plant_rows(rng.normal(size=(24, 12)).astype(np.float32), bad)
    want = jax_fused_vae._stack_fwd(jnp.asarray(x), _jax_pairs(hidden), _jax_pairs(heads))
    got = fused_vae.stack_forward(torch.from_numpy(x), _torch_pairs(hidden), _torch_pairs(heads))
    for k, (a, b) in enumerate(zip(got, want)):
        same_nonfinite(a, b, f"K2 head {k}", **KERNEL_TOL)
        same_nonfinite(a, _xla_stack(x, _jax_pairs(hidden), _jax_pairs(heads))[k], "K2 XLA",
                       **KERNEL_TOL)


# Values made inside the stack (tests/nonfinite_stacks.py): NaN, +inf and -inf
# from finite sums (or a NaN) in the first layers, and NEAR_MAX carried as a
# finite value, which every later product takes as a ReLU output; at the
# layer-wise route's widths, the reference side of the card's within-stack
# cases (tests/test_torch_cuda_kernels.py).

INSIDE_ROWS = (2, 9, 17, 30, 38, 39)


def _inside_case(rng, dims, head_dims, plant):
    hidden, heads = _stack(rng, dims, head_dims)
    route_stack(hidden, heads)
    x = rng.normal(size=(40, dims[0])).astype(np.float32)
    return hidden, heads, x, plant_inside(x, (plant,), INSIDE_ROWS)


def _near_max_came_through(want, near, what):
    w = _np(want)[list(near)]
    assert np.isfinite(w).all() and np.abs(w).max() == NEAR_MAX, what


@pytest.mark.parametrize("bad", BAD_IDS)
def test_k1_plain_carries_values_made_inside_the_stack_as_the_pallas_kernel(rng, bad):
    hidden, heads, x, near = _inside_case(rng, (32, 64, 128, 256), (300,), bad)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    want = jax_fused_mlp_apply(layers, x)
    _near_max_came_through(want, near, "K1")
    got = fused_mlp.fused_mlp_apply([{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
                                    torch.from_numpy(x))
    same_nonfinite(got, want, "K1", **KERNEL_TOL)
    same_nonfinite(got, _xla_stack(x, _jax_pairs(hidden), _jax_pairs(heads))[0], "K1 XLA",
                   **KERNEL_TOL)


@pytest.mark.parametrize("bad", BAD_IDS)
def test_k2_plain_carries_values_made_inside_the_stack_as_the_pallas_kernel(rng, bad):
    """Against XLA on every row; against the Pallas kernel on every row but
    those whose last hidden layer holds +inf: the kernel pads that 64-wide
    layer to 128 lanes with zero weights, and inf * 0 there makes its heads
    NaN where XLA's (and the port's) are +-inf (ROADMAP, Known divergences)."""
    hidden, heads, x, near = _inside_case(rng, (300, 256, 128, 64), (32, 32), bad)
    want = jax_fused_vae._stack_fwd(jnp.asarray(x), _jax_pairs(hidden), _jax_pairs(heads))
    xla = _xla_stack(x, _jax_pairs(hidden), _jax_pairs(heads))
    got = fused_vae.stack_forward(torch.from_numpy(x), _torch_pairs(hidden), _torch_pairs(heads))
    padded = [r for r in INSIDE_ROWS if r not in near] if bad == "inf" else []
    keep = [r for r in range(x.shape[0]) if r not in padded]
    for k, (a, b) in enumerate(zip(got, want)):
        _near_max_came_through(xla[k], near, f"K2 XLA head {k}")
        same_nonfinite(a, xla[k], f"K2 XLA head {k}", **KERNEL_TOL)
        same_nonfinite(a[keep], _np(b)[keep], f"K2 head {k}", **KERNEL_TOL)


@jax.jit
def _xla_stack_vjp(x, params, gs):
    return jax.vjp(lambda a, p: _xla_stack(a, p[:3], p[3:]), x, params)[1](gs)


@pytest.mark.parametrize("where", ["x", "g"])
@pytest.mark.parametrize("bad", BAD, ids=BAD_IDS)
def test_k3_plain_carries_a_plant_as_the_default_path(rng, bad, where):
    """Against the vjp of the default (XLA) stack and against the Pallas
    kernel.  A plant in a head gradient makes a row of g not finite; under
    a ReLU that is off it gives 0, not inf x 0 (the port's mask selects)."""
    dims, head_dims = (12, 20, 16, 9), (5, 5)
    hidden, heads = _stack(rng, dims, head_dims)
    x = rng.normal(size=(24, 12)).astype(np.float32)
    grads = [(rng.normal(size=(24, m)) / 24).astype(np.float32) for m in head_dims]
    if where == "x":
        _plant_rows(x, bad)
    else:
        grads[1][6, 2] = bad
    dws, dbs, dx = fused_vae.stack_backward(torch.from_numpy(x), _torch_pairs(hidden),
                                            _torch_pairs(heads),
                                            [torch.from_numpy(g) for g in grads], True)

    want_dx, want_params = _xla_stack_vjp(jnp.asarray(x), _jax_pairs(hidden) + _jax_pairs(heads),
                                   tuple(jnp.asarray(g) for g in grads))
    want_dws = [w for w, _ in want_params]
    want_dbs = [b for _, b in want_params]
    for i, (a, b) in enumerate(zip(dws + dbs + [dx], want_dws + want_dbs + [want_dx])):
        same_nonfinite(a, b, f"K3 leaf {i}", **KERNEL_TOL)
    p_dw, p_db, p_dx = jax_fused_vae._stack_bwd(jnp.asarray(x), _jax_pairs(hidden),
                                                _jax_pairs(heads), [jnp.asarray(g) for g in grads],
                                                True)
    for i, (a, b) in enumerate(zip(dws + dbs + [dx], list(p_dw) + list(p_db) + [p_dx])):
        same_nonfinite(a, b, f"K3 leaf {i} against the Pallas kernel", **KERNEL_TOL)
    if where == "g":   # the row's ReLUs that are off gave 0: the biases' gradients stay finite
        assert all(np.isfinite(_np(b)).any() for b in dbs[:3])


@pytest.mark.parametrize("column,bad", [(0, NAN), (2, NAN), (0, INF), (1, -INF)],
                         ids=["pt_nan", "phi_nan", "pt_inf", "y_-inf"])
def test_k4_plain_carries_a_plant_as_the_xla_program(rng, column, bad):
    """An infinite y makes a row of infinite costs; the rounded plan's
    rank-one term meets them with deficits whose signs are float rounding
    (+inf where all are positive, NaN where one is 0 or negative), so there
    only the jet's EMD being not finite is held, on both sides."""
    jp = np.zeros((4, 10, 3), np.float32)
    jq = np.zeros((4, 10, 3), np.float32)
    for arr in (jp, jq):
        arr[..., 0] = rng.uniform(0.1, 2.0, (4, 10))
        arr[..., 1:] = rng.normal(0, 0.5, (4, 10, 2))
    jp[:, 7:] = 0.0
    jp[1, 3, column] = bad
    got = emd._sinkhorn_emd(torch.from_numpy(jp), torch.from_numpy(jq), 1.0, 20, 0.01)
    want = jax_emd._emd_batch_xla(jnp.asarray(jp), jnp.asarray(jq), 1.0, 20, 0.01)
    if column == 1:
        want = np.where(np.isfinite(_np(want)), _np(want), NAN)
        got = np.where(np.isfinite(_np(got)), _np(got), NAN)
    same_nonfinite(got, want, "K4", rtol=2e-5, atol=1e-6)
    assert not np.isfinite(_np(got)[1])


def _xla_conv_chain(x, w, b, pool):
    z = jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    win = (1,) + tuple(pool) + (1,)
    return jax.nn.relu(-jax.lax.reduce_window(-z, jnp.inf, jax.lax.min, win, win, "SAME"))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_conv_vjp(fn, pool, x, w, b, g):
    want, vjp = jax.vjp(lambda w_, b_: fn(x, w_, b_, pool), w, b)
    return (want,) + vjp(g)


@pytest.mark.parametrize("where", ["x", "g"])
@pytest.mark.parametrize("bad", BAD, ids=BAD_IDS)
@pytest.mark.parametrize("shape", [(3, 7, 7, 1, 3, 3, 6, (2, 2)),
                                   (2, 7, 6, 2, 3, 2, 5, (3, 3))], ids=["tiles", "bands"])
def test_k5_k6_plain_carry_a_plant_as_the_pallas_kernel_and_the_chain(rng, shape, bad, where):
    n, h, wd, c, kh, kw, m, pool = shape
    x = np.abs(rng.normal(size=(n, h, wd, c))) * (rng.random((n, h, wd, c)) < 0.4)
    x = x.astype(np.float32)
    w = (rng.normal(size=(kh, kw, c, m)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(m,)) * 0.1).astype(np.float32)
    out_shape = (n, -(-(h - kh + 1) // pool[0]), -(-(wd - kw + 1) // pool[1]), m)
    g = rng.normal(size=out_shape).astype(np.float32)
    if where == "x":
        x[1, 3, 2, 0] = bad
    else:
        g[1, 1, 0, :] = bad
    tw, tb = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    out = fused_conv.fused_conv1_pool_relu(torch.tensor(x), tw, tb, pool)
    out.backward(torch.tensor(g))
    for name, fn in (("Pallas", jax_fused_conv.fused_conv1_pool_relu), ("XLA", _xla_conv_chain)):
        want, gw, gb = _jax_conv_vjp(fn, pool, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     jnp.asarray(g))
        same_nonfinite(out, want, f"K5 against {name}", rtol=2e-6, atol=2e-6)
        same_nonfinite(tw.grad, gw, f"K6 dW against {name}", rtol=2e-4, atol=_leaf_bar(gw, 2e-4))
        same_nonfinite(tb.grad, gb, f"K6 db against {name}", rtol=2e-4, atol=_leaf_bar(gb, 2e-4))
