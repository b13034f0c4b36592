"""Port K1 (atlasvae_torch.ops.fused_mlp) against the JAX fused_mlp_apply.

On the CPU the port runs the kernel's plain version; the JAX side runs its
Pallas kernel in interpret mode.  Tolerance atol 1e-5, as
tests/test_models_losses.py holds the Pallas kernel to the unfused stack.
"""

import jax
import numpy as np
import pytest
import torch

from atlasvae.ops import fused_mlp_apply as jax_fused_mlp_apply
from atlasvae_torch.ops import fused_mlp, fused_vae
from test_torch_fused_vae import walk_plan

ATOL = 1e-5


def _layers(rng, dims):
    return [{"w": (rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32),
             "b": rng.normal(size=dims[i + 1]).astype(np.float32)}
            for i in range(len(dims) - 1)]


def _torch(layers):
    return [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]


@pytest.mark.parametrize("dims", [(10, 20, 40, 80, 12),   # canonical decoder
                                  (40, 32, 16, 8),        # narrow constituents-like
                                  (6, 3)])                # a single layer
@pytest.mark.parametrize("final", ["linear", "relu"])
def test_plain_matches_jax_pallas(rng, dims, final):
    layers = _layers(rng, dims)
    x = rng.normal(size=(300, dims[0])).astype(np.float32)
    want = np.asarray(jax_fused_mlp_apply(layers, x, final_activation=final))
    got = fused_mlp.fused_mlp_apply(_torch(layers), torch.from_numpy(x), final_activation=final)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cpu_tensor_takes_plain_path_without_launch(rng):
    layers = _torch(_layers(rng, (10, 20, 12)))
    x = torch.from_numpy(rng.normal(size=(17, 10)).astype(np.float32))
    before = fused_mlp.launches
    got = fused_mlp.fused_mlp_apply(layers, x)
    assert fused_mlp.launches == before
    assert torch.equal(got, fused_mlp.fused_mlp_plain(layers, x))


def test_unsupported_activation_raises(rng):
    layers = _torch(_layers(rng, (4, 3)))
    with pytest.raises(ValueError, match="relu hidden"):
        fused_mlp.fused_mlp_apply(layers, torch.zeros(2, 4), activation="tanh")
    with pytest.raises(ValueError, match="relu hidden"):
        fused_mlp.fused_mlp_plain(layers, torch.zeros(2, 4), final_activation="sigmoid")


@pytest.mark.parametrize("dims", [(32, 64, 128, 256, 300),     # constituents decoder
                                  (300, 256, 128, 64, 32),     # its encoder's mean as a stack
                                  (301, 130, 33, 5)])          # odd widths
@pytest.mark.parametrize("final", ["linear", "relu"])
def test_layered_plan_walk_matches_plain_and_jax(rng, dims, final):
    """K1's layer-wise route at constituents widths (37 rows): the plain walk
    of its plan (ReLU out of every segment that ends before the last layer)
    equals fused_mlp_plain and the JAX kernel (interpret mode), atol 1e-5."""
    layers = _layers(rng, dims)
    x = rng.normal(size=(37, dims[0])).astype(np.float32)
    plan = fused_vae.forward_plan(37, dims[:-1], dims[-1:])
    assert plan.route == "layers"
    pairs = [(l["w"], l["b"]) for l in _torch(layers)]
    got, = walk_plan(plan, torch.from_numpy(x), pairs, 1, final == "relu")
    want = np.asarray(jax_fused_mlp_apply(layers, x, final_activation=final))
    plain = fused_mlp.fused_mlp_apply(_torch(layers), torch.from_numpy(x), final_activation=final)
    assert got.shape == (37, dims[-1])
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_wide_stack_on_cpu_counts_no_launch(rng):
    layers = _torch(_layers(rng, (32, 256, 300)))
    x = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    before = (fused_mlp.launches, fused_mlp.layered_launches)
    got = fused_mlp.fused_mlp_apply(layers, x, final_activation="relu")
    assert (fused_mlp.launches, fused_mlp.layered_launches) == before
    assert torch.equal(got, fused_mlp.fused_mlp_plain(layers, x, final_activation="relu"))
