"""Carry parameter trees between the JAX package and the port.

Both packages keep the same trees and layouts, so moving weights is a
leaf-by-leaf conversion: the VAE's {'encoder': {...}, 'decoder': {...}} with
(in, out) dense weights, and the jet-ID classifier's {'towers': {shape:
[conv, ...]}, 'constituents': [...], 'scalars': [...], 'head': [...],
'out': {...}} with channels-last (*kernel, c_in, c_out) conv weights and a
trunk whose rows follow the towers' (h, w, c) flatten.  Pass the JAX tree as numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.  The
optimizer state of a JAX run carries across too (``adam_state_from_jax``).
The EMD and KSD metrics have no weights, so constituents-mode scoring needs
nothing more than the (wider) VAE tree.
"""

import numpy as np
import torch

from .train.checkpoint import tree_map
from .train.step import Adam


def params_from_jax(tree_of_numpy, device="cuda"):
    """A JAX parameter tree of numpy arrays -> the port's tree of float32
    tensors on ``device``."""
    return tree_map(lambda leaf: torch.from_numpy(np.array(leaf, np.float32))
                    .to(device).contiguous(), tree_of_numpy)


def params_to_numpy(params):
    """The port's tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda leaf: leaf.detach().cpu().numpy(), params)


def adam_state_from_jax(opt_state_numpy, device="cuda"):
    """optax's ``(ScaleByAdamState(count, mu, nu), EmptyState())`` of
    ``optax.adam(1.0)``, as numpy (``jax.tree.map(np.asarray, opt_state)``)
    -> the port's ``Adam`` over the parameters' flat layout."""
    adam = opt_state_numpy[0]
    return Adam.from_trees(int(adam.count), adam.mu, adam.nu, device)
