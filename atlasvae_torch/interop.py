"""Carry parameter trees between the JAX package and the port.

Both packages keep the same tree ({'encoder': {...}, 'decoder': {...}})
and the same (in, out) weight layout, so moving weights is a leaf-by-leaf
conversion.  Pass the JAX tree as numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.
"""

import numpy as np
import torch

from .train.checkpoint import tree_map


def params_from_jax(tree_of_numpy, device="cuda"):
    """A JAX parameter tree of numpy arrays -> the port's tree of float32
    tensors on ``device``."""
    return tree_map(lambda leaf: torch.from_numpy(np.array(leaf, np.float32))
                    .to(device).contiguous(), tree_of_numpy)


def params_to_numpy(params):
    """The port's tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda leaf: leaf.detach().cpu().numpy(), params)
