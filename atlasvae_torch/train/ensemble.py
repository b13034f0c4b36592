"""Ensemble / hyper-parameter-sweep training: G VAE configurations, one lane
each, over one shared copy of the data.

Counterpart of ``atlasvae/train/ensemble.py``.  The reference runs its grid
as Slurm array jobs, one process per configuration (ref
OE-VAE/utils.py:597-600 ``grid_search``).  The JAX package trains the G
same-shape configurations as one ``jax.vmap``-ed program; here each
configuration is a lane, and every batch of a load is stepped lane after
lane, each lane through the port's own step (``make_vae_step_fns`` with its
beta, lamb and margin: K2/K3 on the card, K1 in its validation).  What the
ensemble promises is kept:

* G lanes that reproduce G sequential ``train_model`` runs: the same data,
  each lane's noise from its own ``torch.Generator`` seeded with its seed,
  the same loss math, each lane's own ``Adam`` (its own step count), its own
  lr and plateau controller (``model_checkpoint`` on its 'Train loss');
  on the CPU a lane equals its sequential run bit for bit;
* data preparation, host packing and the host-to-device copy paid once: all
  lanes read the device batches of one ``LoadCache``.

``torch.func.vmap`` cannot batch the lanes: the fused autograd Functions
(``ops/fused_vae.py``, ``ops/fused_conv.py``) define the old-style
``forward(ctx, ...)``, which functorch transforms refuse.  The lanes run
through ``train/loop.py::train_lanes``, the epoch loop ``train_model`` runs
on one lane.  A lane the plateau schedule has stopped takes no further step
and no validation: its parameters, history and checkpoints stay as they
were, which is what the JAX package's freeze at lr=0 gives (there its Adam
moments still move; they are read by nothing but the state file).

``mesh`` (``parallel.config_mesh``) shards the configuration axis: each rank
trains its G/n lanes with no collective, writes their histories and
checkpoints, and the results are gathered in configuration order on every
rank; rank 0 writes the state file, which holds every lane.
"""

import os

import numpy as np
import torch

from ..parallel.mesh import axis_rank, axis_size, gather, is_writer
from .checkpoint import load_history, load_pytree, save_pytree, tree_flatten, tree_map, \
    tree_unflatten
from .loop import Lane, train_lanes


def stack_trees(trees):
    """Stack identically shaped trees of tensors along a new axis 0."""
    leaves = [tree_flatten(t) for t in trees]
    return tree_unflatten(trees[0], [torch.stack([torch.as_tensor(x).detach() for x in xs])
                                     for xs in zip(*leaves)])


def tree_slice(tree, g):
    """A copy of lane ``g``'s slice of a stacked tree."""
    return tree_map(lambda leaf: leaf[g].detach().clone(), tree)


def train_ensemble(params_stack, hyper, train_sample, valid_sample, oe_type="KLD", n_epochs=1,
                   batch_size=5000, lr=1e-3, hist_files=None, model_outs=None, seeds=None,
                   activation="relu", valid_batch_size=int(1e6), mesh=None,
                   config_axis="config", state_file=None, noise_sources=None):
    """Train G VAE configurations as G lanes on the device of ``params_stack``.

    ``params_stack``: tree with a leading lane axis G (``stack_trees`` of G
    ``init_vae`` results).  ``hyper``: (beta, lamb, margin), each of shape
    (G,).  ``lr``: a scalar or G initial learning rates.  ``seeds``: G noise
    seeds (default ``range(G)``).  ``state_file``: every lane's parameters,
    Adam state, lr, plateau count (-1 once stopped) and generator state,
    written every epoch and resumed bit for bit.  ``noise_sources``:
    optional G ``train_model``-style noise injectors, one a lane.

    Returns (params_stack, histories): histories is a list of G dicts with
    ``train_model``'s keys and semantics.  ``mesh``: a ``config_axis`` mesh
    whose ranks share the G lanes (G a multiple of its size), every rank
    calling with the same arguments.
    """
    beta, lamb, margin = (np.asarray(h, np.float32) for h in hyper)
    n_cfg = len(beta)
    mine = range(n_cfg)
    if mesh is not None:
        n_shard = axis_size(mesh, config_axis)
        if n_cfg % n_shard:
            raise ValueError(f"n_configs={n_cfg} must be a multiple of the '{config_axis}' "
                             f"mesh axis size {n_shard}")
        share = n_cfg // n_shard
        mine = range(axis_rank(mesh, config_axis) * share,
                     (axis_rank(mesh, config_axis) + 1) * share)
    lrs = np.broadcast_to(np.asarray(lr, np.float64), (n_cfg,))
    seeds = list(range(n_cfg)) if seeds is None else [int(s) for s in seeds]
    noise_sources = noise_sources or [None] * n_cfg
    lanes = [Lane(tree_slice(params_stack, g), oe_type, float(beta[g]), float(lamb[g]),
                  float(margin[g]), activation, float(lrs[g]), seeds[g],
                  hist_files[g] if hist_files else None, model_outs[g] if model_outs else None,
                  noise_sources[g], tag=f"cfg{g}: ") for g in mine]

    def lane_states():
        return [tree_map(lambda t: t.detach().cpu(), lane.state_tree()) for lane in lanes]

    def state_trees():
        states = lane_states() if mesh is None else gather(mesh, lane_states(), config_axis)
        return {"lanes": states}

    def save_state():
        trees = state_trees()
        if is_writer(mesh):
            save_pytree(state_file, trees)

    def all_stopped():
        """Every lane stopped, on every rank: the ranks run as many epochs
        (and collectives) as the longest lane needs."""
        here = all(lane.stopped for lane in lanes)
        return here if mesh is None else all(gather(mesh, [here], config_axis))

    if state_file and os.path.isfile(state_file):
        template = {"lanes": [lanes[0].state_tree()] * n_cfg}
        saved_lanes = load_pytree(state_file, template)["lanes"]
        for lane, saved in zip(lanes, [saved_lanes[g] for g in mine]):
            lane.load_state(saved)
            if lane.hist_file and os.path.isfile(lane.hist_file):
                lane.history = load_history(lane.hist_file)
        stopped = sum(lane.stopped for lane in lanes)
        print(f"Resuming ensemble train state from {state_file} "
              f"({stopped}/{n_cfg} configs already stopped)")
    print(f"STARTING ENSEMBLE TRAINING ({n_cfg} configs, loads/epoch: {len(train_sample)})")
    if not all_stopped():
        train_lanes(lanes, train_sample, valid_sample, n_epochs, batch_size, valid_batch_size,
                    save_state if state_file else None, all_stopped)
    params_stack = stack_trees([lane.state.detached() for lane in lanes])
    histories = [lane.history for lane in lanes]
    if mesh is None:
        return params_stack, histories
    return tree_map(lambda leaf: gather(mesh, leaf, config_axis), params_stack), \
        gather(mesh, histories, config_axis)
