"""Hyper-parameter sweep runner on PyTorch/CUDA.

Counterpart of ``atlasvae/cli/sweep.py``, which replaces the reference's
Slurm-array grid mapping (ref OE-VAE/utils.py:597-600 ``grid_search``): the
grid is the same ``itertools.product`` over named value lists, run as a
local sequential loop, as one index of it (``--task_id``, for any array
scheduler), or, for the OE-VAE, as the lanes of one ensemble (``--vmap
ON``): the grid axes in ``cli/vae.py::VMAPPABLE`` (beta, lamb, margin, lr,
seed) train side by side over one data preparation and one device copy of
each load (``train/ensemble.py``), while the other axes (FC_layers,
OE_type, ...) form sequential groups.  Each config's outputs land in
``<output_dir>/<tag>``, ``beta0.5_lamb1`` and so on, whichever way it ran.
The flags after ``--`` go to the entry point (``--device`` among them).

    python -m atlasvae_torch.cli.sweep --entry vae --grid beta=0,1,10 lamb=1,10 \\
        -- --n_epochs 5 --synthetic 20000 ...
    python -m atlasvae_torch.cli.sweep --entry vae --grid beta=0,1 --task_id 3 -- ...
    python -m atlasvae_torch.cli.sweep --entry vae --vmap ON \\
        --grid beta=0.5,2,8 lamb=1,5 -- --n_epochs 10 ...
"""

import itertools
import sys
from argparse import ArgumentParser


def grid_search(**kwargs):
    """index -> value(s), the reference helper's mapping."""
    if len(kwargs) <= 1:
        array_tuple = list(kwargs.values())[0]
    else:
        array_tuple = list(itertools.product(*kwargs.values()))
    return dict(zip(range(len(array_tuple)), array_tuple))


def _parse_grid(tokens):
    grid = {}
    for token in tokens:
        name, values = token.split("=", 1)
        grid[name] = values.split(",")
    return grid


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, passthrough = argv[:split], argv[split + 1:]
    else:
        passthrough = []
    parser = ArgumentParser()
    parser.add_argument("--entry", default="vae", choices=["vae", "aae", "jetid"])
    parser.add_argument("--grid", nargs="+", required=True, help="name=v1,v2,... tokens")
    parser.add_argument("--task_id", default=-1, type=int,
                        help=">=0: run only this grid index (array-job mode)")
    parser.add_argument("--vmap", default="OFF",
                        help="ON: train the grid axes that lanes can differ in as one "
                             "ensemble (entry vae; the other axes stay sequential groups)")
    parser.add_argument("--output_dir", default="outputs/sweep")
    args = parser.parse_args(argv)

    from . import aae, jetid, vae
    entry = {"vae": vae.main, "aae": aae.main, "jetid": jetid.main}[args.entry]
    grid = _parse_grid(args.grid)
    names = list(grid)
    mapping = grid_search(**grid)

    if args.vmap.upper() == "ON" and args.entry == "vae" and args.task_id < 0:
        return _run_vmapped(vae, grid, names, passthrough, args.output_dir)

    indices = [args.task_id] if args.task_id >= 0 else sorted(mapping)
    for idx in indices:
        values = mapping[idx]
        if len(names) == 1:
            values = (values,)
        tag = "_".join(f"{n}{v}" for n, v in zip(names, values))
        run_args = list(passthrough)
        for name, value in zip(names, values):
            run_args += [f"--{name}", str(value)]
        run_args += ["--output_dir", f"{args.output_dir}/{tag}"]
        print(f"\n===== SWEEP {idx}: {tag} =====")
        entry(run_args)
    return 0


def _run_vmapped(vae, grid, names, passthrough, output_dir):
    """One ensemble a sequential group (the product of the axes outside
    VMAPPABLE); the output directories are named as the sequential sweep's."""
    vm_names = [n for n in names if n in vae.VMAPPABLE]
    seq_names = [n for n in names if n not in vae.VMAPPABLE]
    if not vm_names:
        raise SystemExit(f"--vmap ON but no grid axis is vmappable ({vae.VMAPPABLE}); "
                         "drop --vmap")
    seq_rows = list(itertools.product(*[grid[n] for n in seq_names])) if seq_names else [()]
    vm_rows = list(itertools.product(*[grid[n] for n in vm_names]))
    for seq_values in seq_rows:
        run_args = list(passthrough)
        for name, value in zip(seq_names, seq_values):
            run_args += [f"--{name}", str(value)]
        dirs = []
        for row in vm_rows:
            values = dict(zip(seq_names, seq_values))
            values.update(zip(vm_names, row))
            dirs.append(f"{output_dir}/" + "_".join(f"{n}{values[n]}" for n in names))
        label = ", ".join(f"{n}={v}" for n, v in zip(seq_names, seq_values))
        print(f"\n===== VMAPPED SWEEP GROUP ({label or 'single group'}): "
              f"{len(vm_rows)} configs in one ensemble =====")
        vae.run_ensemble(run_args, vm_names, vm_rows, dirs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
