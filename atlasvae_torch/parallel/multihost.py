"""Process groups: bring-up, per-host data ranges, and the CLIs' launcher.

Counterpart of ``atlasvae/parallel/multihost.py``.  The JAX package joins
every host's chips into one runtime with ``jax.distributed.initialize``;
the port joins one process per device into a ``torch.distributed`` group
(NCCL between cards, gloo on the CPU, or gloo carrying CUDA tensors for
several ranks on one card), and each rank commits its own slice of the
event axis (``host_shard_range``).

``launch`` is how a CLI given ``--n_devices N`` runs: ``run_ranks`` starts
N ranks with ``torch.multiprocessing`` (the ``spawn`` method), rank r on
``cuda:r`` over NCCL, or, under ``--device cpu``, N CPU ranks over gloo;
each rank runs the entry point again inside the group, where ``launch``
gives it its mesh and device.  Rank 0 alone prints; a rank that fails
fails the run.  The distributed tests and ``chip_smoke.py`` start their
worlds through ``run_ranks`` too.
"""

import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None, process_id=None, backend=None,
               timeout=None):
    """Join a ``torch.distributed`` group at ``coordinator_address``
    (host:port, for ``tcp://``, or a full ``init_method`` URL such as
    ``file://...``).

    Returns True when this call made the group, False when it was a no-op
    (no coordinator given, or a group already up).  Real failures (an
    unreachable coordinator, inconsistent process counts) propagate.
    ``backend`` defaults to NCCL where a card is present, else gloo.
    """
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return False
    init = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, **kwargs)
    return True


def host_shard_range(n_events, n_hosts=None, host=None):
    """This process's contiguous [start, stop) slice of the event axis.
    Uneven splits spread the remainder over the leading hosts (linspace
    edges); hosts beyond ``n_events`` get empty ranges.  Defaults: the
    group's size and rank, or 1 and 0 without a group."""
    up = dist.is_initialized()
    n_hosts = (dist.get_world_size() if up else 1) if n_hosts is None else int(n_hosts)
    host = (dist.get_rank() if up else 0) if host is None else int(host)
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} not in [0, {n_hosts})")
    edges = np.linspace(0, n_events, n_hosts + 1).astype(np.int64)
    return int(edges[host]), int(edges[host + 1])


def global_mesh(axes=(("data", -1),)):
    """A mesh over every rank of the group."""
    from .mesh import make_mesh
    return make_mesh(axes)


def cli_ranks(n_devices, device, zero_means_all=True):
    """The ranks a CLI's ``--n_devices`` asks for.  0 is every visible card
    (1 where the JAX CLI reads 0 as 1, ``zero_means_all=False``); under
    ``--device cpu`` it is 1, since torch has one CPU device.  More ranks
    than cards are refused as the JAX CLIs refuse more devices than they
    see, and so is a card's index with more than one rank (rank r runs on
    ``cuda:r``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return n_devices or 1
    visible = torch.cuda.device_count()
    n = n_devices or (visible if zero_means_all else 1)
    if n > visible:
        raise SystemExit(f"--n_devices {n}: only {visible} devices visible")
    if n > 1 and device.index is not None:
        raise SystemExit(f"--device {device} with --n_devices {n}: rank r runs on cuda:r, "
                         "so name no card (--device cuda)")
    return n


def rank_device(device):
    """``device`` for this rank: a CUDA device without an index becomes the
    rank's current card (``run_ranks`` puts rank r on ``cuda:r``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def launch(entry, args, n_ranks, device, axis="data"):
    """Where a CLI given ``--n_devices`` runs.  With more than one rank and
    no group yet, ``run_ranks`` runs ``entry(*args)`` on new ranks and this
    returns None once every rank has returned.  Otherwise (mesh, device)
    for this process: a mesh along ``axis`` over the group's first
    ``n_ranks`` ranks (None for one rank), and this rank's device."""
    if n_ranks > 1 and not dist.is_initialized():
        run_ranks(entry, args, n_ranks, torch.device(device).type)
        return None
    from .mesh import make_mesh
    mesh = make_mesh(((axis, n_ranks),), range(n_ranks)) if n_ranks > 1 else None
    return mesh, rank_device(device)


def run_ranks(entry, args, n_ranks, device_type, backend=None, threads=None, timeout=None):
    """Run ``entry(*args)`` (a module-level function) on ``n_ranks`` new
    processes (``spawn``), the ranks of one new group joined through a file
    in a temporary folder.  Under ``device_type`` "cuda", rank r runs on
    ``cuda:r`` modulo the visible cards.  ``backend``: NCCL for "cuda", else
    gloo (gloo also carries CUDA tensors, so ranks can share a card);
    ``threads``: CPU threads a rank (default this process's share);
    ``timeout``: the group's.  Ranks above 0 print nothing.  Returns 0 when
    every rank returned; raises when one failed (the others are stopped)."""
    import torch.multiprocessing as mp
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    threads = threads or max(1, torch.get_num_threads() // n_ranks)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(entry, tuple(args), n_ranks, device_type, backend,
                                             os.path.join(tmp, "group"), threads, timeout),
                           nprocs=n_ranks, start_method="spawn")
    return 0


def _rank_main(rank, entry, args, n_ranks, device_type, backend, init_file, threads, timeout):
    torch.set_num_threads(threads)
    if rank:
        sys.stdout = open(os.devnull, "w")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n_ranks,
                            rank=rank, **({} if timeout is None else {"timeout": timeout}))
    try:
        status = entry(*args)
        if status:
            raise SystemExit(status)
    finally:
        dist.destroy_process_group()
