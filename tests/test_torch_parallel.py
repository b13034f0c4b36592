"""``atlasvae_torch.parallel`` in the test process: meshes, the shard and
gather helpers and tensor-parallel layouts on a group of one rank, and
``multihost``'s bring-up and per-host ranges, as tests/test_aux.py:29-104
holds the JAX package's."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_dist_checks import one_rank_group

import atlasvae_torch.parallel.multihost as mh
from atlasvae_torch.parallel import mesh as pm


def test_host_shard_range_single_host():
    assert not dist.is_initialized()
    assert mh.initialize() is False            # no coordinator: a no-op
    assert mh.host_shard_range(1000) == (0, 1000)


def test_host_shard_range_uneven_split():
    ranges = [mh.host_shard_range(10, n_hosts=4, host=h) for h in range(4)]
    assert ranges[0][0] == 0 and ranges[-1][1] == 10
    for (_, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    sizes = [b - a for a, b in ranges]
    assert sum(sizes) == 10 and max(sizes) - min(sizes) <= 1


def test_host_shard_range_fewer_events_than_hosts():
    ranges = [mh.host_shard_range(3, n_hosts=8, host=h) for h in range(8)]
    assert sum(b - a for a, b in ranges) == 3
    assert all(b >= a for a, b in ranges)
    with pytest.raises(ValueError):
        mh.host_shard_range(10, n_hosts=2, host=5)


def test_initialize_propagates_real_errors(monkeypatch):
    """A group already up is a no-op; a real failure propagates."""
    with pytest.raises(Exception, match="(?i)timed out|refused|connect"):
        mh.initialize("127.0.0.1:1", num_processes=2, process_id=1, backend="gloo",
                      timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()

    def boom(*args, **kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="connection refused"):
        mh.initialize("127.0.0.1:1", num_processes=2, process_id=1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert mh.initialize("127.0.0.1:1", num_processes=2, process_id=1) is False


def test_initialize_joins_a_file_group(tmp_path):
    try:
        assert mh.initialize(f"file://{tmp_path}/group", 1, 0, backend="gloo") is True
        assert mh.initialize(f"file://{tmp_path}/group", 1, 0) is False
        assert mh.host_shard_range(7) == (0, 7)
        mesh = mh.global_mesh()
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
    finally:
        dist.destroy_process_group()


def test_make_mesh_sizes_and_mismatch(tmp_path):
    with pytest.raises(RuntimeError, match="initialize one"):
        pm.make_mesh()
    with one_rank_group(tmp_path):
        mesh = pm.make_mesh((("data", -1), ("model", 1)))
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert pm.axis_size(mesh, "model") == 1 and pm.axis_rank(mesh, "data") == 0
        with pytest.raises(ValueError, match=r"mesh \{'data': 2\} != 1 devices"):
            pm.make_mesh((("data", 2),))
        assert pm.config_mesh().mesh_dim_names == ("config",)


def test_shard_gather_replicate_on_one_rank(tmp_path):
    with one_rank_group(tmp_path):
        mesh = pm.data_parallel_mesh()
        tree = {"a": torch.arange(12.).reshape(3, 4), "b": [np.arange(6).reshape(2, 3)]}
        assert torch.equal(pm.shard_leading(mesh, tree, "data")["a"], tree["a"])
        assert pm.shard_batch(mesh, tree)["b"][0].shape == (2, 3)
        assert torch.equal(pm.gather(mesh, tree["a"], dim=1), tree["a"])
        assert pm.gather(mesh, ["x", "y"]) == ["x", "y"]
        assert torch.equal(pm.replicate(mesh, tree["a"]), tree["a"])
        assert torch.equal(pm.all_sum(mesh, torch.ones(3)), torch.ones(3))
        assert pm.is_writer(mesh) and pm.is_writer(None)
        pm.barrier(mesh)


def test_block_of_a_dimension_not_divisible_is_refused():
    class Mesh2:
        mesh_dim_names = ("data",)

        def size(self, dim):
            return 2

        def get_local_rank(self, axis):
            return 1

    assert pm.shard_batch(Mesh2(), np.arange(8).reshape(2, 4))[0].tolist() == [2, 3]
    with pytest.raises(ValueError, match="not a multiple"):
        pm.shard_leading(Mesh2(), np.arange(3), "data")


def test_tp_param_shardings_follow_the_jax_rule(tmp_path):
    """Hidden kernels and biases sharded on their output dimension where it
    divides by the axis size, heads replicated (atlasvae/parallel/tp.py:23-35)."""
    from torch.distributed.tensor import Replicate, Shard
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.parallel.tp import tp_param_shardings
    params = init_vae(torch.Generator().manual_seed(0), VAEConfig(fc_layers=(16, 8), input_dim=6),
                      device="cpu")
    with one_rank_group(tmp_path):
        mesh = pm.make_mesh((("data", 1), ("model", 1)))
        specs = tp_param_shardings(mesh, params)
    assert specs["encoder"]["hidden"][0]["w"] == (Replicate(), Shard(1))
    assert specs["encoder"]["hidden"][0]["b"] == (Replicate(), Shard(0))
    assert specs["encoder"]["mean"]["w"] == (Replicate(), Replicate())
    assert specs["decoder"]["out"]["b"] == (Replicate(), Replicate())


@pytest.mark.parametrize("n_devices,device,zero_all,want", [
    (0, "cpu", True, 1), (3, "cpu", True, 3), (0, "cpu", False, 1)])
def test_cli_ranks(n_devices, device, zero_all, want):
    assert mh.cli_ranks(n_devices, device, zero_all) == want


def test_cli_ranks_refuses_more_cards_than_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mh.cli_ranks(0, "cuda") == 1
    with pytest.raises(SystemExit, match="--n_devices 2: only 1 devices"):
        mh.cli_ranks(2, "cuda")


def test_cli_ranks_refuses_a_named_card_for_several_ranks(monkeypatch):
    """Rank r runs on cuda:r, so --device cuda:1 with --n_devices 2 would put
    both ranks of the NCCL world on one card: refused before any rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mh.cli_ranks(2, "cuda") == 2
    assert mh.cli_ranks(1, "cuda:1") == 1
    with pytest.raises(SystemExit, match="--device cuda:1 with --n_devices 2"):
        mh.cli_ranks(2, "cuda:1")


def test_launch_of_one_rank_runs_here(tmp_path):
    """One rank starts no process: no mesh and the device as given, also
    inside a group (as under torchrun)."""
    assert mh.launch(None, (), 1, "cpu") == (None, torch.device("cpu"))
    with one_rank_group(tmp_path):
        assert mh.launch(None, (), 1, "cpu") == (None, torch.device("cpu"))
