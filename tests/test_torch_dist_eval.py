"""The port's configuration-sharded ensemble, sharded EMD/KSD and sharded
BumpHunter scan on 2 CPU ranks over gloo, against their single-device runs
at the JAX package's bars (tests/test_ensemble.py:198, test_emd.py:151,
test_stats.py:184-209); EMD/KSD also against the JAX package's sharded
run on its CPU devices.  One world runs every check
(``tests/torch_dist_checks.py``)."""

import numpy as np
import pytest

from torch_dist_checks import emd_inputs, run_world
from torch_gaps import assert_close


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(2, tmp_path_factory.mktemp("dist_eval"), ("ensemble", "emd_ks", "bump"))


def test_config_sharded_ensemble_matches_unsharded(world):
    """4 configurations over a 2-rank config mesh, 2 lanes a rank with no
    collective, gathered in configuration order on every rank; 3 refused."""
    for rank, res in world.items():
        out = res["ensemble"]
        (h1, p1), (hn, pn) = out["single"], out["sharded"]
        assert len(hn) == len(h1) == 4
        for g in range(4):
            for key in h1[g]:
                assert_close(np.asarray(hn[g][key]), np.asarray(h1[g][key]),
                             f"rank {rank} config {g} {key}", rtol=1e-6)
        for i, (a, b) in enumerate(zip(pn, p1)):
            assert a.shape[0] == 4
            assert_close(a, b, f"rank {rank} leaf {i}", rtol=1e-6, atol=1e-7)
        assert "must be a multiple" in out["refused"]


@pytest.mark.parametrize("jets", [16, 13], ids=["divisible", "padded"])
def test_emd_ks_mesh_sharded_match_single_device(world, jets):
    for rank, res in world.items():
        (e1, en), (k1, kn) = res["emd_ks"][jets]["emd"], res["emd_ks"][jets]["ks"]
        assert en.shape == (jets,)
        assert_close(en, e1, f"rank {rank} EMD", rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(kn, k1)


@pytest.mark.parametrize("jets", [16, 13], ids=["divisible", "padded"])
def test_emd_ks_mesh_sharded_match_jax_mesh(world, jets):
    """The port's sharded EMD and KSD against the JAX package's, its jet
    axis over 2 of its CPU devices, at tests/test_torch_emd.py's bars
    (rtol 2e-5 / atol 1e-6)."""
    import jax
    from atlasvae.ops.emd import emd_pairs, ks_pairs
    from atlasvae.parallel.mesh import make_mesh
    mesh = make_mesh((("data", 2),), jax.devices()[:2])
    a, b = emd_inputs()[jets]
    want_emd = emd_pairs(a, b, n_iters=20, mesh=mesh)
    want_ks = ks_pairs(a[:, :, 0], b[:, :, 0], mesh=mesh)
    for rank, res in world.items():
        en, kn = res["emd_ks"][jets]["emd"][1], res["emd_ks"][jets]["ks"][1]
        assert_close(en, want_emd, f"rank {rank} EMD", rtol=2e-5, atol=1e-6)
        assert_close(kn, want_ks, f"rank {rank} KSD", atol=1e-6)


def test_bump_sigma_sharded_matches_single_device(world):
    """The pseudo-experiments over 2 ranks, the exceedance count summed as
    an integer: exactly the one-device scan; npe = 161 refused."""
    for rank, res in world.items():
        out = res["bump"]
        assert out["sharded"] == out["one"], (rank, out)
        assert out["one"][0] > 1.0 and np.isfinite(out["one"][1])
        assert "must be a multiple" in out["refused"]
