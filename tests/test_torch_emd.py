"""The port's EMD and KS metrics against the JAX package on the same inputs.

On the CPU the port runs ``_sinkhorn_emd``, the plain version of its CUDA
kernel.  It is held against both JAX forms of the same function, the XLA
program ``_emd_batch_xla`` and the Pallas kernel ``emd_batch_pallas`` (in
interpret mode off the TPU), at rtol 2e-5 / atol 1e-6: the bar
``tests/test_emd.py`` holds the two JAX forms to against each other
(float32, sums in different orders, exp and log an ulp apart).  ``ks_pairs``
is exact up to the rounding of a running sum of 1/n steps: atol 1e-6
against scipy and against the JAX package.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atlasvae.ops import emd as jax_emd
from atlasvae.ops.emd_pallas import emd_batch_pallas
from atlasvae_torch.ops import emd, emd_cuda

CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=1e-6)


def _clouds(rng, n_jets, n_const, tails=True):
    jp = np.zeros((n_jets, n_const, 3), np.float32)
    jq = np.zeros((n_jets, n_const, 3), np.float32)
    for arr in (jp, jq):
        arr[..., 0] = rng.uniform(0.1, 2.0, (n_jets, n_const))
        arr[..., 1:] = rng.normal(0, 0.5, (n_jets, n_const, 2))
    if tails:
        jp[:, int(n_const * 0.6):] = 0.0      # zero-padded tails
        jq[:, int(n_const * 0.55):] = 0.0
    return jp, jq


def _plain(jp, jq, n_iters, eps_final=0.01, **kwargs):
    return emd._sinkhorn_emd(torch.from_numpy(jp), torch.from_numpy(jq), 1.0, n_iters,
                             eps_final, **kwargs).numpy()


@pytest.mark.parametrize("n_jets,n_const,n_iters", [(6, 8, 30), (3, 20, 30), (4, 100, 100),
                                                    (3, 129, 20), (2, 255, 15), (2, 300, 10)])
def test_plain_sinkhorn_matches_xla_and_pallas(rng, n_jets, n_const, n_iters):
    """At the register route's widths (up to 128) and at widths of each of
    the cluster route's sizes: 129 (2 CTAs), 255 (4; the widest jet the
    data's uint8 counts give) and 300 (8; the Pallas kernel pads it to
    384)."""
    jp, jq = _clouds(rng, n_jets, n_const)
    got = _plain(jp, jq, n_iters)
    xla = jax_emd._emd_batch_xla(jnp.asarray(jp), jnp.asarray(jq), 1.0, n_iters, 0.01)
    pallas = emd_batch_pallas(jnp.asarray(jp), jnp.asarray(jq), 1.0, n_iters, 0.01)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("n_iters,n_stages", [(25, 7), (3, 10), (7, 10), (1, 10), (40, 1)])
def test_plain_sinkhorn_stage_split_matches_pallas(rng, n_iters, n_stages):
    """n_iters not divisible by n_stages (one more iteration in the first
    ``rem`` stages) and fewer iterations than stages (n_stages clamps).

    A single stage starts at eps_final itself: exp(-C / 0.01) underflows
    into the denormals, and what the 1e-30 floors then see depends on
    whether denormals are flushed to zero.  XLA's CPU programs flush them,
    torch on the CPU keeps them (a gap of up to 3% there, none once torch
    flushes too), so those two cases run the port with flushing on."""
    jp, jq = _clouds(rng, 5, 12)
    single_stage = min(n_stages, n_iters) == 1
    was_set = single_stage and torch.set_flush_denormal(True)
    try:
        got = _plain(jp, jq, n_iters, n_stages=n_stages)
    finally:
        if was_set:
            torch.set_flush_denormal(False)
    want = emd_batch_pallas(jnp.asarray(jp), jnp.asarray(jq), 1.0, n_iters, 0.01,
                            n_stages=n_stages)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    single = jax.vmap(lambda a, b: jax_emd._sinkhorn_emd(a, b, 1.0, n_iters, 0.01, n_stages))(
        jnp.asarray(jp), jnp.asarray(jq))
    np.testing.assert_allclose(got, np.asarray(single), **TOL)


def test_plain_sinkhorn_edge_jets(rng):
    """One live constituent and negative pt agree with the jitted JAX
    program.  A side whose pt is all zero is NaN under ``jax.jit`` on the
    CPU (both JAX forms) while the same JAX function evaluated op by op
    gives the finite |sum p - sum q|; the port gives that finite number."""
    jp, jq = _clouds(rng, 6, 8, tails=False)
    jp[0, :, 0] = 0.0                        # all pt zero on one side
    jq[1, :, 0] = 0.0                        # ... on the other
    jp[2, :, 0] = jq[2, :, 0] = 0.0          # ... on both
    jp[3, 1:, 0] = 0.0                       # one live constituent against eight
    jp[4, 1:, 0] = jq[4, 1:, 0] = 0.0        # one against one
    jq[5, :3, 0] *= -1.0                     # negative pt in the input: clipped to 0
    got = _plain(jp, jq, 30)
    assert np.isfinite(got).all()
    jitted = np.asarray(jax_emd._emd_batch_xla(jnp.asarray(jp), jnp.asarray(jq), 1.0, 30, 0.01))
    np.testing.assert_allclose(got[3:], jitted[3:], **TOL)
    with jax.disable_jit():
        eager = np.array([float(jax_emd._sinkhorn_emd(jnp.asarray(jp[i]), jnp.asarray(jq[i]),
                                                      1.0, 30, 0.01)) for i in range(3)])
    np.testing.assert_allclose(got[:3], eager, **TOL)
    sums = np.abs(np.maximum(jp[:3, :, 0], 0).sum(1) - np.maximum(jq[:3, :, 0], 0).sum(1))
    np.testing.assert_allclose(got[:3], sums, **TOL)


@pytest.mark.parametrize("kind", ["permuted", "far"])
@pytest.mark.parametrize("n_const", [20, 100])
def test_plain_sinkhorn_small_emd_beside_large_pt(rng, n_const, kind):
    """Few iterations on a cloud against itself in the reverse order (true
    EMD 0) and against a far copy of equal total pt.

    EMD = transport * min(sum p, sum q) + |sum p - sum q|, and the float32
    rounding of the transport term is a few 1e-6 of the total pt however
    small the transport: against a permuted copy the result is some 1e-3
    of the total pt, and float32 forms of the function that sum in different
    orders (the port, XLA, the Pallas kernel, the port with both clouds
    permuted together) part by more than rtol 2e-5 of it.  So a permuted
    copy is held to rtol on the EMD plus 1e-5 of the total pt, against both
    JAX forms and the port's own float64; the far copy to the usual bar."""
    jp, _ = _clouds(rng, 16, n_const)
    jq = jp[:, ::-1].copy()
    if kind == "far":
        jq[..., 1] += 0.8
        jq[..., 2] -= 0.6
    got = _plain(jp, jq, 20)
    xla = np.asarray(jax_emd._emd_batch_xla(jnp.asarray(jp), jnp.asarray(jq), 1.0, 20, 0.01))
    pallas = np.asarray(emd_batch_pallas(jnp.asarray(jp), jnp.asarray(jq), 1.0, 20, 0.01))
    if kind == "far":
        np.testing.assert_allclose(got, xla, **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
        return
    mass = jp[..., 0].sum(1)
    exact = emd._sinkhorn_emd(torch.from_numpy(jp).double(), torch.from_numpy(jq).double(),
                              1.0, 20, 0.01).numpy()
    assert (exact < 1e-2 * mass).all()       # all of it regularisation and rounding
    for ref in (xla, pallas, exact):
        assert (np.abs(got - ref) <= 2e-5 * np.abs(ref) + 1e-5 * mass).all()


def test_pairwise_cost_across_the_phi_seam(rng):
    p = np.zeros((3, 7, 3), np.float32)
    q = np.zeros((3, 5, 3), np.float32)
    p[..., 1:] = rng.normal(0, 1, (3, 7, 2))
    q[..., 1:] = rng.normal(0, 1, (3, 5, 2))
    p[:, :4, 2] = np.float32(np.pi) - rng.uniform(0, 0.2, (3, 4))     # either side of +-pi
    q[:, :3, 2] = -np.float32(np.pi) + rng.uniform(0, 0.2, (3, 3))
    p[0, 4, 2], q[0, 3, 2] = np.pi, -np.pi                            # exactly 2 pi apart
    p[1, 5, 2], q[1, 4, 2] = -3.0, 3.0
    got = emd._pairwise_cost(torch.from_numpy(p), torch.from_numpy(q), 0.8).numpy()
    want = jax.vmap(lambda a, b: jax_emd._pairwise_cost(a, b, 0.8))(jnp.asarray(p),
                                                                    jnp.asarray(q))
    assert got.shape == (3, 7, 5)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert got[0, 4, 3] <= abs(p[0, 4, 1] - q[0, 3, 1]) / 0.8 + 1e-5   # wrapped, not 2 pi


def test_emd_pairs_matches_jax_and_chunks(rng, monkeypatch):
    jp, jq = _clouds(rng, 23, 10)
    want = jax_emd.emd_pairs(jp, jq, n_iters=40)
    one = emd.emd_pairs(jp, jq, n_iters=40, device=CPU)
    assert one.shape == (23,) and one.dtype == np.float32
    np.testing.assert_allclose(one, want, **TOL)
    # a small budget cuts the same jets into chunks of 5
    monkeypatch.setattr(emd, "_EMD_BUDGET_BYTES", 5 * 16 * 10 ** 2)
    seen = []
    plain = emd._emd_batch
    monkeypatch.setattr(emd, "_emd_batch", lambda p, *a: seen.append(len(p)) or plain(p, *a))
    chunked = emd.emd_pairs(torch.from_numpy(jp), torch.from_numpy(jq), n_iters=40)
    assert seen == [5, 5, 5, 5, 3]
    np.testing.assert_array_equal(chunked, one)
    assert emd.emd_pairs(jp[:0], jq[:0], device=CPU).shape == (0,)


def test_emd_chunk_rule_is_the_jax_package_s():
    for n in (1, 20, 100, 128):
        assert max(1, min(emd._CHUNK * 8, emd._EMD_BUDGET_BYTES // (16 * n * n))) == \
            max(1, min(jax_emd._CHUNK * 8, jax_emd._EMD_BUDGET_BYTES // (16 * n * n)))
    assert (emd._CHUNK, emd._EMD_BUDGET_BYTES) == (jax_emd._CHUNK, jax_emd._EMD_BUDGET_BYTES)


def test_ks_matches_scipy_and_jax(rng):
    from scipy.stats import ks_2samp
    p = rng.normal(0, 1, (50, 40)).astype(np.float32)
    q = rng.normal(0.3, 1.2, (50, 40)).astype(np.float32)
    ours = emd.ks_pairs(p, q, device=CPU)
    ref = np.array([ks_2samp(p[i], q[i]).statistic for i in range(50)])
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(ours, jax_emd.ks_pairs(p, q), atol=1e-6)
    assert emd.ks_pairs(p[:0], q[:0], device=CPU).shape == (0,)


def test_ks_tie_heavy_matches_scipy_and_jax(rng):
    from scipy.stats import ks_2samp
    p = np.round(rng.normal(0, 1, (60, 37)), 1).astype(np.float32)
    q = np.round(rng.normal(0.2, 1.1, (60, 41)), 1).astype(np.float32)
    ours = emd.ks_pairs(p, q, device=CPU)                    # unequal sample sizes
    ref = np.array([ks_2samp(p[i], q[i]).statistic for i in range(60)])
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(ours, jax_emd.ks_pairs(p, q), atol=1e-6)
    assert emd.ks_pairs(torch.from_numpy(p), torch.from_numpy(p)).max() < 1e-6


def test_emd_discriminant_fidelity_vs_exact_ot(rng):
    """The fidelity gate of tests/test_emd.py with the port's ``emd_pairs``:
    the Sinkhorn score against the exact LP optimum at the production
    settings (100 iterations, eps_final 0.01) as a sig/bkg discriminant."""
    from scipy.stats import spearmanr
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
    try:
        from emd_fidelity import make_pairs, exact_emd_lp, auc, best_cut_index
    finally:
        sys.path.pop(0)
    n_per_class, n_const = 250, 16
    bkg_o, bkg_d = make_pairs(rng, n_per_class, n_const, pos_sigma=0.05, pt_jitter=0.05)
    sig_o, sig_d = make_pairs(rng, n_per_class, n_const, pos_sigma=0.20, pt_jitter=0.25)
    orig, dist = np.concatenate([bkg_o, sig_o]), np.concatenate([bkg_d, sig_d])
    labels = np.concatenate([np.zeros(n_per_class), np.ones(n_per_class)])
    sink = emd.emd_pairs(orig, dist, device=CPU)
    exact = np.array([exact_emd_lp(orig[i], dist[i]) for i in range(len(orig))])
    assert abs(auc(sink, labels) - auc(exact, labels)) < 1e-3
    assert spearmanr(sink, exact).statistic > 0.999
    assert best_cut_index(sink, labels)[0] == best_cut_index(exact, labels)[0]


def test_cuda_wrapper_checks_before_it_launches(rng):
    """The kernel's wrapper refuses CPU tensors; the wide route's device
    scratch for one of ``emd_pairs``'s chunks (the JAX package's rule,
    2 GiB / (16 n^2) jets) stays near 512 MiB at every width it takes;
    ``_emd_batch`` picks the plain version only by the device."""
    jp, jq = _clouds(rng, 2, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        emd_cuda.emd_sinkhorn(torch.from_numpy(jp), torch.from_numpy(jq))
    assert emd_cuda.launches == emd_cuda.cluster_launches == emd_cuda.wide_launches == 0
    for n in range(emd_cuda.CLUSTER_MAX + 1, 4097, 37):
        chunk = max(1, emd._EMD_BUDGET_BYTES // (16 * n * n))
        assert 4 * chunk * emd_cuda.wide_scratch_floats(n) <= 1.05 * 2 ** 29
    assert emd_cuda.wide_scratch_floats(5) == 14 * 8 + 25
    np.testing.assert_array_equal(
        emd._emd_batch(torch.from_numpy(jp), torch.from_numpy(jq), 1.0, 10, 0.01).numpy(),
        _plain(jp, jq, 10))


def test_route_choice_covers_every_width_once():
    """Every jet width n >= 1 has exactly one route: the register route's
    smallest tile that holds it up to the largest tile, then the cluster
    route on the least cluster that holds it up to CLUSTER_MAX (255, the
    widest jet the data's uint8 counts give, on 4 CTAs), then the wide
    route at any width; n = 0 alone is refused."""
    tiles, clusters = emd_cuda.TILES, emd_cuda.CLUSTERS
    assert list(tiles) == sorted(set(tiles)) and tiles[-1] < clusters[0][1]
    assert [c for c, _ in clusters] == [2, 4, 8]
    assert [w for _, w in clusters] == sorted(w for _, w in clusters)
    assert emd_cuda.CLUSTER_MAX == clusters[-1][1] and emd_cuda.route(255) == ("cluster", 4)
    taken = {which: [] for which in emd_cuda.ROUTES}
    for n in range(1, 1025):
        which, size = emd_cuda.route(n)
        taken[which].append(n)
        if which == "tiles":
            assert size == min(t for t in tiles if t >= n)
        elif which == "cluster":
            assert size == min(c for c, widest in clusters if n <= widest)
            assert size == emd_cuda.cluster_size(n)
        else:
            assert size is None
    assert taken["tiles"] == list(range(1, tiles[-1] + 1))
    assert taken["cluster"] == list(range(tiles[-1] + 1, emd_cuda.CLUSTER_MAX + 1))
    assert taken["wide"] == list(range(emd_cuda.CLUSTER_MAX + 1, 1025))
    with pytest.raises(ValueError, match="at least 1"):
        emd_cuda.route(0)
    with pytest.raises(ValueError, match=f"at most {emd_cuda.CLUSTER_MAX}"):
        emd_cuda.cluster_size(emd_cuda.CLUSTER_MAX + 1)


@pytest.mark.parametrize("force_route", [None, "tiles", "cluster", "wide", "fast"])
def test_cuda_wrapper_refuses_cpu_tensors_on_every_route(rng, force_route):
    """Whatever route is asked for, a CPU tensor is refused before anything
    is built or launched."""
    jp, jq = _clouds(rng, 2, 4)
    counts = lambda: (emd_cuda.launches, emd_cuda.cluster_launches, emd_cuda.wide_launches)
    before = counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        emd_cuda.emd_sinkhorn(torch.from_numpy(jp), torch.from_numpy(jq), force_route=force_route)
    assert counts() == before == (0, 0, 0)
