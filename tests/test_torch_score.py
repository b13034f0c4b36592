"""The scoring slice as a whole: the port's metric bank, one chunk of the
score path, and ``atlasvae_torch.cli.score`` end to end, against the JAX
package on the same files, weights and scaler.

Tolerances: the metric bank on the same inputs rtol 1e-5 / atol 1e-5
(float32, sums in different orders; float-max saturation compared as
values); one chunk of the score path with injected noise rtol 1e-4 / atol
1e-4 for MAE and Latent, and rtol 2e-3 / atol 1e-4 times the largest
score for KLD and JSD, whose log2(p/q) magnifies the reconstruction's
rounding where a prediction q is near zero;
kinematics and weights exact.  ``score_MAE`` of the
two CLIs depends on each framework's own latent draws, so only its mean is
compared, within five standard errors of the difference of two means.
"""

import jax
import numpy as np
import pytest
import torch
from torch_gaps import assert_close

from atlasvae.cli import score as jax_score
from atlasvae.data import load_data as jax_load_data, apply_scaler as jax_apply_scaler, \
    fit_scaler as jax_fit_scaler
from atlasvae.eval import compute_metric_bank as jax_metric_bank, loss_mapping as jax_mapping, \
    loss_function as jax_loss_function
from atlasvae.models import VAEConfig as JaxVAEConfig, init_vae as jax_init_vae, \
    vae_apply as jax_vae_apply
from atlasvae.train.checkpoint import save_weights as jax_save_weights
from atlasvae_torch.cli import score
from atlasvae_torch.data import hdf5, load_data, apply_scaler, Scaler, ensure_synthetic_registry
from atlasvae_torch.eval import compute_metric_bank, loss_mapping, loss_function
from atlasvae_torch.interop import params_from_jax
from atlasvae_torch.models import vae_apply

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
METRICS = ("MAE", "MSE", "MARE", "KLD", "JSD", "X-S", "Inputs", "Latent")
QCD = "synthetic_QCD-Geneva.h5"


@pytest.fixture(scope="module")
def model():
    params = jax_init_vae(jax.random.PRNGKey(11), JaxVAEConfig())
    return params, params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _bank_inputs(rng):
    p = np.abs(rng.normal(size=(256, 12))).astype(np.float32)
    q = np.abs(rng.normal(size=(256, 12))).astype(np.float32)
    q[:8, :3] = 0.0          # live feature predicted as zero: float-max terms
    p[8:12, :2] = 0.0        # 0 * log(0 / q) terms
    q[12:16] = 0.0
    p[12:16, :] = 0.0        # 0 / 0 everywhere in the row
    p[16:20, 0] = -1.0       # negative ratio: NaN terms
    return p, q


@pytest.mark.parametrize("normal_losses", [False, True])
def test_metric_bank_matches_jax(rng, model, normal_losses):
    jparams, params = model
    p, q = _bank_inputs(rng)
    want = jax_metric_bank(p, q, jparams, METRICS, normal_losses=normal_losses)
    got = compute_metric_bank(torch.from_numpy(p), torch.from_numpy(q), params, METRICS,
                              normal_losses=normal_losses, device=CPU)
    assert set(got) == set(want)
    for key in want:
        assert_close(got[key], np.asarray(want[key]), f"metric {key}", **TOL)
    if not normal_losses:
        assert np.max(got["KLD"][:8]) == np.finfo(np.float32).max


@pytest.mark.parametrize("x", [[0.1, 0.9], [-0.5, 0.0], [0.0, 3.0], [-4.0, -2.0],
                               [-2.0, 5.0]])
def test_loss_mapping_branches_match_jax(x):
    np.testing.assert_array_equal(loss_mapping(np.array(x)), jax_mapping(np.array(x)))


def test_emd_and_ksd_name_their_roadmap_item(rng):
    """ROADMAP Queue 1 item 7 is done: both metrics score, through
    ``loss_function`` and through the bank, as the JAX package's do."""
    p = rng.normal(size=(9, 12)).astype(np.float32)
    q = (p + rng.normal(0, 0.1, size=p.shape)).astype(np.float32)
    for n_dims in (3, 4):
        got = loss_function(p, q, n_dims, "EMD", multiloss=False, device=CPU)
        want = jax_loss_function(p, q, n_dims, "EMD", multiloss=False)
        assert got.shape == (9,)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    losses = {}
    assert loss_function(torch.from_numpy(p), torch.from_numpy(q), 3, "KSD", losses) is None
    np.testing.assert_allclose(losses["KSD"], jax_loss_function(p, q, 3, "KSD", multiloss=False),
                               atol=1e-6)
    bank = compute_metric_bank(torch.from_numpy(p), torch.from_numpy(q), None,
                               ("MAE", "EMD", "KSD"), normal_losses=True, device=CPU)
    want = jax_metric_bank(p, q, None, ("MAE", "EMD", "KSD"), normal_losses=True)
    assert set(bank) == set(want) == {"MAE", "EMD", "KSD"}
    for key in want:
        np.testing.assert_allclose(bank[key], np.asarray(want[key]), rtol=2e-5, atol=1e-6)


def test_one_chunk_with_injected_noise_matches_jax(synth_dir, model, rng):
    jparams, params = model
    path = str(synth_dir / QCD)
    jax_sample = jax_load_data(path, (0, 1500), verbose=False)
    scaler = jax_fit_scaler(jax_sample["HLVs"], verbose=False)
    x = jax_apply_scaler(jax_sample["HLVs"], scaler=scaler, verbose=False)
    noise = rng.normal(size=(len(x), 10)).astype(np.float32)
    x_pred = np.asarray(jax_vae_apply(jparams, x, jax.random.PRNGKey(0), noise=noise)[0])
    want = jax_metric_bank(x, x_pred, jparams, ("MAE", "Latent", "KLD", "JSD"),
                           normal_losses=False)

    sample = load_data(path, (0, 1500), verbose=False, device=CPU)
    xt = apply_scaler(torch.from_numpy(sample["HLVs"]), scaler=Scaler(**vars(scaler)),
                      verbose=False)
    with torch.inference_mode():
        pred = vae_apply(params, xt, noise=torch.from_numpy(noise))[0]
        got = compute_metric_bank(xt, pred, params, ("MAE", "Latent", "KLD", "JSD"),
                                  normal_losses=False, device=CPU)
    np.testing.assert_allclose(xt.numpy(), x, **TOL)
    for key in want:
        ref = np.asarray(want[key])
        tol = dict(rtol=2e-3, atol=1e-4 * np.abs(ref).max()) if key in ("KLD", "JSD") \
            else dict(rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[key], ref, err_msg=key, **tol)


def test_metric_bank_emd_and_ksd_at_255_constituents_match_jax(rng):
    """The bank's EMD and KSD on 16 jets of 255 (px, py, pz) constituents
    (765 wide: the widest jet the data's uint8 counts give, scored on the
    card by K4's cluster route), with zero-padded tails of their own
    lengths, against the JAX package's on the same inputs: EMD at rtol 2e-5
    / atol 1e-6 (the bar of its two forms), KSD at atol 1e-6."""
    n_jets, n_const = 16, 255
    p = rng.normal(0, 1, (n_jets, n_const, 3)).astype(np.float32)
    p[np.arange(n_const)[None, :] >= rng.integers(20, n_const + 1, (n_jets, 1))] = 0.0
    q = np.where(p != 0, p + rng.normal(0, 0.1, p.shape), 0.0).astype(np.float32)
    p, q = p.reshape(n_jets, -1), q.reshape(n_jets, -1)
    got = compute_metric_bank(torch.from_numpy(p), torch.from_numpy(q), None, ("EMD", "KSD"),
                              normal_losses=False, device=CPU)
    want = jax_metric_bank(p, q, None, ("EMD", "KSD"), normal_losses=False)
    assert got["EMD"].shape == got["KSD"].shape == (n_jets,)
    np.testing.assert_allclose(got["EMD"], np.asarray(want["EMD"]), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["KSD"], np.asarray(want["KSD"]), atol=1e-6)


@pytest.fixture(scope="module")
def scored(synth_dir, tmp_path_factory):
    """The JAX CLI and the port's CLI on the same sample, checkpoint and scaler."""
    tmp = tmp_path_factory.mktemp("score")
    path = str(synth_dir / QCD)
    jax_save_weights(jax_init_vae(jax.random.PRNGKey(4), JaxVAEConfig()), tmp / "model.npz")
    jax_fit_scaler(jax_load_data(path, 4000, verbose=False)["HLVs"],
                   scaler_out=tmp / "hlv.pkl", verbose=False)
    common = ["--data", path, "--model_in", str(tmp / "model.npz"),
              "--HLV_scaler_in", str(tmp / "hlv.pkl"), "--metrics", "MAE", "Latent",
              "--n_jets", "3000", "--chunk", "1000"]
    jax_score.main(common + ["--output", str(tmp / "jax.h5")])
    score.main(common + ["--output", str(tmp / "port.h5"), "--device", "cpu"])
    score.main(common + ["--output", str(tmp / "ranked.h5"), "--device", "cpu",
                         "--n_devices", "2"])
    out = {}
    for name in ("jax", "port", "ranked"):
        with hdf5.File(tmp / f"{name}.h5", "r") as f:
            out[name] = {k: f[k][:] for k in f}
    return out


def test_cli_writes_the_same_keys_and_rows(scored):
    assert set(scored["port"]) == set(scored["jax"]) == \
        {"score_MAE", "score_Latent", "m", "pt", "weights"}
    for key, val in scored["port"].items():
        assert val.shape == (3000,) and val.dtype == np.float32 and np.isfinite(val).all()


def test_cli_kinematics_and_latent_match_per_jet(scored):
    for key in ("m", "pt", "weights"):
        np.testing.assert_array_equal(scored["port"][key], scored["jax"][key])
    np.testing.assert_allclose(scored["port"]["score_Latent"], scored["jax"]["score_Latent"],
                               **TOL)


def test_cli_mae_matches_in_mean(scored):
    a, b = scored["port"]["score_MAE"], scored["jax"]["score_MAE"]
    stderr = np.sqrt(a.var() / len(a) + b.var() / len(b))
    assert abs(a.mean() - b.mean()) < 5 * stderr, (a.mean(), b.mean(), stderr)


CONST_ARGS = ["--constituents", "ON", "--HLVs", "OFF", "--n_const", "20", "--n_dims", "3",
              "--FC_layers", "32", "16", "8", "4", "--metrics", "MAE", "Latent", "EMD", "KSD"]


@pytest.fixture(scope="module")
def scored_constituents(synth_dir, tmp_path_factory):
    """Constituents mode end to end: both CLIs on the same file, fitted
    constituent scaler and 60->32/16/8/4 VAE carried across as npz.

    What is measured: the two frameworks draw different latent noise, so
    the logvar head's bias is set to -40 (sigma = exp(-20), below float32
    resolution beside the mean): the prediction is then the same function
    of the input in both, and every score compares jet by jet."""
    tmp = tmp_path_factory.mktemp("score_const")
    path = str(synth_dir / QCD)
    params = jax_init_vae(jax.random.PRNGKey(9), JaxVAEConfig(fc_layers=(32, 16, 8, 4),
                                                              input_dim=60))
    params["encoder"]["logvar"]["b"] = params["encoder"]["logvar"]["b"] - 40.0
    jax_save_weights(params, tmp / "model.npz")
    const = jax_load_data(path, 4000, (), 20, 3, "ON", "OFF", verbose=False)["constituents"]
    assert const.shape == (4000, 60)
    jax_fit_scaler(const, scaler_out=tmp / "const.pkl", scaler_type="QuantileTransformer",
                   verbose=False)
    common = ["--data", path, "--model_in", str(tmp / "model.npz"),
              "--const_scaler_in", str(tmp / "const.pkl"), "--n_jets", "1500",
              "--chunk", "600", *CONST_ARGS]
    jax_score.main(common + ["--output", str(tmp / "jax.h5")])
    score.main(common + ["--output", str(tmp / "port.h5"), "--device", "cpu"])
    score.main(common + ["--output", str(tmp / "ranked.h5"), "--device", "cpu",
                         "--n_devices", "2"])
    out = {}
    for name in ("jax", "port", "ranked"):
        with hdf5.File(tmp / f"{name}.h5", "r") as f:
            out[name] = {k: f[k][:] for k in f}
    return out


def test_constituents_cli_writes_the_same_keys_and_rows(scored_constituents):
    got, want = scored_constituents["port"], scored_constituents["jax"]
    assert set(got) == set(want) == {"score_MAE", "score_Latent", "score_EMD", "score_KSD",
                                     "m", "pt", "weights"}
    for key, val in got.items():
        assert val.shape == (1500,) and val.dtype == np.float32 and np.isfinite(val).all(), key
    for key in ("m", "pt", "weights"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["score_EMD"].min() > 0 and got["score_EMD"].std() > 0


def test_constituents_cli_scores_match_per_jet(scored_constituents):
    """MAE and Latent as in HLV mode.  score_EMD at rtol 1e-4 + atol 1e-5:
    the prediction it is taken on already differs between the frameworks
    by up to 1e-5 of its scale, and the Sinkhorn plan follows it smoothly."""
    got, want = scored_constituents["port"], scored_constituents["jax"]
    np.testing.assert_allclose(got["score_MAE"], want["score_MAE"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["score_Latent"], want["score_Latent"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["score_EMD"], want["score_EMD"], rtol=1e-4, atol=1e-5)


def test_constituents_cli_shards_emd_and_ksd_over_ranks(scored_constituents):
    """--n_devices 2 on the CPU: two gloo ranks split EMD's and KSD's jet
    axis, rank 0 writes the file: the one-device scores, EMD at
    tests/test_emd.py:151's rtol 1e-5 / atol 1e-7, the rest equal."""
    got, want = scored_constituents["ranked"], scored_constituents["port"]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["score_EMD"], want["score_EMD"], rtol=1e-5, atol=1e-7)
    for key in sorted(set(want) - {"score_EMD"}):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_constituents_cli_ksd_matches_but_for_flipped_near_ties(scored_constituents):
    """score_KSD is a count of sorted positions over 60: atol 1e-6, except
    where a true and a predicted value lie so close that the frameworks'
    rounding of the prediction sorts them the other way round, which moves
    the statistic by one step of 1/60.  Such jets are counted and bounded:
    under 1% of them, none by more than one step."""
    got, want = scored_constituents["port"]["score_KSD"], scored_constituents["jax"]["score_KSD"]
    gap = np.abs(got - want)
    flipped = gap > 1e-6
    assert flipped.mean() < 0.01, flipped.sum()
    assert gap.max() <= 1 / 60 + 1e-6, gap.max()


def test_cli_without_h5py_writes_the_same_file(tmp_path, monkeypatch, model):
    """Where h5py is missing the port reads and writes HDF5 itself; the
    scores are the same as through h5py."""
    monkeypatch.setattr(hdf5, "_h5py", None)
    ensure_synthetic_registry(tmp_path, n_events=1200, n_const_max=12,
                              names=["QCD-Geneva"], seed=3)
    data = str(tmp_path / QCD)
    jax_save_weights(model[0], tmp_path / "model.npz")
    args = ["--data", data, "--model_in", str(tmp_path / "model.npz"), "--metrics", "MAE",
            "Latent", "KLD", "--chunk", "500", "--device", "cpu"]
    score.main(args + ["--output", str(tmp_path / "lite.h5")])
    monkeypatch.undo()
    score.main(args + ["--output", str(tmp_path / "h5py.h5")])
    import h5py
    with h5py.File(tmp_path / "lite.h5", "r") as lite, h5py.File(tmp_path / "h5py.h5") as ref:
        assert sorted(lite) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(lite[key][()], ref[key][()])
        assert len(ref["m"]) == 1200


def test_cli_refuses_aae_and_missing_cuda(tmp_path):
    """The default device is the card, with no fall-back to the CPU (the
    AAE's scoring is held to the JAX CLI's in tests/test_torch_cli_aae.py)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            score.main(["--data", "x", "--model_in", "y"])
