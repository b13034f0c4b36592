#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (atlasvae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- require CUDA, print the card's name and power limit, turn
               TF32 off so every plain reference runs in full float32;
2. build    -- compile the hand-written kernels (csrc/*.cu) with nvcc,
               one process per source, all started together;
3. parity   -- hold each kernel against its plain PyTorch version at the
               scoring path's shape (65,536-row chunks of the canonical
               12->80/40/20/10 VAE), at the training batch (10,000 rows;
               the forward kernel as encoder and as one-head decoder at
               both) and at B = 1,000,003 rows (a ragged tile) for the
               canonical and the constituents-mode 312->256/128/64/32
               stacks, and the backward kernel at the training batch and
               1,000,003 rows; time
               kernel, plain version, a torch.addmm/relu chain (library
               yardstick: its forward, or autograd through it) and the
               bound;
4. slice    -- score a 200k-jet synthetic sample end to end through
               atlasvae_torch.cli.score with the launch counters set to 0
               just before; check rows, finiteness, that both kernels ran,
               and MAE/Latent against the plain CPU path on the first jets;
               then time a warm run and profile a third (device busy share);
5. train    -- train the canonical OE-VAE (vae.sh hyper-parameters, 3
               epochs of 1e5 jets in batches of 1e4) through
               atlasvae_torch.cli.vae with the counters set to 0 just
               before; check the history, the weights and that K2 and K3
               ran; time a warm run (epochs 2-3), profile one epoch, hold
               the CUDA path against the plain CPU path (first-step
               gradients, 2-epoch losses with injected noise), and score
               the trained weights through atlasvae_torch.cli.score;
6. kernels  -- one JSON line with every ported kernel;
7. last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores and HBM3 bandwidth.  Bounds are stated against these.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

ATOL = 1e-5
RTOL = 1e-5
SLICE_EVENTS = 200_000
SLICE_CHUNK = 65_536
BIG_B = 1_000_003
REF_ROWS = 4096

KERNELS = {
    "fused_mlp": dict(source="atlasvae_torch/csrc/fused_mlp.cu",
                      replaces="atlasvae/ops/fused_mlp.py:42",
                      main_shape="slice decoder"),
    "stack_forward": dict(source="atlasvae_torch/csrc/fused_vae.cu",
                          replaces="atlasvae/ops/fused_vae.py:71",
                          main_shape="slice encoder"),
    "stack_backward": dict(source="atlasvae_torch/csrc/fused_vae_bwd.cu",
                           replaces="atlasvae/ops/fused_vae.py:130",
                           main_shape="train encoder"),
}

# Training: the canonical model with the vae.sh hyper-parameters, cut to
# 3 epochs of 1e5 jets (200,000 synthetic events per sample).
TRAIN_EVENTS = 200_000
TRAIN_BATCH = 10_000
TRAIN_EPOCHS = 3
TRAIN_ARGS = ["--n_train", "1e5", "--n_valid", "5e4", "--n_OoD", "2e5",
              "--batch_size", "1e4", "--n_epochs", str(TRAIN_EPOCHS), "--lr", "1e-3",
              "--beta", "2", "--lamb", "5", "--OE_type", "MAE", "--weight_type", "X-S",
              "--HLV_scaler_type", "RobustScaler", "--plotting", "OFF",
              "--apply_cuts", "OFF"]
GRAD_SCALE_TOL = 3e-4   # per dW/db leaf, times the leaf's largest |value|
TRAIN_REL_TOL = 1e-4    # per-epoch losses, CUDA path vs plain CPU path


def counters():
    from atlasvae_torch.ops import fused_mlp, fused_vae
    return {"fused_mlp": fused_mlp.launches, "stack_forward": fused_vae.launches,
            "stack_backward": fused_vae.backward_launches}


def reset_counters():
    from atlasvae_torch.ops import fused_mlp, fused_vae
    fused_mlp.launches = fused_vae.launches = fused_vae.backward_launches = 0


def log(phase, **facts):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in facts.items()), flush=True)


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stack_pairs(params, role):
    """(hidden, heads) (w, b) pairs of the encoder or the decoder."""
    part = params[role]
    hidden = [(l["w"], l["b"]) for l in part["hidden"]]
    if role == "encoder":
        return hidden, [(part["mean"]["w"], part["mean"]["b"]),
                        (part["logvar"]["w"], part["logvar"]["b"])]
    return hidden, [(part["out"]["w"], part["out"]["b"])]


def bound(batch, d0, hidden, heads):
    """Least time (ms) for one call and what bounds it: each input read
    once, each output written once, 2*K*N + N FLOP per row and layer."""
    layers = list(hidden) + list(heads)
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    out_cols = sum(w.shape[1] for w, _ in heads)
    nbytes = 4 * (batch * d0 + n_params + batch * out_cols)
    flops = batch * sum(2 * w.shape[0] * w.shape[1] + w.shape[1] for w, _ in layers)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def bound_backward(batch, d0, hidden, heads, want_dx):
    """Least time (ms) for one backward call and what bounds it: x, the
    head gradients and the parameters read once, the gradients (and dx)
    written once; per row the forward recompute, dW (2*K*N), db, the ReLU
    masks and g @ W^T (2*K*N) for every layer but the input one unless dx
    is wanted."""
    layers = list(hidden) + list(heads)
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    head_cols = sum(w.shape[1] for w, _ in heads)
    nbytes = 4 * (batch * d0 + batch * head_cols + 2 * n_params + (batch * d0 if want_dx else 0))
    per_row = sum(2 * w.shape[0] * w.shape[1] + 2 * w.shape[1] for w, _ in hidden)  # recompute, mask
    per_row += sum(2 * w.shape[0] * w.shape[1] + w.shape[1] for w, _ in layers)     # dW, db
    per_row += sum(2 * w.shape[0] * w.shape[1] for i, (w, _) in enumerate(layers)
                   if i > 0 or want_dx)                                            # g @ W^T
    flops = batch * per_row
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def parity_backward(params, role, x, gen):
    """K3 vs its plain version on the same inputs and head gradients (a
    mean-loss scale, N(0, 1) / B); timings, autograd yardstick and bound."""
    import torch
    from atlasvae_torch.ops import fused_vae
    hidden, heads = stack_pairs(params, role)
    want_dx = role == "decoder"
    batch = x.shape[0]
    grads = [torch.randn((batch, w.shape[1]), generator=gen, device=x.device) / batch
             for w, _ in heads]
    kernel = lambda: fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    plain = lambda: fused_vae.stack_backward_plain(x, hidden, heads, grads, want_dx)

    def library():
        leaves = [t.detach().requires_grad_() for pair in hidden + heads for t in pair]
        xin = x.detach().requires_grad_(want_dx)
        h = xin
        for i in range(len(hidden)):
            h = torch.relu(torch.addmm(leaves[2 * i + 1], h, leaves[2 * i]))
        outs = [torch.addmm(leaves[2 * k + 1], h, leaves[2 * k])
                for k in range(len(hidden), len(hidden) + len(heads))]
        return torch.autograd.grad(outs, leaves + ([xin] if want_dx else []), grads)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, rel, ok = 0.0, 0.0, True
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        diff = float((g - w).abs().max())
        scale = float(w.abs().max())
        err, rel = max(err, diff), max(rel, diff / scale if scale > 0 else diff)
        ok &= diff <= GRAD_SCALE_TOL * scale and bool(torch.isfinite(g).all())
    if want_dx:
        diff = (got[2] - want[2]).abs()
        err = max(err, float(diff.max()))
        ok &= bool((diff <= ATOL + RTOL * want[2].abs()).all())
    b_ms, b_by, flops, nbytes = bound_backward(batch, x.shape[1], hidden, heads, want_dx)
    iters = 50 if batch < BIG_B else 10
    res = dict(batch=batch, widths=[x.shape[1]] + [w.shape[1] for w, _ in hidden]
               + [sum(w.shape[1] for w, _ in heads)], want_dx=want_dx, max_abs_err=err,
               max_err_over_leaf_scale=rel, ms=time_ms(kernel, iters),
               plain_ms=time_ms(plain, iters), library_ms=time_ms(library, iters),
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    if not ok:
        raise AssertionError(f"stack_backward disagrees with its plain version at {res}: "
                             f"dW/db leaf over {GRAD_SCALE_TOL}*max|leaf| or dx over "
                             f"atol {ATOL} + rtol {RTOL}*|ref|")
    return res


def parity(name, params, role, x):
    """Kernel vs plain version on the same inputs; timings and bound."""
    import torch
    from atlasvae_torch.ops import fused_mlp, fused_vae
    hidden, heads = stack_pairs(params, role)
    if name == "fused_mlp":
        layers = [{"w": w, "b": b} for w, b in hidden + heads]
        kernel = lambda: (fused_mlp.fused_mlp_apply(layers, x),)
        plain = lambda: (fused_mlp.fused_mlp_plain(layers, x),)
    else:
        kernel = lambda: fused_vae.stack_forward(x, hidden, heads)
        plain = lambda: fused_vae.stack_forward_plain(x, hidden, heads)

    def library():
        h = x
        for w, b in hidden:
            h = torch.relu(torch.addmm(b, h, w))
        return tuple(torch.addmm(b, h, w) for w, b in heads)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for g, w in zip(got, want):
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        ok &= bool((diff <= ATOL + RTOL * w.abs()).all()) and bool(torch.isfinite(g).all())
    b_ms, b_by, flops, nbytes = bound(x.shape[0], x.shape[1], hidden, heads)
    iters = 50 if x.shape[0] < BIG_B else 20
    res = dict(batch=x.shape[0], widths=[x.shape[1]] + [w.shape[1] for w, _ in hidden]
               + [sum(w.shape[1] for w, _ in heads)], max_abs_err=err,
               ms=time_ms(kernel, iters), plain_ms=time_ms(plain, iters),
               library_ms=time_ms(library, iters), bound_ms=b_ms, bound_by=b_by,
               flops=flops, bytes=nbytes)
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {res}: "
                             f"max abs err {err} > atol {ATOL} + rtol {RTOL}*|ref|")
    return res


def phase_device():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print(smi, flush=True)
    return smi


def phase_build():
    from atlasvae_torch.ops import cuda_build
    start = time.perf_counter()
    report = cuda_build.build()
    for name, (path, secs, ptxas) in report.items():
        usage = [l.split("info    :")[-1].strip() for l in ptxas.splitlines()
                 if "registers" in l or "spill" in l]
        log("build", lib=path.name, nvcc_s=f"{secs:.2f}", ptxas=json.dumps(usage))
    log("build", total_s=f"{time.perf_counter() - start:.2f}")


def phase_parity(device):
    import torch
    from atlasvae_torch.models import VAEConfig, init_vae
    gen = torch.Generator(device).manual_seed(1234)
    configs = {
        "slice": (VAEConfig(), SLICE_CHUNK),
        "train": (VAEConfig(), TRAIN_BATCH),
        "canonical": (VAEConfig(), BIG_B),
        "constituents": (VAEConfig(fc_layers=(256, 128, 64, 32), input_dim=312), BIG_B),
    }
    # K1 runs the decoder (scoring); K2 runs the encoder on both paths and
    # the decoder (one head) in training, so at the scoring chunk and the
    # training batch it is held in both roles, beside K1 on the same decoder
    fwd = {"canonical": (("fused_mlp", "decoder"), ("stack_forward", "encoder"))}
    fwd["constituents"] = fwd["canonical"]
    fwd["slice"] = fwd["train"] = fwd["canonical"] + (("stack_forward", "decoder"),)
    results = {name: [] for name in KERNELS}
    for shape, (cfg, batch) in configs.items():
        params = init_vae(gen, cfg, device=device)
        x = torch.randn((batch, cfg.input_dim), generator=gen, device=device)
        z = torch.randn((batch, cfg.fc_layers[-1]), generator=gen, device=device)
        with torch.inference_mode():
            for name, role in fwd[shape]:
                res = parity(name, params, role, x if role == "encoder" else z)
                res["shape"] = f"{shape} {role}"
                results[name].append(res)
                log("parity", kernel=name, shape=res["shape"], batch=batch, widths=res["widths"],
                    max_abs_err=f"{res['max_abs_err']:.3g}", ms=f"{res['ms']:.4f}",
                    plain_ms=f"{res['plain_ms']:.4f}", library_ms=f"{res['library_ms']:.4f}",
                    bound_ms=f"{res['bound_ms']:.4f}", bound_by=res["bound_by"],
                    tflops=f"{res['tflops']:.2f}")
        del params, x, z
        torch.cuda.empty_cache()
    # K3 at the training batch and at 1,000,003 rows: the canonical encoder
    # (two heads, no dx) and decoder (one head, dx); constituents encoder
    bwd_configs = [("train", VAEConfig(), TRAIN_BATCH, ("encoder", "decoder")),
                   ("canonical", VAEConfig(), BIG_B, ("encoder", "decoder")),
                   ("constituents", VAEConfig(fc_layers=(256, 128, 64, 32), input_dim=312),
                    BIG_B, ("encoder",))]
    for shape, cfg, batch, roles in bwd_configs:
        params = init_vae(gen, cfg, device=device)
        for role in roles:
            width = cfg.input_dim if role == "encoder" else cfg.fc_layers[-1]
            x = torch.randn((batch, width), generator=gen, device=device)
            res = parity_backward(params, role, x, gen)
            res["shape"] = f"{shape} {role}"
            results["stack_backward"].append(res)
            log("parity", kernel="stack_backward", shape=res["shape"], batch=batch,
                widths=res["widths"], want_dx=res["want_dx"],
                max_abs_err=f"{res['max_abs_err']:.3g}",
                max_err_over_leaf_scale=f"{res['max_err_over_leaf_scale']:.3g}",
                ms=f"{res['ms']:.4f}", plain_ms=f"{res['plain_ms']:.4f}",
                library_ms=f"{res['library_ms']:.4f}", bound_ms=f"{res['bound_ms']:.4f}",
                bound_by=res["bound_by"], tflops=f"{res['tflops']:.2f}")
            del x
        del params
        torch.cuda.empty_cache()
    return results


def profile_slice(run, phase="profile"):
    """A profiled run of a path: device busy share of the wall time, and
    the device time of the busiest kernels.  Returns the idle share.

    Busy time sums the device-side events only (kernels, copies, memsets):
    a host operator's own device time repeats the time of the kernels it
    launched, so it is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and dev > 0:
            rows.append((dev, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log(phase, wall_ms=f"{wall_us / 1e3:.2f}", device_busy_ms=f"{busy_us / 1e3:.3f}",
        idle_share=f"{1 - busy_us / wall_us:.4f}", device_events=sum(r[2] for r in rows),
        top=json.dumps([(k[:60], n, round(d / 1e3, 4)) for d, k, n in rows[:8]]))
    return 1 - busy_us / wall_us


def phase_slice(device, workdir):
    import numpy as np
    import torch
    from atlasvae_torch.cli import score
    from atlasvae_torch.data import (ensure_synthetic_registry, load_data, fit_scaler,
                                     apply_scaler, hdf5, Scaler)
    from atlasvae_torch.eval import compute_metric_bank
    from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
    from atlasvae_torch.train.checkpoint import save_pytree, load_pytree

    t0 = time.perf_counter()
    ensure_synthetic_registry(workdir, n_events=SLICE_EVENTS, n_const_max=20,
                              names=["QCD-Geneva"], seed=0)
    qcd = load_data("QCD-Geneva", SLICE_EVENTS, verbose=False, device=device)
    scaler_path = os.path.join(workdir, "HLV_RobustScaler.pkl")
    fit_scaler(qcd["HLVs"], scaler_out=scaler_path, scaler_type="RobustScaler",
               verbose=False)
    model_path = os.path.join(workdir, "model.npz")
    save_pytree(model_path, init_vae(torch.Generator(device).manual_seed(7), VAEConfig(),
                                     device=device))
    out_path = os.path.join(workdir, "scores.h5")
    log("slice", setup_s=f"{time.perf_counter() - t0:.2f}", events=SLICE_EVENTS)

    metrics = ["MAE", "Latent", "KLD", "JSD"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run(output):
        score.main(["--data", "QCD-Geneva", "--model_in", model_path,
                    "--HLV_scaler_in", scaler_path, "--metrics", *metrics,
                    "--chunk", str(SLICE_CHUNK), "--output", output, "--device", str(device)])
        sync()

    reset_counters()
    sync()
    t0 = time.perf_counter()
    run(out_path)
    cold_s = time.perf_counter() - t0
    launches = counters()

    with hdf5.File(out_path, "r") as f:
        got = {k: f[k][:] for k in f}
    want_keys = {f"score_{m}" for m in metrics} | {"m", "pt", "weights"}
    if set(got) != want_keys:
        raise AssertionError(f"output keys {sorted(got)} != {sorted(want_keys)}")
    for key, val in got.items():
        if val.shape != (SLICE_EVENTS,) or not np.isfinite(val).all():
            raise AssertionError(f"{key}: shape {val.shape}, finite {np.isfinite(val).all()}")

    # reference: the plain CPU path on the first jets, with the latent noise
    # the scorer drew for its first chunk (CUDA generator seeded 0)
    cpu = torch.device("cpu")
    sample = load_data("QCD-Geneva", REF_ROWS, verbose=False, device=cpu)
    x = apply_scaler(torch.as_tensor(sample["HLVs"]), 3, Scaler.load(scaler_path),
                     verbose=False)
    params = load_pytree(model_path, init_vae(torch.Generator().manual_seed(0), VAEConfig(),
                                              device=cpu))
    noise = torch.randn((SLICE_CHUNK, 10), generator=torch.Generator(device).manual_seed(0),
                        device=device)[:REF_ROWS].cpu()
    with torch.inference_mode():
        x_pred = vae_apply(params, x, noise=noise)[0]
        ref = compute_metric_bank(x, x_pred, params, ("MAE", "Latent"),
                                  normal_losses=False, device=cpu)
    ref_err = {}
    for m in ("MAE", "Latent"):
        a, b = got[f"score_{m}"][:REF_ROWS], ref[m]
        ref_err[m] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-3)))
        if not np.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"score_{m} differs from the plain CPU path: "
                                 f"max rel err {ref_err[m]}")
    for name in ("fused_mlp", "stack_forward"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the scoring path")

    # the same slice again, warm (file in the page cache, CUDA modules
    # loaded), then once more under the profiler
    t0 = time.perf_counter()
    run(os.path.join(workdir, "scores_warm.h5"))
    warm_s = time.perf_counter() - t0
    if device.type == "cuda":
        profile_slice(lambda: run(os.path.join(workdir, "scores_profiled.h5")))
    rate = SLICE_EVENTS / warm_s
    log("slice", jets=SLICE_EVENTS, cold_s=f"{cold_s:.4f}",
        cold_jets_per_s=f"{SLICE_EVENTS / cold_s:.0f}", warm_s=f"{warm_s:.4f}",
        warm_jets_per_s=f"{rate:.0f}", launches=json.dumps(launches),
        ref_rel_err=json.dumps(ref_err))
    return launches, rate


class _Stamped(list):
    """A list of loads that notes the time (after a device sync) and the
    launch counters each time train_model starts iterating it."""

    def __init__(self, loads, stamps, tag):
        super().__init__(loads)
        self.stamps, self.tag = stamps, tag

    def __iter__(self):
        import torch
        torch.cuda.synchronize()
        self.stamps.append((self.tag, time.perf_counter(), counters()))
        return super().__iter__()


def _train_parity(load, device):
    """The CUDA training path against the plain CPU path on the first 5
    batches of a load: first-step gradients per leaf, and 2 epochs of
    losses with one injected noise stream."""
    import numpy as np
    import torch
    from atlasvae_torch.losses import get_losses
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.train import train_model
    from atlasvae_torch.train.checkpoint import tree_flatten, tree_map
    from atlasvae_torch.train.loop import features

    n = 5 * TRAIN_BATCH
    bkg, ood = load
    small = ({"HLVs": features(bkg)[:n], "weights": bkg["weights"][:n]},
             {"HLVs": features(ood)[:n], "weights": ood["weights"][:n]})
    rng = np.random.default_rng(5)
    noise = {(phase, e): (rng.standard_normal((nb, TRAIN_BATCH if phase == "train" else n, 10))
                          .astype(np.float32),
                          rng.standard_normal((nb, TRAIN_BATCH if phase == "train" else n, 10))
                          .astype(np.float32))
             for e in range(2) for phase, nb in (("train", 5), ("valid", 1))}
    source = lambda phase, epoch, load_idx, n_batches, batch: noise[(phase, epoch)]
    cpu = torch.device("cpu")
    init = init_vae(torch.Generator().manual_seed(21), VAEConfig(), device=cpu)
    on = {d: tree_map(lambda t, d=d: t.detach().to(d).requires_grad_(), init)
          for d in (cpu, device)}

    # first step's gradients
    grads = {}
    for d, params in on.items():
        x = lambda k, side: torch.as_tensor(side[k][:TRAIN_BATCH]).to(d)
        nz = tuple(torch.as_tensor(a[0]).to(d) for a in noise[("train", 0)])
        total = get_losses(params, x("HLVs", small[0]), x("HLVs", small[1]),
                           x("weights", small[0]), x("weights", small[1]), None, "MAE",
                           2.0, 5.0, 1.0, noise=nz)[3].sum()
        leaves = tree_flatten(params)
        grads[d] = [g.cpu() for g in torch.autograd.grad(total, leaves)]
    grad_rel = 0.0
    for g_dev, g_cpu in zip(grads[device], grads[cpu]):
        scale = float(g_cpu.abs().max())
        diff = float((g_dev - g_cpu).abs().max())
        grad_rel = max(grad_rel, diff / scale if scale > 0 else diff)
        if diff > GRAD_SCALE_TOL * scale:
            raise AssertionError(f"first-step gradient leaf differs: {diff} > "
                                 f"{GRAD_SCALE_TOL} * {scale}")

    hists = {}
    for d in (cpu, device):
        _, hists[d] = train_model(tree_map(lambda t, d=d: t.detach().to(d), init),
                                  [small], [small], "MAE", 2, TRAIN_BATCH, 2.0, 5.0, 1.0,
                                  1e-3, noise_source=source)
    loss_rel = 0.0
    for key, want in hists[cpu].items():
        got = np.asarray(hists[device][key])
        want = np.asarray(want)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        loss_rel = max(loss_rel, rel)
        if not rel <= TRAIN_REL_TOL:
            raise AssertionError(f"{key}: CUDA {got} vs CPU {want}, rel {rel} > {TRAIN_REL_TOL}")
    return grad_rel, loss_rel


def phase_train(device, workdir):
    """Train the canonical OE-VAE through the CLI, then time, profile,
    check against the plain CPU path, and score the result."""
    import pickle
    import numpy as np
    import torch
    from atlasvae_torch.cli import score, vae as cli_vae
    from atlasvae_torch.data import ensure_synthetic_registry, hdf5
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.train import train_model, load_pytree

    ensure_synthetic_registry(workdir, n_events=TRAIN_EVENTS, n_const_max=20,
                              names=["QCD-Geneva", "OoD-H"], seed=0)
    out_dir = os.path.join(workdir, "train")
    args = TRAIN_ARGS + ["--output_dir", out_dir, "--device", str(device)]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_vae.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = counters()
    for name in ("stack_forward", "stack_backward"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    with open(os.path.join(out_dir, "history.pkl"), "rb") as f:
        history = pickle.load(f)
    for key, vals in history.items():
        if len(vals) != TRAIN_EPOCHS or not np.isfinite(vals).all():
            raise AssertionError(f"history[{key!r}] = {vals}: want {TRAIN_EPOCHS} finite epochs")
    model_path = os.path.join(out_dir, "model.npz")
    template = init_vae(torch.Generator(device).manual_seed(0), VAEConfig(), device=device)
    load_pytree(model_path, template)
    log("train", cli_s=f"{cli_s:.3f}", launches=json.dumps(launches),
        history=json.dumps(history))

    # the same data, prepared once, for a timed warm run and a profile
    parsed = cli_vae.build_parser().parse_args(args)
    cli_vae._wire_paths(parsed)
    hlv_list, _, train_cuts, _ = cli_vae._select_samples(parsed)
    train_gen, valid_gen, _, _ = cli_vae._make_generators(parsed, hlv_list, train_cuts,
                                                          None, None)
    load, vload = train_gen[0], valid_gen[0]
    jets = len(load[0]["weights"])
    steps = -(-jets // TRAIN_BATCH)
    stamps = []
    params = init_vae(torch.Generator(device).manual_seed(0), VAEConfig(), device=device)
    timed_dir = os.path.join(workdir, "timed")
    os.makedirs(timed_dir)
    reset_counters()
    train_model(params, _Stamped([load], stamps, "train"), _Stamped([vload], stamps, "valid"),
                "MAE", TRAIN_EPOCHS, TRAIN_BATCH, 2.0, 5.0, 1.0, 1e-3,
                hist_file=os.path.join(timed_dir, "history.pkl"),
                model_out=os.path.join(timed_dir, "model.npz"))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    # training part of epoch e: from its "train" stamp to its "valid" stamp;
    # the whole epoch (validation, history and checkpoint too) to the next
    # epoch's "train" stamp, the last one to the return of train_model
    spans = [(stamps[2 * e][1], stamps[2 * e + 1][1], stamps[2 * e][2], stamps[2 * e + 1][2])
             for e in range(TRAIN_EPOCHS)]
    warm_s = sum(t1 - t0 for t0, t1, _, _ in spans[1:])
    warm_rate = jets * (TRAIN_EPOCHS - 1) / warm_s
    epoch_s = (t_end - stamps[2][1]) / (TRAIN_EPOCHS - 1)
    per_step = {name: (spans[-1][3][name] - spans[-1][2][name]) / steps for name in launches}
    idle = profile_slice(lambda: (train_model(params, [load], [vload], "MAE", 1, TRAIN_BATCH,
                                              2.0, 5.0, 1.0, 1e-3), torch.cuda.synchronize()),
                         phase="train profile")
    grad_rel, loss_rel = _train_parity(load, device)

    # the two paths meet: score the trained weights through cli.score
    scores = os.path.join(workdir, "train_scores.h5")
    score.main(["--data", "QCD-Geneva", "--model_in", model_path, "--HLV_scaler_in",
                os.path.join(out_dir, "HLV_RobustScaler.pkl"), "--metrics", "MAE", "Latent",
                "--chunk", str(SLICE_CHUNK), "--output", scores, "--device", str(device)])
    with hdf5.File(scores, "r") as f:
        mae = f["score_MAE"][:]
    if mae.shape != (TRAIN_EVENTS,) or not np.isfinite(mae).all():
        raise AssertionError(f"scores of the trained model: shape {mae.shape}, "
                             f"finite {np.isfinite(mae).all()}")
    facts = dict(jets_per_epoch=jets, steps_per_epoch=steps,
                 warm_jets_per_s=warm_rate, ms_per_step=warm_s / (steps * (TRAIN_EPOCHS - 1)) * 1e3,
                 warm_epoch_s=epoch_s, warm_epoch_jets_per_s=jets / epoch_s,
                 launches_per_step=per_step, idle_share=idle, grad_rel=grad_rel,
                 loss_rel=loss_rel, scored_mae_mean=float(mae.mean()))
    log("train", **{k: (json.dumps(v) if isinstance(v, dict) else v) for k, v in facts.items()})
    return launches, facts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import atlasvae_torch  # noqa: F401  (fails outside a checkout of the repo)
    smi = phase_device()
    device = torch.device("cuda")
    phase_build()
    parity_results = phase_parity(device)
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        slice_launches, rate = phase_slice(device, workdir)
        train_launches, train = phase_train(device, workdir)

    kernels = []
    for name, meta in KERNELS.items():
        main_shape = next(r for r in parity_results[name] if r["shape"] == meta["main_shape"])
        by_phase = {"slice": slice_launches[name], "train": train_launches[name]}
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            max_abs_err=max(r["max_abs_err"] for r in parity_results[name]),
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
            phases=["parity"] + [p for p, n in by_phase.items() if n > 0],
            shapes=parity_results[name]))
    log("kernels", card=json.dumps(smi), slice_jets_per_s=f"{rate:.0f}",
        train_jets_per_s=f"{train['warm_jets_per_s']:.0f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
