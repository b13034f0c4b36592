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
               12->80/40/20/10 VAE) and at B = 1,000,003 rows (a ragged
               tile) for the canonical and the constituents-mode
               312->256/128/64/32 stacks; time kernel, plain version, a
               torch.addmm/relu chain (library yardstick) and the bound;
4. slice    -- score a 200k-jet synthetic sample end to end through
               atlasvae_torch.cli.score with the launch counters set to 0
               just before; check rows, finiteness, that both kernels ran,
               and MAE/Latent against the plain CPU path on the first jets;
               then time a warm run and profile a third (device busy share);
5. kernels  -- one JSON line with every ported kernel;
6. last line: {"ok": true, "device": {...}}.

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
                      role="decoder"),
    "stack_forward": dict(source="atlasvae_torch/csrc/fused_vae.cu",
                          replaces="atlasvae/ops/fused_vae.py:71",
                          role="encoder"),
}


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
        "canonical": (VAEConfig(), BIG_B),
        "constituents": (VAEConfig(fc_layers=(256, 128, 64, 32), input_dim=312), BIG_B),
    }
    results = {name: [] for name in KERNELS}
    for shape, (cfg, batch) in configs.items():
        params = init_vae(gen, cfg, device=device)
        x = torch.randn((batch, cfg.input_dim), generator=gen, device=device)
        z = torch.randn((batch, cfg.fc_layers[-1]), generator=gen, device=device)
        with torch.inference_mode():
            for name, meta in KERNELS.items():
                res = parity(name, params, meta["role"], x if meta["role"] == "encoder" else z)
                res["shape"] = shape
                results[name].append(res)
                log("parity", kernel=name, shape=shape, batch=batch, widths=res["widths"],
                    max_abs_err=f"{res['max_abs_err']:.3g}", ms=f"{res['ms']:.4f}",
                    plain_ms=f"{res['plain_ms']:.4f}", library_ms=f"{res['library_ms']:.4f}",
                    bound_ms=f"{res['bound_ms']:.4f}", bound_by=res["bound_by"],
                    tflops=f"{res['tflops']:.2f}")
        del params, x, z
        torch.cuda.empty_cache()
    return results


def profile_slice(run):
    """A second, profiled run of the slice: device busy share of the wall
    time, and the device time of the busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        dev = getattr(e, "self_cuda_time_total", 0) if dev is None else dev
        if dev > 0:
            rows.append((dev, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log("profile", wall_ms=f"{wall_us / 1e3:.2f}", device_busy_ms=f"{busy_us / 1e3:.3f}",
        idle_share=f"{1 - busy_us / wall_us:.4f}",
        top=json.dumps([(k[:60], n, round(d / 1e3, 4)) for d, k, n in rows[:8]]))


def phase_slice(device, workdir):
    import numpy as np
    import torch
    from atlasvae_torch.cli import score
    from atlasvae_torch.data import (ensure_synthetic_registry, load_data, fit_scaler,
                                     apply_scaler, hdf5, Scaler)
    from atlasvae_torch.eval import compute_metric_bank
    from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
    from atlasvae_torch.ops import fused_mlp, fused_vae
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

    fused_mlp.launches = 0
    fused_vae.launches = 0
    sync()
    t0 = time.perf_counter()
    run(out_path)
    cold_s = time.perf_counter() - t0
    launches = {"fused_mlp": fused_mlp.launches, "stack_forward": fused_vae.launches}

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
    for name, count in launches.items():
        if count <= 0:
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
        launches, rate = phase_slice(device, workdir)

    kernels = []
    for name, meta in KERNELS.items():
        main_shape = next(r for r in parity_results[name] if r["shape"] == "slice")
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in parity_results[name]),
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"], phases=["parity", "slice"],
            shapes=parity_results[name]))
    log("kernels", card=json.dumps(smi), slice_jets_per_s=f"{rate:.0f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
