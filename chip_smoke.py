#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (atlasvae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- require CUDA, print the card's name and power limit, turn
               TF32 off so every plain reference runs in full float32; say
               whether matplotlib, h5py and scipy import here;
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
               bound; the forward kernels also at the constituents-mode
               scoring chunk (65,536 x 300->256/128/64/32); the Sinkhorn
               EMD kernel against its plain version at (8192, 100),
               (65,536, 20), (1,000, 128) and at the scoring path's chunk
               (13,421, 100), 100 iterations, and at 20 iterations on a
               permuted copy (true EMD 0) and on a far transport at
               (8192, 100) and (1,000, 233), the widest jet it takes, each
               beside the plain version in float64, with the same bits
               asked of a second call (no PyTorch call computes a staged
               Sinkhorn, so it has no library yardstick); the fused conv
               block (K5) and its backward (K6) against their plain versions
               at the jet-ID training batch (5,000 x 16x16x1 -> 3x3, 100
               maps, pool 2x2), the predict chunk (20,000), a ragged batch,
               the reference's default tower (500 x 64x64x1) and the odd
               shapes of the CPU tests (two channels, pools of 3 and 4 with
               a low pad, 130 maps) on dense and on sparse, tied images,
               with the same bits asked of a second call, beside cuDNN's
               conv + max_pool2d + relu (autograd through it for K6);
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
6. emd_slice -- constituents mode at full width: 65,536 synthetic QCD and
               65,536 synthetic signal jets of 100 constituents, a
               RobustScaler fitted on the constituents, a seeded
               300->256/128/64/32 VAE, scored through atlasvae_torch.cli.score
               with MAE, Latent, KLD, JSD, EMD and KSD, the counters set to
               0 just before each file; check rows, finiteness, that the
               dense-stack and the EMD kernels ran (the EMD kernel 5 times
               a file), EMD and KSD against the plain CPU path on the first
               1,024 jets; print each metric's AUC (bkg against signal);
               then a warm timed run and a profiled run;
7. jetid    -- the jet-ID CNN at the CLI's default widths (16x16 image ->
               conv 3x3/100 -> pool -> conv 3x3/100 -> pool -> 900; scalars
               -> 200; trunk 200/200; softmax 2): train 3 epochs of 1e5 jets
               in batches of 5,000 through atlasvae_torch.cli.jetid on
               200,000-event synthetic files, the counters set to 0 just
               before; check the epochs' ticker, the files, the
               probabilities and that K5 ran once a training step,
               validation batch and predict chunk and K6 once a training
               step; then serve (--n_epochs 0 --model_in)
               in the same folder: the same probabilities, no K6, and the
               first 4,096 jets against the plain CPU path; accuracy, AUC
               and rejections (synthetic data: no physics result); CUDA
               against the plain CPU path at dropout 0 (first-step
               gradients, 2-epoch losses); a warm timed run and a profiled
               epoch;
8. kernels  -- one JSON line with every ported kernel;
9. last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

import contextlib
import io
import json
import os
import re
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

# Constituents-mode scoring: 100 (px, py, pz) constituents, the wide VAE.
EMD_EVENTS = 65_536
EMD_CONST = 100
EMD_LAYERS = (256, 128, 64, 32)
EMD_METRICS = ["MAE", "Latent", "KLD", "JSD", "EMD", "KSD"]
EMD_REF_ROWS = 1024
EMD_ITERS = 100
EMD_EPS = 0.01
EMD_STAGES = 10
EMD_RTOL, EMD_ATOL = 2e-5, 1e-6   # kernel vs plain version, same inputs, same card
EMD_MASS_TOL = 1e-5               # of min(sum pt), where the EMD is small beside it
EMD_FEW_ITERS = 20

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
    "emd_sinkhorn": dict(source="atlasvae_torch/csrc/emd_sinkhorn.cu",
                         replaces="atlasvae/ops/emd_pallas.py:45",
                         main_shape="emd_slice chunk"),
    "fused_conv": dict(source="atlasvae_torch/csrc/fused_conv.cu",
                       replaces="atlasvae/ops/fused_conv.py:112",
                       main_shape="jetid train batch sparse"),
    "fused_conv_backward": dict(source="atlasvae_torch/csrc/fused_conv_bwd.cu",
                                replaces="atlasvae/ops/fused_conv.py:130",
                                main_shape="jetid train batch sparse"),
}

# jet-ID: the CNN the CLI builds by default, on 200,000-event synthetic
# files, cut to 3 epochs of 1e5 jets.
JETID_EVENTS = 200_000
JETID_TRAIN = 100_000
JETID_BATCH = 5_000
JETID_CHUNK = 20_000      # predict_classifier's chunk
JETID_EPOCHS = 3
JETID_IMAGE = 16
JETID_ARGS = ["--NN_type", "CNN", "--mixed_precision", "OFF", "--plotting", "OFF",
              "--synthetic", str(JETID_EVENTS), "--n_train", "1e5", "--n_valid", "5e4",
              "--batch_size", "5e3"]
JETID_REF_ROWS = 4096
JETID_PARITY_BATCHES = 3
CONV_SHAPES = [
    # (name, N, H, W, C, kh, kw, M, pool)
    ("jetid train batch", JETID_BATCH, 16, 16, 1, 3, 3, 100, (2, 2)),
    ("jetid predict chunk", JETID_CHUNK, 16, 16, 1, 3, 3, 100, (2, 2)),
    ("ragged batch", 1037, 16, 16, 1, 3, 3, 100, (2, 2)),
    ("reference tower", 500, 64, 64, 1, 3, 3, 100, (2, 2)),
    ("5x16x16 10 maps", 5, 16, 16, 1, 3, 3, 10, (2, 2)),
    ("two channels pool 3", 3, 13, 11, 2, 3, 2, 7, (3, 3)),
    ("pool 3 low pad", 4, 10, 10, 1, 2, 2, 5, (3, 3)),
    ("130 maps", 2, 12, 9, 1, 3, 3, 130, (2, 2)),
    ("pool 4", 3, 9, 9, 1, 3, 3, 4, (4, 4)),
]
CONV_GRAD_TOL = 2e-4        # dW/db leaf over its largest value, at test sizes
CONV_GRAD_TOL_BIG = 3e-4    # at a thousand images and more
# CUDA against the CPU through the whole CNN: a batch has 12.5 million conv
# outputs behind a ReLU mask and a pool's argmax, and where one lies within
# float32 rounding of 0 or of its neighbour the two libraries' convolutions
# decide differently.  Each such element moves a tower leaf's gradient by one
# element's share, about 1e-3 of a bias gradient's largest value at 5,000
# jets; the dense leaves behind the towers do not see it.
JETID_CONV_GRAD_TOL = 3e-3
# ... and its 2-epoch loss series.  Adam's first steps move every weight by
# about lr whatever the size of its gradient, so an element whose gradient is
# rounding noise, or 0 on one side after such a flipped decision, parts by a
# whole step: the series part by about 1e-4 after 6 steps (the VAE's dense
# stacks have no such decisions and hold TRAIN_REL_TOL).
JETID_LOSS_REL_TOL = 1e-3

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
    from atlasvae_torch.ops import emd_cuda, fused_conv_cuda, fused_mlp, fused_vae
    return {"fused_mlp": fused_mlp.launches, "stack_forward": fused_vae.launches,
            "stack_backward": fused_vae.backward_launches,
            "emd_sinkhorn": emd_cuda.launches, "fused_conv": fused_conv_cuda.launches,
            "fused_conv_backward": fused_conv_cuda.backward_launches}


def reset_counters():
    from atlasvae_torch.ops import emd_cuda, fused_conv_cuda, fused_mlp, fused_vae
    fused_mlp.launches = fused_vae.launches = fused_vae.backward_launches = 0
    emd_cuda.launches = 0
    fused_conv_cuda.launches = fused_conv_cuda.backward_launches = 0


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


def bound_emd(batch, n, n_iters=EMD_ITERS):
    """Least time (ms) for one EMD call and what bounds it.  Bytes: the two
    (B, n, 3) clouds read once, one float a pair written.  Operations the
    function needs, per element of an n x n matrix: 4 a Sinkhorn iteration
    (two matrix-vector products, a multiply and an add per element each);
    c = 4 for each of the n_stages Gibbs kernels and the final plan (add,
    subtract, divide by eps, exp; a transcendental counts as one); the cost
    matrix once, 11 (two differences; the phi wrap of an add, a modulo and
    a subtract; two squares, an add, a square root, a division by R); and
    an epilogue of 13 (two masks, the row, column and two deficit sums with
    their two rescalings = 8, the rank-one term and the costed sum = 5).
    The kernel builds the cost matrix anew for every Gibbs kernel instead of
    keeping it: that is its design, not the function's work, and is not in
    the bound."""
    n_stages = max(1, min(EMD_STAGES, n_iters))
    nbytes = 4 * (2 * batch * n * 3 + batch)
    flops = batch * n * n * (4 * n_iters + 4 * (n_stages + 1) + 11 + 13)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def emd_clouds(gen, batch, n, device, kind="near"):
    """Jet pairs in (pt, y, phi): falling pt, zero-padded tails.

    near      the second cloud a distorted copy of the first with a tail of
              its own length (what a trained model's reconstruction is to
              its input); the total-pt difference carries most of the EMD.
    permuted  the second cloud is the first with its constituents in the
              reverse order: the true EMD is 0, so the result is all
              rounding and regularisation error, in units of the total pt.
    far       the first cloud's pt in the reverse order at positions about
              one unit of DeltaR away (what an untrained model's
              reconstruction is): equal totals, every bit of pt moved far.
    """
    import torch
    p = torch.zeros((batch, n, 3), device=device)
    p[..., 0] = -torch.log(torch.rand((batch, n), generator=gen, device=device).clamp_min(1e-6))
    p[..., 1:] = torch.randn((batch, n, 2), generator=gen, device=device) * 0.4
    slots = torch.arange(n, device=device)[None, :]
    live = torch.randint(max(1, int(0.5 * n)), n + 1, (batch, 1), generator=gen, device=device)
    p[(slots >= live).expand(batch, n)] = 0.0
    if kind == "permuted":
        return p.contiguous(), p.flip(1).contiguous()
    q = p.clone()
    if kind == "far":
        q[..., 1] += 0.8
        q[..., 2] -= 0.6
        q[..., 1:] += torch.randn((batch, n, 2), generator=gen, device=device) * 0.1
        q[..., 0] = p[..., 0].flip(1)
        return p.contiguous(), q.contiguous()
    q[..., 1:] += torch.randn((batch, n, 2), generator=gen, device=device) * 0.1
    q[..., 0] *= (1 + 0.1 * torch.randn((batch, n), generator=gen, device=device)).clamp_min(0.05)
    live = torch.randint(max(1, int(0.6 * n)), n + 1, (batch, 1), generator=gen, device=device)
    q[(slots >= live).expand(batch, n)] = 0.0
    return p.contiguous(), q.contiguous()


def parity_emd(gen, batch, n, device, kind="near", n_iters=EMD_ITERS):
    """K4 vs its plain version on the same clouds; the gap, both times, the
    bound, and the same bits on a second call.

    The EMD is transport * min(sum p, sum q) + |sum p - sum q|, and the
    float32 rounding of the transport term does not shrink with the
    transport: it is a few 1e-6 of the total pt however small the EMD.  So
    the `near` and `far` clouds are held to rtol + atol on the EMD, and
    the `permuted` clouds, whose EMD is small beside their pt, to rtol on
    the EMD plus EMD_MASS_TOL of min(sum p, sum q).  The plain
    version in float64 is the yardstick for both float32 forms."""
    import torch
    from atlasvae_torch.ops import emd, emd_cuda
    p, q = emd_clouds(gen, batch, n, device, kind)
    kernel = lambda: emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, EMD_EPS, EMD_STAGES)
    plain = lambda: emd._sinkhorn_emd(p, q, 1.0, n_iters, EMD_EPS, EMD_STAGES)
    got, want = kernel(), plain()
    again = kernel()
    exact = emd._sinkhorn_emd(p.double(), q.double(), 1.0, n_iters, EMD_EPS, EMD_STAGES)
    torch.cuda.synchronize()
    mass = torch.minimum(p[..., 0].clamp_min(0).sum(1), q[..., 0].clamp_min(0).sum(1))
    diff = (got - want).abs()
    rel = float((diff / want.abs().clamp_min(1e-12)).max())
    tol = EMD_RTOL * want.abs() + (EMD_MASS_TOL * mass if kind == "permuted" else EMD_ATOL)
    ok = bool((diff <= tol).all()) and bool(torch.isfinite(got).all())
    same_bits = bool(torch.equal(got, again))
    over_mass = lambda x, y: float(((x.double() - y.double()).abs() / mass.clamp_min(1e-12)).max())
    b_ms, b_by, flops, nbytes = bound_emd(batch, n, n_iters)
    res = dict(batch=batch, n_const=n, n_iters=n_iters, eps_final=EMD_EPS, clouds=kind,
               max_abs_err=float(diff.max()), max_rel_err=rel, same_bits=same_bits,
               mean_emd=float(exact.mean()), mean_mass=float(mass.mean()),
               err_over_mass=over_mass(got, want), kernel_vs_f64_over_mass=over_mass(got, exact),
               plain_vs_f64_over_mass=over_mass(want, exact),
               ms=time_ms(kernel, 10, 2), plain_ms=time_ms(plain, 3, 1), library_ms=None,
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
    del exact
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    res["jets_per_s"] = batch / (res["ms"] * 1e-3)
    # one iteration a stage: what the n_stages + 1 rebuilds of K and the
    # epilogue cost beside the iterations (9 in 10 of them left out)
    res["ms_one_iter_a_stage"] = time_ms(
        lambda: emd_cuda.emd_sinkhorn(p, q, 1.0, EMD_STAGES, EMD_EPS, EMD_STAGES), 10, 2)
    if not ok or not same_bits:
        raise AssertionError(f"emd_sinkhorn vs its plain version at {res}: gap over rtol "
                             f"{EMD_RTOL}*|ref| + " + (f"{EMD_MASS_TOL}*min(sum pt)" if kind == "permuted"
                                                       else f"atol {EMD_ATOL}")
                             + ", or a second call gave other bits")
    return res


def bound_conv(n, h, w, c, kh, kw, m, pool, backward):
    """Least time (ms) for one call of the fused conv block or its backward
    and what bounds it.  Forward: x, w, b read once, the pooled block written
    once; 2*K FLOP per conv pixel and map (K = kh*kw*C taps), a compare per
    conv pixel, a bias add and a clamp per pooled pixel.  Backward: x, w, b
    and g read, dW and db written; the same recompute and compares, the ReLU
    mask, and one FMA per pooled pixel, tap and map for dW plus an add for
    db (only the window's first maximum gets gradient)."""
    hc, wc = h - kh + 1, w - kw + 1
    ho, wo = -(-hc // pool[0]), -(-wc // pool[1])
    k = kh * kw * c
    conv_px, pooled_px = n * hc * wc * m, n * ho * wo * m
    flops = conv_px * (2 * k + 1) + 2 * pooled_px
    nbytes = 4 * (n * h * w * c + k * m + m + pooled_px)
    if backward:
        flops += pooled_px * (2 * k + 1)
        nbytes += 4 * (k * m + m)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def parity_conv(gen, shape, sparse, device):
    """K5 and K6 against their plain versions on the same inputs; the same
    bits on a second call; times of kernel, plain version and the library
    yardstick (cuDNN's conv2d, a -inf pad where XLA's SAME pool has one,
    max_pool2d and relu in NCHW views; autograd through it for K6); bounds."""
    import torch
    import torch.nn.functional as F
    from atlasvae_torch.ops import fused_conv, fused_conv_cuda
    from atlasvae_torch.ops.pooling import same_pad_lo
    name, n, h, wd, c, kh, kw, m, pool = shape
    x = torch.randn((n, h, wd, c), generator=gen, device=device)
    if sparse:   # jet images: a few lit pixels, so whole pool windows tie
        x = x.abs() * (torch.rand(x.shape, generator=gen, device=device) < 0.08)
    w = torch.randn((kh, kw, c, m), generator=gen, device=device) * 0.3
    b = torch.randn((m,), generator=gen, device=device) * 0.1
    want = fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    g = torch.randn(want.shape, generator=gen, device=device) / n

    pads = []
    for size, p in ((wd - kw + 1, pool[1]), (h - kh + 1, pool[0])):   # F.pad: last axis first
        lo, out = same_pad_lo(size, p)
        pads += [lo, out * p - size - lo]
    x_lib, w_lib = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    g_lib = g.permute(0, 3, 1, 2)

    def library(w_=w_lib, b_=b):
        z = F.conv2d(x_lib, w_, b_)
        if any(pads):
            z = F.pad(z, pads, value=float("-inf"))
        return torch.relu(F.max_pool2d(z, pool))

    def library_backward():
        w_, b_ = w_lib.detach().requires_grad_(), b.detach().requires_grad_()
        return torch.autograd.grad(library(w_, b_), (w_, b_), g_lib)

    kernel = lambda: fused_conv_cuda.conv_pool_relu(x, w, b, pool)
    kernel_bwd = lambda: fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool)
    plain = lambda: fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    plain_bwd = lambda: fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, pool)

    got, again = kernel(), kernel()
    grads, grads_again, grads_want = kernel_bwd(), kernel_bwd(), plain_bwd()
    lib = library().permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err_fwd = float(diff.max())
    ok = bool((diff <= ATOL + RTOL * want.abs()).all()) and bool(torch.isfinite(got).all())
    lib_ok = bool(((lib - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    same_bits = bool(torch.equal(got, again)) and all(
        bool(torch.equal(a, b_)) for a, b_ in zip(grads, grads_again))
    tol = CONV_GRAD_TOL_BIG if n >= 1000 else CONV_GRAD_TOL
    err_bwd, rel_bwd, ok_bwd = 0.0, 0.0, True
    for a, ref in zip(grads, grads_want):
        d, scale = float((a - ref).abs().max()), float(ref.abs().max())
        err_bwd, rel_bwd = max(err_bwd, d), max(rel_bwd, d / scale if scale > 0 else d)
        ok_bwd &= a.shape == ref.shape and d <= tol * scale + 1e-12 and bool(torch.isfinite(a).all())
    del got, again, want, lib, diff
    iters = 30 if n * h * wd <= 2_000_000 else 10
    out = {}
    for kname, backward, fn, fn_plain, fn_lib in (
            ("fused_conv", False, kernel, plain, library),
            ("fused_conv_backward", True, kernel_bwd, plain_bwd, library_backward)):
        b_ms, b_by, flops, nbytes = bound_conv(n, h, wd, c, kh, kw, m, pool, backward)
        res = dict(shape=name + (" sparse" if sparse else ""), batch=n, image=[h, wd, c],
                   kernel=[kh, kw], maps=m, pool=list(pool), sparse=sparse, same_bits=same_bits,
                   ms=time_ms(fn, iters), plain_ms=time_ms(fn_plain, iters),
                   library_ms=time_ms(fn_lib, iters), bound_ms=b_ms, bound_by=b_by,
                   flops=flops, bytes=nbytes)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        out[kname] = res
    out["fused_conv"]["max_abs_err"] = err_fwd
    out["fused_conv_backward"].update(max_abs_err=err_bwd, max_err_over_leaf_scale=rel_bwd)
    if not (ok and ok_bwd and same_bits and lib_ok):
        raise AssertionError(f"fused conv block vs its plain version at {out}: forward over atol "
                             f"{ATOL} + rtol {RTOL}*|ref| ({not ok}), a dW/db leaf over {tol} * "
                             f"its largest value ({not ok_bwd}), other bits on a second call "
                             f"({not same_bits}), or the library yardstick computes another "
                             f"function ({not lib_ok})")
    return out


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
    found = {}
    for name in ("matplotlib", "h5py", "scipy"):
        try:
            __import__(name)
            found[name] = True
        except ImportError:
            found[name] = False
    log("imports", **found)
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
        "emd_slice": (VAEConfig(fc_layers=EMD_LAYERS, input_dim=3 * EMD_CONST), SLICE_CHUNK),
    }
    # K1 runs the decoder (scoring); K2 runs the encoder on both paths and
    # the decoder (one head) in training, so at the scoring chunk and the
    # training batch it is held in both roles, beside K1 on the same decoder
    fwd = {"canonical": (("fused_mlp", "decoder"), ("stack_forward", "encoder"))}
    fwd["constituents"] = fwd["emd_slice"] = fwd["canonical"]
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
    # K4 at the three reference shapes and at the chunk emd_pairs cuts a
    # 100-constituent sample into (2 GiB / (16 n^2) jets); then, at few
    # iterations, a permuted copy (true EMD 0) and a far transport at
    # n = 100 and at the widest jet the kernel takes
    from atlasvae_torch.ops import emd, emd_cuda
    chunk = emd._EMD_BUDGET_BYTES // (16 * EMD_CONST ** 2)
    widest = emd_cuda.MAX_CONST
    cases = [("8192x100", 8192, 100, "near", EMD_ITERS), ("65536x20", 65_536, 20, "near", EMD_ITERS),
             ("1000x128", 1000, 128, "near", EMD_ITERS),
             ("emd_slice chunk", chunk, EMD_CONST, "near", EMD_ITERS)]
    cases += [(f"{batch}x{n} {kind}", batch, n, kind, EMD_FEW_ITERS)
              for batch, n in ((8192, 100), (1000, widest)) for kind in ("permuted", "far")]
    for shape, batch, n, kind, n_iters in cases:
        res = parity_emd(gen, batch, n, device, kind, n_iters)
        res["shape"] = shape
        results["emd_sinkhorn"].append(res)
        log("parity", kernel="emd_sinkhorn", shape=json.dumps(shape), batch=batch, n_const=n,
            n_iters=n_iters, mean_emd=f"{res['mean_emd']:.4g}", mean_mass=f"{res['mean_mass']:.4g}",
            max_abs_err=f"{res['max_abs_err']:.3g}", max_rel_err=f"{res['max_rel_err']:.3g}",
            err_over_mass=f"{res['err_over_mass']:.3g}",
            kernel_vs_f64_over_mass=f"{res['kernel_vs_f64_over_mass']:.3g}",
            plain_vs_f64_over_mass=f"{res['plain_vs_f64_over_mass']:.3g}",
            same_bits=res["same_bits"], ms=f"{res['ms']:.4f}",
            ms_one_iter_a_stage=f"{res['ms_one_iter_a_stage']:.4f}",
            plain_ms=f"{res['plain_ms']:.4f}",
            library_ms="none", bound_ms=f"{res['bound_ms']:.4f}", bound_by=res["bound_by"],
            tflops=f"{res['tflops']:.2f}", jets_per_s=f"{res['jets_per_s']:.0f}")
        torch.cuda.empty_cache()
    # K5 and K6: the jet-ID shapes on sparse images (what a jet image is),
    # the CPU tests' odd shapes on dense and on sparse ones
    for shape in CONV_SHAPES:
        for sparse in ((True,) if shape[1] >= 500 else (False, True)):
            for name, res in parity_conv(gen, shape, sparse, device).items():
                results[name].append(res)
                log("parity", kernel=name, shape=json.dumps(res["shape"]), batch=res["batch"],
                    image=res["image"], maps=res["maps"], pool=res["pool"],
                    max_abs_err=f"{res['max_abs_err']:.3g}",
                    **({"max_err_over_leaf_scale": f"{res['max_err_over_leaf_scale']:.3g}"}
                       if "max_err_over_leaf_scale" in res else {}),
                    same_bits=res["same_bits"], ms=f"{res['ms']:.4f}",
                    plain_ms=f"{res['plain_ms']:.4f}", library_ms=f"{res['library_ms']:.4f}",
                    bound_ms=f"{res['bound_ms']:.4f}", bound_by=res["bound_by"],
                    tflops=f"{res['tflops']:.2f}")
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
        top=json.dumps([(k[:60], n, round(d / 1e3, 4)) for d, k, n in rows[:10]]))
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


def phase_emd_slice(device, workdir):
    """Constituents-mode scoring at full width through cli.score, EMD and
    KSD included, on a background and a signal file."""
    import numpy as np
    import torch
    from atlasvae_torch.cli import score
    from atlasvae_torch.data import (ensure_synthetic_registry, load_data, fit_scaler,
                                     apply_scaler, hdf5, Scaler)
    from atlasvae_torch.eval import compute_metric_bank, auc_score
    from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
    from atlasvae_torch.ops import emd
    from atlasvae_torch.train.checkpoint import save_weights, load_weights

    t0 = time.perf_counter()
    os.makedirs(workdir)
    names = ["QCD-Geneva", "2HDM-Geneva"]
    ensure_synthetic_registry(workdir, n_events=EMD_EVENTS, n_const_max=EMD_CONST,
                              names=names, seed=0)
    mode = ["--constituents", "ON", "--HLVs", "OFF", "--n_const", str(EMD_CONST), "--n_dims", "3"]
    const = load_data("QCD-Geneva", EMD_EVENTS, (), EMD_CONST, 3, "ON", "OFF", verbose=False,
                      device=device)["constituents"]
    scaler_path = os.path.join(workdir, "const_RobustScaler.pkl")
    fit_scaler(const, scaler_out=scaler_path, scaler_type="RobustScaler", verbose=False)
    cfg = VAEConfig(fc_layers=EMD_LAYERS, input_dim=3 * EMD_CONST)
    model_path = os.path.join(workdir, "model.npz")
    save_weights(init_vae(torch.Generator(device).manual_seed(11), cfg, device=device), model_path)
    size_mb = os.path.getsize(os.path.join(workdir, "synthetic_QCD-Geneva.h5")) / 1e6
    log("emd_slice", setup_s=f"{time.perf_counter() - t0:.2f}", events=EMD_EVENTS,
        n_const=EMD_CONST, file_mb=f"{size_mb:.1f}", input_dim=cfg.input_dim)

    def run(name, output):
        score.main(["--data", name, "--model_in", model_path, "--const_scaler_in", scaler_path,
                    *mode, "--FC_layers", *map(str, EMD_LAYERS), "--metrics", *EMD_METRICS,
                    "--chunk", str(SLICE_CHUNK), "--output", output, "--device", str(device)])
        torch.cuda.synchronize()

    chunk = emd._EMD_BUDGET_BYTES // (16 * EMD_CONST ** 2)
    want_emd_launches = -(-EMD_EVENTS // chunk)
    got, launches, cold_s = {}, {}, {}
    for name in names:
        out_path = os.path.join(workdir, f"scores_{name}.h5")
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, out_path)
        cold_s[name] = time.perf_counter() - t0
        launches[name] = counters()
        with hdf5.File(out_path, "r") as f:
            got[name] = {k: f[k][:] for k in f}
        want_keys = {f"score_{m}" for m in EMD_METRICS} | {"m", "pt", "weights"}
        if set(got[name]) != want_keys:
            raise AssertionError(f"{name}: output keys {sorted(got[name])} != {sorted(want_keys)}")
        for key, val in got[name].items():
            if val.shape != (EMD_EVENTS,) or not np.isfinite(val).all():
                raise AssertionError(f"{name} {key}: shape {val.shape}, "
                                     f"finite {np.isfinite(val).all()}")
        for kernel in ("fused_mlp", "stack_forward"):
            if launches[name][kernel] <= 0:
                raise AssertionError(f"kernel {kernel} was not launched scoring {name}")
        if launches[name]["emd_sinkhorn"] != want_emd_launches:
            raise AssertionError(f"emd_sinkhorn launched {launches[name]['emd_sinkhorn']} times "
                                 f"scoring {name}, want {want_emd_launches}")

    # reference: the plain CPU path on the first jets of the background file,
    # with the latent noise the scorer drew for its chunk (CUDA generator 0)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    sample = load_data("QCD-Geneva", EMD_REF_ROWS, (), EMD_CONST, 3, "ON", "OFF", verbose=False,
                       device=cpu)
    x = apply_scaler(torch.as_tensor(sample["constituents"]), 3, Scaler.load(scaler_path),
                     verbose=False)
    params = load_weights(model_path, init_vae(torch.Generator().manual_seed(0), cfg, device=cpu))
    noise = torch.randn((SLICE_CHUNK, EMD_LAYERS[-1]),
                        generator=torch.Generator(device).manual_seed(0),
                        device=device)[:EMD_REF_ROWS].cpu()
    with torch.inference_mode():
        x_pred = vae_apply(params, x, noise=noise)[0]
        ref = compute_metric_bank(x, x_pred, params, ("MAE", "EMD", "KSD"),
                                  normal_losses=False, device=cpu)
    scored = got["QCD-Geneva"]
    gaps = {}
    for m, rtol, atol in (("MAE", 1e-4, 1e-4), ("EMD", 1e-3, 1e-4)):
        a, b = scored[f"score_{m}"][:EMD_REF_ROWS], ref[m]
        gaps[m] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-3)))
        if not np.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"score_{m} differs from the plain CPU path beyond rtol {rtol} "
                                 f"+ atol {atol}: max rel gap {gaps[m]}")
    # KSD counts sorted positions in steps of 1/300: equal but where a true
    # and a predicted value lie within the two paths' rounding of each other
    ks_gap = np.abs(scored["score_KSD"][:EMD_REF_ROWS] - ref["KSD"])
    step = 1.0 / (3 * EMD_CONST)
    gaps["KSD_max"], gaps["KSD_share_over_1e-6"] = float(ks_gap.max()), float(np.mean(ks_gap > 1e-6))
    if ks_gap.max() > 2 * step + 1e-6 or np.mean(ks_gap > 1e-6) > 0.02:
        raise AssertionError(f"score_KSD differs from the plain CPU path: {gaps}")
    log("emd_slice", reference_s=f"{time.perf_counter() - t0:.2f}", rows=EMD_REF_ROWS,
        gaps=json.dumps(gaps))

    # what each score is worth: background (label 1) against signal (label 0)
    labels = np.concatenate([np.ones(EMD_EVENTS), np.zeros(EMD_EVENTS)])
    aucs = {m: auc_score(labels, np.concatenate([got[names[0]][f"score_{m}"],
                                                 got[names[1]][f"score_{m}"]]), device=device)
            for m in EMD_METRICS}
    for m, val in aucs.items():
        if not 0.0 <= val <= 1.0:
            raise AssertionError(f"AUC of {m} is {val}")
    log("emd_slice", auc=json.dumps(aucs), emd_mean_bkg=f"{scored['score_EMD'].mean():.4f}",
        emd_mean_sig=f"{got[names[1]]['score_EMD'].mean():.4f}")

    # the background file again, warm, then once more under the profiler
    t0 = time.perf_counter()
    run(names[0], os.path.join(workdir, "scores_warm.h5"))
    warm_s = time.perf_counter() - t0
    idle = profile_slice(lambda: run(names[0], os.path.join(workdir, "scores_profiled.h5")),
                         phase="emd_slice profile")
    total = {k: sum(launches[name][k] for name in names) for k in launches[names[0]]}
    facts = dict(jets=EMD_EVENTS, cold_s=cold_s[names[0]], warm_s=warm_s,
                 warm_jets_per_s=EMD_EVENTS / warm_s, idle_share=idle,
                 launches_per_file=launches[names[0]], auc=aucs)
    log("emd_slice", **{k: (json.dumps(v) if isinstance(v, dict) else v)
                        for k, v in facts.items() if k != "auc"})
    return total, facts


class _Echo(io.StringIO):
    """Keeps what is printed while passing it on."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def _jetid_history(printed):
    """The per-epoch series of a training run's ticker lines (the jet-ID CLI
    writes no history file): JETID_EPOCHS finite epochs, the loss falling."""
    import numpy as np
    rows = re.findall(r"Epoch (\d+)/(\d+): loss=(\S+) acc=(\S+)% val_loss=(\S+) ", printed)
    history = {"loss": [float(r[2]) for r in rows], "accuracy": [float(r[3]) for r in rows],
               "val_loss": [float(r[4]) for r in rows]}
    if [r[:2] for r in rows] != [(str(e + 1), str(JETID_EPOCHS)) for e in range(JETID_EPOCHS)] \
            or not all(np.isfinite(v).all() for v in history.values()) \
            or not history["loss"][-1] < history["loss"][0]:
        raise AssertionError(f"jet-ID training history {history}: want {JETID_EPOCHS} finite "
                             "epochs with a falling loss")
    return history


def _jetid_report(results_path, device):
    """(view, labels, probabilities) of a results file and the numbers the
    CLI prints from them."""
    import pickle
    import numpy as np
    from atlasvae_torch.eval import auc_score, compo_matrix, discriminant
    from atlasvae_torch.plotting.performance import background_rejection
    with open(results_path, "rb") as f:
        v_view, v_labels, probs = pickle.load(f)
    n = len(v_labels)
    if probs.shape != (n, 2) or not np.isfinite(probs).all() \
            or np.abs(probs.sum(axis=1) - 1).max() > 1e-5:
        raise AssertionError(f"{results_path}: probabilities of shape {probs.shape} for {n} jets, "
                             f"finite {np.isfinite(probs).all()}")
    _, accuracy = compo_matrix(v_labels, (), probs)
    view, y, disc = discriminant(v_view, v_labels, probs)
    facts = dict(accuracy=float(accuracy), auc=float(auc_score(y, disc, view["weights"], device)),
                 rejection=background_rejection(y, disc, view["weights"], device=device))
    return v_view, v_labels, probs, facts


def _jetid_parity(config, inputs, labels, device):
    """The CUDA path against the plain CPU path at dropout 0, on the first
    batches of a sample: first-step gradients per leaf, and a 2-epoch loss
    series of train_classifier."""
    import dataclasses
    import numpy as np
    import torch
    from atlasvae_torch.models import init_jetid
    from atlasvae_torch.train.checkpoint import tree_flatten, tree_map
    from atlasvae_torch.train.jetid_loop import batch_loss, train_classifier

    config = dataclasses.replace(config, dropout=0.0)
    n = JETID_PARITY_BATCHES * JETID_BATCH
    train = {k: v[:n] for k, v in inputs.items()}
    valid = {k: v[n:n + JETID_BATCH] for k, v in inputs.items()}
    cpu = torch.device("cpu")
    init = init_jetid(torch.Generator().manual_seed(21), config, device=cpu)
    grads = {}
    for d in (cpu, device):
        params = tree_map(lambda t, d=d: t.detach().to(d).requires_grad_(), init)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[:JETID_BATCH])).to(d)
                 for k, v in train.items()}
        loss, _ = batch_loss(params, config, batch,
                             torch.from_numpy(labels[:JETID_BATCH]).to(d),
                             torch.ones(JETID_BATCH, device=d), None)
        grads[d] = [g.cpu() for g in torch.autograd.grad(loss, tree_flatten(params))]
    # leaves in tree_flatten's order (sorted keys), towers flagged
    in_tower = [key == "towers" for key in sorted(init) for _ in tree_flatten(init[key])]
    grad_rel = {"dense": 0.0, "conv": 0.0}
    for g_dev, g_cpu, conv in zip(grads[device], grads[cpu], in_tower):
        scale, diff = float(g_cpu.abs().max()), float((g_dev - g_cpu).abs().max())
        kind, tol = ("conv", JETID_CONV_GRAD_TOL) if conv else ("dense", GRAD_SCALE_TOL)
        grad_rel[kind] = max(grad_rel[kind], diff / scale if scale > 0 else diff)
        if diff > tol * scale:
            raise AssertionError(f"jet-ID first-step gradient of a {kind} leaf differs: {diff} > "
                                 f"{tol} * {scale}")
    hists = {}
    for d in (cpu, device):
        _, hists[d] = train_classifier(tree_map(lambda t, d=d: t.detach().to(d), init), config,
                                       train, labels[:n], valid, labels[n:n + JETID_BATCH],
                                       epochs=2, batch_size=JETID_BATCH, verbose=False)
    loss_rel = 0.0
    for key in ("loss", "val_loss"):
        got, want = np.asarray(hists[device][key]), np.asarray(hists[cpu][key])
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        loss_rel = max(loss_rel, rel)
        if not rel <= JETID_LOSS_REL_TOL:
            raise AssertionError(f"jet-ID {key}: CUDA {got} vs CPU {want}, rel {rel} > "
                                 f"{JETID_LOSS_REL_TOL}")
    return grad_rel, loss_rel


def phase_jetid(device, workdir):
    """Train and serve the jet-ID CNN through the CLI, hold the CUDA path
    against the plain CPU path, then time and profile it."""
    import numpy as np
    import torch
    from atlasvae_torch.cli import jetid as cli_jetid
    from atlasvae_torch.models import JetIDConfig, init_jetid
    from atlasvae_torch.train.checkpoint import load_pytree
    from atlasvae_torch.train.jetid_loop import (predict_classifier, train_classifier,
                                                 train_classifier_streaming)

    os.makedirs(workdir)
    out_dir = os.path.join(workdir, "out")
    # --synthetic writes its files under the data directory; this is the last
    # phase, so the setting stays
    os.environ["ATLASVAE_DATA_DIR"] = os.path.join(workdir, "data")
    args = JETID_ARGS + ["--output_dir", out_dir, "--device", str(device)]

    # 1. train
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Echo()) as printed:
        cli_jetid.main(args + ["--n_epochs", str(JETID_EPOCHS)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = counters()
    history = _jetid_history(printed.getvalue())
    for name in ("model.npz", "valid_results.pkl", "image_scale.pkl", "scaler_RobustScaler.pkl"):
        if not os.path.isfile(os.path.join(out_dir, name)):
            raise AssertionError(f"the jet-ID training run did not write {name}")
    v_view, v_labels, probs, _ = _jetid_report(os.path.join(out_dir, "valid_results.pkl"), device)
    n_valid = len(v_labels)
    if n_valid < JETID_TRAIN:   # the CLI then trains on half the sample, not on --n_train jets
        raise AssertionError(f"only {n_valid} validation jets: the sample is smaller than planned")
    steps = -(-JETID_TRAIN // JETID_BATCH)
    valid_batches = -(-n_valid // JETID_BATCH)
    chunks = -(-n_valid // JETID_CHUNK)
    want = {"fused_conv": JETID_EPOCHS * (steps + valid_batches) + chunks,
            "fused_conv_backward": JETID_EPOCHS * steps}
    for name, count in want.items():
        if train_launches[name] != count:
            raise AssertionError(f"{name} launched {train_launches[name]} times in the training "
                                 f"run, want {count} ({JETID_EPOCHS} epochs of {steps} steps and "
                                 f"{valid_batches} validation batches, {chunks} predict chunks)")
    log("jetid", train_cli_s=f"{train_s:.3f}", valid_jets=n_valid, steps_per_epoch=steps,
        valid_batches=valid_batches, predict_chunks=chunks, launches=json.dumps(train_launches),
        history=json.dumps(history))

    # 2. serve
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_jetid.main(args + ["--n_epochs", "0", "--model_in", "model.npz", "--results_out",
                           "served.pkl"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = counters()
    if serve_launches["fused_conv"] != chunks or serve_launches["fused_conv_backward"] != 0:
        raise AssertionError(f"serving launched {serve_launches}: want fused_conv {chunks} times "
                             "and no backward")
    _, served_labels, served, report = _jetid_report(os.path.join(out_dir, "served.pkl"), device)
    gap = float(np.abs(served - probs).max())
    if not np.array_equal(served_labels, v_labels) or gap > 1e-6:
        raise AssertionError(f"served probabilities differ from the training run's by {gap}")
    config = JetIDConfig(n_classes=2, scalars=("HLVs",), scalar_dims=(v_view["HLVs"].shape[1],),
                         nn_type="CNN", images=("images",),
                         image_shapes=((JETID_IMAGE, JETID_IMAGE),), dropout=0.1, l2=1e-7)
    inputs = {"HLVs": v_view["HLVs"], "images": v_view["images"]}
    cpu = torch.device("cpu")
    cpu_params = load_pytree(os.path.join(out_dir, "model.npz"),
                             init_jetid(torch.Generator().manual_seed(0), config, device=cpu))
    ref = predict_classifier(cpu_params, config, {k: v[:JETID_REF_ROWS] for k, v in inputs.items()})
    ref_gap = float(np.abs(served[:JETID_REF_ROWS] - ref).max())
    if not np.allclose(served[:JETID_REF_ROWS], ref, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"served probabilities differ from the plain CPU path: {ref_gap}")
    log("jetid", serve_cli_s=f"{serve_s:.3f}", launches=json.dumps(serve_launches),
        same_bits_as_training_run=bool(np.array_equal(served, probs)), max_gap=gap,
        cpu_ref_rows=JETID_REF_ROWS, cpu_ref_max_gap=ref_gap,
        accuracy=f"{report['accuracy']:.2f}", auc=f"{report['auc']:.4f}",
        rejection=json.dumps(report["rejection"]), note="synthetic data: no physics result")

    # 3. CUDA against the plain CPU path at dropout 0
    t0 = time.perf_counter()
    grad_rel, loss_rel = _jetid_parity(config, inputs, v_labels, device)
    log("jetid", parity_s=f"{time.perf_counter() - t0:.2f}", grad_rel=json.dumps(grad_rel),
        loss_rel=loss_rel)

    # 4. a warm timed run on JETID_TRAIN of these jets, then a profiled epoch
    train_in = {k: v[:JETID_TRAIN] for k, v in inputs.items()}
    valid_in = {k: v[JETID_TRAIN:JETID_TRAIN + 50_000] for k, v in inputs.items()}
    train_y, valid_y = v_labels[:JETID_TRAIN], v_labels[JETID_TRAIN:JETID_TRAIN + 50_000]
    stamps = []

    def loads():
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), counters()))
        yield train_in, train_y, None
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), counters()))

    params = init_jetid(torch.Generator(device).manual_seed(0), config, device=device)
    reset_counters()
    train_classifier_streaming(params, config, loads, valid_in, valid_y, JETID_EPOCHS,
                               JETID_BATCH, verbose=False)
    spans = [(stamps[2 * e], stamps[2 * e + 1]) for e in range(JETID_EPOCHS)]
    warm_s = sum(end[0] - start[0] for start, end in spans[1:])
    per_step = {name: (spans[-1][1][1][name] - spans[-1][0][1][name]) / steps
                for name in ("fused_conv", "fused_conv_backward")}
    predict_classifier(params, config, inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict_classifier(params, config, inputs)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    idle = profile_slice(lambda: (train_classifier(params, config, train_in, train_y, valid_in,
                                                   valid_y, epochs=1, batch_size=JETID_BATCH,
                                                   verbose=False), torch.cuda.synchronize()),
                         phase="jetid profile")
    facts = dict(train_jets=JETID_TRAIN, steps_per_epoch=steps,
                 warm_jets_per_s=JETID_TRAIN * (JETID_EPOCHS - 1) / warm_s,
                 ms_per_step=warm_s / (steps * (JETID_EPOCHS - 1)) * 1e3,
                 launches_per_step=per_step, predict_jets=n_valid,
                 predict_jets_per_s=n_valid / predict_s, idle_share=idle, grad_rel=grad_rel,
                 loss_rel=loss_rel, **report)
    log("jetid", **{k: (json.dumps(v) if isinstance(v, dict) else v) for k, v in facts.items()})
    total = {k: train_launches[k] + serve_launches[k] for k in train_launches}
    return total, facts


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
        emd_launches, emd_facts = phase_emd_slice(device, os.path.join(workdir, "emd_slice"))
        jetid_launches, jetid_facts = phase_jetid(device, os.path.join(workdir, "jetid"))

    kernels = []
    for name, meta in KERNELS.items():
        main_shape = next(r for r in parity_results[name] if r["shape"] == meta["main_shape"])
        by_phase = {"slice": slice_launches[name], "train": train_launches[name],
                    "emd_slice": emd_launches[name], "jetid": jetid_launches[name]}
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
        train_jets_per_s=f"{train['warm_jets_per_s']:.0f}",
        emd_slice_jets_per_s=f"{emd_facts['warm_jets_per_s']:.0f}",
        jetid_train_jets_per_s=f"{jetid_facts['warm_jets_per_s']:.0f}",
        jetid_predict_jets_per_s=f"{jetid_facts['predict_jets_per_s']:.0f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
