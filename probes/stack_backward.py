#!/usr/bin/env python3
"""Probe K3 (csrc/fused_vae_bwd.cu: its fused body, and its layer-wise route
on csrc/gemm_wgmma.cuh) on one NVIDIA GPU.

    python3 probes/stack_backward.py [--build NAME=DIR ...] [--rounds 3]
                                     [--match REGEX]
                                     [--out build/probe_stack_backward.json]

Builds this tree's K2 and K3 libraries (fused_vae, fused_vae_bwd) and, all
started together, those of every earlier tree named by ``--build NAME=DIR``
(e.g. the parent commit, ``git archive``d into a directory .gitignore
lists; its ``atlasvae_torch/`` is enough).  An earlier tree's package is
loaded beside this one under another name (probes/stack_forward.py's
``load_tree``), so that its wrapper runs in the same process, on its own
plan and its own kernels.  Prints each build's ptxas lines (registers,
shared memory, spills) and nvcc seconds.

Then, at each of SHAPES, holds every tree's wrapper against the plain
version at chip_smoke.py's bars (dW/db within GRAD_SCALE_TOL of each leaf's
largest value, dx within ATOL + RTOL |ref|; this tree also the same bits on
a second call, every other tree whether it gives this tree's bits) and
times, in rounds with the calls in order and then in reverse (the median
of the rounds), each tree's wrapper call (host work included) and the same
call on the device alone (``time_ms(queued=True)``:
the calls wait behind a sleeping kernel until all are enqueued), beside the
plain version and autograd through one chain of torch.addmm and relu (the
library yardstick).  On the layer-wise route it also records each launch's
device ms of one call of every tree, and the ReLU masks of this tree's
recompute where they differ from K2's forward and the plain version's
(chip_smoke.py's ``recompute_flips``).  ``--match`` keeps the shapes whose
label the regular expression finds.  Prints one JSON object as its last
line.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "probes"))

import chip_smoke  # noqa: E402

ENCODER, DECODER = (12, 80, 40, 20), (10, 20, 40, 80)
CONST_ENCODER, CONST_DECODER = (300, 256, 128, 64), (32, 64, 128, 256)
# (label, batch, widths, heads, dx): the training batch on the fused body
# (the train phase's 4 calls a step), 1,000,003 rows of it; the
# constituents-mode stacks on the layer-wise route at const_train's batch
# (its 4 calls a step: 2 encoders, 2 decoders with dx) and at 1,000,003 rows
# 312 wide (chip_smoke.py's parity shapes); then the stacks of any depth and
# width of chip_smoke.py's DEEP_WIDE_STACKS at the training batch
SHAPES = [("train encoder", 10_000, ENCODER, (10, 10), False),
          ("train decoder", 10_000, DECODER, (12,), True),
          ("1,000,003 encoder", 1_000_003, ENCODER, (10, 10), False),
          ("const_train encoder", 10_000, CONST_ENCODER, (32, 32), False),
          ("const_train decoder", 10_000, CONST_DECODER, (300,), True),
          ("1,000,003 x 312 encoder", 1_000_003, (312, 256, 128, 64), (32, 32), False),
          ("1,000,003 x 312 decoder", 1_000_003, CONST_DECODER, (312,), True),
          ("deep_12_narrow encoder", 10_000, (12,) + (64,) * 12, (10, 10), False),
          ("deep_10_const encoder", 10_000, (300,) + (128,) * 9, (32, 32), False),
          ("const_1200 encoder", 10_000, (1200, 256, 128, 64), (32, 32), False),
          ("wide_2048 encoder", 10_000, (2048, 512, 64), (32, 32), False)]


def ptxas_lines(log):
    """{kernel: [ptxas lines]} of a build log."""
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("registers" in line or "spill" in line or "smem" in line):
            out.setdefault(kernel, []).append(line.split("ptxas info    :")[-1].strip())
    return out


def stack(gen, widths, heads, batch, device):
    """Seeded inputs: x, the (w, b) pairs of the hidden layers and heads, and
    head gradients at a mean loss's scale (N(0, 1) / batch)."""
    import torch

    def pair(k, n):
        return (torch.randn((k, n), generator=gen, device=device) / k ** 0.5,
                torch.randn((n,), generator=gen, device=device))
    hidden = [pair(k, n) for k, n in zip(widths, widths[1:])]
    head_pairs = [pair(widths[-1], n) for n in heads]
    x = torch.randn((batch, widths[0]), generator=gen, device=device)
    grads = [torch.randn((batch, n), generator=gen, device=device) / batch for n in heads]
    return x, hidden, head_pairs, grads


def library_of(x, hidden, heads, grads, want_dx):
    """The same gradients by autograd through one chain of torch.addmm and relu."""
    import torch

    def call():
        leaves = [t.detach().requires_grad_() for pair in hidden + heads for t in pair]
        xin = x.detach().requires_grad_(want_dx)
        h = xin
        for i in range(len(hidden)):
            h = torch.relu(torch.addmm(leaves[2 * i + 1], h, leaves[2 * i]))
        outs = [torch.addmm(leaves[2 * k + 1], h, leaves[2 * k])
                for k in range(len(hidden), len(hidden) + len(heads))]
        return torch.autograd.grad(outs, leaves + ([xin] if want_dx else []), grads)
    return call


def gap(got, want, allow=None):
    """(largest |got - want| over the dW/db leaves over the leaf's largest
    |value|, over GRAD_SCALE_TOL: the ratio to the bar; dx's ratio to ATOL +
    RTOL |ref|; every element within its bar).  ``allow``: each element may
    go beyond its bar by one flipped ReLU tie's move there (dws + dbs, dx:
    tests/relu_ties.py), as chip_smoke.py holds wide_2048."""
    leaf = max(float((g - w).abs().max()) / (chip_smoke.GRAD_SCALE_TOL * float(w.abs().max()))
               for g, w in zip(got[0] + got[1], want[0] + want[1]))
    dx = 0.0
    if want[2] is not None:
        dx = float(((got[2] - want[2]).abs()
                    / (chip_smoke.ATOL + chip_smoke.RTOL * want[2].abs())).max())
    if allow is None:
        return leaf, dx, leaf <= 1 and dx <= 1
    ok = all(bool(((g - w).abs() <= chip_smoke.GRAD_SCALE_TOL * float(w.abs().max()) + a).all())
             for g, w, a in zip(got[0] + got[1], want[0] + want[1], allow[0]))
    if want[2] is not None:
        ok &= bool(((got[2] - want[2]).abs() <= chip_smoke.ATOL + chip_smoke.RTOL * want[2].abs()
                    + allow[1]).all())
    return leaf, dx, ok


def main():
    from stack_forward import load_tree
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--match", default="")
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_stack_backward.json"))
    args = ap.parse_args()
    import torch
    from atlasvae_torch.ops import cuda_build, fused_mlp, fused_vae

    if not torch.cuda.is_available():
        print("stack_backward: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    report = {"card": smi, "torch": torch.__version__, "ptxas": {}, "parity": [], "ms": {}}

    trees = {"this": (fused_vae, fused_mlp, cuda_build)}
    for item in args.build:
        name, root = item.split("=", 1)
        trees[name] = load_tree(name, Path(root).resolve())
    names = ("fused_vae", "fused_vae_bwd")
    with ThreadPoolExecutor(len(trees)) as pool:
        builds = {t: pool.submit(mods[2].build, names) for t, mods in trees.items()}
        for t, job in builds.items():
            for lib, (_, secs, log) in job.result().items():
                report.setdefault("nvcc_s", {}).setdefault(t, {})[lib] = secs
                print(f"[build] {t} {lib} nvcc_s={secs:.2f}", flush=True)
                if lib != "fused_vae_bwd":
                    continue
                for kernel, lines in ptxas_lines(log).items():
                    report["ptxas"].setdefault(t, {})[kernel] = lines
                    print(f"[ptxas] {t} {kernel[:70]}: {' | '.join(lines)}", flush=True)

    gen = torch.Generator(device).manual_seed(1234)
    for label, batch, widths, heads, want_dx in SHAPES:
        if not re.search(args.match, label):
            continue
        x, hidden, head_pairs, grads = stack(gen, widths, heads, batch, device)
        plain = fused_vae.stack_backward_plain(x, hidden, head_pairs, grads, want_dx)
        route = fused_vae.backward_plan(batch, widths, heads, want_dx).route
        allow = None
        if label.startswith("wide_2048"):   # a tie may flip (tests/relu_ties.py)
            sys.path.insert(0, str(ROOT / "tests"))
            from relu_ties import single_flip_allowance
            a_dws, a_dbs, a_dx, _ = single_flip_allowance(x, hidden, head_pairs, grads, want_dx)
            allow = [t.float() for t in a_dws + a_dbs], (0.0 if a_dx is None else a_dx.float())
        b_ms, b_by, _, _ = chip_smoke.bound_backward(batch, widths[0], hidden, head_pairs,
                                                     want_dx, route)
        calls, row = {}, dict(label=label, batch=batch, want_dx=want_dx, route=route,
                              bound_ms=b_ms, bound_by=b_by)
        for t, (t_vae, _, _) in trees.items():
            row[f"{t}_route"] = t_vae.backward_plan(batch, widths, heads, want_dx).route
            fn = (lambda v: lambda: v.stack_backward(x, hidden, head_pairs, grads, want_dx))(t_vae)
            got = fn()
            again = fn() if t == "this" else got
            torch.cuda.synchronize()
            leaf, dx, ok = gap(got, plain, allow)
            row[f"{t}_over_bar"], row[f"{t}_dx_over_bar"], row[f"{t}_within_bar"] = leaf, dx, ok
            flat = got[0] + got[1] + [got[2]] * want_dx
            if t == "this":
                row["same_bits"] = all(bool(torch.equal(a, b)) for a, b in
                                       zip(flat, again[0] + again[1] + [again[2]] * want_dx))
                mine = flat
            else:
                row[f"{t}_same_bits_as_this"] = all(bool(torch.equal(a, b))
                                                    for a, b in zip(flat, mine))
            del got, again, flat
            calls[f"{t} wrapper"] = calls[f"{t} device"] = fn
            if route == "layers":
                row[f"{t}_launch_ms"] = chip_smoke.kernel_device_ms(fn)
        if route == "layers":
            row.update(chip_smoke.recompute_flips(x, hidden))
        report["parity"].append(row)
        print("[parity] " + json.dumps(row), flush=True)
        if not (row["this_within_bar"] and row["same_bits"]):
            raise AssertionError(f"K3 disagrees with its plain version: {row}")
        calls["plain"] = lambda: fused_vae.stack_backward_plain(x, hidden, head_pairs, grads,
                                                                want_dx)
        calls["library"] = library_of(x, hidden, head_pairs, grads, want_dx)
        iters = 20 if batch < chip_smoke.BIG_B else 5
        rounds = {k: [] for k in calls}
        for r in range(args.rounds):
            for k in (list(calls) if r % 2 == 0 else list(reversed(calls))):
                rounds[k].append(chip_smoke.time_ms(calls[k], iters, 3,
                                                    queued=k.endswith("device")))
        report["ms"][label] = {k: statistics.median(v) for k, v in rounds.items()}
        report["ms"][label]["bound_ms"] = b_ms
        print(f"[ms] {label} " + json.dumps(report["ms"][label]), flush=True)
        del x, hidden, head_pairs, grads, plain, calls, mine
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
