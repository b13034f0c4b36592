#!/usr/bin/env python3
"""Probe K1/K2 on one NVIDIA GPU: the fused body (csrc/dense_stack.cuh)
and the layer-wise route's row product (csrc/gemm_wgmma.cuh).

    python3 probes/stack_forward.py [--build NAME=DIR ...] [--rounds 3]
                                    [--match REGEX]
                                    [--out build/probe_stack_forward.json]

Builds this tree's K1 and K2 libraries (fused_mlp, fused_vae) and, all
started together, those of every earlier tree named by ``--build NAME=DIR``
(e.g. the parent commit, ``git archive``d into a directory .gitignore
lists; its ``atlasvae_torch/`` is enough).  An earlier tree's package is
loaded beside this one under another name, so that its wrappers run in the
same process, on its own plan and its own kernels.  Prints each build's
ptxas lines (registers, shared memory, spills) and nvcc seconds.

Then, at each of SHAPES, holds every tree's wrapper against the plain
version at chip_smoke.py's bars (atol + rtol |ref|; this tree also the same
bits on a second call) and times, in rounds with the calls in order and
then in reverse (the median of the rounds), each tree's wrapper call (host
work included) and the same call on the device alone
(``time_ms(queued=True)``: the calls wait behind a sleeping kernel until
all are enqueued), beside the plain version and one PyTorch call of the
same function (an addmm/relu chain).  On the layer-wise route it also
records each launch's device ms of one call (the pre-pass, the row
products, the fused segments), and for every tree the largest gap to the
plain version, its largest ratio to the bar, and whether it gives this
tree's bits.  ``--match`` keeps the
shapes whose label the regular expression finds.  Prints one JSON object
as its last line.
"""

import argparse
import importlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from stack_backward import ptxas_lines  # noqa: E402

ENCODER, DECODER = (12, 80, 40, 20), (10, 20, 40, 80)
# (label, batch, kernel, widths, heads): K2 takes hidden widths and head
# widths, K1 its layers' widths and the final activation.  The scoring chunk
# (encoder and decoder, K1 and K2), the training, evaluation and sweep batch,
# 1,000,003 rows (many blocks a warp), the fused segments of the
# constituents-mode stacks, stacks that this body cuts into more fused
# segments than the earlier body (a deep narrow stack, three 128 x 128
# layers, chip_smoke.py's deep_10_const), then what a call costs beside its
# rows: 32 rows, one CTA of this body an SM (132 x 64 rows) and one 128-row
# tile of the earlier body an SM
SHAPES = [("slice encoder", 65_536, "K2", ENCODER, (10, 10)),
          ("slice decoder", 65_536, "K1", DECODER + (12,), "linear"),
          ("slice decoder one head", 65_536, "K2", DECODER, (12,)),
          ("train encoder", 10_000, "K2", ENCODER, (10, 10)),
          ("train decoder one head", 10_000, "K2", DECODER, (12,)),
          ("evaluate decoder", 10_000, "K1", DECODER + (12,), "linear"),
          ("1,000,003 encoder", 1_000_003, "K2", ENCODER, (10, 10)),
          ("const tail 10,000", 10_000, "K2", (128, 64), (32, 32)),
          ("const tail 65,536", 65_536, "K2", (128, 64), (32, 32)),
          ("const head 10,000", 10_000, "K1", (32, 64, 128), "relu"),
          ("const head 65,536", 65_536, "K1", (32, 64, 128), "relu"),
          ("deep_12_narrow 10,000", 10_000, "K2", (12,) + (64,) * 12, (10, 10)),
          ("128 x 3 + 2x64 10,000", 10_000, "K2", (128, 128, 128), (64, 64)),
          ("deep_10_const encoder 10,000", 10_000, "K2", (300,) + (128,) * 9, (32, 32)),
          ("deep_10_const decoder 10,000", 10_000, "K1", (32,) + (128,) * 9 + (300,), "linear"),
          ("32 encoder", 32, "K2", ENCODER, (10, 10)),
          ("8,448 encoder", 132 * 64, "K2", ENCODER, (10, 10)),
          ("16,896 encoder", 132 * 128, "K2", ENCODER, (10, 10)),
          ("const_train encoder", 10_000, "K2", (300, 256, 128, 64), (32, 32)),
          ("emd_slice encoder", 65_536, "K2", (300, 256, 128, 64), (32, 32)),
          ("emd_slice decoder", 65_536, "K1", (32, 64, 128, 256, 300), "linear"),
          ("emd_slice255 encoder", 65_536, "K2", (765, 256, 128, 64), (32, 32)),
          ("emd_slice255 decoder", 65_536, "K1", (32, 64, 128, 256, 765), "linear"),
          ("const_1200 encoder", 10_000, "K2", (1200, 256, 128, 64), (32, 32)),
          ("const_1200 decoder", 10_000, "K1", (32, 64, 128, 256, 1200), "linear"),
          ("wide_2048 encoder", 10_000, "K2", (2048, 512, 64), (32, 32)),
          ("1,000,003 x 312 encoder", 1_000_003, "K2", (312, 256, 128, 64), (32, 32)),
          ("1,000,003 x 312 decoder", 1_000_003, "K1", (32, 64, 128, 256, 312), "linear")]


def load_tree(name, root):
    """An earlier tree's fused_vae, fused_mlp and cuda_build modules, its
    package loaded as atlasvae_torch_<name>."""
    pkg = f"atlasvae_torch_{name}"
    spec = importlib.util.spec_from_file_location(
        pkg, root / "atlasvae_torch" / "__init__.py",
        submodule_search_locations=[str(root / "atlasvae_torch")])
    module = importlib.util.module_from_spec(spec)
    sys.modules[pkg] = module
    spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{pkg}.ops.{m}")
                 for m in ("fused_vae", "fused_mlp", "cuda_build"))


def stack(gen, kernel, widths, heads, batch, device):
    """Seeded inputs: x and the (w, b) pairs of the hidden layers and heads."""
    import torch
    dims = widths if kernel == "K2" else widths[:-1]
    outs = heads if kernel == "K2" else widths[-1:]

    def pair(k, n):
        return (torch.randn((k, n), generator=gen, device=device) / k ** 0.5,
                torch.randn((n,), generator=gen, device=device))
    hidden = [pair(k, n) for k, n in zip(dims, dims[1:])]
    head_pairs = [pair(dims[-1], n) for n in outs]
    return torch.randn((batch, dims[0]), generator=gen, device=device), hidden, head_pairs


def call_of(fused_vae, fused_mlp, kernel, x, hidden, heads, final):
    if kernel == "K2":
        return lambda: fused_vae.stack_forward(x, hidden, heads)
    layers = [{"w": w, "b": b} for w, b in hidden + heads]
    return lambda: (fused_mlp.fused_mlp_apply(layers, x, final_activation=final),)


def library_of(kernel, x, hidden, heads, final):
    """The same function as one chain of torch.addmm and relu."""
    import torch

    def call():
        h = x
        for w, b in hidden:
            h = torch.relu(torch.addmm(b, h, w))
        outs = tuple(torch.addmm(b, h, w) for w, b in heads)
        return tuple(torch.relu(o) for o in outs) if final == "relu" else outs
    return call


def gap(got, want):
    """(largest |got - want|, its largest ratio to atol + rtol |want|, every
    element within that bar)."""
    err, ratio, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        diff = (g - w).abs()
        bar = chip_smoke.ATOL + chip_smoke.RTOL * w.abs()
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / bar).max()))
        ok &= bool((diff <= bar).all())
    return err, ratio, ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--match", default="")
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_stack_forward.json"))
    args = ap.parse_args()
    import torch
    from atlasvae_torch.ops import cuda_build, fused_mlp, fused_vae

    if not torch.cuda.is_available():
        print("stack_forward: needs an NVIDIA GPU", file=sys.stderr)
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
    names = ("fused_vae", "fused_mlp")
    with ThreadPoolExecutor(len(trees)) as pool:
        builds = {t: pool.submit(mods[2].build, names) for t, mods in trees.items()}
        for t, job in builds.items():
            for lib, (_, secs, log) in job.result().items():
                report.setdefault("nvcc_s", {}).setdefault(t, {})[lib] = secs
                print(f"[build] {t} {lib} nvcc_s={secs:.2f}", flush=True)
                for kernel, lines in ptxas_lines(log).items():
                    report["ptxas"].setdefault(t, {})[f"{lib} {kernel}"] = lines
                    print(f"[ptxas] {t} {lib} {kernel[:70]}: {' | '.join(lines)}", flush=True)

    gen = torch.Generator(device).manual_seed(1234)
    for label, batch, kernel, widths, heads in SHAPES:
        if not re.search(args.match, label):
            continue
        x, hidden, head_pairs = stack(gen, kernel, widths, heads, batch, device)
        final = heads if kernel == "K1" else "linear"
        plain = (fused_vae.stack_forward_plain(x, hidden, head_pairs) if kernel == "K2" else
                 (fused_mlp.fused_mlp_plain([{"w": w, "b": b} for w, b in hidden + head_pairs], x,
                                            final_activation=final),))
        dims = (x.shape[1],) + tuple(w.shape[1] for w, _ in hidden)
        plan = fused_vae.forward_plan(batch, dims, tuple(w.shape[1] for w, _ in head_pairs))
        b_ms, b_by, _, _ = chip_smoke.bound(batch, x.shape[1], hidden, head_pairs)
        calls, row = {}, dict(label=label, batch=batch, kernel=kernel, route=plan.route,
                              bound_ms=b_ms, bound_by=b_by)
        for t, (t_vae, t_mlp, _) in trees.items():
            row[f"{t}_launches"] = len(t_vae.forward_plan(
                batch, dims, tuple(w.shape[1] for w, _ in head_pairs)).segments)
            fn = call_of(t_vae, t_mlp, kernel, x, hidden, head_pairs, final)
            got = fn()
            again = fn() if t == "this" else got
            torch.cuda.synchronize()
            err, ratio, ok = gap(got, plain)
            row[f"{t}_max_abs_err"], row[f"{t}_over_bar"], row[f"{t}_within_bar"] = err, ratio, ok
            if t == "this":
                row["same_bits"] = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
                mine = got
            else:
                row[f"{t}_same_bits_as_this"] = all(bool(torch.equal(a, b))
                                                    for a, b in zip(got, mine))
            del got, again
            calls[f"{t} wrapper"] = calls[f"{t} device"] = fn
        if plan.route == "layers":
            row["launch_ms"] = chip_smoke.kernel_device_ms(calls["this wrapper"])
        report["parity"].append(row)
        print("[parity] " + json.dumps(row), flush=True)
        if not (row["this_within_bar"] and row["same_bits"]):
            raise AssertionError(f"K1/K2 disagree with their plain version: {row}")
        calls["plain"] = (lambda: fused_vae.stack_forward_plain(x, hidden, head_pairs)) \
            if kernel == "K2" else (lambda: fused_mlp.fused_mlp_plain(
                [{"w": w, "b": b} for w, b in hidden + head_pairs], x, final_activation=final))
        calls["library"] = library_of(kernel, x, hidden, head_pairs, final)
        iters = 20 if batch < chip_smoke.BIG_B else 5
        rounds = {k: [] for k in calls}
        for r in range(args.rounds):
            for k in (list(calls) if r % 2 == 0 else list(reversed(calls))):
                rounds[k].append(chip_smoke.time_ms(calls[k], iters, 3,
                                                    queued=k.endswith("device")))
        report["ms"][label] = {k: statistics.median(v) for k, v in rounds.items()}
        report["ms"][label]["bound_ms"] = b_ms
        print(f"[ms] {label} " + json.dumps(report["ms"][label]), flush=True)
        del x, hidden, head_pairs, plain, calls, mine
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
