#!/usr/bin/env python3
"""Probe K3's fused body (csrc/fused_vae_bwd.cu) on one NVIDIA GPU.

    python3 probes/stack_backward.py [--build NAME=DIR ...] [--rounds 3]
                                     [--out build/probe_stack_backward.json]

Builds this tree's K3 library and, one nvcc each, all started together,
the K3 source of every earlier tree named by ``--build NAME=DIR`` (e.g. the
parent commit, ``git archive``d into a directory .gitignore lists; its
``atlasvae_torch/csrc/`` is enough) into build/probe_stack_backward/.
Prints each build's ptxas lines (registers, shared memory, spills).

Then, at each of SHAPES (chip_smoke.py's seeded canonical VAE), holds this
tree's K3 against the plain version at chip_smoke.py's bars
(``parity_backward``: the same bits asked of a second call) and times, in
rounds with the calls in order and then in reverse (the median of the
rounds): this tree's wrapper call (``stack_backward``, host work included)
and on the device alone (``time_ms(queued=True)``: the calls wait behind a
sleeping kernel until all are enqueued), and every earlier build's fused
body through its C entry, on the device alone.  Prints one JSON object as
its last line.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# (label, batch, role): the training batch (the train phase's 4 calls a
# step: 2 encoders, 2 decoders) and 1,000,003 rows (many tiles a CTA); then
# what a call costs beside its rows: one CTA of 32 rows, 132 CTAs of 32
# rows, and 132 CTAs of 152 rows (two tiles each)
SHAPES = [("train encoder", chip_smoke.TRAIN_BATCH, "encoder"),
          ("train decoder", chip_smoke.TRAIN_BATCH, "decoder"),
          ("1,000,003 encoder", chip_smoke.BIG_B, "encoder"),
          ("32 encoder", 32, "encoder"),
          ("4,224 encoder", 4224, "encoder"),
          ("20,064 encoder", 20_064, "encoder")]
PARENT_ROWS, PARENT_PARTS = 64, 264   # the parent body's tile and slice bound


def build_others(builds, out_dir):
    """nvcc of each earlier tree's K3 source with the package's flags, all
    started together.  Returns {name: (library path, ptxas log)}."""
    from atlasvae_torch.ops import cuda_build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in builds.items():
        lib = out_dir / f"libfused_vae_bwd_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of {name} failed:\n{log}")
        done[name] = (lib, log)
    return done


def ptxas_lines(log):
    """{kernel: [ptxas lines]} of a build log."""
    import re
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("registers" in line or "spill" in line or "smem" in line):
            out.setdefault(kernel, []).append(line.split("ptxas info    :")[-1].strip())
    return out


def parent_call(lib, x, hidden, heads, grads, want_dx):
    """The earlier tree's fused body through its C entry (the parent's
    signature: partial slices of the whole parameter vector, then
    reduce_partials), and what it writes; a callable of no arguments."""
    import torch
    from atlasvae_torch.ops import cuda_build
    fn = lib.atlasvae_stack_backward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    batch = x.shape[0]
    n_params = sum(w.numel() + b.numel() for w, b in hidden) + \
        sum(w.numel() + w.shape[1] for w, _ in heads)
    n_parts = min(-(-batch // PARENT_ROWS), PARENT_PARTS)
    partial = torch.empty(n_parts * n_params, device=x.device)
    out = torch.empty(n_params, device=x.device)
    dx = torch.empty_like(x) if want_dx else None
    dims = cuda_build.int_array([x.shape[1]] + [w.shape[1] for w, _ in hidden])
    head_dims = cuda_build.int_array([w.shape[1] for w, _ in heads])
    keep = [cuda_build.pointer_array(t) for t in ([w for w, _ in hidden], [b for _, b in hidden],
                                                  [w for w, _ in heads], grads)]
    args = (x.data_ptr(), batch, len(hidden), ctypes.addressof(dims), *(
        ctypes.addressof(a) for a in keep[:2]), len(heads), ctypes.addressof(head_dims),
        ctypes.addressof(keep[2]), ctypes.addressof(keep[3]), dx.data_ptr() if want_dx else None,
        partial.data_ptr(), n_parts, out.data_ptr())
    hold = (dims, head_dims, keep, partial, out, dx)

    def call():
        cuda_build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "parent K3")
        return hold
    return call, out, dx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_stack_backward.json"))
    args = ap.parse_args()
    import torch
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.ops import cuda_build, fused_vae

    if not torch.cuda.is_available():
        print("stack_backward: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    report = {"card": smi, "torch": torch.__version__, "ptxas": {}, "parity": [], "ms": {}}

    (_, _, log), = cuda_build.build(("fused_vae_bwd",)).values()
    report["ptxas"]["this"] = ptxas_lines(log)
    sources = {item.split("=", 1)[0]: Path(item.split("=", 1)[1]) / "atlasvae_torch" / "csrc"
               / "fused_vae_bwd.cu" for item in args.build}
    others = build_others(sources, ROOT / "build" / "probe_stack_backward")
    for name, (_, other_log) in others.items():
        report["ptxas"][name] = ptxas_lines(other_log)
    for name, kernels in report["ptxas"].items():
        for kernel, lines in kernels.items():
            print(f"[ptxas] {name} {kernel[:60]}: {' | '.join(lines)}", flush=True)
    libs = {name: ctypes.CDLL(str(lib)) for name, (lib, _) in others.items()}

    gen = torch.Generator(device).manual_seed(1234)
    params = init_vae(gen, VAEConfig(), device=device)
    for label, batch, role in SHAPES:
        width = 12 if role == "encoder" else 10
        x = torch.randn((batch, width), generator=gen, device=device)
        name, res = chip_smoke.parity_backward(params, role, x, torch.Generator(device).manual_seed(7))
        keep = {k: res[k] for k in ("batch", "want_dx", "route", "same_bits", "max_abs_err",
                                    "max_err_over_leaf_scale", "ms", "device_ms",
                                    "plain_ms", "library_ms", "bound_ms", "bound_by") if k in res}
        report["parity"].append(dict(label=label, **keep))
        print("[parity] " + json.dumps(report["parity"][-1]), flush=True)
        hidden, heads = chip_smoke.stack_pairs(params, role)
        want_dx = role == "decoder"
        grads = [torch.randn((batch, w.shape[1]), generator=gen, device=device) / batch
                 for w, _ in heads]
        calls = {"this wrapper": lambda: fused_vae.stack_backward(x, hidden, heads, grads, want_dx)}
        calls["this device"] = calls["this wrapper"]
        plain = fused_vae.stack_backward_plain(x, hidden, heads, grads, want_dx)
        for name, lib in libs.items():
            call, out, dx = parent_call(lib, x, hidden, heads, grads, want_dx)
            call()
            torch.cuda.synchronize()
            flat = torch.cat([t.reshape(-1) for pair in zip(plain[0], plain[1]) for t in pair])
            gap = float((out - flat).abs().max())
            print(f"[parity] {label} {name}: largest gap to the plain version {gap:.3g}"
                  + (f", dx {float((dx - plain[2]).abs().max()):.3g}" if want_dx else ""),
                  flush=True)
            calls[f"{name} device"] = call
        rounds = {k: [] for k in calls}
        for r in range(args.rounds):
            order = list(calls) if r % 2 == 0 else list(reversed(calls))
            for k in order:
                iters = 20 if batch < chip_smoke.BIG_B else 5
                rounds[k].append(chip_smoke.time_ms(calls[k], iters, 3,
                                                    queued=k.endswith("device")))
        report["ms"][label] = {k: statistics.median(v) for k, v in rounds.items()}
        report["ms"][label]["bound_ms"] = res["bound_ms"]
        print(f"[ms] {label} " + json.dumps(report["ms"][label]), flush=True)
        del x, grads, plain
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
