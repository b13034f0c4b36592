#!/usr/bin/env python3
"""Probe K4's routes (csrc/emd_sinkhorn.cu) on one NVIDIA GPU.

    python3 probes/emd_routes.py [--build NAME=DIR ...] [--rounds 3]
                                 [--out build/probe_emd.json]

Builds this tree's K4 library and, one nvcc each, all started together,
the K4 source of every earlier tree named by ``--build NAME=DIR`` (e.g.
the parent commit, ``git archive``d into a directory .gitignore lists; its
``atlasvae_torch/csrc/`` is enough) into build/probe_emd/.  Prints each
build's ptxas lines (registers, shared memory, spills) for its kernels.

Then, on chip_smoke.py's seeded clouds (``emd_clouds``), holds each route
of this tree against the plain version at chip_smoke.py's bars
(``parity_emd``, with the same bits asked of a second call) and times, on
the device alone (``time_ms(queued=True)``), in rounds with the calls in
order and then in reverse (the median of the rounds), at each of SHAPES:
this tree's route of the width, its wide route, and every earlier build's
route of the same name where it has one; on the cluster route, also every
cluster size of ``CLUSTERS`` that holds the width (with its largest gap to
the plain version).  Prints one JSON object as its last line.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# (label, batch, n, clouds, iterations)
SHAPES = [("emd_slice chunk", 13_421, 100, "near", 100), ("1000x233 far", 1000, 233, "far", 20),
          ("emd_slice255 chunk", 2064, 255, "near", 100), ("300x129 far", 300, 129, "far", 20),
          ("2000x176 far", 2000, 176, "far", 20), ("500x352 far", 500, 352, "far", 20),
          ("129 chunk", 8065, 129, "near", 100), ("176 chunk", 4332, 176, "near", 100)]
# (batch, n, clouds, iterations, route) held against the plain version
PARITY = [(13_421, 100, "near", 100, None), (1000, 233, "far", 20, None),
          (1000, 233, "permuted", 20, None), (2064, 255, "near", 100, None),
          (300, 129, "far", 20, None), (500, 352, "far", 20, None),
          (200, 400, "far", 20, None), (1000, 233, "far", 20, "wide"),
          (2000, 64, "far", 20, "cluster")]


def build_others(builds, out_dir):
    """nvcc of each earlier tree's K4 source with the package's flags, all
    started together.  Returns {name: (library path, ptxas log)}."""
    from atlasvae_torch.ops import cuda_build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in builds.items():
        lib = out_dir / f"libemd_{name}.so"
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
    """{kernel: [ptxas lines]} of a build log, kernels by their demangled
    template argument (emd_tile_kernel<EmdTile<...>>) or name."""
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            kernel = re.sub(r"_Z\d+emd_tile_kernelIN8atlasvae7EmdTileIL", "tile<", kernel)
            continue
        if kernel and ("registers" in line or "spill" in line or "smem" in line):
            out.setdefault(kernel, []).append(line.split("ptxas info    :")[-1].strip())
    return out


def tiles_entry(lib, name="tiles"):
    fn = getattr(lib, f"atlasvae_emd_sinkhorn_{name}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_emd.json"))
    args = ap.parse_args()
    import torch
    from atlasvae_torch.ops import cuda_build, emd, emd_cuda

    if not torch.cuda.is_available():
        print("emd_routes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    report = {"card": smi, "torch": torch.__version__, "ptxas": {}, "parity": [], "ms": {}}

    (_, seconds, log), = cuda_build.build(("emd_sinkhorn",)).values()
    report["ptxas"]["this"] = ptxas_lines(log)
    sources = {item.split("=", 1)[0]: Path(item.split("=", 1)[1]) / "atlasvae_torch" / "csrc"
               / "emd_sinkhorn.cu" for item in args.build}
    others = build_others(sources, ROOT / "build" / "probe_emd")
    for name, (_, other_log) in others.items():
        report["ptxas"][name] = ptxas_lines(other_log)
    for name, kernels in report["ptxas"].items():
        for kernel, lines in kernels.items():
            print(f"[ptxas] {name} {kernel}: {' | '.join(lines)}", flush=True)

    gen = torch.Generator(device).manual_seed(3)
    for batch, n, kind, n_iters, force in PARITY:
        res = chip_smoke.parity_emd(gen, batch, n, device, kind, n_iters, force_route=force)
        keep = {k: res[k] for k in ("batch", "n_const", "n_iters", "clouds", "route", "max_abs_err",
                                    "max_rel_err", "same_bits", "ms", "bound_ms")}
        keep.update({k: res[k] for k in ("wide_route_ms", "plain_ms") if k in res})
        report["parity"].append(keep)
        print("[parity] " + json.dumps(keep), flush=True)

    libs = {name: ctypes.CDLL(str(lib)) for name, (lib, _) in others.items()}
    for label, batch, n, kind, n_iters in SHAPES:
        p, q = chip_smoke.emd_clouds(torch.Generator(device).manual_seed(n), batch, n, device,
                                     kind)
        out = torch.empty((batch,), device=device)
        stream = torch.cuda.current_stream().cuda_stream
        args_c = (p.data_ptr(), q.data_ptr(), out.data_ptr(), batch, n, 1.0, n_iters,
                  chip_smoke.EMD_STAGES, chip_smoke.EMD_EPS)
        calls = {}
        which, size = emd_cuda.route(n)
        calls[f"this {which}"] = lambda: emd_cuda.emd_sinkhorn(
            p, q, 1.0, n_iters, chip_smoke.EMD_EPS, chip_smoke.EMD_STAGES)
        if which != "wide":
            calls["this wide"] = lambda: emd_cuda.emd_sinkhorn(
                p, q, 1.0, n_iters, chip_smoke.EMD_EPS, chip_smoke.EMD_STAGES, force_route="wide")
        for name, lib in libs.items():
            if which != "wide" and hasattr(lib, f"atlasvae_emd_sinkhorn_{which}"):
                calls[f"{name} {which}"] = (lambda fn=tiles_entry(lib, which), name=name:
                                            cuda_build.check(fn(*args_c, size, stream), name))
        if which == "cluster":   # every cluster that holds n, through the entry
            want = emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, chip_smoke.EMD_EPS,
                                         chip_smoke.EMD_STAGES).cpu()
            plain = emd._sinkhorn_emd(p, q, 1.0, n_iters, chip_smoke.EMD_EPS,
                                      chip_smoke.EMD_STAGES).cpu()
            fn = emd_cuda._entries()["cluster"]
            for c in [c for c, widest in emd_cuda.CLUSTERS if n <= widest]:
                calls[f"this cluster of {c}"] = (lambda c=c: cuda_build.check(
                    fn(*args_c, c, stream), f"cluster of {c}"))
                calls[f"this cluster of {c}"]()
                print(f"[cluster] {label} cluster of {c}: largest gap to the plain version "
                      f"{float((out.cpu() - plain).abs().max()):.3g} (the route's own "
                      f"{float((want - plain).abs().max()):.3g})", flush=True)
        rounds = {k: [] for k in calls}
        for r in range(args.rounds):
            order = list(calls) if r % 2 == 0 else list(reversed(calls))
            for k in order:
                rounds[k].append(chip_smoke.time_ms(calls[k], 10, 2, queued=True))
        report["ms"][label] = {k: statistics.median(v) for k, v in rounds.items()}
        b_ms = chip_smoke.bound_emd(batch, n, n_iters)[0]
        print(f"[ms] {label} bound {b_ms:.4f} " + json.dumps(report["ms"][label]), flush=True)
        report["ms"][label]["bound_ms"] = b_ms
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
