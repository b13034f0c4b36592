#!/usr/bin/env python3
"""Probe K5's and K6's register routes (csrc/fused_conv.cu, csrc/fused_conv_bwd.cu)
on one NVIDIA GPU.

    python3 probes/conv_backward.py [--dtype float32|bfloat16] [--build NAME=DIR ...]
                                    [--no-variants] [--out build/probe_conv_<dtype>.json]

Builds, one nvcc a source, all started together, into build/probe_conv/:

* ``--dtype float32`` (the default): K6's float register route as it is
  and variants of its design choices (VARIANTS: its first form, which
  divided each pixel's index anew instead of stepping it by the slot
  stride, with other numbers of partial slices, the pixel loop unrolled
  twice, a register cap for two CTAs an SM, or the next pixel's g loaded
  before this pixel's FMAs); ``--no-variants`` builds it as it is only.
* ``--dtype bfloat16``: K5's and K6's bf16 register routes (the
  tensor-core kernels) as they are.

and, in either, both sources of every earlier tree of the repository named
by ``--build NAME=DIR`` (e.g. the parent commit, ``git archive``d into a
directory .gitignore lists; its ``atlasvae_torch/csrc/`` is enough).
Prints each build's ptxas lines (registers, shared memory, spills) and the
static opcode mix of the probed kernels' SASS (cuobjdump -sass: in float32
K5's and K6's register kernels), with the HMMA instructions by their full
name; a bf16 build without HMMA fails.

Then, on sparse seeded images (a few lit pixels: whole windows tie) at the
jet-ID training batch (5,000 x 16x16x1, 3x3, 100 maps, pool 2x2), a ragged
batch (1,037), the predict chunk (20,000) and 100,000 images: holds every
build's output and dW/db against the plain versions at chip_smoke.py's
bars and a second call (the same bits), times every build's C entry points
on preallocated buffers (``chip_smoke.time_ms(queued=True)``: the device
alone; in rounds, the builds in order and then in reverse, the median of
the rounds), the package's wrappers (host work included), and splits one
call of each build into its kernels' device times with torch.profiler.
Prints one JSON object as its last line.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "atlasvae_torch" / "csrc"
SHAPES = [("jetid train batch", 5000), ("ragged batch", 1037), ("jetid predict chunk", 20000),
          ("large batch", 100000)]
MAPS = 100
KERNELS = {"float32": ("conv_pool_relu_tiles_kernel", "conv_pool_relu_bwd_tiles_kernel"),
           "bfloat16": ("conv_pool_relu_tc_kernel", "conv_pool_relu_bwd_tc_kernel")}

LOOP = "#pragma unroll 1\n  for (int k = 0; k < per_thread; ++k) {"
PARTS = "constexpr int kTileParts = 264;"
BOUNDS = "__launch_bounds__(256)\nconv_pool_relu_bwd_tiles_kernel"
G_LOAD = """    const T* gp = g + (size_t)pix * M + m0;
    float gv[4];
    if (vec4) {
      const float4 t = load_quad(gp);
      gv[0] = t.x;
      gv[1] = t.y;
      gv[2] = t.z;
      gv[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = m0 + j < M ? load_widened(gp + j) : 0.f;
    }
"""
# Load the next pixel's g before this pixel's FMAs (4 more registers).
G_PREFETCH = [
    (LOOP, """auto load_g = [&](int pix, float (&gv)[4]) {
    const T* gp = g + (size_t)pix * M + m0;
    if (vec4) {
      const float4 t = load_quad(gp);
      gv[0] = t.x;
      gv[1] = t.y;
      gv[2] = t.z;
      gv[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = m0 + j < M ? load_widened(gp + j) : 0.f;
    }
  };
  float gn[4] = {0.f, 0.f, 0.f, 0.f};
  if (first < pixels) load_g(first, gn);
""" + LOOP),
    (G_LOAD, """    float gv[4] = {gn[0], gn[1], gn[2], gn[3]};
    if (k + 1 < per_thread && pix + slots < pixels) load_g(pix + slots, gn);
"""),
]
# Divide each pixel's index anew instead of stepping (image, oy, ox) by the
# slot stride: the float kernel's first form.
DIVIDE = [
    ("""  const int step_x = slots % Wo, step_y = slots / Wo;
  int ox = first % Wo, oy = first / Wo % Ho, img = first / Wo / Ho;
""", ""),
    ("    if (pix >= pixels) break;\n", """    if (pix >= pixels) break;
    const int ox = pix % Wo, rest = pix / Wo;
    const int oy = rest % Ho, img = rest / Ho;
"""),
    ("""    ox += step_x;
    oy += step_y;
    if (ox >= Wo) {
      ox -= Wo;
      ++oy;
    }
    if (oy >= Ho) {
      img += oy / Ho;
      oy %= Ho;
    }
""", ""),
]
TUNING = {
    "first": [],
    "parts_132": [(PARTS, PARTS.replace("264", "132"))],
    "parts_528": [(PARTS, PARTS.replace("264", "528"))],
    "parts_1056": [(PARTS, PARTS.replace("264", "1056"))],
    "parts_2112": [(PARTS, PARTS.replace("264", "2112"))],
    "unroll_2": [(LOOP, LOOP.replace("unroll 1", "unroll 2"))],
    "parts_1056_unroll_2": [(PARTS, PARTS.replace("264", "1056")),
                            (LOOP, LOOP.replace("unroll 1", "unroll 2"))],
    "two_ctas_an_sm": [(BOUNDS, BOUNDS.replace("(256)", "(256, 2)"))],
}
# edits of fused_conv_bwd.cu a float32 variant makes: name -> (old, new) pairs
VARIANTS = {name: DIVIDE + edits for name, edits in TUNING.items()}
VARIANTS.update({"first_g_prefetch": DIVIDE + G_PREFETCH, "g_prefetch": G_PREFETCH,
                 "g_prefetch_parts_528": G_PREFETCH + [(PARTS, PARTS.replace("264", "528"))]})
TEMPLATE_ARGS = {"ILb1E": "<true>", "ILb0E": "<false>", "IfE": "<float>",
                 "I13__nv_bfloat16E": "<bf16>"}


def label(line, kernels):
    """kernel<template argument> for a ptxas or cuobjdump line naming one of kernels."""
    for k in kernels:
        if k in line:
            return k + next((v for key, v in TEMPLATE_ARGS.items() if k + key in line), "")
    return None


def build_all(builds, out_dir, kernels):
    """nvcc of every build's two sources, all started together, with the
    package's flags.  builds: {name: {source: text}}.  Returns {name:
    ({source: ctypes handle}, {kernel: ptxas lines}, {kernel: opcode mix})}."""
    from atlasvae_torch.ops import cuda_build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, sources in builds.items():
        for src, text in sources.items():
            path, lib = out_dir / f"{name}_{src}.cu", out_dir / f"{name}_{src}.so"
            path.write_text(text)
            procs[name, src] = (lib, subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib),
                 str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {name: ({}, {}, {}) for name in builds}
    for (name, src), (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {src} ({name}): {log[-3000:]}")
        libs, ptxas, mix = done[name]
        libs[src] = ctypes.CDLL(str(lib))
        current = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = label(line, kernels)
            elif current and ("Used" in line or "spill" in line or "stack frame" in line):
                ptxas.setdefault(current, []).append(line.split(":", 1)[-1].strip())
        mix.update(sass_mix(lib, kernels))
    return done


def sass_mix(lib, kernels):
    """{kernel: {opcode: count}} over the SASS of lib, counted statically."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            current = label(line, kernels)
        elif current and line.strip().startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip().rstrip(";").split()
            if body and body[0].startswith("@"):
                body = body[1:]
            if body:
                op = body[0] if body[0].startswith("HMMA") else body[0].split(".")[0]
                counts.setdefault(current, {})
                counts[current][op] = counts[current].get(op, 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in counts.items()}


def entries(libs, own_fwd, bf16):
    """(forward or None, backward parts, backward) C entry points of the
    register route of one form; own_fwd: the package's forward library, for
    builds that changed only the backward."""
    p, i = ctypes.c_void_p, ctypes.c_int
    form = "_bf16" if bf16 else ""
    fwd = getattr(libs.get("fused_conv", own_fwd), "atlasvae_conv_pool_relu_tiles" + form)
    fwd.argtypes, fwd.restype = [p] * 4 + [i] * 4 + [p], i
    bwd_lib = libs["fused_conv_bwd"]
    parts = getattr(bwd_lib, "atlasvae_conv_backward_tiles_parts" + form, None) \
        or bwd_lib.atlasvae_conv_backward_tiles_parts   # earlier trees: one count for both forms
    parts.argtypes, parts.restype = [i] * 4, i
    bwd = getattr(bwd_lib, "atlasvae_conv_backward_tiles" + form)
    bwd.argtypes, bwd.restype = [p] * 5 + [i, p] + [i] * 4 + [p], i
    return fwd, parts, bwd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=tuple(KERNELS), default="float32")
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probes/conv_backward.py: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from atlasvae_torch.ops import cuda_build, fused_conv, fused_conv_cuda
    from atlasvae_torch.utils.bf16 import ulp, ulps_apart
    torch.backends.cudnn.allow_tf32 = False
    bf16 = args.dtype == "bfloat16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    kernels = KERNELS[args.dtype]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    own = {src: (CSRC / f"{src}.cu").read_text() for src in ("fused_conv", "fused_conv_bwd")}
    sources = {"as_is": own}
    if not bf16 and not args.no_variants:
        for name, edits in VARIANTS.items():
            text = own["fused_conv_bwd"]
            for old, new in edits:
                assert old in text, (name, old)
                text = text.replace(old, new)
            sources[name] = {"fused_conv_bwd": text}
    for item in args.build:
        name, tree = item.split("=", 1)
        csrc = Path(tree).resolve() / "atlasvae_torch" / "csrc"
        sources[name] = {src: (csrc / f"{src}.cu").read_text().replace(
            '#include "fused_conv.cuh"', f'#include "{csrc / "fused_conv.cuh"}"') for src in own}
    built = build_all(sources, ROOT / "build" / "probe_conv", kernels)
    report = {"card": smi, "dtype": args.dtype, "torch": torch.__version__, "builds": {}}
    builds = {}
    for name, (libs, ptxas, mix) in built.items():
        report["builds"][name] = {"ptxas": ptxas, "sass": mix}
        for k in sorted(set(ptxas) | set(mix)):
            print(f"[build] {name} {k}: {' | '.join(ptxas.get(k, []))} "
                  f"total={sum(mix.get(k, {}).values())} {json.dumps(mix.get(k, {}))}", flush=True)
        if bf16 and name == "as_is" and not all(
                any(op.startswith("HMMA") for op in mix.get(k + v, {}))
                for k in kernels for v in ("<true>", "<false>")):
            raise SystemExit("a tensor-core kernel has no HMMA instruction")
        builds[name] = entries(libs, cuda_build.load("fused_conv"), bf16)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    report["shapes"] = {}
    for shape_name, n in SHAPES:
        x = torch.randn((n, 16, 16, 1), generator=gen, device=dev)
        x = (x.abs() * (torch.rand(x.shape, generator=gen, device=dev) < 0.08)).to(dtype)
        w = (torch.randn((3, 3, 1, MAPS), generator=gen, device=dev) * 0.3).to(dtype)
        b = (torch.randn((MAPS,), generator=gen, device=dev) * 0.1).to(dtype)
        want = fused_conv.conv1_pool_relu_plain(x, w, b, (2, 2))
        g = (torch.randn(want.shape, generator=gen, device=dev) / n).to(dtype)
        want_grads = fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, (2, 2))
        tol = chip_smoke.CONV_GRAD_TOL_BIG if n >= 1000 else chip_smoke.CONV_GRAD_TOL
        calls, facts = {}, {}
        for name, (fwd, parts_fn, bwd) in builds.items():
            out, parts = torch.empty_like(want), parts_fn(n, 16, 16, MAPS)
            partial = torch.empty((parts, 10 * MAPS), device=dev)
            grads = torch.empty(10 * MAPS, device=dev, dtype=dtype)
            call_f = lambda fwd=fwd, out=out: fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                   out.data_ptr(), n, 16, 16, MAPS, stream())
            call_b = lambda bwd=bwd, parts=parts, partial=partial, grads=grads: bwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), partial.data_ptr(),
                parts, grads.data_ptr(), n, 16, 16, MAPS, stream())
            if call_f() or call_b():
                raise RuntimeError(f"{name}: a launch failed")
            torch.cuda.synchronize()
            first_out, first_grads = out.clone(), grads.clone()
            call_f(), call_b()
            torch.cuda.synchronize()
            gap = (out.float() - want.float()).abs()
            if bf16:
                ok = bool(((ulps_apart(out, want) <= 1) | (gap <= chip_smoke.ATOL)).all())
            else:
                ok = bool((gap <= chip_smoke.ATOL + chip_smoke.RTOL * want.abs()).all())
            rel = []
            for got, ref in zip((grads[:9 * MAPS].view(3, 3, 1, MAPS), grads[9 * MAPS:]),
                                want_grads):
                scale = float(ref.float().abs().max())
                d = (got.float() - ref.float()).abs()
                ok &= bool((d <= tol * scale + 1e-12 + (ulp(ref) if bf16 else 0.0)).all())
                rel.append(float(d.max()) / scale)
            facts[name] = dict(parts=parts, within_bars=ok, dw_db_err_over_leaf_scale=rel,
                               same_bits=torch.equal(out, first_out)
                               and torch.equal(grads, first_grads))
            calls[name] = {"forward": call_f, "backward": call_b}
        times = {(name, d): [] for name in calls for d in ("forward", "backward")}
        order = list(calls) + list(calls)[::-1]
        for _ in range(args.rounds):
            for name in order:
                for d, fn in calls[name].items():
                    times[name, d].append(chip_smoke.time_ms(fn, args.iters, 2, queued=True))
        for name in calls:
            for d, fn in calls[name].items():
                facts[name][f"{d}_ms"] = statistics.median(times[name, d])
                facts[name][f"{d}_ms_min_max"] = [min(times[name, d]), max(times[name, d])]
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                facts[name][f"{d}_kernels_ms"] = [
                    (re.sub(r"\(.*", "", e.name.replace("void ", "").replace("atlasvae::", "")),
                     round(e.device_time_total / 1e3, 4))
                    for e in prof.events() if e.device_type == DeviceType.CUDA]
        wrappers = {"forward": lambda: fused_conv_cuda.conv_pool_relu(x, w, b, (2, 2)),
                    "backward": lambda: fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, (2, 2))}
        for d, fn in wrappers.items():
            facts[f"wrapper_{d}_ms"] = statistics.median(
                chip_smoke.time_ms(fn, args.iters, 2) for _ in range(3))
        facts["bound_ms"] = {d: chip_smoke.bound_conv(n, 16, 16, 1, 3, 3, MAPS, (2, 2),
                                                      d == "backward", elem=2 if bf16 else 4)[0]
                             for d in ("forward", "backward")}
        report["shapes"][shape_name] = facts
        for name, row in facts.items():
            print(f"[probe] {shape_name} (n={n}) {name} {json.dumps(row)}", flush=True)
        del x, w, b, g, want, want_grads, calls
        torch.cuda.empty_cache()
    out = Path(args.out or ROOT / "build" / f"probe_conv_{args.dtype}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    ok = all(f["as_is"]["within_bars"] and f["as_is"]["same_bits"]
             for f in report["shapes"].values())
    print(json.dumps({"ok": ok, "card": smi, "dtype": args.dtype, "out": str(out)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
