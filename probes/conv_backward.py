#!/usr/bin/env python3
"""Probe K6's register route (csrc/fused_conv_bwd.cu) on one NVIDIA GPU.

    python3 probes/conv_backward.py [--out build/probe_conv_backward.json]

Builds the kernel as it is and variants of its design choices, one nvcc
each, all started together, into build/probe_conv_backward/: its first
form, which divided each pixel's index anew instead of stepping it by the
slot stride, with other numbers of partial slices (kTileParts), the pixel
loop unrolled twice, a register cap for two CTAs an SM, or the next pixel's
g loaded before this pixel's FMAs; and the form as it is with that
prefetch.  Prints each build's ptxas line (registers, stack frame, spills)
and the static opcode mix of its SASS.

Then, on sparse seeded images at the jet-ID training batch (5,000 x
16x16x1, 3x3, 100 maps, pool 2x2), a ragged batch (1,037) and the predict
chunk (20,000): holds every variant against the plain version (3e-4 of
each leaf's largest value, chip_smoke.py's bar from 1,000 images) and a
second call (the same bits), times each in interleaved rounds (CUDA events,
the median of the rounds' means), and splits the kernel as it is between
its two launches with torch.profiler (device time alone).  Beside them,
through the package's wrappers (host work included): both routes of K6,
and K5's register route (the same recompute, writing instead of reading
g).  Prints one JSON object as its last line.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "atlasvae_torch" / "csrc" / "fused_conv_bwd.cu"
LOOP = "#pragma unroll 1\n  for (int k = 0; k < per_thread; ++k) {"
PARTS = "constexpr int kTileParts = 264;"
BOUNDS = "__launch_bounds__(256)\nconv_pool_relu_bwd_tiles_kernel"
# Tuning choices of the first form (each pixel's index divided anew, DIVIDE
# below): name -> replacements in the source
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
# Load the next pixel's g before this pixel's FMAs (4 more registers).
G_LOAD = """    const float* gp = g + (size_t)pix * M + m0;
    float gv[4];
    if (vec4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(gp));
      gv[0] = t.x;
      gv[1] = t.y;
      gv[2] = t.z;
      gv[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = m0 + j < M ? __ldg(gp + j) : 0.f;
    }
"""
G_PREFETCH = [
    (LOOP, """auto load_g = [&](int pix, float (&gv)[4]) {
    const float* gp = g + (size_t)pix * M + m0;
    if (vec4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(gp));
      gv[0] = t.x;
      gv[1] = t.y;
      gv[2] = t.z;
      gv[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = m0 + j < M ? __ldg(gp + j) : 0.f;
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
# slot stride: the first form of the kernel, before this probe's second run.
STEP = """  const int step_x = slots % Wo, step_y = slots / Wo;
  int ox = first % Wo, oy = first / Wo % Ho, img = first / Wo / Ho;
"""
LOOP_HEAD = "    if (pix >= pixels) break;\n"
LOOP_END = """    ox += step_x;
    oy += step_y;
    if (ox >= Wo) {
      ox -= Wo;
      ++oy;
    }
    if (oy >= Ho) {
      img += oy / Ho;
      oy %= Ho;
    }
"""
DIVIDE = [
    (STEP, ""),
    (LOOP_HEAD, LOOP_HEAD + """    const int ox = pix % Wo, rest = pix / Wo;
    const int oy = rest % Ho, img = rest / Ho;
"""),
    (LOOP_END, ""),
]
VARIANTS = {name: DIVIDE + edits for name, edits in TUNING.items()}
VARIANTS.update({
    "first_g_prefetch": DIVIDE + G_PREFETCH,
    "as_is": [],   # the slot-stride walk
    "g_prefetch": G_PREFETCH,
    "g_prefetch_parts_528": G_PREFETCH + [(PARTS, PARTS.replace("264", "528"))],
})
SHAPES = [("jetid train batch", 5000), ("ragged batch", 1037), ("jetid predict chunk", 20000)]


def sass_mix(lib):
    """Opcodes of conv_pool_relu_bwd_tiles_kernel's SASS, counted statically."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "conv_pool_relu_bwd_tiles_kernel" in line
        elif inside and line.strip().startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip().rstrip(";").split()
            if body and body[0].startswith("@"):
                body = body[1:]
            if body:
                op = body[0].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def build(out_dir):
    from atlasvae_torch.ops import cuda_build
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            assert old in src, (name, old)
            src = src.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
               "-o", str(out_dir / f"lib{name}.so"), str(path)]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (start, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        lines = log.splitlines()
        at = next(i for i, l in enumerate(lines) if "conv_pool_relu_bwd_tiles_kernel" in l
                  and "Compiling" in l)
        ptxas[name] = [l.split("info    :")[-1].strip() for l in lines[at + 1:at + 4]]
        print(f"[build] {name} {time.perf_counter() - start:.1f}s {ptxas[name]}", flush=True)
        mix = sass_mix(out_dir / f"lib{name}.so")
        print(f"[sass] {name} total={sum(mix.values())} {json.dumps(mix)}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        parts, fn = lib.atlasvae_conv_backward_tiles_parts, lib.atlasvae_conv_backward_tiles
        parts.argtypes = [ctypes.c_int] * 4
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        parts.restype = fn.restype = ctypes.c_int
        libs[name] = (parts, fn)
    return libs, ptxas


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(ROOT / "build" / "probe_conv_backward.json"))
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_conv_backward: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from atlasvae_torch.ops import fused_conv, fused_conv_cuda
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs, ptxas = build(ROOT / "build" / "probe_conv_backward")
    gen = torch.Generator("cuda").manual_seed(9)
    report = {"card": smi, "ptxas": ptxas, "shapes": {}}
    for shape_name, n in SHAPES:
        x = torch.randn((n, 16, 16, 1), generator=gen, device="cuda")
        x = x.abs() * (torch.rand(x.shape, generator=gen, device="cuda") < 0.08)
        w = torch.randn((3, 3, 1, 100), generator=gen, device="cuda") * 0.3
        b = torch.randn((100,), generator=gen, device="cuda") * 0.1
        g = torch.randn((n, 7, 7, 100), generator=gen, device="cuda") / n
        want = fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, (2, 2))
        tol = chip_smoke.CONV_GRAD_TOL_BIG if n >= 1000 else chip_smoke.CONV_GRAD_TOL
        calls, rows = {}, {}
        for name, (parts_fn, fn) in libs.items():
            parts = parts_fn(n, 16, 16, 100)
            partial = torch.empty((parts, 1000), device="cuda")
            grads = torch.empty(1000, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn=fn, parts=parts, partial=partial, grads=grads, stream=stream):
                err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                         partial.data_ptr(), parts, grads.data_ptr(), n, 16, 16, 100, stream)
                if err:
                    raise RuntimeError(f"{name}: error {err}")
                return grads

            got = call().clone()
            again = call().clone()
            torch.cuda.synchronize()
            rel = max(float((a - r).abs().max()) / float(r.abs().max())
                      for a, r in ((got[:900].view(3, 3, 1, 100), want[0]), (got[900:], want[1])))
            if not rel <= tol or not torch.equal(got, again):
                raise AssertionError(f"{name} at {shape_name}: {rel} over {tol} of a leaf, or "
                                     "other bits on a second call")
            calls[name] = call
            rows[name] = {"parts": parts, "err_over_leaf_scale": rel}
        calls["wrapper_tiles"] = lambda: fused_conv_cuda.conv_pool_relu_backward(
            x, w, b, g, (2, 2))
        calls["wrapper_bands"] = lambda: fused_conv_cuda.conv_pool_relu_backward(
            x, w, b, g, (2, 2), force_route="bands")
        calls["k5_tiles_forward"] = lambda: fused_conv_cuda.conv_pool_relu(x, w, b, (2, 2))
        times = {name: [] for name in calls}
        for _ in range(args.rounds):   # interleaved: every variant once a round
            for name, call in calls.items():
                times[name].append(chip_smoke.time_ms(call, iters=20, warmup=2))
        for name, ts in times.items():
            rows.setdefault(name, {}).update(ms=sorted(ts)[len(ts) // 2], ms_min=min(ts),
                                             ms_max=max(ts))
        # the register route's two kernels apart, in the variant as it is
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                calls["as_is"]()
            torch.cuda.synchronize()
        split = {e.key[:60]: e.self_device_time_total / e.count / 1e3
                 for e in prof.key_averages() if e.self_device_time_total > 0}
        bound = chip_smoke.bound_conv(n, 16, 16, 1, 3, 3, 100, (2, 2), True)[0]
        report["shapes"][shape_name] = {"batch": n, "bound_ms": bound, "variants": rows,
                                        "kernel_ms_as_is": split}
        for name, row in rows.items():
            print(f"[probe] {shape_name} {name} " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()),
                flush=True)
        print(f"[probe] {shape_name} bound_ms={bound:.4f} split={json.dumps(split)}", flush=True)
        del x, g, want
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
