#!/usr/bin/env python3
"""Probe the row products' TF32 split (csrc/gemm_wgmma.cuh::split_rna) on
one NVIDIA GPU.

    python3 probes/split_words.py [--build NAME=DIR ...]
                                  [--out build/probe_split_words.json]

Checks the split of this tree and of every tree named by ``--build NAME=DIR``
(an earlier commit or a variant, ``git archive``d or copied into a directory
.gitignore lists; its ``split_rna(x, hi, lo)``) on every one of the 2^32
float words, on the card, and counts the words that break its contract:

* ``finite``: a finite x whose magnitude bits are below 0x7F7FF000 gives the
  hi and lo words of the integer split the row products used before,
  (u + 0x1000) & 0xFFFFE000 for both;
* ``near_max``: from 0x7F7FF000 up to FLT_MAX, hi is the largest finite TF32
  value of x's sign and lo is x - hi rounded to TF32, finite;
* ``inf``: hi as above and lo the inf itself;
* ``nan``: hi or lo is a NaN, so that every product carries it.

Prints the smallest word that breaks each check, with its hi and lo.

Then builds every tree's K1/K2/K3 libraries (fused_vae, fused_vae_bwd) and
prints each row-product kernel's SASS opcode mix (cuobjdump): the whole
function's count of each opcode.  Prints one
JSON object as its last line; exits 1 if this tree's split breaks a check.
"""

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "probes"))

CHECKS = ("finite", "near_max", "inf", "nan")
SOURCE = r"""
#include "gemm_wgmma.cuh"

namespace {
__device__ __forceinline__ uint32_t int_rna(uint32_t u) { return (u + 0x1000u) & 0xFFFFE000u; }

// counts[2 c] words of check c seen, counts[2 c + 1] of them broken;
// first[c] the smallest broken word of check c
__global__ void check_words(unsigned long long* counts, unsigned* first) {
  unsigned long long mine[8] = {};
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const uint32_t u = (uint32_t)i, mag = u & 0x7FFFFFFFu, sign = u & 0x80000000u;
    const float x = __uint_as_float(u);
    uint32_t hi, lo;
    atlasvae::wg::split_rna(x, hi, lo);
    const float fh = __uint_as_float(hi), fl = __uint_as_float(lo);
    int c;
    bool broken;
    if (mag < 0x7F7FF000u) {
      const uint32_t ph = int_rna(u), pl = int_rna(__float_as_uint(x - __uint_as_float(ph)));
      c = 0;
      broken = hi != ph || lo != pl;
    } else if (mag < 0x7F800000u) {
      c = 1;
      broken = hi != (sign | 0x7F7FE000u) || lo != int_rna(__float_as_uint(x - fh)) ||
               !isfinite(fl);
    } else if (mag == 0x7F800000u) {
      c = 2;
      broken = hi != (sign | 0x7F7FE000u) || lo != u;
    } else {
      c = 3;
      broken = !isnan(fh) && !isnan(fl);
    }
    mine[2 * c] += 1;
    if (broken) {
      mine[2 * c + 1] += 1;
      atomicMin(first + c, u);
    }
  }
  for (int c = 0; c < 8; ++c) atomicAdd(counts + c, mine[c]);
}

__global__ void split_of(const unsigned* words, unsigned* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    atlasvae::wg::split_rna(__uint_as_float(words[i]), out[2 * i], out[2 * i + 1]);
}
}  // namespace

// host_counts: 8 counts; host_first: the 4 smallest broken words (or
// 0xFFFFFFFF), then each one's hi and lo
extern "C" int split_words_check(unsigned long long* host_counts, unsigned* host_first) {
  unsigned long long* counts = nullptr;
  unsigned* first = nullptr;
  cudaError_t err = cudaMalloc(&counts, 8 * sizeof(unsigned long long));
  if (err == cudaSuccess) err = cudaMalloc(&first, 12 * sizeof(unsigned));
  if (err == cudaSuccess) err = cudaMemset(counts, 0, 8 * sizeof(unsigned long long));
  if (err == cudaSuccess) err = cudaMemset(first, 0xFF, 12 * sizeof(unsigned));
  if (err == cudaSuccess) {
    check_words<<<132 * 8, 256>>>(counts, first);
    split_of<<<1, 32>>>(first, first + 4, 4);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(host_counts, counts, 8 * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  if (err == cudaSuccess)
    err = cudaMemcpy(host_first, first, 12 * sizeof(unsigned), cudaMemcpyDeviceToHost);
  cudaFree(counts);
  cudaFree(first);
  return (int)err;
}
"""
KERNELS = re.compile(r"rows_wgmma_kernel|bwd_rows_kernel|bwd_dw_kernel")


def build_check(cuda_build, out_dir):
    """The word check built against the split of one tree's csrc/."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "split_words.cu", out_dir / "libsplit_words.so"
    src.write_text(SOURCE)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
           str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}\n{done.stderr}")
    return lib


def sass_mix(cuobjdump, library):
    """{kernel: {opcode with its modifiers: count, "total": n}} over the
    row-product kernels."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300).stdout
    mix, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            name = name if KERNELS.search(name) else None
            if name:
                mix[name] = collections.Counter()
        elif name and "*/" in line and re.search(r"/\*[0-9a-f]{4}\*/", line):
            toks = line.split("*/", 1)[1].split()
            if not toks:
                continue
            op = toks[1] if toks[0].startswith("@") and len(toks) > 1 else toks[0]
            mix[name]["total"] += 1
            mix[name][op.rstrip(";")] += 1
    return {k: dict(v) for k, v in mix.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_split_words.json"))
    args = ap.parse_args()
    import torch
    from atlasvae_torch.ops import cuda_build
    from stack_forward import load_tree

    if not torch.cuda.is_available():
        print("split_words: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    report = {"card": smi, "words": {}, "sass": {}}
    cuobjdump = str(Path(cuda_build.nvcc_path()).with_name("cuobjdump"))
    trees = {"this": cuda_build}
    for item in args.build:
        tree, root = item.split("=", 1)
        trees[tree] = load_tree(tree, Path(root).resolve())[2]
    for tree, builder in trees.items():
        lib = ctypes.CDLL(str(build_check(builder, ROOT / "build" / "split_words" / tree)))
        counts, first = (ctypes.c_ulonglong * 8)(), (ctypes.c_uint * 12)()
        err = lib.split_words_check(counts, first)
        if err != 0:
            raise RuntimeError(f"split_words_check: CUDA error {err}")
        if sum(counts) != 2 ** 32 + sum(counts[1::2]):
            raise AssertionError("the check did not see every word once")
        for c, name in enumerate(CHECKS):
            row = {"words": counts[2 * c], "broken": counts[2 * c + 1]}
            if row["broken"]:   # the smallest broken word, its hi and lo
                row["first"] = [f"0x{first[c]:08X}", f"0x{first[4 + 2 * c]:08X}",
                                f"0x{first[5 + 2 * c]:08X}"]
            report["words"].setdefault(tree, {})[name] = row
            print(f"[words] {tree} {name} " + json.dumps(row), flush=True)
    for tree, builder in trees.items():
        for name, (path, _, _) in builder.build(("fused_vae", "fused_vae_bwd")).items():
            for kernel, mix in sass_mix(cuobjdump, path).items():
                report["sass"].setdefault(tree, {})[f"{name} {kernel}"] = mix
                print(f"[sass] {tree} {name} {kernel[:60]} {json.dumps(mix)}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 1 if any(v["broken"] for v in report["words"]["this"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
