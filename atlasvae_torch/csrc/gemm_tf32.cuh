// 3xTF32 on the tensor cores: the split of an f32 operand into TF32 parts,
// the m16n8k8 product the fused body (dense_stack.cuh) runs on, and its
// cp.async copies.  The layer-wise row product runs on wgmma
// (gemm_wgmma.cuh) with the same split.
//
// Why 3xTF32: f32 FMAs on the CUDA cores top out near 36 TFLOP/s in a
// register tile, about half the 67 peak, while the tensor cores run TF32 at
// several times that.  Each f32 operand x splits into a TF32 high part
// hi = rna(x) and a TF32 residual lo = rna(x - hi); a*b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three TF32 products with f32
// accumulators (the small terms first).  hi + lo keeps about 22 of the 24
// significand bits of x, and lo_a lo_b is left out, so a product is good to
// about 2^-22 of itself: a few times float32's own rounding (2^-24), not
// equal to it.  On an H100 the outputs of the 300- and 312-wide stacks came
// 3.8e-6 to 6.2e-6 from the plain version (bar 1e-5 + 1e-5 |ref|).  The
// tensor cores add a product into their f32 accumulator without rounding to
// nearest, and over the 39 k-steps of a 312-wide layer that drift reached
// 3e-5 of the output on an H100 (bar: 1e-5 + 1e-5 |ref|).  So a run of
// k-steps goes into a fresh accumulator that starts at 0, and the running
// sum takes it with an ordinary f32 add, rounded to nearest: the drift stays
// within the run.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "nan_math.cuh"

namespace atlasvae {
namespace tf32 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 4 bytes, or write zeros where !valid (src is then not read).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// hi saturates at the largest finite TF32 value: an infinite x leaves its
// inf to lo (inf - hi), so that the product is +-inf of the f32 product's
// sign and not NaN (gemm_wgmma.cuh, split_rna); a NaN stays a NaN.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.satfinite.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d = a b + c on one m16n8k8 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                                    const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

}  // namespace tf32
}  // namespace atlasvae
