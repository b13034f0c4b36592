// Row products of K1 and K2's layer-wise forward on the tensor cores, in
// 3xTF32: out_s (rows x n_s) = epilogue(A W_s) for up to kMaxSeg column
// segments W_s (the heads of a stack, one product without a copy), A the
// (rows, k) row-major activations, W_s (k, n_s) row-major as the model keeps
// it, bias and optional ReLU in the epilogue.
//
// Why 3xTF32: the f32 tile of gemm_tile.cuh tops out near 36 TFLOP/s of
// FMAs, about half the CUDA cores' 67, while the tensor cores run TF32 at
// several times that.  Each f32 operand x splits into a TF32 high part
// hi = rna(x) and a TF32 residual lo = rna(x - hi); a*b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three mma.sync.m16n8k8 with f32
// accumulators (the small terms first).  hi + lo keeps about 22 of the 24
// significand bits of x, and lo_a lo_b is left out, so a product is good to
// about 2^-22 of itself: a few times float32's own rounding (2^-24), not
// equal to it.  On an H100 the outputs of the 300- and 312-wide stacks came
// 3.8e-6 to 6.2e-6 from the plain version (bar 1e-5 + 1e-5 |ref|), where
// the f32 tile of gemm_tile.cuh matched it bit for bit.  The tensor cores
// add a product into their f32 accumulator without rounding to nearest, and
// over the 39 k-steps of a 312-wide layer that drift reached 3e-5 of the
// output on an H100 (bar: 1e-5 + 1e-5 |ref|).  So each k-step's three
// products go into a fresh accumulator that starts at 0, and the running sum
// takes it with an ordinary f32 add, rounded to nearest: the drift stays
// within one k-step, and the running sum rounds as an in-order f32 sum does.
//
// The tile: 128 rows x BN columns (128, 64 or 32) a CTA of 8 warps, each
// warp 16 MT rows x 32 columns (MT m16 tiles x 4 n8 tiles, 4 accumulators
// each); k in chunks of 32 through a 3-stage ring of cp.async copies in
// shared memory, so two chunks are in flight while one is multiplied.  A
// and W lie as the fragments want them (A's rows along k, W's rows along
// n), so both are copied as they lie, 16 bytes a thread where k, every
// width and every pointer allow it (else 4 bytes), zero-filled past the
// edges by the copy itself.  Rows of shared memory are padded (A by 4
// floats, W by 8) so that every fragment read of a warp hits 32 distinct
// banks.  One CTA per (row tile, column tile), column tiles of a row tile
// adjacent in launch order, so a tile of A is read from HBM once and from
// L2 by its other column tiles.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace atlasvae {
namespace tf32 {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kSA = kBK + 4;  // A's row stride in shared memory (floats)
constexpr int kMaxSeg = 4;

struct RowsArgs {
  const float* a;               // (rows, k) row-major
  long long rows;
  int k;
  int n;                        // columns: the segments' widths summed
  int nseg;
  int nbeg[kMaxSeg + 1];        // segment s holds columns [nbeg[s], nbeg[s + 1])
  const float* w[kMaxSeg];      // (k, width of s) row-major
  const float* bias[kMaxSeg];
  float* out[kMaxSeg];          // (rows, width of s) row-major
  int relu;
  int vec_a, vec_b;             // 16-byte copies of A, of W
  int vec_out;                  // 8-byte stores: every segment edge even, outputs 8-byte aligned
  int tiles_n;
};

template <int BN>
struct Shape {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMT = kBM / kWarpsM / 16;  // m16 tiles a warp
  static constexpr int kSB = BN + 8;              // W's row stride in shared memory
  static constexpr int kStageFloats = kBM * kSA + kBK * kSB;
  static constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (4) bytes, or write zeros where !valid (src is then not read).
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
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

__device__ __forceinline__ int segment_of(const RowsArgs& g, int n) {
  int s = 0;
  while (s + 1 < g.nseg && n >= g.nbeg[s + 1]) ++s;
  return s;
}

// W's element (k, n), or g.a (any address: not read) where it is past the edge.
__device__ __forceinline__ const float* w_at(const RowsArgs& g, int k, int n, bool valid) {
  if (!valid) return g.a;
  const int s = segment_of(g, n);
  return g.w[s] + (long long)k * (g.nbeg[s + 1] - g.nbeg[s]) + (n - g.nbeg[s]);
}

// Issue the copies of chunk k0 of A's rows m0.. and W's columns n0.. .
template <int BN>
__device__ __forceinline__ void load_chunk(const RowsArgs& g, float* As, float* Bs, long long m0,
                                           int n0, int k0) {
  using S = Shape<BN>;
  const int tid = threadIdx.x;
  if (g.vec_a) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 4), kq = (c % (kBK / 4)) * 4;
      const long long m = m0 + r;
      const int k = k0 + kq;
      const bool ok = m < g.rows && k < g.k;
      copy16(As + r * kSA + kq, ok ? g.a + m * g.k + k : g.a, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const long long m = m0 + r;
      const int k = k0 + kk;
      const bool ok = m < g.rows && k < g.k;
      copy4(As + r * kSA + kk, ok ? g.a + m * g.k + k : g.a, ok);
    }
  }
  if (g.vec_b) {
#pragma unroll
    for (int i = 0; i < kBK * BN / 4 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c / (BN / 4), nq = (c % (BN / 4)) * 4;
      const int k = k0 + kr, n = n0 + nq;
      const bool ok = k < g.k && n < g.n;
      copy16(Bs + kr * S::kSB + nq, w_at(g, k, n, ok), ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * BN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kr = e / BN, nn = e % BN;
      const int k = k0 + kr, n = n0 + nn;
      const bool ok = k < g.k && n < g.n;
      copy4(Bs + kr * S::kSB + nn, w_at(g, k, n, ok), ok);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2) rows_tf32_kernel(const __grid_constant__ RowsArgs g) {
  using S = Shape<BN>;
  constexpr int MT = S::kMT;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const long long m0 = (long long)(blockIdx.x / g.tiles_n) * kBM;
  const int n0 = (int)(blockIdx.x % g.tiles_n) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / S::kWarpsN) * (MT * 16), wn0 = (warp % S::kWarpsN) * 32;
  const int gq = lane / 4, t = lane % 4;

  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_chunks = (g.k + kBK - 1) / kBK;
  auto As = [&](int stage) { return smem + stage * S::kStageFloats; };
  auto Bs = [&](int stage) { return smem + stage * S::kStageFloats + kBM * kSA; };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk<BN>(g, As(s), Bs(s), m0, n0, s * kBK);
    commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    wait<kStages - 2>();  // chunk c has landed (this thread's copies) ...
    __syncthreads();      // ... everyone's; and chunk c - 1's slot is free
    const int next = c + kStages - 1;
    if (next < n_chunks) load_chunk<BN>(g, As(next % kStages), Bs(next % kStages), m0, n0, next * kBK);
    commit();
    const float* as = As(c % kStages);
    const float* bs = Bs(c % kStages);
    // one k-step at a time: unrolled over the chunk, the loop's loads run
    // ahead and need more than the 128 registers two CTAs an SM leave (the
    // 128-column tile spilled), and it ran slower on an H100
#pragma unroll 1
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn0 + j * 8 + gq;
        split(bs[(kk + t) * S::kSB + n], bh[j][0], bl[j][0]);
        split(bs[(kk + t + 4) * S::kSB + n], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ar = as + (wm0 + i * 16 + gq) * kSA + kk + t;
        uint32_t ah[4], al[4];
        split(ar[0], ah[0], al[0]);
        split(ar[8 * kSA], ah[1], al[1]);
        split(ar[4], ah[2], al[2]);
        split(ar[8 * kSA + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the three products of this k-step in a fresh sum, added to the
          // running one by an f32 add (see the note on accumulation above)
          float part[4];
          mma(part, al, bh[j], zero);
          mma(part, ah, bl[j], part);
          mma(part, ah, bh[j], part);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
        }
      }
    }
  }
  wait<0>();

  // accumulator e of (i, j): row gq (+ 8 for e >= 2), column 2 t (+ 1 for odd e)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn0 + j * 8 + 2 * t;
    if (g.vec_out) {  // n even, every segment edge even: columns n, n + 1 in one segment
      if (n >= g.n) continue;
      const int s = segment_of(g, n);
      const int width = g.nbeg[s + 1] - g.nbeg[s];
      const float* bias = g.bias[s] + (n - g.nbeg[s]);
      const float b0 = __ldg(bias), b1 = __ldg(bias + 1);
      float* const col = g.out[s] + (n - g.nbeg[s]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e0 = 0; e0 < 2; ++e0) {
          const long long m = m0 + wm0 + i * 16 + gq + 8 * e0;
          if (m >= g.rows) continue;
          float2 v = make_float2(acc[i][j][2 * e0] + b0, acc[i][j][2 * e0 + 1] + b1);
          if (g.relu) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
          *reinterpret_cast<float2*>(col + m * width) = v;
        }
      }
      continue;
    }
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int nc = n + e1;
      if (nc >= g.n) continue;
      const int s = segment_of(g, nc);
      const int width = g.nbeg[s + 1] - g.nbeg[s];
      const float bias = __ldg(g.bias[s] + (nc - g.nbeg[s]));
      float* const col = g.out[s] + (nc - g.nbeg[s]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e0 = 0; e0 < 2; ++e0) {
          const long long m = m0 + wm0 + i * 16 + gq + 8 * e0;
          if (m >= g.rows) continue;
          float v = acc[i][j][2 * e0 + e1] + bias;
          if (g.relu) v = fmaxf(v, 0.f);
          col[m * width] = v;
        }
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BN>
inline cudaError_t launch_t(RowsArgs g, cudaStream_t st) {
  using S = Shape<BN>;
  cudaError_t err = cudaFuncSetAttribute(rows_tf32_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::kSmemBytes);
  if (err != cudaSuccess) return err;
  g.tiles_n = (g.n + BN - 1) / BN;
  const long long ctas = ((g.rows + kBM - 1) / kBM) * g.tiles_n;
  if (ctas >= (1ll << 31)) return cudaErrorInvalidValue;
  rows_tf32_kernel<BN><<<(unsigned)ctas, kThreads, S::kSmemBytes, st>>>(g);
  return cudaGetLastError();
}

// Fills the copy widths from the shapes and pointers, and launches with a
// column tile of bn (128, 64 or 32) columns.
inline cudaError_t launch_rows(int bn, RowsArgs g, cudaStream_t st) {
  if (g.rows <= 0) return cudaSuccess;
  if (g.nseg < 1 || g.nseg > kMaxSeg || g.k < 1) return cudaErrorInvalidValue;
  g.vec_a = g.k % 4 == 0 && aligned16(g.a);
  g.vec_b = 1;
  for (int s = 0; s < g.nseg; ++s)
    g.vec_b = g.vec_b && g.nbeg[s] % 4 == 0 && aligned16(g.w[s]);
  g.vec_b = g.vec_b && g.nbeg[g.nseg] % 4 == 0;
  g.vec_out = 1;
  for (int s = 0; s < g.nseg; ++s)
    g.vec_out = g.vec_out && g.nbeg[s + 1] % 2 == 0 &&
                (reinterpret_cast<uintptr_t>(g.out[s]) & 7) == 0;
  switch (bn) {
    case 128: return launch_t<128>(g, st);
    case 64: return launch_t<64>(g, st);
    case 32: return launch_t<32>(g, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tf32
}  // namespace atlasvae
