// Dense ReLU stack + linear heads, one CTA per tile of rows, f32 on the
// CUDA cores: the fused body of K1 (fused_mlp.cu) and K2 (fused_vae.cu), for
// stacks no wider than 128, and the fused segments of their layer-wise route
// (stack_layers.cuh).
//
// Work per tile of TM rows:
//   1. the x tile is read once from HBM (coalesced: a tile of rows is one
//      contiguous span) and stored K-major (act[k * stride + row]) in shared memory;
//   2. each hidden layer h = relu(h @ W + b) reads one activation buffer, writes
//      (two ping-pong buffers), never touching HBM;
//   3. the head layer concatenates the heads' columns (a VAE encoder's
//      mean|logvar) and writes each head's rows to its own output.
// Weights are staged through shared memory in chunks of kChunkK rows by
// NC columns, zero-filled past the layer's edge, so widths that are not a
// multiple of 4 or 8 need no padding of the arrays in HBM.
//
// Each of the 256 threads owns an 8-row x 4-column register tile: per k
// it reads two float4 of activations (rows) and one float4 of weights
// (columns) from shared memory and issues 32 FMAs.
#pragma once

#include <cuda_runtime.h>

namespace atlasvae {

constexpr int kMaxHidden = 8;
constexpr int kMaxHeads = 4;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kColsPerThread = 4;
constexpr int kChunkK = 16;
constexpr int kStackRows = 128;       // TM of the fused body
constexpr int kMaxFusedWidth = 128;   // wider stacks take the layer-wise route
constexpr size_t kSmemPerSM = 233472; // an SM's 228 KB on sm_90, 1 KB of it reserved per CTA

struct StackArgs {
  const float* x;              // (batch, dims[0]) row-major
  long long batch;
  int n_hidden;                // ReLU layers before the heads
  int dims[kMaxHidden + 1];    // dims[0] = input width, dims[i + 1] = out of layer i
  const float* w[kMaxHidden];  // (dims[i], dims[i + 1]) row-major, JAX (in, out) layout
  const float* b[kMaxHidden];
  int n_heads;                 // linear heads on the last hidden activation
  int head_dims[kMaxHeads];
  const float* hw[kMaxHeads];  // (dims[n_hidden], head_dims[h])
  const float* hb[kMaxHeads];
  float* out[kMaxHeads];       // (batch, head_dims[h])
  int final_relu;              // ReLU on the heads too (fused_mlp final_activation="relu")
  int max_width;               // max(dims[0..n_hidden]), at most kMaxFusedWidth
  int act_rows[2];             // rows of the two activation buffers (launch_dense_stack sets them)
};

template <int TM>
struct TileShape {
  static constexpr int kRowGroups = TM / kRowsPerThread;
  static constexpr int kColGroups = kThreads / kRowGroups;
  static constexpr int kCols = kColGroups * kColsPerThread;  // NC: columns per pass
  static constexpr int kStride = TM + 4;                     // act row stride (floats), 16B aligned
};

template <int TM>
inline size_t stack_smem_bytes(const int (&act_rows)[2]) {
  using T = TileShape<TM>;
  return sizeof(float) * ((size_t)(act_rows[0] + act_rows[1]) * T::kStride + kChunkK * T::kCols);
}

__device__ __forceinline__ int head_of(const StackArgs& a, int n, int* col) {
  int h = 0;
  while (h + 1 < a.n_heads && n >= a.head_dims[h]) {
    n -= a.head_dims[h];
    ++h;
  }
  *col = n;
  return h;
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
dense_stack_kernel(const __grid_constant__ StackArgs a) {
  using T = TileShape<TM>;
  constexpr int NC = T::kCols;
  constexpr int S = T::kStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* const act0 = smem;
  float* const act1 = smem + (size_t)a.act_rows[0] * S;
  float* const ws = smem + (size_t)(a.act_rows[0] + a.act_rows[1]) * S;

  const int tid = threadIdx.x;
  const int r0 = (tid / T::kColGroups) * kRowsPerThread;
  const int c0 = (tid % T::kColGroups) * kColsPerThread;
  const long long row0 = (long long)blockIdx.x * TM;
  const long long left = a.batch - row0;
  const int rows = left < TM ? (int)left : TM;

  // x tile -> act0, K-major; rows past the batch end are zero
  {
    const int d0 = a.dims[0];
    const float* xt = a.x + row0 * d0;
    for (int i = tid; i < TM * d0; i += kThreads) {
      const int r = i / d0;
      const int k = i - r * d0;
      act0[k * S + r] = r < rows ? __ldg(xt + i) : 0.f;
    }
  }

  int head_total = 0;
  for (int h = 0; h < a.n_heads; ++h) head_total += a.head_dims[h];

  for (int l = 0; l <= a.n_hidden; ++l) {
    const bool head = l == a.n_hidden;
    const int K = a.dims[l];
    const int N = head ? head_total : a.dims[l + 1];
    const float* in = (l & 1) ? act1 : act0;
    float* nxt = (l & 1) ? act0 : act1;

    for (int n0 = 0; n0 < N; n0 += NC) {
      float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;

      for (int k0 = 0; k0 < K; k0 += kChunkK) {
        __syncthreads();  // input activations written / previous chunk consumed
        for (int i = tid; i < kChunkK * NC; i += kThreads) {
          const int kk = i / NC;
          const int n = n0 + (i - kk * NC);
          const int k = k0 + kk;
          float v = 0.f;
          if (k < K && n < N) {
            if (head) {
              int c;
              const int h = head_of(a, n, &c);
              v = __ldg(a.hw[h] + (size_t)k * a.head_dims[h] + c);
            } else {
              v = __ldg(a.w[l] + (size_t)k * N + n);
            }
          }
          ws[i] = v;
        }
        __syncthreads();
        const int kmax = min(kChunkK, K - k0);
#pragma unroll 4
        for (int kk = 0; kk < kmax; ++kk) {
          const float* ak = in + (k0 + kk) * S + r0;
          const float4 a0 = *reinterpret_cast<const float4*>(ak);
          const float4 a1 = *reinterpret_cast<const float4*>(ak + 4);
          const float4 wv = *reinterpret_cast<const float4*>(ws + kk * NC + c0);
          const float av[kRowsPerThread] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float wj[kColsPerThread] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = fmaf(av[r], wj[j], acc[r][j]);
        }
      }

      const bool relu = !head || a.final_relu;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int n = n0 + c0 + j;
        if (n >= N) continue;
        if (head) {
          int c;
          const int h = head_of(a, n, &c);
          const int width = a.head_dims[h];
          const float bias = __ldg(a.hb[h] + c);
          float* o = a.out[h] + row0 * width + c;
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            if (r0 + r >= rows) break;
            float v = acc[r][j] + bias;
            if (relu) v = fmaxf(v, 0.f);
            o[(size_t)(r0 + r) * width] = v;
          }
        } else {
          const float bias = __ldg(a.b[l] + n);
          float v[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) v[r] = fmaxf(acc[r][j] + bias, 0.f);
          float4* dst = reinterpret_cast<float4*>(nxt + n * S + r0);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  }
}

// One CTA per 128-row tile.  The two activation buffers hold max_width rows
// each, unless that lets only one CTA fit an SM: then each holds as few rows
// as its layers need (layer l reads buffer l % 2), so that the 128 -> 64
// segment of the constituents-mode encoder takes 105 KB and two CTAs fit.
// Equal buffers otherwise: at the canonical widths the smaller buffers fit
// three CTAs an SM, which made the 65,536-row scoring chunk slower on an
// H100 (512 tiles: 1.3 waves of 396 in place of 1.9 of 264).  Returns the
// launch error, or cudaSuccess.
inline cudaError_t launch_dense_stack(StackArgs a, cudaStream_t stream) {
  constexpr int TM = kStackRows;
  if (a.batch <= 0) return cudaSuccess;
  if (a.max_width > kMaxFusedWidth) return cudaErrorInvalidValue;
  a.act_rows[0] = a.act_rows[1] = a.max_width;
  if (2 * (stack_smem_bytes<TM>(a.act_rows) + 1024) > kSmemPerSM) {
    a.act_rows[0] = a.act_rows[1] = 0;
    for (int l = 0; l <= a.n_hidden; ++l)
      if (a.dims[l] > a.act_rows[l & 1]) a.act_rows[l & 1] = a.dims[l];
  }
  const size_t smem = stack_smem_bytes<TM>(a.act_rows);
  cudaError_t err = cudaFuncSetAttribute(dense_stack_kernel<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.batch + TM - 1) / TM);
  dense_stack_kernel<TM><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace atlasvae
