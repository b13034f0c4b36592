// K3: backward of the dense stack with linear heads (K2's gradient: the VAE
// encoder's and decoder's backward in every training step).
//
// Replaces atlasvae/ops/fused_vae.py:130 _stack_bwd_kernel (Pallas, TPU): it
// recomputes the forward activations, backpropagates the head gradients
// through the heads and the ReLU masks, and sums dW/db over all rows; dx only
// on request (the decoder needs dz, the encoder's input is data).  The TPU
// kernel summed dW/db in output blocks revisited by a grid that runs in order
// on one core.  Here CTAs run in parallel and in no order, so each CTA (or
// row split) sums into its own slice of a scratch buffer, and a second kernel
// adds the slices in slice order: the same bits on every run and every card,
// no float atomics.  Two routes; ops/fused_vae.py::backward_plan picks one by
// the stack's shape alone.
//
// 1. The fused body (stack_bwd_kernel), for stacks no wider than 128 whose
//    64-row tile fits a CTA (the canonical 12->80/40/20 + 2x10 VAE).  Per
//    tile of rows, in shared memory: every layer's activation (feature-major,
//    act[k * S + row]), two ping-pong gradient buffers and one staged chunk of
//    a weight matrix; the row-by-feature products reuse the register tiling
//    of dense_stack.cuh (8 rows x 4 columns a thread).  Bound at B = 10,000
//    rows, canonical encoder, no dx: about 29 kFLOP and 128 B of HBM traffic
//    a row, 230 FLOP/B, far above the f32 ridge of 20, so 4.4 us of f32 work
//    on an H100, spread over 157 tiles on 132 SMs: one wave, bound by launch
//    latency, barriers and occupancy.  One launch, all activations on chip,
//    two CTAs an SM (93 KB of shared memory each).
//
// 2. The layer-wise route (the rest of this file), for everything else: the
//    constituents-mode 312->256/128/64 + 2x32 encoder and its decoder, and
//    stacks whose fused tile does not fit.  At 312 wide the fused body's
//    tile held 200 KB (one CTA an SM), restaged all 500 KB of weights twice
//    per 32 rows with uncoalesced transposed reads, and read-modified-wrote
//    every CTA's whole dW slice per tile.  Here each product is one launch of
//    the register-tiled GEMM of gemm_tile.cuh over the whole batch:
//      recompute  a_l = relu(a_{l-1} W_l + b_l)          row product, a_l to a
//                 scratch buffer of batch x sum(hidden widths): the one HBM
//                 round trip the design accepts (1.8 GB at 1,000,003 rows);
//      heads      dW_h = a_L^T g_h, db_h = sum g_h         split-K products;
//                 g_L = (sum_h g_h W_h^T) * (a_L > 0)      one row product
//                 over the concatenated heads, the mask in its epilogue,
//                 written over a_L (read by its own thread just before);
//      layer l    dW_l = a_{l-1}^T g_l, db_l = sum g_l     split-K;
//                 g_{l-1} = (g_l W_l^T) * (a_{l-1} > 0)    over a_{l-1}, or
//                 dx = g_1 W_1^T unmasked for the input layer;
//    then one ordered reduction of the split slices.  A split-K CTA owns one
//    output tile of dW and a fixed range of rows, keeps the tile in
//    registers over the whole range and writes it once; db comes from the
//    same pass.  Bound at 1,000,003 x 312->256/128/64 + 2x32: 582 GFLOP
//    (recompute 120,832 MAC a row, dW 124,928, g W^T 45,056) over 67 TFLOP/s
//    of f32, 8.7 ms; bytes (x, g, the activations' round trip) about 1 ms.
//    So the design aims every product at the f32 FMA rate: up to 16 FMAs a
//    shared-memory read, coalesced 16-byte global loads, two CTAs an SM
//    (registers capped at 128 a thread), a weight gradient's tiles x splits
//    at most 264 CTAs: one wave.
#include <cstdint>

#include "dense_stack.cuh"
#include "gemm_tile.cuh"

namespace atlasvae {

constexpr int kMaxParts = 264;  // partial slices: 2 per SM of an H100, fixed
constexpr int kMaxLayers = kMaxHidden + kMaxHeads;
constexpr size_t kMaxSmem = 232448;  // a CTA's shared memory on sm_90

struct BwdArgs {
  const float* x;                   // (batch, dims[0])
  long long batch;
  long long n_tiles;
  int n_hidden;
  int dims[kMaxHidden + 1];
  const float* w[kMaxHidden];       // (dims[i], dims[i + 1]), JAX (in, out) layout
  const float* b[kMaxHidden];
  int n_heads;
  int head_dims[kMaxHeads];
  const float* hw[kMaxHeads];       // (dims[n_hidden], head_dims[h])
  const float* g[kMaxHeads];        // (batch, head_dims[h]): the head outputs' gradients
  float* dx;                        // (batch, dims[0]), or null: no dx
  float* partial;                   // (grid, n_params): one slice per CTA
  int n_params;
  int off[kMaxLayers];              // layer i's dW in a parameter vector; its db follows
  int act_off[kMaxHidden + 1];      // floats from the start of shared memory
  int g_off;                        // first gradient buffer; the second follows
  int g_width;                      // rows of each gradient buffer
  int ws_off;                       // staged weight chunk
};

__device__ __forceinline__ int bwd_head_of(const BwdArgs& a, int n, int* col) {
  int h = 0;
  while (h + 1 < a.n_heads && n >= a.head_dims[h]) {
    n -= a.head_dims[h];
    ++h;
  }
  *col = n;
  return h;
}

// out[row][n] = sum_k in[k * S + row] * w_at(k, n) for n < N, k < K; the
// epilogue gets each owned column n with its 8 rows.  Starts with a barrier,
// so `in` may have been written just before the call.
template <int TM, class WAt, class Epi>
__device__ __forceinline__ void rows_gemm(const float* in, int K, int N, float* ws, WAt w_at,
                                          Epi epi) {
  using T = TileShape<TM>;
  constexpr int NC = T::kCols;
  constexpr int S = T::kStride;
  const int tid = threadIdx.x;
  const int r0 = (tid / T::kColGroups) * kRowsPerThread;
  const int c0 = (tid % T::kColGroups) * kColsPerThread;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kChunkK) {
      __syncthreads();  // input written / previous chunk consumed
      for (int i = tid; i < kChunkK * NC; i += kThreads) {
        const int kk = i / NC;
        const int n = n0 + (i - kk * NC);
        const int k = k0 + kk;
        ws[i] = (k < K && n < N) ? w_at(k, n) : 0.f;
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
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int n = n0 + c0 + j;
      if (n >= N) continue;
      float v[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) v[r] = acc[r][j];
      epi(n, r0, v);
    }
  }
}

// dw[j * N + c] (+)= sum_row act[j * S + row] * g[c * S + row] for j < K,
// c < N, and db[c] (+)= sum_row g[c * S + row]: the first tile of a CTA
// stores, later tiles add.  Each output has one owner thread, the same one
// for every tile, so the read-modify-write of the CTA's slice needs no sync.
template <int TM>
__device__ __forceinline__ void weight_grad(const float* act, int K, const float* g, int N,
                                            float* dw, float* db, bool first) {
  constexpr int S = TileShape<TM>::kStride;
  __syncthreads();  // act and g written
  const int jg = (K + 3) / 4;
  const int cg = (N + 3) / 4;
  for (int t = threadIdx.x; t < jg * cg; t += kThreads) {
    const int j0 = (t / cg) * 4;
    const int c0 = (t % cg) * 4;
    const float* ar[4];
    const float* gr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ar[u] = act + min(j0 + u, K - 1) * S;
      gr[u] = g + min(c0 + u, N - 1) * S;
    }
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int r = 0; r < TM; r += 4) {
      float4 av[4], gv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = *reinterpret_cast<const float4*>(ar[u] + r);
        gv[u] = *reinterpret_cast<const float4*>(gr[u] + r);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] = fmaf(av[u].x, gv[v].x, acc[u][v]);
          acc[u][v] = fmaf(av[u].y, gv[v].y, acc[u][v]);
          acc[u][v] = fmaf(av[u].z, gv[v].z, acc[u][v]);
          acc[u][v] = fmaf(av[u].w, gv[v].w, acc[u][v]);
        }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = j0 + u, c = c0 + v;
        if (j < K && c < N) {
          float* p = dw + (size_t)j * N + c;
          *p = first ? acc[u][v] : *p + acc[u][v];
        }
      }
  }
  for (int c = threadIdx.x; c < N; c += kThreads) {
    const float* gc = g + c * S;
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += gc[r];
    db[c] = first ? s : db[c] + s;
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
stack_bwd_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int S = TileShape<TM>::kStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* const gA = smem + a.g_off;
  float* const gB = gA + (size_t)a.g_width * S;
  float* const ws = smem + a.ws_off;
  const int L = a.n_hidden;
  const int tid = threadIdx.x;
  int head_total = 0;
  for (int h = 0; h < a.n_heads; ++h) head_total += a.head_dims[h];
  float* const part = a.partial + (size_t)blockIdx.x * a.n_params;

  for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const bool first = tile == (long long)blockIdx.x;
    const long long row0 = tile * TM;
    const long long left = a.batch - row0;
    const int rows = left < TM ? (int)left : TM;
    __syncthreads();  // the previous tile is done with every buffer

    // x tile -> act[0], head gradients -> gA (concatenated), both
    // feature-major; rows past the batch end are zero
    {
      float* act0 = smem + a.act_off[0];
      const int d0 = a.dims[0];
      const float* xt = a.x + row0 * d0;
      for (int i = tid; i < TM * d0; i += kThreads) {
        const int r = i / d0;
        const int k = i - r * d0;
        act0[k * S + r] = r < rows ? __ldg(xt + i) : 0.f;
      }
      for (int i = tid; i < TM * head_total; i += kThreads) {
        const int r = i / head_total;
        const int n = i - r * head_total;
        int c;
        const int h = bwd_head_of(a, n, &c);
        gA[n * S + r] = r < rows ? __ldg(a.g[h] + (row0 + r) * a.head_dims[h] + c) : 0.f;
      }
    }

    // recompute the hidden activations
    for (int l = 0; l < L; ++l) {
      const int K = a.dims[l], N = a.dims[l + 1];
      const float* w = a.w[l];
      const float* b = a.b[l];
      float* out = smem + a.act_off[l + 1];
      rows_gemm<TM>(smem + a.act_off[l], K, N, ws,
                    [&](int k, int n) { return __ldg(w + (size_t)k * N + n); },
                    [&](int n, int r0, const float* v) {
                      const float bias = __ldg(b + n);
                      float4* dst = reinterpret_cast<float4*>(out + n * S + r0);
                      dst[0] = make_float4(fmaxf(v[0] + bias, 0.f), fmaxf(v[1] + bias, 0.f),
                                           fmaxf(v[2] + bias, 0.f), fmaxf(v[3] + bias, 0.f));
                      dst[1] = make_float4(fmaxf(v[4] + bias, 0.f), fmaxf(v[5] + bias, 0.f),
                                           fmaxf(v[6] + bias, 0.f), fmaxf(v[7] + bias, 0.f));
                    });
    }

    const float* actL = smem + a.act_off[L];
    const int dL = a.dims[L];
    // heads: dW_h = act_L^T g_h, db_h = sum g_h
    for (int h = 0, col0 = 0; h < a.n_heads; col0 += a.head_dims[h], ++h) {
      float* dw = part + a.off[L + h];
      weight_grad<TM>(actL, dL, gA + col0 * S, a.head_dims[h], dw,
                      dw + (size_t)dL * a.head_dims[h], first);
    }

    // store one column of g @ W^T: masked by a ReLU activation into a
    // gradient buffer, or (the input layer) unmasked into dx in HBM
    auto store_grad = [&](float* dst, const float* mask_act) {
      return [&, dst, mask_act](int n, int r0, const float* v) {
        if (dst != nullptr) {
          const float* m = mask_act + n * S + r0;
          float o[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) o[r] = v[r] * (m[r] > 0.f ? 1.f : 0.f);
          float4* d = reinterpret_cast<float4*>(dst + n * S + r0);
          d[0] = make_float4(o[0], o[1], o[2], o[3]);
          d[1] = make_float4(o[4], o[5], o[6], o[7]);
        } else {
          const int d0 = a.dims[0];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
            if (r0 + r < rows) a.dx[(row0 + r0 + r) * d0 + n] = v[r];
        }
      };
    };

    // g_hidden = sum_h g_h W_h^T, masked by act_L > 0 (or dx if no hidden layer)
    if (L > 0 || a.dx != nullptr) {
      rows_gemm<TM>(gA, head_total, dL, ws,
                    [&](int k, int n) {
                      int c;
                      const int h = bwd_head_of(a, k, &c);
                      return __ldg(a.hw[h] + (size_t)n * a.head_dims[h] + c);
                    },
                    store_grad(L > 0 ? gB : nullptr, actL));
    }

    // hidden layers, last to first
    float* gcur = gB;
    float* gnext = gA;
    for (int i = L - 1; i >= 0; --i) {
      const int K = a.dims[i], N = a.dims[i + 1];
      float* dw = part + a.off[i];
      weight_grad<TM>(smem + a.act_off[i], K, gcur, N, dw, dw + (size_t)K * N, first);
      if (i > 0 || a.dx != nullptr) {
        const float* w = a.w[i];
        rows_gemm<TM>(gcur, N, K, ws,
                      [&](int k, int n) { return __ldg(w + (size_t)n * N + k); },
                      store_grad(i > 0 ? gnext : nullptr, smem + a.act_off[i]));
        float* t = gcur;
        gcur = gnext;
        gnext = t;
      }
    }
  }
}

// out[p] = sum over slices i = 0, 1, ... of partial[i][p], in slice order.
__global__ void reduce_partials(const float* __restrict__ partial, int n_parts, int n_params,
                                float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_params) return;
  float s = 0.f;
  for (int i = 0; i < n_parts; ++i) s += partial[(size_t)i * n_params + p];
  out[p] = s;
}

constexpr int kFusedRows = 64;  // TM of the fused body

struct BwdPlan {
  bool fits;  // every width at most 128 (else the layer-wise route)
  int n_parts;
  size_t smem;
};

inline BwdPlan plan_bwd(long long batch, int n_hidden, const int* dims, int n_heads,
                        const int* head_dims) {
  int head_total = 0;
  for (int h = 0; h < n_heads; ++h) head_total += head_dims[h];
  int widest = head_total, sum_dims = 0, g_width = head_total;
  for (int i = 0; i <= n_hidden; ++i) {
    widest = widest > dims[i] ? widest : dims[i];
    sum_dims += dims[i];
    if (i > 0 && dims[i] > g_width) g_width = dims[i];
  }
  BwdPlan p;
  p.fits = widest <= 128;
  const int stride = kFusedRows + 4;
  const int cols = kThreads / (kFusedRows / kRowsPerThread) * kColsPerThread;
  p.smem = sizeof(float) * ((size_t)(sum_dims + 2 * g_width) * stride + kChunkK * cols);
  const long long tiles = (batch + kFusedRows - 1) / kFusedRows;
  p.n_parts = (int)(tiles < kMaxParts ? tiles : kMaxParts);
  return p;
}

template <int TM>
cudaError_t launch_bwd(BwdArgs& a, const BwdPlan& p, float* grads, cudaStream_t stream) {
  constexpr int S = TileShape<TM>::kStride;
  int off = 0;
  for (int i = 0; i <= a.n_hidden; ++i) {
    a.act_off[i] = off;
    off += a.dims[i] * S;
  }
  a.g_off = off;
  a.ws_off = off + 2 * a.g_width * S;
  a.n_tiles = (a.batch + TM - 1) / TM;
  cudaError_t err = cudaFuncSetAttribute(stack_bwd_kernel<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  stack_bwd_kernel<TM><<<p.n_parts, kThreads, p.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<(a.n_params + 255) / 256, 256, 0, stream>>>(a.partial, p.n_parts,
                                                                a.n_params, grads);
  return cudaGetLastError();
}

}  // namespace atlasvae

// Number of partial slices (rows of the scratch buffer) the fused body uses
// for this stack at this batch, or -1 if it does not take the stack.
static int fused_parts(long long batch, int n_hidden, const int* dims, int n_heads,
                       const int* head_dims) {
  using namespace atlasvae;
  if (n_hidden < 0 || n_hidden > kMaxHidden || n_heads < 1 || n_heads > kMaxHeads || batch < 1)
    return -1;
  const BwdPlan p = plan_bwd(batch, n_hidden, dims, n_heads, head_dims);
  return !p.fits || p.smem > kMaxSmem ? -1 : p.n_parts;
}

// grads: the parameter vector [dW_0, db_0, ..., dW_head0, db_head0, ...];
// partial: (parts, n_params) scratch, parts as ops/fused_vae.py::backward_plan
// gives them; dx: (batch, dims[0]) or null.  The fused body.
extern "C" int atlasvae_stack_backward(const void* x, long long batch, int n_hidden,
                                       const int* dims, const void* const* weights,
                                       const void* const* biases, int n_heads,
                                       const int* head_dims, const void* const* head_weights,
                                       const void* const* head_grads, void* dx, void* partial,
                                       int n_parts, void* grads, void* stream) {
  using namespace atlasvae;
  if (fused_parts(batch, n_hidden, dims, n_heads, head_dims) != n_parts)
    return (int)cudaErrorInvalidValue;
  const BwdPlan p = plan_bwd(batch, n_hidden, dims, n_heads, head_dims);
  BwdArgs a = {};
  a.x = static_cast<const float*>(x);
  a.batch = batch;
  a.n_hidden = n_hidden;
  a.n_heads = n_heads;
  int off = 0;
  for (int i = 0; i <= n_hidden; ++i) a.dims[i] = dims[i];
  for (int i = 0; i < n_hidden; ++i) {
    a.w[i] = static_cast<const float*>(weights[i]);
    a.b[i] = static_cast<const float*>(biases[i]);
    a.off[i] = off;
    off += dims[i] * dims[i + 1] + dims[i + 1];
  }
  a.g_width = 0;
  for (int h = 0; h < n_heads; ++h) {
    a.head_dims[h] = head_dims[h];
    a.hw[h] = static_cast<const float*>(head_weights[h]);
    a.g[h] = static_cast<const float*>(head_grads[h]);
    a.off[n_hidden + h] = off;
    off += dims[n_hidden] * head_dims[h] + head_dims[h];
    a.g_width += head_dims[h];
  }
  for (int i = 1; i <= n_hidden; ++i)
    if (dims[i] > a.g_width) a.g_width = dims[i];
  a.n_params = off;
  a.dx = static_cast<float*>(dx);
  a.partial = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(grads);
  return (int)launch_bwd<kFusedRows>(a, p, out, s);
}

// ---------------------------------------------------------------------------
// The layer-wise route.

namespace atlasvae {
namespace layers {

using gemm::Operand;

enum Epilogue { kBiasRelu = 0, kMask = 1, kPlain = 2 };

// out (rows x n, row stride ldo) = epilogue(A B) over the whole batch.
struct RowsArgs {
  Operand a, b;
  long long k;           // reduction length
  long long rows;
  int n;
  float* out;
  long long ldo;
  const float* bias;     // kBiasRelu: relu(acc + bias[n])
  const float* mask;     // kMask: acc * (mask[m * ldo + n] > 0); may be `out` itself
  int epi;
  int vec_out;           // float4 stores and mask/bias reads
};

// One slice of dW (m x n) and db (n) per row split: slice s at part + s * slice.
struct SplitArgs {
  Operand a, b;          // a: (i = input column, k = row); b: (k = row, i = output column)
  long long batch;
  long long rows_per_split;
  int m, n;
  int tiles_n;
  float* part;
  long long slice;
  int vec_out;
};

__device__ __forceinline__ float epilogue(const RowsArgs& g, float v, long long m, int n,
                                          float bias_n) {
  if (g.epi == kBiasRelu) return fmaxf(v + bias_n, 0.f);
  if (g.epi == kMask) return v * (g.mask[m * g.ldo + n] > 0.f ? 1.f : 0.f);
  return v;
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(gemm::kThreads, 2)
rows_gemm_kernel(const __grid_constant__ RowsArgs g) {
  using T = gemm::Tile<BM, BN, TM, TN>;
  __shared__ __align__(16) float smem[T::kSmemFloats];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN], unused[TN];
  gemm::mainloop<BM, BN, TM, TN>(g.a, g.b, m0, n0, 0, g.k, smem, acc, unused, false);
  const int tx = threadIdx.x % T::kTX, ty = threadIdx.x / T::kTX;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const long long m = m0 + T::row(ty, r);
    if (m >= g.rows) continue;
    float* dst = g.out + m * g.ldo;
#pragma unroll
    for (int f = 0; f < TN / 4; ++f) {
      const int n = n0 + T::col(tx, 4 * f);
      if (g.vec_out) {  // n and g.n multiples of 4: the four columns are all in or all out
        if (n >= g.n) continue;
        float4 v = make_float4(acc[r][4 * f], acc[r][4 * f + 1], acc[r][4 * f + 2],
                               acc[r][4 * f + 3]);
        if (g.epi == kBiasRelu) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(g.bias + n));
          v = make_float4(fmaxf(v.x + b.x, 0.f), fmaxf(v.y + b.y, 0.f), fmaxf(v.z + b.z, 0.f),
                          fmaxf(v.w + b.w, 0.f));
        } else if (g.epi == kMask) {
          const float4 a = *reinterpret_cast<const float4*>(g.mask + m * g.ldo + n);
          v = make_float4(v.x * (a.x > 0.f ? 1.f : 0.f), v.y * (a.y > 0.f ? 1.f : 0.f),
                          v.z * (a.z > 0.f ? 1.f : 0.f), v.w * (a.w > 0.f ? 1.f : 0.f));
        }
        *reinterpret_cast<float4*>(dst + n) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.n)
            dst[n + j] = epilogue(g, acc[r][4 * f + j], m, n + j,
                                  g.epi == kBiasRelu ? __ldg(g.bias + n + j) : 0.f);
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(gemm::kThreads, 2)
split_gemm_kernel(const __grid_constant__ SplitArgs g) {
  using T = gemm::Tile<BM, BN, TM, TN>;
  __shared__ __align__(16) float smem[T::kSmemFloats];
  const int s = blockIdx.x;
  const int tile_m = blockIdx.y / g.tiles_n, tile_n = blockIdx.y % g.tiles_n;
  const long long m0 = (long long)tile_m * BM;
  const long long n0 = (long long)tile_n * BN;
  const long long k_begin = s * g.rows_per_split;
  const long long k_end = min(k_begin + g.rows_per_split, g.batch);
  const bool want_db = tile_m == 0;
  float acc[TM][TN], db[TN];
  gemm::mainloop<BM, BN, TM, TN>(g.a, g.b, m0, n0, k_begin, k_end, smem, acc, db, want_db);
  const int tx = threadIdx.x % T::kTX, ty = threadIdx.x / T::kTX;
  float* const dw = g.part + s * g.slice;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const long long m = m0 + T::row(ty, r);
    if (m >= g.m) continue;
#pragma unroll
    for (int f = 0; f < TN / 4; ++f) {
      const long long n = n0 + T::col(tx, 4 * f);
      if (g.vec_out) {
        if (n < g.n)
          *reinterpret_cast<float4*>(dw + m * g.n + n) =
              make_float4(acc[r][4 * f], acc[r][4 * f + 1], acc[r][4 * f + 2], acc[r][4 * f + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.n) dw[m * g.n + n + j] = acc[r][4 * f + j];
      }
    }
  }
  if (want_db && ty == 0) {  // the first row group's threads hold the column sums
    float* const dbs = dw + (long long)g.m * g.n;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + T::col(tx, j);
      if (n < g.n) dbs[n] = db[j];
    }
  }
}

// grads[p] = sum over the splits of p's layer, in split order.
struct ReduceArgs {
  int n_layers;
  long long off[kMaxLayers + 1];  // layer i's dW/db in grads: [off[i], off[i + 1])
  long long base[kMaxLayers];     // its first slice in partial; slices follow at stride size
  int splits[kMaxLayers];
};

__global__ void reduce_splits(const float* __restrict__ partial, const __grid_constant__ ReduceArgs r,
                              float* __restrict__ grads) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r.off[r.n_layers]) return;
  int i = 0;
  while (p >= r.off[i + 1]) ++i;
  const long long size = r.off[i + 1] - r.off[i];
  const float* src = partial + r.base[i] + (p - r.off[i]);
  float s = 0.f;
  for (int k = 0; k < r.splits[i]; ++k) s += src[k * size];
  grads[p] = s;
}

// Tile shapes (BM, BN, TM, TN), indexed as GEMM_TILES in ops/fused_vae.py.
constexpr int kNumTiles = 5;

template <int BM, int BN, int TM, int TN>
cudaError_t launch_rows_t(const RowsArgs& g, cudaStream_t st) {
  const dim3 grid((unsigned)((g.rows + BM - 1) / BM), (unsigned)((g.n + BN - 1) / BN));
  rows_gemm_kernel<BM, BN, TM, TN><<<grid, gemm::kThreads, 0, st>>>(g);
  return cudaGetLastError();
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_split_t(SplitArgs g, int splits, cudaStream_t st) {
  g.tiles_n = (g.n + BN - 1) / BN;
  const dim3 grid((unsigned)splits, (unsigned)(((g.m + BM - 1) / BM) * g.tiles_n));
  split_gemm_kernel<BM, BN, TM, TN><<<grid, gemm::kThreads, 0, st>>>(g);
  return cudaGetLastError();
}

cudaError_t launch_rows(int tile, const RowsArgs& g, cudaStream_t st) {
  switch (tile) {
    case 0: return launch_rows_t<128, 128, 8, 8>(g, st);
    case 1: return launch_rows_t<128, 64, 8, 4>(g, st);
    case 2: return launch_rows_t<128, 32, 4, 4>(g, st);
    case 3: return launch_rows_t<64, 128, 4, 8>(g, st);
    case 4: return launch_rows_t<64, 64, 4, 4>(g, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_split(int tile, const SplitArgs& g, int splits, cudaStream_t st) {
  switch (tile) {
    case 0: return launch_split_t<128, 128, 8, 8>(g, splits, st);
    case 1: return launch_split_t<128, 64, 8, 4>(g, splits, st);
    case 2: return launch_split_t<128, 32, 4, 4>(g, splits, st);
    case 3: return launch_split_t<64, 128, 4, 8>(g, splits, st);
    case 4: return launch_split_t<64, 64, 4, 4>(g, splits, st);
  }
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline void set_vec(Operand& o) {
  bool v = o.k_contig ? o.kbeg[o.nseg] % 4 == 0 : o.extent % 4 == 0;
  for (int s = 0; s < o.nseg; ++s)
    v = v && aligned16(o.p[s]) && o.ld[s] % 4 == 0 && o.kbeg[s] % 4 == 0;
  o.vec = v;
}

// (i, k) at p[i * ld + k] for k < k_len
inline Operand k_contig(const float* p, long long ld, long long extent, int k_len) {
  Operand o = {};
  o.p[0] = p;
  o.ld[0] = ld;
  o.kbeg[1] = k_len;
  o.nseg = 1;
  o.k_contig = 1;
  o.extent = extent;
  set_vec(o);
  return o;
}

// (i, k) at p[k * ld + i]
inline Operand i_contig(const float* p, long long ld, long long extent) {
  Operand o = {};
  o.p[0] = p;
  o.ld[0] = ld;
  o.nseg = 1;
  o.extent = extent;
  set_vec(o);
  return o;
}

inline RowsArgs rows_args(const Operand& a, const Operand& b, long long k, long long rows, int n,
                          float* out, int epi, const float* bias, const float* mask) {
  RowsArgs g = {};
  g.a = a;
  g.b = b;
  g.k = k;
  g.rows = rows;
  g.n = n;
  g.out = out;
  g.ldo = n;
  g.epi = epi;
  g.bias = bias;
  g.mask = mask;
  g.vec_out = n % 4 == 0 && aligned16(out) && (epi != kBiasRelu || aligned16(bias)) &&
              (epi != kMask || aligned16(mask));
  return g;
}

}  // namespace layers
}  // namespace atlasvae

// The layer-wise route.  acts: batch x sum(dims[1..n_hidden]) floats of
// scratch (hidden activations, then the gradients written over them);
// partial: each layer's split slices, hidden layers then heads, layer i's
// splits x (dims_in * dims_out + dims_out) floats; row_tiles (2 n_hidden + 1)
// and split_plan (3 per layer: tile, splits, rows per split) as
// ops/fused_vae.py::backward_plan gives them.  Returns the first CUDA error.
extern "C" int atlasvae_stack_backward_layers(
    const void* x, long long batch, int n_hidden, const int* dims, const void* const* weights,
    const void* const* biases, int n_heads, const int* head_dims,
    const void* const* head_weights, const void* const* head_grads, void* dx, void* acts,
    void* partial, const int* row_tiles, const int* split_plan, void* grads, void* stream) {
  using namespace atlasvae;
  using namespace atlasvae::layers;
  const int L = n_hidden;
  if (L < 0 || L > kMaxHidden || n_heads < 1 || n_heads > kMaxHeads || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int n_layers = L + n_heads;
  for (int i = 0; i < 2 * L + 1; ++i)
    if (row_tiles[i] < 0 || row_tiles[i] >= kNumTiles)
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_layers; ++i) {
    const int* sp = split_plan + 3 * i;
    if (sp[0] < 0 || sp[0] >= kNumTiles || sp[1] < 1 || sp[2] < 1 ||
        (long long)sp[1] * sp[2] < batch || (long long)(sp[1] - 1) * sp[2] >= batch)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* W = reinterpret_cast<const float* const*>(weights);
  const float* const* Bv = reinterpret_cast<const float* const*>(biases);
  const float* const* HW = reinterpret_cast<const float* const*>(head_weights);
  const float* const* G = reinterpret_cast<const float* const*>(head_grads);
  float* const DX = static_cast<float*>(dx);
  float* const P = static_cast<float*>(partial);

  // act[0] = x; act[l + 1] = hidden layer l's output, then its gradient
  float* act[kMaxHidden + 1];
  act[0] = const_cast<float*>(static_cast<const float*>(x));
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    act[l + 1] = static_cast<float*>(acts) + off;
    off += batch * dims[l + 1];
  }
  const int dL = dims[L];
  int head_total = 0;
  for (int h = 0; h < n_heads; ++h) head_total += head_dims[h];

  // each layer's dW/db: its place in grads, its slices in partial
  ReduceArgs red = {};
  red.n_layers = n_layers;
  long long base = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long k = i < L ? dims[i] : dL;
    const long long n = i < L ? dims[i + 1] : head_dims[i - L];
    red.off[i + 1] = red.off[i] + k * n + n;
    red.base[i] = base;
    red.splits[i] = split_plan[3 * i + 1];
    base += red.splits[i] * (k * n + n);
  }
  auto weight_grad = [&](int i, const float* a, const float* g, int k, int n) {
    SplitArgs s = {};
    s.a = i_contig(a, k, k);
    s.b = i_contig(g, n, n);
    s.batch = batch;
    s.rows_per_split = split_plan[3 * i + 2];
    s.m = k;
    s.n = n;
    s.part = P + red.base[i];
    s.slice = (long long)k * n + n;
    s.vec_out = n % 4 == 0 && s.slice % 4 == 0 && aligned16(s.part);
    return launch_split(split_plan[3 * i], s, split_plan[3 * i + 1], st);
  };
  cudaError_t err;
#define K3_TRY(call)          \
  if ((err = (call)) != cudaSuccess) return (int)err

  // 1. recompute the hidden activations
  for (int l = 0; l < L; ++l)
    K3_TRY(launch_rows(row_tiles[l],
                       rows_args(k_contig(act[l], dims[l], batch, dims[l]),
                                 i_contig(W[l], dims[l + 1], dims[l + 1]), dims[l], batch,
                                 dims[l + 1], act[l + 1], kBiasRelu, Bv[l], nullptr),
                       st));
  // 2. the heads' dW/db, then g_L = (sum_h g_h W_h^T) * (a_L > 0) over a_L
  for (int h = 0; h < n_heads; ++h)
    K3_TRY(weight_grad(L + h, act[L], G[h], dL, head_dims[h]));
  if (L > 0 || DX != nullptr) {
    Operand a = {}, b = {};
    a.nseg = b.nseg = n_heads;
    a.k_contig = b.k_contig = 1;
    a.extent = batch;
    b.extent = dL;
    for (int h = 0; h < n_heads; ++h) {
      a.p[h] = G[h];
      b.p[h] = HW[h];
      a.ld[h] = b.ld[h] = head_dims[h];
      a.kbeg[h + 1] = b.kbeg[h + 1] = a.kbeg[h] + head_dims[h];
    }
    set_vec(a);
    set_vec(b);
    float* out = L > 0 ? act[L] : DX;
    K3_TRY(launch_rows(row_tiles[L],
                       rows_args(a, b, head_total, batch, dL, out, L > 0 ? kMask : kPlain,
                                 nullptr, L > 0 ? act[L] : nullptr),
                       st));
  }
  // 3. hidden layers, last first: dW/db, then the gradient one layer down
  for (int i = L - 1; i >= 0; --i) {
    const int k = dims[i], n = dims[i + 1];
    K3_TRY(weight_grad(i, act[i], act[i + 1], k, n));
    if (i > 0 || DX != nullptr) {
      float* out = i > 0 ? act[i] : DX;
      K3_TRY(launch_rows(row_tiles[L + 1 + i],
                         rows_args(k_contig(act[i + 1], n, batch, n), k_contig(W[i], n, k, n),
                                   n, batch, k, out, i > 0 ? kMask : kPlain, nullptr,
                                   i > 0 ? act[i] : nullptr),
                         st));
    }
  }
#undef K3_TRY
  // 4. the ordered sum of the splits
  const long long n_params = red.off[n_layers];
  reduce_splits<<<(unsigned)((n_params + 255) / 256), 256, 0, st>>>(P, red,
                                                                     static_cast<float*>(grads));
  return (int)cudaGetLastError();
}
