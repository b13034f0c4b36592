// K3: backward of the dense stack with linear heads (K2's gradient: the VAE
// encoder's and decoder's backward in every training step).
//
// Replaces atlasvae/ops/fused_vae.py:130 _stack_bwd_kernel (Pallas, TPU).
// Per tile of rows it recomputes the forward activations, backpropagates the
// head gradients through the heads and the ReLU masks, and sums dW/db over
// all rows; dx only on request (the decoder needs dz, the encoder's input is
// data).  The TPU kernel summed dW/db in output blocks revisited by a grid
// that runs in order on one core, zeroed at grid step 0.  Here CTAs run in
// parallel and in no order, so:
//   * the grid is at most kMaxParts CTAs (a constant, not the card's SM
//     count); CTA i takes tiles i, i + grid, i + 2*grid, ... and sums its
//     dW/db into its own slice of a scratch buffer (no float atomics);
//   * a second kernel sums the slices in slice order.
// So the result is the same bits on every run and every card.
//
// Per tile of TM rows, in shared memory: every layer's activation (the
// input tile and each hidden output, feature-major: act[k * S + row]), two
// ping-pong gradient buffers, and one staged chunk of a weight matrix.  The
// row-by-feature products (forward recompute, g @ W^T) reuse the register
// tiling of dense_stack.cuh (8 rows x 4 columns a thread); the weight
// gradient a^T g gives each thread 4 x 4 outputs and walks the rows four at
// a time with float4 loads.  Ragged last tiles are zero-filled: a zero head
// gradient row stays zero through every layer, so padded rows add nothing.
//
// Bound on an H100, canonical encoder (12->80->40->20, heads 2x(20->10)) at
// B = 10,000 rows without dx: per row the recompute of the hidden stack is
// 4,960 MAC, dW of the hidden layers and heads 5,360 MAC, g @ W^T 4,400 MAC
// (heads 400, 80<-40 3,200, 40<-20 800; none for the input layer): about
// 29 kFLOP per row against 128 B of HBM traffic (48 B of x, 80 B of head
// gradients), 230 FLOP/B, far above the f32 ridge of 20.  At 67 TFLOP/s that
// is about 4.4 us of f32 work, spread over 157 tiles of 64 rows on 132 SMs:
// one wave, so launch latency, barriers and occupancy bound it, not bytes.
// The design keeps every activation of a tile on chip (no HBM round trip
// between layers), runs 64-row tiles so that two CTAs fit an SM (93 KB of
// shared memory each at canonical widths), and does the whole backward in
// one launch plus one small reduction launch.
#include "dense_stack.cuh"

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

struct BwdPlan {
  int tm;
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
  p.tm = widest <= 128 ? 64 : 32;
  const int stride = p.tm + 4;
  const int cols = kThreads / (p.tm / kRowsPerThread) * kColsPerThread;
  p.smem = sizeof(float) * ((size_t)(sum_dims + 2 * g_width) * stride + kChunkK * cols);
  const long long tiles = (batch + p.tm - 1) / p.tm;
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

// Number of partial slices (rows of the scratch buffer) the backward of
// this stack uses at this batch, or -1 if its tile does not fit a CTA's
// shared memory.
extern "C" int atlasvae_stack_backward_parts(long long batch, int n_hidden, const int* dims,
                                             int n_heads, const int* head_dims) {
  using namespace atlasvae;
  if (n_hidden < 0 || n_hidden > kMaxHidden || n_heads < 1 || n_heads > kMaxHeads || batch < 1)
    return -1;
  const BwdPlan p = plan_bwd(batch, n_hidden, dims, n_heads, head_dims);
  return p.smem > kMaxSmem ? -1 : p.n_parts;
}

// grads: the parameter vector [dW_0, db_0, ..., dW_head0, db_head0, ...];
// partial: (parts, n_params) scratch with parts from
// atlasvae_stack_backward_parts; dx: (batch, dims[0]) or null.
extern "C" int atlasvae_stack_backward(const void* x, long long batch, int n_hidden,
                                       const int* dims, const void* const* weights,
                                       const void* const* biases, int n_heads,
                                       const int* head_dims, const void* const* head_weights,
                                       const void* const* head_grads, void* dx, void* partial,
                                       int n_parts, void* grads, void* stream) {
  using namespace atlasvae;
  if (atlasvae_stack_backward_parts(batch, n_hidden, dims, n_heads, head_dims) != n_parts)
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
  return (int)(p.tm == 64 ? launch_bwd<64>(a, p, out, s) : launch_bwd<32>(a, p, out, s));
}
