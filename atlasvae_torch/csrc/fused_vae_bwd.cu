// K3: backward of the dense stack with linear heads (K2's gradient: the VAE
// encoder's and decoder's backward in every training step).
//
// Replaces atlasvae/ops/fused_vae.py:130 _stack_bwd_kernel (Pallas, TPU): it
// recomputes the forward activations, backpropagates the head gradients
// through the heads and the ReLU masks, and sums dW/db over all rows; dx only
// on request (the decoder needs dz, the encoder's input is data).  The TPU
// kernel summed dW/db in output blocks revisited by a grid that runs in order
// on one core.  Here CTAs run in parallel and in no order, so each CTA (or
// row split) sums into its own slice of a scratch buffer, and the slices are
// added in a fixed order: the same bits on every run, no float atomics.  Two
// routes; ops/fused_vae.py::backward_plan picks one by the stack's shape
// alone.
//
// 1. The fused body (stack_bwd_kernel), for stacks of at most kMaxHidden
//    hidden layers, every width at most 128, whose weights and a 128-row
//    tile's activations and gradients fit one CTA's shared memory (the
//    canonical 12->80/40/20 + 2x10 VAE: 25 KB of weights, 168 KB of tile).
//    Bound at B = 10,000 rows, canonical encoder, no dx: 29.4 kFLOP and 128 B
//    of HBM traffic a row, 230 FLOP/B, far above the f32 ridge of 20: 4.4 us
//    of f32 work on an H100.  That is 76 rows an SM, so the body is held back
//    by latency, not by throughput; the design (PR 21) removes what made the
//    old body wait:
//    - weights on chip once: each CTA copies the whole stack's W and b into
//      shared memory with cp.async at its start (hidden layer i as
//      dims[i] + 1 rows, the bias last, zero-padded to 4 rows and to a pitch
//      of 4 mod 8 floats); no product restages a chunk or waits at a barrier
//      for one, and g W^T reads W's rows as float4 without bank conflicts;
//    - rows owned by warps: a warp carries 8 rows through the recompute
//      (ReLU(a W + b), the bias against a ones column kept beside each
//      activation) and the descent of g (masked g W^T, heads first), with
//      __syncwarp only; a lane owns columns lane, lane + 32, ... of a layer,
//      so a 20-wide layer keeps 20 lanes busy, not 20 of 128 columns of a
//      CTA; each step reads 8 rows' float4 (one broadcast each) and feeds
//      8 x (columns a lane) FMAs;
//    - dW/db as one product with the rows as its k: after the tile's warps
//      are done (one barrier), each of 512 threads sums 4 x 4 blocks of
//      a^T g (db is the ones column's row) over the tile's rows, in
//      registers that live across the CTA's tiles; two barriers a tile in
//      all;
//    - no second launch: each CTA writes its block sums once, as one slice
//      in block order (coalesced), and after a grid-wide barrier (an integer
//      counter; the launch is cooperative, so every CTA is resident) every
//      CTA adds a share of the elements over all slices in slice order:
//      16 warps take a run of slices each and one warp adds their 16 sums
//      in warp order;
//    - dx staged in shared memory and stored as whole rows, coalesced.
//    One CTA of 512 threads an SM (W once an SM), at most 132 CTAs, each
//    taking an equal run of rows (at least 32): 76 rows a CTA at 10,000.
//    f32 FMAs, not the 3xTF32 tensor-core products of K1/K2's row
//    segments: at 12-80 columns, 8 rows a warp, the mma tiles would pad 12
//    and 20 up to 16 and 24 and cost three products and the splits each,
//    while FMAs keep the recompute's ReLU masks the plain version's within
//    f32 rounding.
//
// 2. The layer-wise route (the rest of this file), for everything else: the
//    constituents-mode 312->256/128/64 + 2x32 encoder and its decoder, and
//    stacks whose fused tile does not fit.  Each product is one persistent
//    launch over the whole batch on the wgmma mainloop of gemm_wgmma.cuh
//    (3xTF32, TMA, a producer warpgroup and two consumer warpgroups, a fresh
//    accumulator every k8 step), after one pre-pass launch that splits every
//    layer's weights into hi/lo TF32 words in the order and swizzle a stage
//    wants (bwd_split_kernel):
//      recompute  a_l = relu(a_{l-1} W_l + b_l)          bwd_rows_kernel, K2's
//                 row product with its ReLU near-ties re-decided in f32, a_l
//                 to a scratch buffer of batch x sum(hidden widths): the one
//                 HBM round trip the design accepts (1.8 GB at 1,000,003 rows);
//      heads      dW_h = a_L^T g_h, db_h = sum g_h         bwd_dw_kernel, all
//                 heads one launch (column segments);
//                 g_L = (sum_h g_h W_h^T) * (a_L > 0)      one row product
//                 over the heads' gradients as k segments, the mask in its
//                 epilogue, written over a_L (read by its own thread just
//                 before);
//      layer l    dW_l = a_{l-1}^T g_l, db_l = sum g_l     bwd_dw_kernel;
//                 g_{l-1} = (g_l W_l^T) * (a_{l-1} > 0)    over a_{l-1}, or
//                 dx = g_1 W_1^T unmasked for the input layer;
//    then one ordered reduction of the weight gradients' split slices
//    (reduce_splits; a weight gradient of one split writes its place in
//    the output directly).  A weight gradient's CTA takes an output tile
//    and a fixed range of the batch, keeps the tile in registers over it and
//    writes it once; db comes from the same pass.  Bound at 1,000,003 x
//    312->256/128/64 + 2x32: 582 GFLOP (recompute 120,832 MAC a row, dW
//    124,928, g W^T 45,056), 1,745 GFLOP of TF32 products in 3xTF32: 3.53 ms
//    at 495 TFLOP/s; bytes (x, g, the activations' round trip) about 1 ms.
//    No launch has a bound on its tiles but the 2^31 rows of a batch: the
//    CTAs are persistent, one an SM, walking their tiles.
#include <array>
#include <cstdint>
#include <vector>

#include "dense_stack.cuh"
#include "gemm_wgmma.cuh"

namespace atlasvae {

constexpr int kBwdThreads = 512;                 // 16 warps, one CTA an SM
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kWarpRows = 8;                     // rows a warp carries through every layer
constexpr int kBwdRows = kBwdWarps * kWarpRows;  // 128: a tile
constexpr int kBwdMaxParts = 132;                // CTAs, and partial slices, at most
constexpr int kBwdMinRows = 32;                  // fewest rows a CTA takes
constexpr int kMaxBlocks = 2;                    // 4 x 4 dW/db blocks a thread owns
constexpr int kBwdMaxWidth = 128;
constexpr int kBwdLayers = kMaxHidden + 1;       // the hidden layers, then the heads as one
constexpr size_t kMaxSmem = 232448;              // a CTA's shared memory on sm_90

struct BwdArgs {
  const float* x;                   // (batch, dims[0])
  long long batch;
  int n_hidden, n_heads;
  int dims[kMaxHidden + 1];
  const float* w[kMaxHidden];       // (dims[i], dims[i + 1]), JAX (in, out) layout
  const float* b[kMaxHidden];
  int head_dims[kMaxHeads];
  int head_off[kMaxHeads + 1];      // a head's first column among the heads' columns
  const float* hw[kMaxHeads];       // (dims[n_hidden], head_dims[h])
  const float* g[kMaxHeads];        // (batch, head_dims[h]): the head outputs' gradients
  float* dx;                        // (batch, dims[0]), or null: no dx
  float* partial;                   // (gridDim.x, 16 n_blocks): a CTA's block sums
  float* grads;                     // [dW_0, db_0, ..., dW_head0, db_head0, ...]
  unsigned* counter;                // 2 integers, 0 at the launch and left 0
  // shared memory, in floats from its start.  Layer t < n_hidden is hidden
  // layer t (a_t -> a_{t + 1}); t = n_hidden is the heads, concatenated.
  int w_off[kBwdLayers], pitch[kBwdLayers];
  int act_off[kMaxHidden + 1], act_w[kMaxHidden + 1];  // a_l, then 1, then zeros
  int g_off[kMaxHidden + 1], g_w[kMaxHidden + 1];      // [0] the heads' g; [l] dL/dz_l masked
  int dx_off, dx_w;
  int blk_begin[kBwdLayers + 1];    // layer t's first dW/db block; the last entry: n_blocks
  int param_off[kMaxHidden + kMaxHeads];  // layer i's dW in grads; its db follows
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
// A weight row's pitch: a multiple of 4 floats (float4 reads) that is 4 mod
// 8, so that the float4 reads of 8 consecutive rows by a quarter-warp hit 8
// distinct groups of 4 banks.
inline int bwd_pitch(int n) { const int p = round4(n); return (p / 4) % 2 == 0 ? p + 4 : p; }

__device__ __forceinline__ int bwd_cols(const BwdArgs& a, int t) {
  return t < a.n_hidden ? a.dims[t + 1] : a.head_off[a.n_heads];
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// out[r][c] = relu(sum_k in[r][k] W[k][c]) for the warp's 8 rows and c < n,
// k over in_w columns: the bias enters as W's row dims of the layer against
// in's ones column, zeros beyond.  Then out's own ones column and zero pads.
template <int NI>
__device__ __forceinline__ void warp_forward(const float* in, int in_w, const float* W,
                                             int pitch, int n, float* out, int out_w) {
  const int lane = threadIdx.x & 31;
  int col[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) col[i] = min(lane + 32 * i, n - 1);
  float acc[kWarpRows][NI];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  for (int k = 0; k < in_w; k += 4) {
    float4 av[kWarpRows];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r)
      av[r] = *reinterpret_cast<const float4*>(in + r * in_w + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float wv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) wv[i] = W[(k + u) * pitch + col[i]];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(lane_of(av[r], u), wv[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = lane + 32 * i;
    if (c < n) {
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) out[r * out_w + c] = fmaxf(acc[r][i], 0.f);
    }
  }
  const int extra = out_w - n;
  for (int e = lane; e < kWarpRows * extra; e += 32) {
    const int r = e / extra, c = n + (e - r * extra);
    out[r * out_w + c] = c == n ? 1.f : 0.f;
  }
}

// out[r][k] = (sum_c g[r][c] W[k][c]) * (mask[r][k] > 0) for the warp's 8
// rows and k < n (no mask for dx), c over g_w columns; then zero pads.  A
// lane owns outputs lane, lane + 32, ... and reads its rows of W as float4.
template <int NI>
__device__ __forceinline__ void warp_backward(const float* g, int g_w, const float* W, int pitch,
                                              int n, const float* mask, int mask_w, float* out,
                                              int out_w) {
  const int lane = threadIdx.x & 31;
  const float* wrow[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) wrow[i] = W + min(lane + 32 * i, n - 1) * pitch;
  float acc[kWarpRows][NI];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  for (int c = 0; c < g_w; c += 4) {
    float4 gv[kWarpRows];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) gv[r] = *reinterpret_cast<const float4*>(g + r * g_w + c);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(wrow[i] + c);
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        acc[r][i] = fmaf(gv[r].x, w.x, acc[r][i]);
        acc[r][i] = fmaf(gv[r].y, w.y, acc[r][i]);
        acc[r][i] = fmaf(gv[r].z, w.z, acc[r][i]);
        acc[r][i] = fmaf(gv[r].w, w.w, acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int k = lane + 32 * i;
    if (k < n) {
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        float v = acc[r][i];
        if (mask != nullptr) v *= mask[r * mask_w + k] > 0.f ? 1.f : 0.f;
        out[r * out_w + k] = v;
      }
    }
  }
  const int extra = out_w - n;
  for (int e = lane; e < kWarpRows * extra; e += 32) {
    const int r = e / extra;
    out[r * out_w + n + (e - r * extra)] = 0.f;
  }
}

__device__ __forceinline__ void forward_any(const float* in, int in_w, const float* W, int pitch,
                                            int n, float* out, int out_w) {
  switch ((n + 31) / 32) {
    case 1: warp_forward<1>(in, in_w, W, pitch, n, out, out_w); break;
    case 2: warp_forward<2>(in, in_w, W, pitch, n, out, out_w); break;
    case 3: warp_forward<3>(in, in_w, W, pitch, n, out, out_w); break;
    default: warp_forward<4>(in, in_w, W, pitch, n, out, out_w); break;
  }
}

__device__ __forceinline__ void backward_any(const float* g, int g_w, const float* W, int pitch,
                                             int n, const float* mask, int mask_w, float* out,
                                             int out_w) {
  switch ((n + 31) / 32) {
    case 1: warp_backward<1>(g, g_w, W, pitch, n, mask, mask_w, out, out_w); break;
    case 2: warp_backward<2>(g, g_w, W, pitch, n, mask, mask_w, out, out_w); break;
    case 3: warp_backward<3>(g, g_w, W, pitch, n, mask, mask_w, out, out_w); break;
    default: warp_backward<4>(g, g_w, W, pitch, n, mask, mask_w, out, out_w); break;
  }
}

// The warp's rows [row, row + n) (n <= 8) into rows r0.. of the tile: x into
// a_0 with its ones column, the heads' gradients into g[0] concatenated;
// rows past n are zero.
__device__ __forceinline__ void warp_load(const BwdArgs& a, float* sm, long long row, int n,
                                          int r0) {
  const int lane = threadIdx.x & 31;
  {
    const int d = a.dims[0], w = a.act_w[0];
    float* dst = sm + a.act_off[0] + r0 * w;
    const float* src = a.x + row * d;
    for (int e = lane; e < kWarpRows * w; e += 32) {
      const int r = e / w, k = e - r * w;
      dst[e] = k < d ? (r < n ? __ldg(src + r * d + k) : 0.f) : (k == d ? 1.f : 0.f);
    }
  }
  const int w = a.g_w[0], total = a.head_off[a.n_heads];
  float* dst = sm + a.g_off[0] + r0 * w;
  for (int e = lane; e < kWarpRows * w; e += 32) {
    const int r = e / w, c = e - r * w;
    float v = 0.f;
    if (c < total && r < n) {
      int h = 0;
      while (h + 1 < a.n_heads && c >= a.head_off[h + 1]) ++h;
      v = __ldg(a.g[h] + (row + r) * a.head_dims[h] + (c - a.head_off[h]));
    }
    dst[e] = v;
  }
}

// The recompute, the descent of g and dx for the warp's rows.
__device__ __forceinline__ void warp_rows(const BwdArgs& a, float* sm, long long row, int n,
                                          int r0) {
  const int L = a.n_hidden;
  auto act = [&](int l) { return sm + a.act_off[l] + r0 * a.act_w[l]; };
  auto grad = [&](int l) { return sm + a.g_off[l] + r0 * a.g_w[l]; };
  for (int l = 1; l <= L; ++l) {
    forward_any(act(l - 1), a.act_w[l - 1], sm + a.w_off[l - 1], a.pitch[l - 1], a.dims[l],
                act(l), a.act_w[l]);
    __syncwarp();
  }
  // g of a_l from the layer above it (hidden layer l, or the heads at l = L)
  for (int l = L; l >= 1; --l) {
    const int above = l == L ? 0 : l + 1;
    backward_any(grad(above), a.g_w[above], sm + a.w_off[l], a.pitch[l], a.dims[l], act(l),
                 a.act_w[l], grad(l), a.g_w[l]);
    __syncwarp();
  }
  if (a.dx != nullptr) {
    const int lowest = L > 0 ? 1 : 0;
    float* stage = sm + a.dx_off + r0 * a.dx_w;
    backward_any(grad(lowest), a.g_w[lowest], sm + a.w_off[0], a.pitch[0], a.dims[0], nullptr,
                 0, stage, a.dx_w);
    __syncwarp();
    const int d = a.dims[0];
    float* dst = a.dx + row * d;   // the warp's rows are one run of n * d floats
    for (int e = threadIdx.x & 31; e < n * d; e += 32) {
      const int r = e / d;
      dst[e] = stage[r * a.dx_w + (e - r * d)];
    }
  }
}

// Element p of a slice (block p / 16, its row p / 4 % 4 and column p % 4) to
// its place in grads; the padding of a block goes nowhere.
__device__ __forceinline__ void store_grad(const BwdArgs& a, int p, float v) {
  const int blk = p >> 4;
  int t = 0;
  while (blk >= a.blk_begin[t + 1]) ++t;
  const int K = a.dims[t], N = bwd_cols(a, t), C = (N + 3) / 4;
  const int local = blk - a.blk_begin[t];
  const int j = (local / C) * 4 + ((p >> 2) & 3), c = (local % C) * 4 + (p & 3);
  if (j > K || c >= N) return;   // row K of a block column is db: it follows dW
  if (t < a.n_hidden) {
    a.grads[a.param_off[t] + j * N + c] = v;
    return;
  }
  int h = 0;
  while (h + 1 < a.n_heads && c >= a.head_off[h + 1]) ++h;
  a.grads[a.param_off[t + h] + j * a.head_dims[h] + (c - a.head_off[h])] = v;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0));
}

__global__ void __launch_bounds__(kBwdThreads, 1)
stack_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = a.n_hidden;

  // every layer's weights (hidden: W, then b as row dims[t]; heads
  // concatenated), zero past the edges, by cp.async; waited for after the
  // first tile's loads are issued
  for (int t = 0; t <= L; ++t) {   // a warp a row, its lanes along the row
    const int K = a.dims[t], N = bwd_cols(a, t), pitch = a.pitch[t];
    const int rows = t < L ? round4(K + 1) : K;
    for (int k = warp; k < rows; k += kBwdWarps) {
      float* const dst = sm + a.w_off[t] + k * pitch;
      for (int c = lane; c < pitch; c += 32) {
        const float* src = a.x;   // any address: not read where the copy is a zero fill
        const bool valid = c < N && k <= K && !(t == L && k == K);
        if (valid) {
          if (t < L) {
            src = k < K ? a.w[t] + k * N + c : a.b[t] + c;
          } else {
            int h = 0;
            while (h + 1 < a.n_heads && c >= a.head_off[h + 1]) ++h;
            src = a.hw[h] + k * a.head_dims[h] + (c - a.head_off[h]);
          }
        }
        copy4_async(dst + c, src, valid);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this thread's dW/db blocks: offsets of their a and g columns
  const int n_blocks = a.blk_begin[L + 1];
  int a_at[kMaxBlocks], a_w[kMaxBlocks], g_at[kMaxBlocks], g_w[kMaxBlocks];
  float acc[kMaxBlocks][16];
#pragma unroll
  for (int q = 0; q < kMaxBlocks; ++q) {
    const int blk = tid + q * kBwdThreads;
    a_at[q] = -1;
    a_w[q] = g_at[q] = g_w[q] = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[q][e] = 0.f;
    if (blk < n_blocks) {
      int t = 0;
      while (blk >= a.blk_begin[t + 1]) ++t;
      const int C = (bwd_cols(a, t) + 3) / 4, local = blk - a.blk_begin[t];
      const int gl = t < L ? t + 1 : 0;
      a_at[q] = a.act_off[t] + 4 * (local / C);
      a_w[q] = a.act_w[t];
      g_at[q] = a.g_off[gl] + 4 * (local % C);
      g_w[q] = a.g_w[gl];
    }
  }

  // this CTA's rows: an equal run of the batch
  const long long rb = blockIdx.x * a.batch / gridDim.x;
  const long long re = (blockIdx.x + 1) * a.batch / gridDim.x;
  for (long long t0 = rb; t0 < re; t0 += kBwdRows) {
    const int rows = re - t0 < kBwdRows ? (int)(re - t0) : kBwdRows;
    const int r0 = warp * kWarpRows;
    const int n = rows - r0 < kWarpRows ? rows - r0 : kWarpRows;
    if (n > 0) warp_load(a, sm, t0 + r0, n, r0);
    if (t0 == rb) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the weights (first tile); every warp's rows loaded before any compute
    if (n > 0) warp_rows(a, sm, t0 + r0, n, r0);
    __syncthreads();  // the tile's a and g complete
#pragma unroll
    for (int q = 0; q < kMaxBlocks; ++q) {
      if (a_at[q] < 0) continue;
      const float* ap = sm + a_at[q];
      const float* gp = sm + g_at[q];
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(ap + r * a_w[q]);
        const float4 gv = *reinterpret_cast<const float4*>(gp + r * g_w[q]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float x = lane_of(av, u);
          acc[q][4 * u + 0] = fmaf(x, gv.x, acc[q][4 * u + 0]);
          acc[q][4 * u + 1] = fmaf(x, gv.y, acc[q][4 * u + 1]);
          acc[q][4 * u + 2] = fmaf(x, gv.z, acc[q][4 * u + 2]);
          acc[q][4 * u + 3] = fmaf(x, gv.w, acc[q][4 * u + 3]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }

  // this CTA's slice, block by block, then a grid-wide barrier
  const int P = 16 * n_blocks;
  float* const slice = a.partial + (size_t)blockIdx.x * P;
#pragma unroll
  for (int q = 0; q < kMaxBlocks; ++q) {
    if (a_at[q] < 0) continue;
    float4* dst = reinterpret_cast<float4*>(slice + 16 * (tid + q * kBwdThreads));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      dst[u] = make_float4(acc[q][4 * u], acc[q][4 * u + 1], acc[q][4 * u + 2], acc[q][4 * u + 3]);
  }
  __syncthreads();
  if (tid == 0) {   // the CTA's writes, ordered before its arrival by the fence
    __threadfence();
    atomicAdd(a.counter, 1u);
    while (load_acquire(a.counter) < gridDim.x) __nanosleep(64);
  }
  __syncthreads();

  // the sum over the slices in 32-element chunks: a chunk's slices are cut
  // into runs of at most kSpan, one warp a run, and the run's sums added in
  // run order by the chunk's first warp; with few slices the CTA's warps take
  // several chunks at once.  Fixed by the grid alone: the same bits on every
  // call.
  float* const red = sm;  // the tile buffers are free
  constexpr int kSpan = (kBwdMaxParts + kBwdWarps - 1) / kBwdWarps;  // slices a run, at most
  const int G = gridDim.x;
  const int runs = (G + kSpan - 1) / kSpan, span = (G + runs - 1) / runs;
  const int per_round = kBwdWarps / runs;          // chunks the CTA takes at once
  const int run = warp % runs, slot = warp / runs;
  const int s0 = min(G, run * span), s1 = min(G, s0 + span);
  for (int c0 = blockIdx.x * per_round; c0 * 32 < P; c0 += G * per_round) {
    const int p = (c0 + slot) * 32 + lane;
    const bool mine = slot < per_round && p < P;
    float v[kSpan];   // every load in flight before the first add
#pragma unroll
    for (int i = 0; i < kSpan; ++i)
      v[i] = mine && s0 + i < s1 ? __ldcg(a.partial + (size_t)(s0 + i) * P + p) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kSpan; ++i)
      if (s0 + i < s1) s += v[i];
    red[warp * 32 + lane] = s;
    __syncthreads();
    if (mine && run == 0) {
      float total = 0.f;
      for (int r = 0; r < runs; ++r) total += red[(slot * runs + r) * 32 + lane];
      store_grad(a, p, total);
    }
    __syncthreads();
  }
  // the last CTA out leaves the counter at 0 for the next call
  if (tid == 0 && atomicAdd(a.counter + 1, 1u) == gridDim.x - 1) {
    a.counter[0] = 0;
    a.counter[1] = 0;
  }
}

// The fused body's layout of a stack, into a; the shared memory bytes, or 0
// where the body does not take the stack (ops/fused_vae.py::_fused_fits
// mirrors it).
inline size_t plan_fused_bwd(BwdArgs& a, bool want_dx) {
  const int L = a.n_hidden;
  if (L < 0 || L > kMaxHidden || a.n_heads < 1 || a.n_heads > kMaxHeads) return 0;
  a.head_off[0] = 0;
  for (int h = 0; h < a.n_heads; ++h) a.head_off[h + 1] = a.head_off[h] + a.head_dims[h];
  const int total = a.head_off[a.n_heads];
  if (total < 1 || total > kBwdMaxWidth) return 0;
  for (int l = 0; l <= L; ++l)
    if (a.dims[l] < 1 || a.dims[l] > kBwdMaxWidth) return 0;
  int off = 0, nb = 0, params = 0;
  for (int t = 0; t <= L; ++t) {
    const int K = a.dims[t], N = t < L ? a.dims[t + 1] : total;
    a.w_off[t] = off;
    a.pitch[t] = bwd_pitch(N);
    off += (t < L ? round4(K + 1) : K) * a.pitch[t];
    a.blk_begin[t] = nb;
    nb += ((K + 4) / 4) * ((N + 3) / 4);
    if (t < L) {
      a.param_off[t] = params;
      params += K * N + N;
    } else {
      for (int h = 0; h < a.n_heads; ++h) {
        a.param_off[L + h] = params;
        params += K * a.head_dims[h] + a.head_dims[h];
      }
    }
  }
  a.blk_begin[L + 1] = nb;
  if (nb > kMaxBlocks * kBwdThreads) return 0;
  for (int l = 0; l <= L; ++l) {
    a.act_off[l] = off;
    a.act_w[l] = round4(a.dims[l] + 1);
    off += kBwdRows * a.act_w[l];
  }
  for (int l = 0; l <= L; ++l) {
    a.g_off[l] = off;
    a.g_w[l] = round4(l == 0 ? total : a.dims[l]);
    off += kBwdRows * a.g_w[l];
  }
  a.dx_off = off;
  a.dx_w = round4(a.dims[0]);
  if (want_dx) off += kBwdRows * a.dx_w;
  const size_t bytes = sizeof(float) * (size_t)off;
  return bytes <= kMaxSmem ? bytes : 0;
}

inline int fused_bwd_parts(long long batch) {
  const long long parts = (batch + kBwdMinRows - 1) / kBwdMinRows;
  return (int)(parts < kBwdMaxParts ? parts : kBwdMaxParts);
}

}  // namespace atlasvae

// grads: the parameter vector [dW_0, db_0, ..., dW_head0, db_head0, ...];
// partial: (n_parts, 16 x the stack's dW/db blocks) scratch and counter: 2
// unsigned integers at 0, both as ops/fused_vae.py::backward_plan and the
// wrapper give them; dx: (batch, dims[0]) or null.  The fused body: one
// cooperative launch of n_parts CTAs (fewer on a card of fewer SMs).
extern "C" int atlasvae_stack_backward(const void* x, long long batch, int n_hidden,
                                       const int* dims, const void* const* weights,
                                       const void* const* biases, int n_heads,
                                       const int* head_dims, const void* const* head_weights,
                                       const void* const* head_grads, void* dx, void* partial,
                                       int n_parts, void* grads, void* counter, void* stream) {
  using namespace atlasvae;
  if (n_hidden < 0 || n_hidden > kMaxHidden || n_heads < 1 || n_heads > kMaxHeads || batch < 1 ||
      n_parts != fused_bwd_parts(batch))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.x = static_cast<const float*>(x);
  a.batch = batch;
  a.n_hidden = n_hidden;
  a.n_heads = n_heads;
  for (int i = 0; i <= n_hidden; ++i) a.dims[i] = dims[i];
  for (int i = 0; i < n_hidden; ++i) {
    a.w[i] = static_cast<const float*>(weights[i]);
    a.b[i] = static_cast<const float*>(biases[i]);
  }
  for (int h = 0; h < n_heads; ++h) {
    a.head_dims[h] = head_dims[h];
    a.hw[h] = static_cast<const float*>(head_weights[h]);
    a.g[h] = static_cast<const float*>(head_grads[h]);
  }
  a.dx = static_cast<float*>(dx);
  a.partial = static_cast<float*>(partial);
  a.grads = static_cast<float*>(grads);
  a.counter = static_cast<unsigned*>(counter);
  const size_t smem = plan_fused_bwd(a, dx != nullptr);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stack_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  static int sms[64] = {0};   // SMs of each device: every CTA must be resident at once
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return (int)err;
  const int grid = n_parts < sms[device] ? n_parts : sms[device];
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(stack_bwd_kernel), dim3(grid),
                                    dim3(kBwdThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The layer-wise route.

namespace atlasvae {
namespace layers {

constexpr int kCols[2] = {128, 64};   // a product's column tile: FORWARD_TILE_COLS

// grads[dst + e] = sum over the splits of partial[src + e + split * stride],
// in split order, for each entry (a layer's dW/db, or a head's) of a group:
// one launch up to kReduceLayers entries.
constexpr int kReduceLayers = 12;
struct ReduceArgs {
  int n;
  long long pre[kReduceLayers + 1];  // entry i's elements are p in [pre[i], pre[i + 1])
  long long dst[kReduceLayers];
  long long src[kReduceLayers];
  long long stride[kReduceLayers];
  int splits[kReduceLayers];
};

__global__ void reduce_splits(const float* __restrict__ partial, const __grid_constant__ ReduceArgs r,
                              float* __restrict__ grads) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r.pre[r.n]) return;
  int i = 0;
  while (p >= r.pre[i + 1]) ++i;
  const float* src = partial + r.src[i] + (p - r.pre[i]);
  float s = 0.f;
  for (int k = 0; k < r.splits[i]; ++k) s += src[k * r.stride[i]];
  grads[r.dst[i] + (p - r.pre[i])] = s;
}

// Collects the pre-pass's layers, kMaxPrep a launch, each layer's split B
// placed after the last in `ws`.
struct Prep {
  wg::PrepArgs p = {};
  float* ws;
  cudaStream_t st;
  cudaError_t err = cudaSuccess;

  // B of a product of k x n, one segment (trans: W (n, k) row-major, else
  // W (k, n)) or the heads' (trans, segments along k); with `norm2`, room
  // for its columns' squared norms follows.  Returns where B goes.
  float* add(const float* const* w, const int* beg, int nseg, int trans, int k, int n, int bn,
             bool room_for_norms, float** norm2) {
    wg::PrepLayer& l = p.l[p.n_layers++];
    l = wg::PrepLayer{};
    for (int s = 0; s < nseg; ++s) {
      l.w[s] = w[s];
      l.nbeg[s + 1] = beg[s + 1];
    }
    l.nseg = nseg;
    l.trans = trans;
    l.k = k;
    l.n = n;
    l.bn = bn;
    l.k_chunks = (k + wg::kBK - 1) / wg::kBK;
    l.n_pad = (n + bn - 1) / bn * bn;
    l.dst = ws;
    ws += wg::split_floats(k, n, bn);
    if (room_for_norms) {
      if (norm2 != nullptr) *norm2 = l.norm2 = ws;
      ws += l.n_pad;
    }
    float* const dst = l.dst;
    if (p.n_layers == wg::kMaxPrep) flush();
    return dst;
  }
  void flush() {
    if (p.n_layers > 0 && err == cudaSuccess) err = wg::launch_split(p, st, true);
    p.n_layers = 0;
  }
};

// What both entries share: the stack's views, the pre-pass of the
// recompute's layers, and the recompute itself.
struct Stack {
  long long batch;
  int L;
  const int* dims;
  const float* const* W;
  const float* const* B;
  std::vector<float*> act;   // act[0] = x; act[l + 1] = hidden layer l's output, then its gradient
  std::vector<float*> rec_split, rec_norm2;

  float* chain;               // the re-decisions' row buffers, chain_width wide
  int chain_width;
  int* redecided = nullptr;   // or n_hidden counts of re-decided elements, one a layer

  Stack(const void* x, long long batch_, int n_hidden, const int* dims_, const void* const* w,
        const void* const* b, void* acts, void* chain_, int chain_width_)
      : batch(batch_), L(n_hidden), dims(dims_), W(reinterpret_cast<const float* const*>(w)),
        B(reinterpret_cast<const float* const*>(b)), act(n_hidden + 1),
        rec_split(n_hidden), rec_norm2(n_hidden, nullptr), chain(static_cast<float*>(chain_)),
        chain_width(chain_width_) {
    act[0] = const_cast<float*>(static_cast<const float*>(x));
    long long off = 0;
    for (int l = 0; l < L; ++l) {   // each buffer 16-byte aligned
      act[l + 1] = static_cast<float*>(acts) + off;
      off += (batch * dims[l + 1] + 3) / 4 * 4;
    }
  }

  void prep_recompute(Prep& prep, const int* row_tiles, bool redecide) {
    for (int l = 0; l < L; ++l) {
      const int beg[2] = {0, dims[l + 1]};
      rec_split[l] = prep.add(&W[l], beg, 1, 0, dims[l], dims[l + 1], kCols[row_tiles[l]], true,
                              redecide ? &rec_norm2[l] : nullptr);
    }
  }

  cudaError_t recompute(const int* row_tiles, bool redecide, cudaStream_t st) {
    for (int l = 0; l < L; ++l) {
      wg::RowsArgs r = {};
      r.a[0] = act[l];
      r.rows = batch;
      r.k = dims[l];
      r.n = r.nbeg[1] = dims[l + 1];
      r.nseg = 1;
      r.bias[0] = B[l];
      r.out[0] = act[l + 1];
      r.relu = 1;
      r.wsplit = rec_split[l];
      r.w = W[l];
      r.wnorm2 = rec_norm2[l];
      // a re-decided row's input, rebuilt through up to kMaxChain layers below
      const int first = l > wg::kMaxChain ? l - wg::kMaxChain : 0;
      r.chain_n = l - first;
      r.chain_x = act[first];
      for (int j = first; j <= l; ++j) r.chain_dims[j - first] = dims[j];
      for (int j = first; j < l; ++j) {
        r.chain_w[j - first] = W[j];
        r.chain_b[j - first] = B[j];
        if (dims[j + 1] > chain_width) return cudaErrorInvalidValue;
      }
      r.chain_buf = chain;
      r.chain_width = chain_width;
      r.redecided = redecided != nullptr ? redecided + l : nullptr;
      const cudaError_t err = wg::launch_bwd_rows(kCols[row_tiles[l]], r, redecide, st);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
};

inline bool valid_tiles(const int* row_tiles, int n) {
  for (int i = 0; i < n; ++i)
    if (row_tiles[i] < 0 || row_tiles[i] > 1) return false;
  return true;
}

}  // namespace layers
}  // namespace atlasvae

// The layer-wise route.  wsplit: the pre-pass's split weights (and the
// recompute's column norms), chain: 2 x chain_width floats for each SM
// (chain_width: the widest hidden layer below the last; none for fewer than
// two hidden layers), acts: batch x
// sum(dims[1..n_hidden]) floats
// (each layer's rounded up to 4: hidden activations, then the gradients
// written over them), partial: each weight gradient's split slices (those
// of more than one split), in the sizes and order of
// ops/fused_vae.py::backward_plan; row_tiles (2 n_hidden + 1: the
// recompute of each hidden layer, the heads' gradient, the gradient through
// each hidden layer) and dw_plan (3 per weight gradient, hidden layers then
// the heads together: column tile, splits, rows per split) as backward_plan
// gives them.  Returns the first CUDA error.
extern "C" int atlasvae_stack_backward_layers(
    const void* x, long long batch, int n_hidden, const int* dims, const void* const* weights,
    const void* const* biases, int n_heads, const int* head_dims,
    const void* const* head_weights, const void* const* head_grads, void* dx, void* wsplit,
    void* chain, int chain_width, void* acts, void* partial, const int* row_tiles,
    const int* dw_plan, void* grads, void* stream) {
  using namespace atlasvae;
  using namespace atlasvae::layers;
  const int L = n_hidden;
  if (L < 0 || n_heads < 1 || n_heads > wg::kMaxSeg || batch < 1 || batch >= (1ll << 31) ||
      !valid_tiles(row_tiles, 2 * L + 1))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= L; ++i) {
    const int* d = dw_plan + 3 * i;
    if (d[0] < 0 || d[0] > 1 || d[1] < 1 || d[2] < 1 || d[2] % wg::kBK != 0 ||
        (long long)d[1] * d[2] < batch || (long long)(d[1] - 1) * d[2] >= batch)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Stack v(x, batch, L, dims, weights, biases, acts, chain, chain_width);
  const float* const* HW = reinterpret_cast<const float* const*>(head_weights);
  const float* const* G = reinterpret_cast<const float* const*>(head_grads);
  float* const DX = static_cast<float*>(dx);
  float* const P = static_cast<float*>(partial);
  float* const out = static_cast<float*>(grads);
  const int dL = dims[L];
  int head_beg[wg::kMaxSeg + 1] = {0};
  for (int h = 0; h < n_heads; ++h) head_beg[h + 1] = head_beg[h] + head_dims[h];
  const int head_total = head_beg[n_heads];
  const bool need_gl = L > 0 || DX != nullptr;

  // each weight gradient's place in grads (off, by leaf: hidden layers,
  // then each head), its slices in partial (base, by gradient: hidden
  // layers, then the heads together) and a slice's floats
  const int n_leaves = L + n_heads;
  std::vector<long long> off(n_leaves + 1, 0), base(L + 1, 0), slice(L + 1);
  for (int i = 0; i < n_leaves; ++i) {
    const long long k = i < L ? dims[i] : dL, n = i < L ? dims[i + 1] : head_dims[i - L];
    off[i + 1] = off[i] + k * n + n;
  }
  long long run = 0;
  for (int i = 0; i <= L; ++i) {
    slice[i] = i < L ? (long long)(dims[i] + 1) * dims[i + 1] : (long long)(dL + 1) * head_total;
    base[i] = run;
    if (dw_plan[3 * i + 1] > 1) run += dw_plan[3 * i + 1] * slice[i];
  }

  // 1. the pre-pass: the recompute's weights, the heads' and every hidden
  // layer's whose gradient goes one layer down, kMaxPrep a launch
  Prep prep;
  prep.ws = static_cast<float*>(wsplit);
  prep.st = st;
  v.prep_recompute(prep, row_tiles, true);
  float* gl_split = nullptr;
  if (need_gl)
    gl_split = prep.add(HW, head_beg, n_heads, 1, head_total, dL, kCols[row_tiles[L]], false,
                        nullptr);
  std::vector<float*> g_split(L, nullptr);
  for (int i = L - 1; i >= 0; --i)
    if (i > 0 || DX != nullptr) {
      const int beg[2] = {0, dims[i + 1]};
      g_split[i] = prep.add(&v.W[i], beg, 1, 1, dims[i + 1], dims[i],
                            kCols[row_tiles[L + 1 + i]], false, nullptr);
    }
  prep.flush();
  cudaError_t err = prep.err;
#define K3_TRY(call)          \
  if ((err = (call)) != cudaSuccess) return (int)err
  K3_TRY(err);

  // 2. recompute the hidden activations
  K3_TRY(v.recompute(row_tiles, true, st));

  auto weight_grad = [&](int i, const float* a, int m, int nseg, const float* const* g,
                         const int* beg) {
    wg::DwArgs d = {};
    d.a = a;
    d.batch = batch;
    d.m = m;
    d.n = beg[nseg];
    d.nseg = nseg;
    long long seg_off = 0;
    for (int s = 0; s < nseg; ++s) {
      d.g[s] = g[s];
      d.nbeg[s + 1] = beg[s + 1];
      const int width = beg[s + 1] - beg[s];
      d.part[s] = dw_plan[3 * i + 1] > 1 ? P + base[i] + seg_off : out + off[i + s];
      seg_off += (long long)(m + 1) * width;
    }
    d.slice = slice[i];
    d.rows_per_split = dw_plan[3 * i + 2];
    return wg::launch_dw(kCols[dw_plan[3 * i]], d, dw_plan[3 * i + 1], st);
  };
  auto grad_down = [&](const float* const* a, const int* kbeg, int aseg, int n, const float* split,
                       int tile, float* dst, bool mask) {
    wg::RowsArgs r = {};
    for (int s = 0; s < aseg; ++s) {
      r.a[s] = a[s];
      r.kbeg[s + 1] = kbeg[s + 1];
    }
    r.aseg = aseg;
    r.k = kbeg[aseg];
    r.rows = batch;
    r.n = r.nbeg[1] = n;
    r.nseg = 1;
    r.out[0] = dst;
    r.mask = mask;
    r.wsplit = split;
    return wg::launch_bwd_rows(kCols[tile], r, false, st);
  };

  // 3. the heads' dW/db, then g_L = (sum_h g_h W_h^T) * (a_L > 0) over a_L
  K3_TRY(weight_grad(L, v.act[L], dL, n_heads, G, head_beg));
  if (need_gl)
    K3_TRY(grad_down(G, head_beg, n_heads, dL, gl_split, row_tiles[L], L > 0 ? v.act[L] : DX,
                     L > 0));
  // 4. hidden layers, last first: dW/db, then the gradient one layer down
  for (int i = L - 1; i >= 0; --i) {
    const int beg[2] = {0, dims[i + 1]};
    const float* gi = v.act[i + 1];
    K3_TRY(weight_grad(i, v.act[i], dims[i], 1, &gi, beg));
    if (i > 0 || DX != nullptr)
      K3_TRY(grad_down(&gi, beg, 1, dims[i], g_split[i], row_tiles[L + 1 + i],
                       i > 0 ? v.act[i] : DX, i > 0));
  }
  // 5. the ordered sum of the splits, a group of entries a launch
  std::vector<std::array<long long, 5>> entries;   // dst, len, src, stride, splits
  for (int i = 0; i <= L; ++i) {
    const long long splits = dw_plan[3 * i + 1];
    if (splits == 1) continue;
    if (i < L) {
      entries.push_back({off[i], off[i + 1] - off[i], base[i], slice[i], splits});
    } else {
      long long seg_off = 0;
      for (int h = 0; h < n_heads; ++h) {
        entries.push_back({off[L + h], off[L + h + 1] - off[L + h], base[L] + seg_off, slice[L],
                           splits});
        seg_off += (long long)(dL + 1) * head_dims[h];
      }
    }
  }
  for (size_t g0 = 0; g0 < entries.size(); g0 += kReduceLayers) {
    ReduceArgs red = {};
    red.n = (int)(entries.size() - g0 < (size_t)kReduceLayers ? entries.size() - g0 : kReduceLayers);
    for (int i = 0; i < red.n; ++i) {
      const auto& e = entries[g0 + i];
      red.dst[i] = e[0];
      red.pre[i + 1] = red.pre[i] + e[1];
      red.src[i] = e[2];
      red.stride[i] = e[3];
      red.splits[i] = (int)e[4];
    }
    const long long total = red.pre[red.n];
    reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(P, red, out);
    K3_TRY(cudaGetLastError());
  }
#undef K3_TRY
  return (int)cudaSuccess;
}

// The layer-wise route's recompute alone: its pre-pass and its row
// products, the hidden activations left in acts (laid out as above) and the
// split weights in wsplit (the recompute's share of the layout above).  For
// measuring what the recompute decides (ops/fused_vae.py::stack_recompute);
// redecided: n_hidden ints, 0 at the call, to which each layer adds the
// elements it re-decided.
extern "C" int atlasvae_stack_recompute(const void* x, long long batch, int n_hidden,
                                        const int* dims, const void* const* weights,
                                        const void* const* biases, void* wsplit, void* chain,
                                        int chain_width, void* acts, const int* row_tiles,
                                        int redecide, void* redecided, void* stream) {
  using namespace atlasvae::layers;
  if (n_hidden < 1 || batch < 1 || batch >= (1ll << 31) || !valid_tiles(row_tiles, n_hidden))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Stack v(x, batch, n_hidden, dims, weights, biases, acts, chain, chain_width);
  v.redecided = static_cast<int*>(redecided);
  Prep prep;
  prep.ws = static_cast<float*>(wsplit);
  prep.st = st;
  v.prep_recompute(prep, row_tiles, redecide != 0);
  prep.flush();
  if (prep.err != cudaSuccess) return (int)prep.err;
  return (int)v.recompute(row_tiles, redecide != 0, st);
}
