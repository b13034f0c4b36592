// Dense ReLU stack + linear heads, f32 in and out, products in 3xTF32 on the
// tensor cores: the fused body of K1 (fused_mlp.cu) and K2 (fused_vae.cu),
// for stacks no wider than 128, and the fused segments of their layer-wise
// route (stack_layers.cuh).  It computes h = relu(h W_i + b_i) for the
// hidden layers, then the heads' columns as one layer (a VAE encoder's
// mean|logvar), each head written to its own output, with ReLU on request.
//
// Bound on an H100: the canonical encoder 12->80/40/20 + 2x10 does 5,360
// MAC and moves 128 bytes a row (48 in, 80 out); at the 65,536-row scoring
// chunk that is 4.4 us of products in 3xTF32 (three TF32 products each, at
// the 495 TFLOP/s TF32 peak) beside 2.5 us of bytes, so it is bound by
// operations.  The earlier body (64 columns a pass, weights restaged in 16-row
// chunks behind two barriers each, per 128-row tile) took 0.076 ms there on
// the device alone, and 0.029 ms at 10,000 rows.  The design:
// - Products on the tensor cores, 3xTF32 as in gemm_tf32.cuh: each operand
//   splits into TF32 hi + lo, a*b is lo_a hi_b + hi_a lo_b + hi_a hi_b
//   (mma.sync m16n8k8, three a k-step), each k-step's three products in a
//   fresh accumulator added to the running sum by an f32 add, so that the
//   tensor cores' unrounded accumulation stays within one k-step.  A layer
//   of 80 columns is 10 n8 tiles: nothing is spent on columns past the
//   layer's edge beyond its last n8 tile (one more where the count of tiles
//   is odd, and up to T where a layer takes the instance of T / 2 pairs; see
//   layer_products).
// - Warps own rows, registers hold the activations: a warp carries 16 rows
//   (one m16 tile) through every layer with its activations in the
//   accumulator fragments.  A C fragment holds columns 2t, 2t + 1 of rows
//   g, g + 8; an A fragment wants columns t, t + 4.  The k order inside an
//   8-wide k-step is free if W's rows follow it, so the weights are laid out
//   with A's k = t, t + 4 as W's rows 2t, 2t + 1: the C fragment of n-tile j
//   is, unchanged, the A fragment of k-step j of the next layer.  No layer
//   goes through shared memory and no warp waits for another: after the
//   staging there is no block barrier, and no __syncwarp inside the layer
//   loop.  The register arrays are sized by the template's T (n8 tiles of the
//   widest layer: 4, 8, 10 or 16), the k-steps unrolled to T and guarded by
//   the layer's count, the n-tiles unrolled in pairs with no guard between
//   them (a guard ends the compiler's scheduling block): an instance for
//   each count of pairs that a layer of the main path's stacks has (the
//   canonical encoder and decoder, the constituents-mode tail and head), and
//   one of T / 2 pairs for any other layer.  On an H100 the pairs' instances
//   took the 65,536-row encoder from 0.0339 to 0.0320 ms and the
//   128 -> 64 + 2x32 tail from 0.079 to 0.063; an instance for every count
//   (19 in all) took nvcc 43 s for K1/K2's library.
// - Weights on chip once a CTA: at its start each CTA copies every leaf's W
//   as it lies in HBM, one contiguous span a leaf, 16 bytes a cp.async where
//   the leaf is aligned (else 4), over the warps' buffers, and b into place;
//   then it lays each lane's B fragment of every n8 x k8 tile out as one
//   float4, hi(b0), hi(b1), lo(b0), lo(b1), split once (512 bytes a tile,
//   read conflict-free), zero past the layer's edges; two block barriers.
//   The canonical encoder takes 69 KB a CTA, the constituents-mode tail
//   128->64 + 2x32 193 KB.  Staging costs about 5 us a call beside a
//   launch's 2 (a CTA that only stages: 7.0 us on an H100); the earlier body read
//   each weight with a 4-byte load per 128-row tile.  A stack whose layout
//   does not fit a CTA (two 128 x 128 layers' fragments alone take 256 KB)
//   is cut by ops/fused_vae.py::forward_plan into segments that do, a launch
//   each, their activations through device memory (forward_smem mirrors
//   plan_dense_stack); every single layer up to 128 x 128 fits.
// - Persistent CTAs of 8 warps (4 where 8 warps' buffers do not fit): the
//   grid is the smaller of the CTAs the rows need and those resident on the
//   card's SMs; warp w of CTA c takes 16-row blocks c * warps + w, then a
//   grid's worth of warps further on.  The next block's x (16 rows: one
//   contiguous span, 16-byte cp.async where x is aligned, the copy's own
//   zero fill at the tail) loads into the warp's buffer while the warp
//   multiplies this one, whose x is in registers by then.  4-warp CTAs were
//   slower on an H100 (0.0410 in place of 0.0314 ms at 65,536 rows): twice
//   the CTAs stage the weights.
// - Outputs staged: each head's 16 rows go to the warp's stage in shared
//   memory as they lie in the output (rows of the head's width), then out as
//   one contiguous span, 16 bytes a lane where the output is aligned.
// Each output is one sum in a fixed order: a second call gives the same bits.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "gemm_tf32.cuh"

namespace atlasvae {

constexpr int kMaxHidden = 8;
constexpr int kMaxHeads = 4;
constexpr int kMaxFusedWidth = 128;   // wider stacks take the layer-wise route
constexpr int kStackWarps = 8;        // a CTA, or 4 where 8 warps' buffers do not fit
constexpr int kStackThreads = 32 * kStackWarps;
constexpr int kBlockRows = 16;        // a warp's rows: one m16 tile
constexpr size_t kStackMaxSmem = 232448;   // a CTA's shared memory on sm_90
constexpr size_t kSmemPerSM = 233472;      // an SM's, 1 KB of it reserved per CTA

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
};

// Where plan_dense_stack puts a stack in a CTA's shared memory (floats from
// its start unless said), and the launch.  Layer t < n_hidden is hidden
// layer t; t = n_hidden is the heads, concatenated.
struct StackLayout {
  int tiles;                       // T: the kernel instance (n8 tiles of the widest layer)
  int kt[kMaxHidden + 1];          // layer t's k8 steps
  int nt[kMaxHidden + 1];          // and n8 tiles
  int w_off[kMaxHidden + 1];       // its B fragments, in float4
  int b_off[kMaxHidden + 1];       // its bias, nt * 8 floats
  int head_off[kMaxHeads + 1];     // a head's first column among the heads'
  int warps;                       // a CTA's
  int x_off, x_floats;             // the warps' x buffers, 16 dims[0] floats each
  int st_off, st_floats;           // the warps' stages, 16 x the heads' columns each
  int raw_off[kMaxHidden];         // hidden layer t's W as it lies in HBM, from x_off
  int raw_head[kMaxHeads];         // a head's W (the staging's copies; over the warps' buffers)
  int vec_x, vec_out;              // 16-byte copies of x, stores of the outputs
  long long blocks;                // 16-row blocks
  size_t smem;                     // bytes
  int ctas_per_sm;
};

// The instance for a stack whose widest layer has `tiles` n8 tiles (or k8
// steps), and the CTAs of 8 warps an SM its registers allow (its launch
// bound); of 4 warps, twice as many.
__host__ __device__ constexpr int stack_tiles(int tiles) {
  return tiles <= 4 ? 4 : tiles <= 8 ? 8 : tiles <= 10 ? 10 : 16;   // even: layer_products
}
__host__ __device__ constexpr int stack_ctas(int T) { return T <= 4 ? 3 : T <= 10 ? 2 : 1; }

__device__ __forceinline__ void copy_tail16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tf32::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// The warp's x copies of 16-row block `blk` into dst: one span of rows x
// dims[0] floats; rows past the batch are left as they are (their outputs
// are never stored, and an m16 product's rows do not mix).
__device__ __forceinline__ void copy_block(const StackArgs& a, const StackLayout& p, float* dst,
                                           long long blk, int lane) {
  const long long row0 = blk * kBlockRows;
  const long long left = a.batch - row0;
  const int len = (left < kBlockRows ? (int)left : kBlockRows) * a.dims[0];
  const float* src = a.x + row0 * a.dims[0];
  if (p.vec_x) {   // x 16-byte aligned; row0 * dims[0] is a multiple of 16
    for (int c = 4 * lane; c < len; c += 128) copy_tail16(dst + c, src + c, 4 * min(4, len - c));
  } else {
    for (int e = lane; e < len; e += 32) tf32::copy4(dst + e, src + e, true);
  }
}

// Copy len floats from src into dst (16-byte aligned), the CTA's threads
// together: 16 bytes a copy where src is aligned, else 4.
__device__ __forceinline__ void copy_span(float* dst, const float* src, int len) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int c = 4 * (int)threadIdx.x; c < len; c += 4 * (int)blockDim.x)
      copy_tail16(dst + c, src + c, 4 * min(4, len - c));
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x) tf32::copy4(dst + e, src + e, true);
  }
}

__device__ __forceinline__ const float* bias_at(const StackArgs& a, const StackLayout& p, int t,
                                                int n, bool valid) {
  if (!valid) return a.x;
  if (t < a.n_hidden) return a.b[t] + n;
  int h = 0;
  while (h + 1 < a.n_heads && n >= p.head_off[h + 1]) ++h;
  return a.hb[h] + (n - p.head_off[h]);
}

// acc[j] = act W over the layer's KT k-steps and its n-tiles, NP pairs of
// them (3xTF32, each k-step's products summed apart and added in order).
// act[i] and acc[j] are C fragments: act[i] is read as the A fragment of
// k-step i.  wf: the layer's fragments, offset by the lane.  The pairs are
// unrolled with no branch between them (a branch would end the compiler's
// scheduling block and expose each pair's load and three-deep mma chain):
// a tile past the layer's last (an odd count's second of a pair, or every
// tile past NT where NP is more than the layer needs) repeats the last, and
// its sums, past the layer's edge, are never read.
template <int T, int NP>
__device__ __forceinline__ void pair_products(const float (&act)[T][4], float (&acc)[T][4],
                                              const float4* wf, int KT, int NT) {
  static_assert(2 * NP <= T, "T holds the pairs");
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (i >= KT) break;
    uint32_t ah[4], al[4];   // A: rows g, g + 8 at k = t (W row 2t), then t + 4 (2t + 1)
    tf32::split(act[i][0], ah[0], al[0]);
    tf32::split(act[i][2], ah[1], al[1]);
    tf32::split(act[i][1], ah[2], al[2]);
    tf32::split(act[i][3], ah[3], al[3]);
    const float4* wk = wf + i * NT * 32;
#pragma unroll
    for (int j = 0; j < 2 * NP; j += 2) {
      const float4 w0 = wk[min(j, NT - 1) * 32];
      const float4 w1 = wk[min(j + 1, NT - 1) * 32];
      const uint32_t bh0[2] = {__float_as_uint(w0.x), __float_as_uint(w0.y)};
      const uint32_t bl0[2] = {__float_as_uint(w0.z), __float_as_uint(w0.w)};
      const uint32_t bh1[2] = {__float_as_uint(w1.x), __float_as_uint(w1.y)};
      const uint32_t bl1[2] = {__float_as_uint(w1.z), __float_as_uint(w1.w)};
      float p0[4], p1[4];
      tf32::mma(p0, al, bh0, zero);
      tf32::mma(p1, al, bh1, zero);
      tf32::mma(p0, ah, bl0, p0);
      tf32::mma(p1, ah, bl1, p1);
      tf32::mma(p0, ah, bh0, p0);
      tf32::mma(p1, ah, bh1, p1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] += p0[e];
        acc[j + 1][e] += p1[e];
      }
    }
  }
}

// The products of one layer: an instance for each count of pairs of n-tiles
// that the main path's stacks have under T (the canonical encoder and
// decoder 1, 2, 3 and 5 pairs at T = 10; the constituents-mode tail and head
// 4 and 8 at T = 16), T / 2 pairs for the rest.
template <int T>
__device__ __forceinline__ void layer_products(const float (&act)[T][4], float (&acc)[T][4],
                                               const float4* wf, int KT, int NT) {
  const int np = (NT + 1) / 2;
  if constexpr (T == 10) {
    if (np == 1) return pair_products<T, 1>(act, acc, wf, KT, NT);
    if (np == 2) return pair_products<T, 2>(act, acc, wf, KT, NT);
    if (np == 3) return pair_products<T, 3>(act, acc, wf, KT, NT);
  }
  if constexpr (T == 16) {
    if (np == 4) return pair_products<T, 4>(act, acc, wf, KT, NT);
  }
  pair_products<T, T / 2>(act, acc, wf, KT, NT);
}

template <int T>
__global__ void __launch_bounds__(kStackThreads, stack_ctas(T))
fused_stack_kernel(const __grid_constant__ StackArgs a, const __grid_constant__ StackLayout p) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int L = a.n_hidden, d0 = a.dims[0];
  const long long stride = (long long)gridDim.x * p.warps;
  const long long first = (long long)blockIdx.x * p.warps + warp;
  float* const xb = sm + p.x_off + warp * p.x_floats;
  float* const st = sm + p.st_off + warp * p.st_floats;

  // every layer's W as it lies (one span a leaf) over the warps' buffers, and
  // b in place, zero past the edge
  float* const raw = sm + p.x_off;
  for (int t = 0; t <= L; ++t) {
    const int K = a.dims[t];
    if (t < L) {
      copy_span(raw + p.raw_off[t], a.w[t], K * a.dims[t + 1]);
    } else {
      for (int h = 0; h < a.n_heads; ++h)
        copy_span(raw + p.raw_head[h], a.hw[h], K * a.head_dims[h]);
    }
    const int N = t < L ? a.dims[t + 1] : p.head_off[a.n_heads];
    float* const bias = sm + p.b_off[t];
    for (int c = tid; c < p.nt[t] * 8; c += blockDim.x)
      tf32::copy4(bias + c, bias_at(a, p, t, c, c < N), c < N);
  }
  tf32::commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // then each lane's B fragment of every n8 x k8 tile, split: hi(b0), hi(b1),
  // lo(b0), lo(b1) of W's rows 2q, 2q + 1 and column g; a warp takes rows
  // 2kp, 2kp + 1, its lanes the columns (reads along a row of the copy)
  for (int t = 0; t <= L; ++t) {
    const int K = a.dims[t], N = t < L ? a.dims[t + 1] : p.head_off[a.n_heads];
    const int NT = p.nt[t];
    float4* const wf = smem4 + p.w_off[t];
    for (int kp = warp; kp < 4 * p.kt[t]; kp += p.warps) {
      const int k = 2 * kp;
      for (int n = lane; n < 8 * NT; n += 32) {
        const float* col = raw + p.raw_off[t < L ? t : 0] + n;
        int stride = N;
        if (t == L) {
          int h = 0;
          while (h + 1 < a.n_heads && n >= p.head_off[h + 1]) ++h;
          col = raw + p.raw_head[h] + (n - p.head_off[h]);
          stride = a.head_dims[h];
        }
        uint32_t h0, l0, h1, l1;
        tf32::split(n < N && k < K ? col[k * stride] : 0.f, h0, l0);
        tf32::split(n < N && k + 1 < K ? col[(k + 1) * stride] : 0.f, h1, l1);
        wf[((kp >> 2) * NT + (n >> 3)) * 32 + (n & 7) * 4 + (kp & 3)] =
            make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                        __uint_as_float(l1));
      }
    }
  }
  __syncthreads();   // these fragments are whole; the copies' room is free
  if (first < p.blocks) copy_block(a, p, xb, first, lane);
  tf32::commit();

  const int total = p.head_off[a.n_heads];
  const bool relu_out = a.final_relu != 0;
  for (long long blk = first; blk < p.blocks; blk += stride) {
    const long long row0 = blk * kBlockRows;
    const int rows = a.batch - row0 < kBlockRows ? (int)(a.batch - row0) : kBlockRows;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // x into C fragments: act[i] holds columns 8i + 2q, 8i + 2q + 1 of rows g, g + 8
    float act[T][4];
    const float* x0 = xb + g * d0;
    const float* x1 = xb + (g + 8) * d0;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (i >= p.kt[0]) break;
      const int k = i * 8 + 2 * q;
      act[i][0] = k < d0 ? x0[k] : 0.f;
      act[i][1] = k + 1 < d0 ? x0[k + 1] : 0.f;
      act[i][2] = k < d0 ? x1[k] : 0.f;
      act[i][3] = k + 1 < d0 ? x1[k + 1] : 0.f;
    }
    __syncwarp();   // every lane has read the buffer: the next block's copy may land
    if (blk + stride < p.blocks) copy_block(a, p, xb, blk + stride, lane);
    tf32::commit();

    for (int t = 0;; ++t) {   // one call site of the (large, inlined) products
      float acc[T][4];
      layer_products<T>(act, acc, smem4 + p.w_off[t] + lane, p.kt[t], p.nt[t]);
      if (t == L) {
        // the heads: each head's 16 rows to its place in the stage
        const float* bias = sm + p.b_off[L];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          if (j >= p.nt[L]) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 8 + 2 * q + e;
            if (c < total) {
              int h = 0;
              while (h + 1 < a.n_heads && c >= p.head_off[h + 1]) ++h;
              const int width = a.head_dims[h];
              float* const s = st + kBlockRows * p.head_off[h] + (c - p.head_off[h]);
              float v0 = acc[j][e] + bias[c], v1 = acc[j][2 + e] + bias[c];
              if (relu_out) {   // a segment's hidden layer may feed a row product
                v0 = relu_nan(v0);
                v1 = relu_nan(v1);
              }
              s[g * width] = v0;
              s[(g + 8) * width] = v1;
            }
          }
        }
        break;
      }
      const float* bias = sm + p.b_off[t] + 2 * q;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (j >= p.nt[t]) break;
        const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j);
        act[j][0] = relu_nan(acc[j][0] + bv.x);
        act[j][1] = relu_nan(acc[j][1] + bv.y);
        act[j][2] = relu_nan(acc[j][2] + bv.x);
        act[j][3] = relu_nan(acc[j][3] + bv.y);
      }
    }
    __syncwarp();
    for (int h = 0; h < a.n_heads; ++h) {   // rows x width floats, contiguous on both sides
      const int width = a.head_dims[h], len = rows * width;
      const float* s = st + kBlockRows * p.head_off[h];
      float* const o = a.out[h] + row0 * width;
      int e = lane;
      if (p.vec_out) {
        for (int v = lane; v < len / 4; v += 32)
          reinterpret_cast<float4*>(o)[v] = reinterpret_cast<const float4*>(s)[v];
        e = len / 4 * 4 + lane;
      }
      for (; e < len; e += 32) o[e] = s[e];
    }
    __syncwarp();   // the stage is read before the next block writes it
  }
}

inline bool stack_aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The layout of a in shared memory, into p: every layer's fragments and bias,
// then each warp's x buffer and stage.  Returns the bytes, or 0 where the
// body does not take the stack (ops/fused_vae.py::forward_smem mirrors it).
inline size_t plan_dense_stack(const StackArgs& a, StackLayout* p) {
  *p = StackLayout{};
  const int L = a.n_hidden;
  if (L < 0 || L > kMaxHidden || a.n_heads < 1 || a.n_heads > kMaxHeads) return 0;
  p->head_off[0] = 0;
  for (int h = 0; h < a.n_heads; ++h) {
    if (a.head_dims[h] < 1) return 0;
    p->head_off[h + 1] = p->head_off[h] + a.head_dims[h];
  }
  const int total = p->head_off[a.n_heads];
  long long off = 0;
  int widest = 0;
  for (int t = 0; t <= L; ++t) {
    const int K = a.dims[t], N = t < L ? a.dims[t + 1] : total;
    if (K < 1 || N < 1 || K > kMaxFusedWidth || N > kMaxFusedWidth) return 0;
    p->kt[t] = (K + 7) / 8;
    p->nt[t] = (N + 7) / 8;
    widest = widest > p->kt[t] ? widest : p->kt[t];
    widest = widest > p->nt[t] ? widest : p->nt[t];
    p->w_off[t] = (int)(off / 4);
    off += 128LL * p->kt[t] * p->nt[t];
    p->b_off[t] = (int)off;
    off += 8LL * p->nt[t];
  }
  p->tiles = stack_tiles(widest);
  // every leaf's W as it lies, each span 16-byte aligned, over the warps' buffers
  long long raw = 0;
  for (int t = 0; t <= L; ++t) {
    const int K = a.dims[t];
    if (t < L) {
      p->raw_off[t] = (int)raw;
      raw += ((long long)K * a.dims[t + 1] + 3) / 4 * 4;
    }
    for (int h = 0; t == L && h < a.n_heads; ++h) {
      p->raw_head[h] = (int)raw;
      raw += ((long long)K * a.head_dims[h] + 3) / 4 * 4;
    }
  }
  p->x_off = (int)off;
  p->x_floats = kBlockRows * a.dims[0];
  p->st_floats = kBlockRows * total;
  // 8 warps, else 4: the first that fits
  p->smem = 0;
  for (int warps = kStackWarps; warps >= kStackWarps / 2 && p->smem == 0; warps /= 2) {
    const long long buffers = (long long)warps * (p->x_floats + p->st_floats);
    const size_t bytes = sizeof(float) * (size_t)(off + (buffers > raw ? buffers : raw));
    if (bytes <= kStackMaxSmem) {
      p->smem = bytes;
      p->warps = warps;
    }
  }
  if (p->smem == 0) return 0;
  p->st_off = p->x_off + p->warps * p->x_floats;
  const int by_smem = (int)(kSmemPerSM / (p->smem + 1024));
  const int by_regs = stack_ctas(p->tiles) * (kStackWarps / p->warps);
  p->ctas_per_sm = by_smem < by_regs ? by_smem : by_regs;
  p->blocks = (a.batch + kBlockRows - 1) / kBlockRows;
  p->vec_x = stack_aligned16(a.x);
  p->vec_out = 1;
  for (int h = 0; h < a.n_heads; ++h) p->vec_out = p->vec_out && stack_aligned16(a.out[h]);
  return p->smem;
}

template <int T>
inline cudaError_t launch_stack_t(const StackArgs& a, const StackLayout& p, unsigned grid,
                                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_stack_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  fused_stack_kernel<T><<<grid, 32 * p.warps, p.smem, stream>>>(a, p);
  return cudaGetLastError();
}

// One launch of the fused body: persistent CTAs, at most ctas_per_sm on each
// SM of the current device.  Returns the launch error, or cudaSuccess.
inline cudaError_t launch_dense_stack(StackArgs a, cudaStream_t stream) {
  if (a.batch <= 0) return cudaSuccess;
  if (a.max_width > kMaxFusedWidth) return cudaErrorInvalidValue;
  StackLayout p;
  if (plan_dense_stack(a, &p) == 0) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long want = (p.blocks + p.warps - 1) / p.warps;
  const long long most = (long long)p.ctas_per_sm * sms;
  const unsigned grid = (unsigned)(want < most ? want : most);
  switch (p.tiles) {
    case 4: return launch_stack_t<4>(a, p, grid, stream);
    case 8: return launch_stack_t<8>(a, p, grid, stream);
    case 10: return launch_stack_t<10>(a, p, grid, stream);
    default: return launch_stack_t<16>(a, p, grid, stream);
  }
}

}  // namespace atlasvae
