// K1 and K2's layer-wise row product on Hopper's warpgroup instruction
// (wgmma), in 3xTF32: out_s (rows x n_s) = epilogue(A W_s) for up to kMaxSeg
// column segments W_s (the heads of a stack, one product), A the (rows, k)
// row-major activations, W_s (k, n_s) row-major as the model keeps it, bias
// and optional ReLU in the epilogue.  Part of K1 (replaces the wide layers of
// atlasvae/ops/fused_mlp.py:_kernel) and K2 (atlasvae/ops/fused_vae.py:
// _stack_fwd_kernel): stack_layers.cuh runs every layer wider than 128 here.
//
// Bound on an H100: a 65,536 x 765 -> 256 layer does 25.7 GFLOP of f32
// products, 77 of TF32 (three a product): 0.156 ms at the 495 TFLOP/s TF32
// peak, beside 0.060 ms for the 200 MB of A.  Every layer of the main path's
// stacks is bound by the tensor cores' rate, so the design keeps them fed:
// - Products: wgmma m64nNk8 .tf32, f32 accumulators, built for sm_90a.  The
//   split of gemm_tf32.cuh, a*b = lo_a hi_b + hi_a lo_b + hi_a hi_b, is three
//   wgmma a k8 step.  TF32 wgmma takes K-major operands only, so W reaches
//   shared memory as W^T: a pre-pass in the same host call
//   (split_weights_kernel) writes each layer's W^T, split into its hi and lo
//   TF32 words and zero-padded to whole tiles, into a scratch the wrapper
//   allocates (2 x n_pad x k_pad floats a layer), already in the order and
//   128-byte swizzle a stage wants: a stage's B is one contiguous bulk copy.
//   W is split once a call (about 4 us at the main path's stacks on an
//   H100), not once a CTA and k-step.  A's fragment is read from shared
//   memory into registers, split there by integer operations (split_rna),
//   and given to wgmma from registers (the RS form); B_hi and B_lo are read
//   by wgmma from shared memory through descriptors.  (A from shared memory,
//   unsplit, ran 5-20% faster on an H100: the price of A's split.)
// - Accumulation: the tensor cores do not round their accumulate to nearest
//   (see gemm_tf32.cuh), so each k8 step's three products go into a fresh
//   accumulator (scale-d = 0 on the first), added to the running sum by an
//   f32 add: the products and sums, in their order, of a 3xTF32 loop of
//   mma.sync m16n8k8 with a fresh sum a k-step (this route's earlier form),
//   whose bits the outputs keep (on an H100, at every layer-wise shape
//   probes/stack_forward.py times).  A fresh accumulator for a stage (32 k)
//   ran 8-19% faster and stayed within 0.25 of the forward's bar (1e-5 +
//   1e-5 |ref|; 0.41-0.44 for four stages, 1.4-4.1x beyond it for the whole k
//   at k = 765 to 2,048), but took a first-step gradient of chip_smoke.py's
//   constituents-mode training 1.2x past its bar against the CPU (3e-4 of
//   the leaf's largest value), which this order passes.
// - Staging: a ring of stages in shared memory with mbarriers.  A producer
//   warpgroup (40 registers a thread) fills them: B by one bulk copy
//   (cp.async.bulk), A by a TMA tensor-map copy (cp.async.bulk.tensor, 128
//   rows x 32 k, 128-byte swizzle, zero fill past the edges) where A's row
//   pitch and address are multiples of 16 bytes, else by 4-byte cp.async
//   into the same swizzled layout (a 765-wide input: 3,060-byte rows; the
//   copy loop strength-reduced to a pointer step, 0.63 -> 0.30 ms at 65,536 x
//   765 -> 256); the copies complete on the stage's full barrier.  Two
//   consumer warpgroups take 64 rows each of the CTA's 128, the same B.
//   Taking turns to start products (one warpgroup's queued behind the
//   other's) and a fresh accumulator every 2 stages with A's registers
//   double-buffered were no faster on an H100; the latter spills at 128
//   columns (ptxas holds the kernel to 168 registers a thread).
// - Epilogue: the tile goes through its own shared-memory buffer, then out
//   as whole rows with bias and ReLU, consecutive threads on consecutive
//   columns of one row, each head segment into its own output: coalesced for
//   any width and alignment.
// - Tiles and grid: 128 rows x BN columns (128 or 64) a tile, one CTA an SM
//   (3 stages of 48 KB or 4 of 32 KB, and the epilogue's buffer), persistent:
//   CTA c takes tiles c, c + gridDim.x, ..., and its producer runs on into
//   the next tile's stages while the consumers write one out.
//   ops/fused_vae.py::_forward_tile picks BN from the shape so that the last
//   round of tiles is least wasted.  The column tiles of a row tile are
//   adjacent in tile order, so a tile of A is read from HBM once and from L2
//   by the others.
// Each output is one sum in a fixed order: a second call gives the same bits.
//
// K3's layer-wise route (fused_vae_bwd.cu) runs its three products on the
// same mainloop (mma_stage: a fresh accumulator every k8 step), with the
// same split and staging:
// - the recompute a_l = relu(a_{l-1} W_l + b_l) is this row product itself
//   (bwd_rows_kernel, the kernel body of rows_wgmma_kernel), so that its
//   activations are K2's bits, except where the re-decision below changes
//   them;
// - the gradient one layer down, g W^T, is a row product too: W as it lies
//   is K-major for it, so the pre-pass only splits and swizzles it
//   (PrepLayer::trans, no transpose); its epilogue masks by the activation
//   it writes over (RowsArgs::mask: each element's mask read by the thread
//   that then writes it), and for the heads A spans their separate gradient
//   buffers as k segments (RowsArgs::aseg, copied by the 4-byte route: TMA
//   takes one tensor a copy; 0.41 ms at 1,000,003 rows on an H100, where a
//   concatenating copy in the wrapper would move 512 MB more and take an
//   extra launch);
// - the weight gradient dW = a^T g, db = sum g (bwd_dw_kernel, below): the
//   sum runs over the batch, and TF32 wgmma takes K-major operands only,
//   while a and g both lie batch-major.  Both are transposed on chip: A by
//   indexing (the consumers read a's stage, 32 batch rows x 128 features as
//   TMA lands it, into their fragments transposed), B by the producer
//   warpgroup, which copies g's stage by cp.async into a ring of its own,
//   splits it into hi/lo and writes it K-major and swizzled into the stage
//   wgmma reads, adding db from the same values.  A pre-pass writing K-major
//   copies was not built: it would read each gradient once more and write
//   it twice (hi and lo), about 5.7 GB at 1,000,003 rows of the
//   constituents-mode encoder, 1.7 ms at 3.35 TB/s by bytes alone, half the
//   whole backward's bound (3.5 ms); on an H100 the on-chip transpose's dW
//   launches took 4.98 of that call's 12.94 ms.
// - ReLU masks: 3xTF32 products sit about 2^-22 of sum |a_k w_k| from f32,
//   further than another f32 order, so a recompute on them alone decides
//   pre-activations near 0 the other way than the f32 plain version does
//   (on an H100 at 1,000,003 x 312->256/128/64: 16, 7 and 5 of layers 0-2),
//   and each such flip moves a weight gradient's column by one row's
//   contribution (at 10,000 rows several times its bar).  The recompute
//   (kTies) flags each z with z^2 < 2^-44 |a|^2 |w|^2: |z| under 2^-22 |a|
//   |w|, some 45 times the typical gap that those flip counts give (about
//   2^-27.5 |a| |w| at each layer; the split's worst case, 2^-21 sum
//   |a_k w_k|, is a bound no measured gap came near), for N(0, 1) data a
//   share of about 2e-7 sqrt(k) of the elements.  It re-decides a flagged z
//   at the end of its tile's epilogue (redecide_tile: the tile's flags in
//   lists, its 256 consumer threads on each in turn) by the f32 sum in k
//   order, one FMA chain from 0 and then the bias: the value, and so the
//   mask, of the f32 recompute this route had before, whose masks agreed
//   with the plain version's (cuBLAS in full f32) at every card check but
//   one tie at 2,048 wide.  Below the first layer the row's input is
//   rebuilt first, the same way from x through the layers below (up to
//   kMaxChain of them; deeper, from the stored activations kMaxChain layers
//   down), a thread an output, in a buffer of the CTA's: the stored input,
//   3xTF32 sums, parts from the plain version's by their rounding, and alone
//   left 5 and 6 flips in layers 1 and 2 at the shape above (0 and 0
//   rebuilt).  An f64 sum instead parted from the plain version's masks at
//   10,000 rows (const_1200).  |a|^2 comes from the A values the consumers
//   already hold, |w|^2 from the pre-pass.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "gemm_tf32.cuh"

namespace atlasvae {
namespace wg {

constexpr int kBM = 128;          // rows a CTA: two consumer warpgroups of 64
constexpr int kBK = 32;           // k a stage: one 128-byte swizzle row of f32
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kMaxSeg = 4;
constexpr int kMaxPrep = 8;       // layers a pre-pass launch splits
constexpr float kTieScale = 0x1p-44f;   // z^2 below this times |a|^2 |w|^2: re-decided
constexpr int kMaxChain = 16;     // layers below a recompute that a re-decision rebuilds
constexpr int kMaxFlags = 256;    // re-decisions a tile lists for its consumers together

struct RowsArgs {
  const float* a[kMaxSeg];      // A's k segments: segment s holds k in [kbeg[s], kbeg[s + 1]),
  int kbeg[kMaxSeg + 1];        // (rows, its width) row-major; one segment unless aseg says more
  int aseg;
  long long rows;
  int k;
  int n;                        // columns: the segments' widths summed
  int nseg;
  int nbeg[kMaxSeg + 1];        // segment s holds columns [nbeg[s], nbeg[s + 1])
  const float* bias[kMaxSeg];   // or null: no bias
  float* out[kMaxSeg];          // (rows, width of s) row-major
  int relu;
  int mask;                     // out = acc * (out > 0): the element's old value is its mask
  int tiles_n;
  int k_chunks;                 // stages of 32 k
  const float* wsplit;          // the pre-split W^T (split_weights_kernel)
  const float* w;               // ties only: W (k, n) row-major, one segment,
  const float* wnorm2;          // and its columns' squared norms;
  int chain_n;                  // the layers below, through which a re-decided row's
  const float* chain_x;         // input is rebuilt from chain_x (chain_dims[0] wide):
  int chain_dims[kMaxChain + 1];
  const float* chain_w[kMaxChain];
  const float* chain_b[kMaxChain];
  float* chain_buf;             // 2 x chain_width floats for each CTA
  int chain_width;
  int* redecided;               // or null: the count of re-decided elements is added here
};

// One layer of a pre-pass: its W segments and where its split B goes.  B is
// the product's (k x n) right operand: W itself (trans = 0: element (k, n)
// at w[s][k * width + n - nbeg[s]], segments along n), or W^T of a layer
// whose gradient goes one layer down (trans = 1: element (k, n) at
// w[s][n * width + k - nbeg[s]], segments along k, the heads' k spanning
// their weights).
struct PrepLayer {
  const float* w[kMaxSeg];
  int nbeg[kMaxSeg + 1];
  int nseg;
  int trans;
  int k;
  int n;
  int bn;                       // the layer's column tile
  int k_chunks;
  int n_pad;                    // columns rounded up to whole tiles
  int tile0;                    // its first 32 x 32 block in the launch
  float* dst;
  float* norm2;                 // or null: B's columns' squared norms (trans = 0)
};

struct PrepArgs {
  int n_layers;
  PrepLayer l[kMaxPrep];
};

// Floats of a layer's split W^T: hi and lo, n_pad x k_pad each.
inline long long split_floats(int k, int n, int bn) {
  return 2ll * ((n + bn - 1) / bn) * bn * ((k + kBK - 1) / kBK) * kBK;
}

// The 128-byte swizzle of a K-major tile of 32 f32 a row: the 16-byte group
// q / 4 of row r lies at group (q / 4) ^ (r % 8), as TMA writes it and
// wgmma's descriptor reads it (from a 1024-byte aligned base).
__host__ __device__ __forceinline__ int swizzle(int q, int r) {
  return ((((q >> 2) ^ (r & 7))) << 2) | (q & 3);
}

__device__ __forceinline__ int segment_of(const int* beg, int nseg, int i) {
  int s = 0;
  while (s + 1 < nseg && i >= beg[s + 1]) ++s;
  return s;
}

// B of each layer, split: block (column tile j, stage c) of a layer is
// 2 x bn x 32 floats, hi then lo, row n of the tile holding B[c * 32 .. + 31]
// [n] swizzled, zero past the edges.  A CTA transposes one 32 x 32 block
// through shared memory (for trans = 0; for trans = 1 it only reorders):
// read along the source's rows, written along k.  The blocks of stage 0
// also write their columns' squared norms where the layer asks for them.
__device__ __forceinline__ void split_weights_body(const PrepArgs& p) {
  __shared__ float t[32][33];
  __shared__ float sq[8][32];
  int li = 0;
  while (li + 1 < p.n_layers && (int)blockIdx.x >= p.l[li + 1].tile0) ++li;
  const PrepLayer& L = p.l[li];
  const int b = blockIdx.x - L.tile0;
  const int kc = b / (L.n_pad / 32), n0 = (b % (L.n_pad / 32)) * 32;
  const int lane = threadIdx.x % 32, wy = threadIdx.x / 32;
  if (!L.trans) {
    const int n = n0 + lane;
    const int s = segment_of(L.nbeg, L.nseg, n);
    const bool col_ok = n < L.n;
    const int width = L.nbeg[s + 1] - L.nbeg[s];
    const float* const src = L.w[s] + (n - L.nbeg[s]);
#pragma unroll
    for (int i = wy; i < 32; i += 8) {
      const int k = kc * 32 + i;
      t[i][lane] = col_ok && k < L.k ? src[(long long)k * width] : 0.f;
    }
    if (L.norm2 != nullptr && kc == 0) {
      float acc = 0.f;
      for (int k = wy; col_ok && k < L.k; k += 8) {
        const float v = src[(long long)k * width];
        acc = fmaf(v, v, acc);
      }
      sq[wy][lane] = acc;
    }
  } else {
    const int k = kc * 32 + lane;
    const int s = segment_of(L.nbeg, L.nseg, k);
    const bool k_ok = k < L.k;
    const int width = L.nbeg[s + 1] - L.nbeg[s];
    const float* const src = L.w[s] + (k - L.nbeg[s]);
#pragma unroll
    for (int i = wy; i < 32; i += 8) {
      const int n = n0 + i;
      t[lane][i] = k_ok && n < L.n ? src[(long long)n * width] : 0.f;
    }
  }
  __syncthreads();
  if (L.norm2 != nullptr && kc == 0 && wy == 0) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += sq[i][lane];
    L.norm2[n0 + lane] = acc;
  }
#pragma unroll
  for (int r = wy; r < 32; r += 8) {
    const int nn = n0 + r;
    const int j = nn / L.bn, rr = nn % L.bn;
    float* blk = L.dst + ((long long)j * L.k_chunks + kc) * (2 * L.bn * kBK);
    uint32_t hi, lo;
    tf32::split(t[lane][r], hi, lo);
    const int at = rr * kBK + swizzle(lane, rr);
    blk[at] = __uint_as_float(hi);
    blk[L.bn * kBK + at] = __uint_as_float(lo);
  }
}

// K1/K2's pre-pass, and K3's under its own name (profiles tell them apart).
__global__ void __launch_bounds__(256) split_weights_kernel(const __grid_constant__ PrepArgs p) {
  split_weights_body(p);
}
__global__ void __launch_bounds__(256) bwd_split_kernel(const __grid_constant__ PrepArgs p) {
  split_weights_body(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// Waits for the phase of the given parity to complete.  A wait of more than
// kWaitNs traps: a barrier that never completes (a fault in the protocol)
// ends the launch with an error instead of holding the card.
constexpr unsigned long long kWaitNs = 1ull << 33;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long start = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - start > kWaitNs) __trap();
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// arrives on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// Copy 16 bytes, or write zeros where !valid (src is then not read).
__device__ __forceinline__ void copy16(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The consumer warpgroups' own barrier (256 threads), for the epilogue.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// Whether any consumer thread's c holds (their barrier, with a reduction).
__device__ __forceinline__ bool consumers_any(bool c) {
  int any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 q, %1, 0;\nbar.red.or.pred p, 1, %2, q;\n"
      "selp.s32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"((int)c), "n"(kConsumers)
      : "memory");
  return any != 0;
}
// The producer warpgroup's own barrier (128 threads).
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// tf32::split by integer operations: hi = x rounded to TF32 (nearest, ties
// away from zero: half a TF32 ulp added to the bits, the 13 low bits
// cleared), lo = the rest so rounded; the same words as cvt.rna.tf32.f32
// for every finite x, on the integer pipe.  kSafe (K3's kernels): the
// magnitude is first held below 0x7FFFF000, where the add's carry would run
// into the sign and make the GPU's own NaN, 0x7FFFFFFF, a -0.0 (a NaN stays
// a NaN, or an inf where only its low payload bits were set; finite values
// and infs keep their words).  Without it a NaN of the caller's (K3: a head
// gradient's, or inf x 0 in a mask) vanished from a product where the
// plain version's f32 sum keeps it (a form that tested for inf and NaN
// instead cost K3 8-11% on an H100).  K1/K2 keep the two operations and
// their speed: their inputs are data, their own ReLU outputs (never a NaN)
// and, in training, the decoder's latent, where a NaN of the GPU's still
// vanishes (ROADMAP, Queue 3).
template <bool kSafe = false>
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  const uint32_t u = __float_as_uint(x);
  if constexpr (kSafe)
    return ((min(u & 0x7FFFFFFFu, 0x7FFFEFFFu) + 0x1000u) & 0x7FFFE000u) | (u & 0x80000000u);
  else
    return (u + 0x1000u) & 0xFFFFE000u;
}
template <bool kSafe = false>
__device__ __forceinline__ void split_rna(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32<kSafe>(x);
  lo = rna_tf32<kSafe>(x - __uint_as_float(hi));
}

// A's fragments of a stage's four k8 steps, split: (r0, q), (r0 + 8, q),
// (r0, q + 4), (r0 + 8, q + 4) for q = 8 kk + t; (r0 + 8) % 8 == r0 % 8 == gq.
// kNorm: ss[0] and ss[1] also take the squares of rows r0 and r0 + 8.
template <bool kNorm = false, bool kSafe = false>
__device__ __forceinline__ void load_fragments(const float* as, int r0, int gq, int t,
                                               uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                               float (&ss)[2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int q = 8 * kk + t;
    const float v[4] = {as[r0 * kBK + swizzle(q, gq)], as[(r0 + 8) * kBK + swizzle(q, gq)],
                        as[r0 * kBK + swizzle(q + 4, gq)], as[(r0 + 8) * kBK + swizzle(q + 4, gq)]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_rna<kSafe>(v[e], ah[kk][e], al[kk][e]);
      if constexpr (kNorm) ss[e & 1] = fmaf(v[e], v[e], ss[e & 1]);
    }
  }
}

// keeps the compiler from moving reads or writes of r across wgmma's
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= a b on an m64nNk8 tile: A (64 x 8) from registers, B (N x 8,
// K-major) through its descriptor; accumulate = 0 starts d afresh.
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  if constexpr (BN == 128) mma_n128(d, a, b, accumulate);
  else mma_n64(d, a, b, accumulate);
}

// The mainloop's step, one stage of 32 k on a warpgroup's m64 x BN tile:
// each k8 step's three products in a fresh accumulator, the small ones
// first, added to the running sum by an f32 add (see the note on
// accumulation above).  A k8 step is 32 bytes further along each row of the
// swizzled B tile.  Every kernel of this file multiplies through it.
template <int BN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], float (&part)[BN / 2],
                                          const uint32_t (&ah)[4][4], const uint32_t (&al)[4][4],
                                          uint64_t bh, uint64_t bl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(part[i]);
    wgmma_fence();
    mma<BN>(part, al[kk], bh + 2 * kk, 0);
    mma<BN>(part, ah[kk], bl + 2 * kk, 1);
    mma<BN>(part, ah[kk], bh + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(part[i]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
}

template <int BN>
struct Tile {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kBBytes = BN * kBK * 4;   // B_hi (or B_lo) of a stage
  static constexpr int kABytes = kBM * kBK * 4;
  static constexpr int kStageBytes = 2 * kBBytes + kABytes;
  static constexpr int kOutStride = BN + 8;      // the epilogue tile's row stride (floats)
  static constexpr int kOutBytes = kBM * kOutStride * 4;
  static constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + kOutBytes + 1024;
};

// acc + the f32 sum in k order of stage[0 .. kc) and w[0], w[stride], ...:
// one FMA chain, its loads kUnroll at a time ahead of it.
__device__ __forceinline__ float chain_from(float acc, const float* stage, const float* w,
                                           long long stride, int kc) {
  constexpr int kUnroll = 16;
  int i = 0;
  for (; i + kUnroll <= kc; i += kUnroll) {
    float wv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) wv[q] = __ldg(w + (i + q) * stride);
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) acc = fmaf(stage[i + q], wv[q], acc);
  }
  for (; i < kc; ++i) acc = fmaf(stage[i], __ldg(w + i * stride), acc);
  return acc;
}

// The recompute's re-decisions of one tile's listed flags (tile row << 16 |
// tile column), by its 256 consumer threads together (every one calls it;
// stage: 2 x kConsumers floats of shared memory): for each, the row's input
// rebuilt through the layers below in the CTA's buffer (a thread an output,
// its f32 sum in k order, the input staged kConsumers at a time), then the
// flagged pre-activation's f32 sum in k order (row and column staged, one
// thread's chain) and the bias, written over the element with the
// epilogue's ReLU.
__device__ __forceinline__ void redecide_tile(const RowsArgs& g, const int* flags, int count,
                                           long long m0, int n0, float* stage) {
  float* const buf = g.chain_buf + 2ll * g.chain_width * blockIdx.x;
  const int tid = threadIdx.x;
  for (int e = 0; e < count; ++e) {
    const long long m = m0 + (flags[e] >> 16);
    const int n = n0 + (flags[e] & 0xFFFF);
    const float* in = g.a[0] + m * g.k;
    if (g.chain_n > 0) {
      in = g.chain_x + m * g.chain_dims[0];
      for (int j = 0; j < g.chain_n; ++j) {
        float* const dst = buf + (j & 1) * g.chain_width;
        const int kin = g.chain_dims[j], kout = g.chain_dims[j + 1];
        for (int u0 = 0; u0 < kout; u0 += kConsumers) {
          const int u = u0 + tid;
          const bool live = u < kout;
          const float* const wc = g.chain_w[j] + (live ? u : 0);
          float acc = 0.f;
          for (int k0 = 0; k0 < kin; k0 += kConsumers) {
            const int kc = kin - k0 < kConsumers ? kin - k0 : kConsumers;
            consumers_sync();
            if (tid < kc) stage[tid] = in[k0 + tid];
            consumers_sync();
            if (live) acc = chain_from(acc, stage, wc + (long long)k0 * kout, kout, kc);
          }
          if (live) dst[u] = fmaxf(acc + __ldg(g.chain_b[j] + u), 0.f);
        }
        consumers_sync();
        in = dst;
      }
    }
    float dot = 0.f;
    for (int k0 = 0; k0 < g.k; k0 += kConsumers) {
      const int kc = g.k - k0 < kConsumers ? g.k - k0 : kConsumers;
      consumers_sync();
      if (tid < kc) {
        stage[tid] = in[k0 + tid];
        stage[kConsumers + tid] = __ldg(g.w + (long long)(k0 + tid) * g.n + n);
      }
      consumers_sync();
      if (tid == 0)
        for (int i = 0; i < kc; ++i) dot = fmaf(stage[i], stage[kConsumers + i], dot);
    }
    if (tid == 0) {
      float v = g.bias[0] != nullptr ? dot + __ldg(g.bias[0] + n) : dot;
      if (g.relu) v = fmaxf(v, 0.f);
      g.out[0][m * g.n + n] = v;
    }
    consumers_sync();   // the buffers are free for the next
  }
}

// The row product's body.  One CTA an SM walks the output tiles blockIdx.x,
// + gridDim.x, ...: the producer runs on into the next tile's stages while
// the consumers write this one out, so a tile costs no launch and no
// pipeline fill.  kTies: K3's recompute, its ReLU's near-ties re-decided;
// kBwd: one of K3's products (the split keeps a NaN, rna_tf32).
template <int BN, bool kTma, bool kTies, bool kBwd>
__device__ __forceinline__ void rows_body(const CUtensorMap& a_map, const RowsArgs& g) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* const tile_out = reinterpret_cast<float*>(smem + S * T::kStageBytes);
  __shared__ uint64_t full[S], empty[S];
  __shared__ float row_norm2[kTies ? kBM : 1];
  __shared__ int flags[kTies ? kMaxFlags : 1], n_flags;   // a tile's re-decisions, a list at a time
  const long long n_tiles = (g.rows + kBM - 1) / kBM * g.tiles_n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kTma ? 1 : 1 + 128);   // the bulk copies' arrival (+ each copier's)
      mbar_init(&empty[s], kConsumers / 32);     // a consumer warp's arrival each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x - kConsumers;
    if (kTma && pt != 0) return;
    // the copy route: thread pt copies k column q = pt % 32 of rows rb + 4 i,
    // whose swizzled places alternate between two offsets, 8 rows apart
    const int q = pt % 32, rb = pt / 32;
    const int d0 = rb * kBK + swizzle(q, rb), d1 = (rb + 4) * kBK + swizzle(q, rb + 4);
    int it = 0;   // stages filled so far, over all tiles
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long m0 = tile / g.tiles_n * kBM;
      const float* const bsrc = g.wsplit + tile % g.tiles_n * g.k_chunks * (2 * BN * kBK);
      const long long valid = g.rows - m0 < kBM ? g.rows - m0 : kBM;
      for (int c = 0; c < g.k_chunks; ++c, ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        uint8_t* const st = smem + s * T::kStageBytes;
        if (pt == 0) {
          mbar_expect_tx(&full[s], 2 * T::kBBytes + (kTma ? T::kABytes : 0));
          bulk_copy(st, bsrc + (long long)c * (2 * BN * kBK), 2 * T::kBBytes, &full[s]);
          if (kTma) tma_load_2d(st + 2 * T::kBBytes, &a_map, c * kBK, (int)m0, &full[s]);
        }
        if (!kTma) {
          // column c * 32 + q lies in one of A's k segments, of its own pitch
          float* const as = reinterpret_cast<float*>(st + 2 * T::kBBytes);
          const int kq = c * kBK + q;
          const int sa = segment_of(g.kbeg, g.aseg, kq);
          const int pitch = g.kbeg[sa + 1] - g.kbeg[sa];
          const bool k_ok = kq < g.k;
          const float* src = g.a[sa] + (m0 + rb) * pitch + (kq - g.kbeg[sa]);
          const long long step = 4ll * pitch;
#pragma unroll 8
          for (int i = 0; i < kBM / 4; ++i, src += step) {
            const bool ok = k_ok && rb + 4 * i < valid;
            tf32::copy4(as + (i & 1 ? d1 : d0) + (i / 2) * 8 * kBK, ok ? src : g.a[0], ok);
          }
          mbar_arrive_copies(&full[s]);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: warpgroup w takes rows 64 w .. 64 w + 63 of a
  // tile, its warp v rows 16 v ..; a thread rows r0 and r0 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16 + gq;
  int it = 0;   // stages taken so far, over all tiles
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc[BN / 2], part[BN / 2];
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int c = 0; c < g.k_chunks; ++c, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* const st = smem + s * T::kStageBytes;
      uint32_t ah[4][4], al[4][4];
      load_fragments<kTies, kBwd>(reinterpret_cast<const float*>(st + 2 * T::kBBytes), r0, gq, t,
                                  ah, al, ss);
      mma_stage<BN>(acc, part, ah, al, desc_sw128(st), desc_sw128(st + T::kBBytes));
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: the tile through shared memory (once every consumer is done
    // reading the last tile's), then out by rows
    const long long m0 = tile / g.tiles_n * kBM;
    const int n0 = (int)(tile % g.tiles_n) * BN;
    consumers_sync();
    if constexpr (kTies) {   // the rows' squared norms: a quad holds a row's k
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
      }
      if (t == 0) {
        row_norm2[r0] = ss[0];
        row_norm2[r0 + 8] = ss[1];
      }
    }
    // accumulator 4 j + e: row r0 (+ 8 for e >= 2), column 8 j + 2 t (+ 1 for odd e)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(tile_out + r0 * T::kOutStride + 8 * j + 2 * t) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile_out + (r0 + 8) * T::kOutStride + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    consumers_sync();
    // a warp's 32 lanes take 32 columns of one row at a time
    const int col = threadIdx.x % BN, n = n0 + col;
    const bool n_ok = n < g.n;
    const int s = segment_of(g.nbeg, g.nseg, n);
    const int width = g.nbeg[s + 1] - g.nbeg[s];
    const bool has_bias = g.bias[s] != nullptr;
    const float bias = n_ok && has_bias ? __ldg(g.bias[s] + (n - g.nbeg[s])) : 0.f;
    float* const out = g.out[s] + (n - g.nbeg[s]);
    if constexpr (kTies) {
      const float col_norm2 = n_ok ? __ldg(g.wnorm2 + n) : 0.f;
      uint64_t mine = 0;   // this thread's flagged rows: bit i for its i-th
      for (int r = threadIdx.x / BN; r < kBM; r += kConsumers / BN) {
        const long long m = m0 + r;
        if (m >= g.rows) break;   // the same r for every lane of a warp
        float v = tile_out[r * T::kOutStride + col];
        if (has_bias) v += bias;
        // flagged: bit i of this thread's mask, re-decided with the tile's
        // other flags below; meanwhile the 3xTF32 value stands
        if (n_ok && v * v < kTieScale * row_norm2[r] * col_norm2)
          mine |= 1ull << ((r - threadIdx.x / BN) / (kConsumers / BN));
        if (g.relu) v = fmaxf(v, 0.f);
        if (n_ok) out[m * width] = v;
      }
      // the flags in lists of up to kMaxFlags, each list by all 256 threads
      while (consumers_any(mine != 0)) {
        if (threadIdx.x == 0) n_flags = 0;
        consumers_sync();
        while (mine != 0) {
          const int i = __ffsll((long long)mine) - 1;
          const int at = atomicAdd(&n_flags, 1);
          if (at >= kMaxFlags) break;
          flags[at] = ((threadIdx.x / BN + i * (kConsumers / BN)) << 16) | col;
          mine &= mine - 1;
        }
        consumers_sync();
        const int listed = n_flags < kMaxFlags ? n_flags : kMaxFlags;
        if (threadIdx.x == 0 && g.redecided != nullptr) atomicAdd(g.redecided, listed);
        redecide_tile(g, flags, listed, m0, n0, tile_out);   // the tile is out: its buffer is free
      }
    } else {
      // rows in runs of kRun a thread, the masks of a run read before any
      // of its writes (each mask is the element it writes over)
      constexpr int kStep = kConsumers / BN, kRun = 16;
      for (int rb = threadIdx.x / BN; rb < kBM; rb += kRun * kStep) {
        float mk[kRun];
        if (g.mask && n_ok) {
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            const long long m = m0 + rb + i * kStep;
            mk[i] = rb + i * kStep < kBM && m < g.rows ? out[m * width] : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int r = rb + i * kStep;
          const long long m = m0 + r;
          if (r >= kBM || m >= g.rows) break;
          float v = tile_out[r * T::kOutStride + col];
          if (has_bias) v += bias;
          if (g.relu) v = fmaxf(v, 0.f);
          if (n_ok) {
            if (g.mask) v *= mk[i] > 0.f ? 1.f : 0.f;
            out[m * width] = v;
          }
        }
      }
    }
  }
}

template <int BN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    rows_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ RowsArgs g) {
  rows_body<BN, kTma, false, false>(a_map, g);
}

// K3's row products under their own name: the recompute (kTies) and the
// gradients one layer down.
template <int BN, bool kTma, bool kTies>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_rows_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ RowsArgs g) {
  rows_body<BN, kTma, kTies, true>(a_map, g);
}

// ---------------------------------------------------------------------------
// K3's weight gradient: dW_s (m x width of s) = a^T g_s and db_s = sum g_s
// over the batch, for up to kMaxSeg column segments (the heads together),
// the batch cut into splits of rows_per_split rows (a multiple of 32), each
// split's sums written to its own slice: slice p of segment s holds dW_s
// then db_s at part[s] + p * slice.  fused_vae_bwd.cu adds the slices in
// split order.
struct DwArgs {
  const float* a;               // (batch, m) row-major
  long long batch;
  int m;
  int n;                        // columns over all segments
  int nseg;
  int nbeg[kMaxSeg + 1];
  const float* g[kMaxSeg];      // (batch, width of s) row-major
  float* part[kMaxSeg];
  long long slice;
  long long rows_per_split;
  long long items;              // tiles_m x tiles_n x splits
  int tiles_m, tiles_n;
  int g_vec;                    // 16-byte copies of g: every width and pointer allows them
};

// A work item: one output tile (tm, tn) over one split of the batch.  Items
// of one split and column tile are adjacent, so a stage of g is read from
// HBM once and from L2 by the CTAs of the other row tiles.
struct DwItem {
  long long r0;                 // its first batch row
  long long split;
  int chunks;                   // its stages of 32 rows
  int m0, n0;
  bool first_m;                 // tm == 0: it writes db
};

__device__ __forceinline__ DwItem dw_item(const DwArgs& g, long long w) {
  DwItem it;
  const int tm = (int)(w % g.tiles_m);
  const long long rest = w / g.tiles_m;
  const int tn = (int)(rest % g.tiles_n);
  it.split = rest / g.tiles_n;
  it.r0 = it.split * g.rows_per_split;
  const long long r1 = it.r0 + g.rows_per_split < g.batch ? it.r0 + g.rows_per_split : g.batch;
  it.chunks = (int)((r1 - it.r0 + kBK - 1) / kBK);
  it.m0 = tm * kBM;
  it.n0 = tn;   // scaled by BN in the kernel
  it.first_m = tm == 0;
  return it;
}

// The feature (a's column, dW's row) of tile row rr % 32 inside its 32-wide
// box: chosen so that the eight rows gq of a warp's transposed fragment
// reads, at each of its four k columns t, fall on 32 different banks of the
// swizzled box (feature f at 16-byte group (f / 4) ^ (k % 8)).
__device__ __forceinline__ int dw_feature(int rr) {
  const int gq = rr & 7, h = (rr >> 3) & 1, w2 = (rr >> 4) & 1;
  return 16 * (gq >> 2) + (gq & 3) + 4 * (2 * w2 + h);
}

constexpr int kRawSlots = 3;      // g's stages in flight: two ahead of the one transposed

template <int BN>
struct DwTile {
  static constexpr int kStages = Tile<BN>::kStages;
  static constexpr int kRawBytes = kBK * BN * 4;   // a stage of g as it lies
  static constexpr size_t kSmemBytes =
      (size_t)kStages * Tile<BN>::kStageBytes + (size_t)kRawSlots * kRawBytes + 1024;
};

// One CTA an SM walks the work items blockIdx.x, + gridDim.x, ...  A stage
// holds A = a's 32 rows x 128 features as four 32 x 32 boxes (TMA, or
// 4-byte cp.async where a's pitch or address is not a multiple of 16
// bytes), B_hi and B_lo = g's 32 rows x BN columns split and K-major.  The
// producer warpgroup: its warp v owns rows 8 v .. 8 v + 7 of every stage of
// g, copies them by cp.async into a ring of kRawSlots slots two stages ahead,
// then splits and writes them into the stage (float4 stores along k, in the
// swizzle), and sums db over them; its four warps' sums are added in warp
// order at the end of an item.  The consumers read A transposed into their
// fragments and run mma_stage; a warpgroup whose 64 rows lie past m only
// keeps the ring turning.
template <int BN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dw_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ DwArgs g) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* const raw = reinterpret_cast<float*>(smem + S * T::kStageBytes);
  __shared__ uint64_t full[S], empty[S];
  __shared__ float db_part[4][BN];
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the A copies' arrival (TMA: the expecting thread's; else each copier's),
      // then each producer thread's, once its share of B is written
      mbar_init(&full[s], (kTma ? 1 : 128) + 128);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup
    const int pt = threadIdx.x - kConsumers, pw = pt / 32;
    // the stage being filled, and the one whose g is copied kRawSlots - 1 ahead
    long long w = blockIdx.x, wp = blockIdx.x;
    int c = 0, cp = 0;
    DwItem item = dw_item(g, w), ahead = item;
    auto copy_g = [&](int slot) {   // this warp's 8 rows of `ahead`'s stage cp, or nothing
      if (wp < g.items) {
        float* const dst = raw + slot * (kBK * BN) + 8 * pw * BN;
        const long long kb0 = ahead.r0 + (long long)cp * kBK + 8 * pw;
        const int n0 = ahead.n0 * BN;
        if (g.g_vec) {
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            const int e = lane + 32 * j, i = e / (BN / 4), c4 = 4 * (e % (BN / 4));
            const int col = n0 + c4, s = segment_of(g.nbeg, g.nseg, col);
            const bool ok = kb0 + i < g.batch && col < g.n;
            const float* src = g.g[s] + (kb0 + i) * (g.nbeg[s + 1] - g.nbeg[s]) + (col - g.nbeg[s]);
            copy16(dst + i * BN + c4, ok ? src : g.g[0], ok);
          }
        } else {
#pragma unroll 8
          for (int j = 0; j < BN / 4; ++j) {
            const int e = lane + 32 * j, i = e / BN, cl = e % BN;
            const int col = n0 + cl, s = segment_of(g.nbeg, g.nseg, col);
            const bool ok = kb0 + i < g.batch && col < g.n;
            const float* src = g.g[s] + (kb0 + i) * (g.nbeg[s + 1] - g.nbeg[s]) + (col - g.nbeg[s]);
            tf32::copy4(dst + i * BN + cl, ok ? src : g.g[0], ok);
          }
        }
        if (++cp == ahead.chunks) {
          cp = 0;
          wp += gridDim.x;
          if (wp < g.items) ahead = dw_item(g, wp);
        }
      }
      tf32::commit();
    };
    for (int i = 0; i < kRawSlots - 1; ++i) copy_g(i);
    float db[BN / 32];
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) db[j] = 0.f;
    for (int it = 0; w < g.items; ++it) {
      const int s = it % S;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      uint8_t* const st = smem + s * T::kStageBytes;
      float* const as = reinterpret_cast<float*>(st + 2 * T::kBBytes);
      const long long kb0 = item.r0 + (long long)c * kBK;
      if (kTma) {
        if (pt == 0) {
          mbar_expect_tx(&full[s], T::kABytes);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_load_2d(as + b * (kBK * 32), &a_map, item.m0 + 32 * b, (int)kb0, &full[s]);
        }
      } else {
        // thread pt copies feature pt of the stage's 32 rows
        const int f = item.m0 + pt;
        float* const dst = as + (pt / 32) * (kBK * 32);
        const float* src = g.a + kb0 * g.m + f;
#pragma unroll 8
        for (int r = 0; r < kBK; ++r, src += g.m) {
          const bool ok = f < g.m && kb0 + r < g.batch;
          tf32::copy4(dst + r * 32 + swizzle(pt % 32, r), ok ? src : g.a, ok);
        }
        mbar_arrive_copies(&full[s]);
      }
      copy_g((it + kRawSlots - 1) % kRawSlots);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRawSlots - 1) : "memory");
      __syncwarp();
      // this warp's 8 rows of g: column l + 32 j of each, split, into B's row
      // l + 32 j at k 8 pw .. 8 pw + 7 (two float4 of hi and two of lo)
      const float* const src = raw + (it % kRawSlots) * (kBK * BN) + 8 * pw * BN;
      float* const bh = reinterpret_cast<float*>(st);
      float* const bl = reinterpret_cast<float*>(st + T::kBBytes);
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int row = lane + 32 * j;
        uint32_t hi[8], lo[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = src[i * BN + row];
          db[j] += v;
          split_rna<true>(v, hi[i], lo[i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = row * kBK + swizzle(8 * pw + 4 * h, row);
          *reinterpret_cast<uint4*>(bh + at) =
              make_uint4(hi[4 * h], hi[4 * h + 1], hi[4 * h + 2], hi[4 * h + 3]);
          *reinterpret_cast<uint4*>(bl + at) =
              make_uint4(lo[4 * h], lo[4 * h + 1], lo[4 * h + 2], lo[4 * h + 3]);
        }
      }
      fence_async_smem();
      mbar_arrive(&full[s]);
      __syncwarp();
      if (++c == item.chunks) {
        if (item.first_m) {   // db of this split: the four warps' sums in warp order
          producers_sync();
#pragma unroll
          for (int j = 0; j < BN / 32; ++j) db_part[pw][lane + 32 * j] = db[j];
          producers_sync();
          const int col = item.n0 * BN + pt;
          if (pt < BN && col < g.n) {
            const int sg = segment_of(g.nbeg, g.nseg, col);
            const int width = g.nbeg[sg + 1] - g.nbeg[sg];
            g.part[sg][item.split * g.slice + (long long)g.m * width + (col - g.nbeg[sg])] =
                ((db_part[0][pt] + db_part[1][pt]) + db_part[2][pt]) + db_part[3][pt];
          }
        }
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) db[j] = 0.f;
        c = 0;
        w += gridDim.x;
        if (w < g.items) item = dw_item(g, w);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // the consumer warpgroups: warpgroup wg takes tile rows 64 wg .., a thread
  // rows r0 and r0 + 8, which are features f0 and f1 of box r0 / 32; its
  // fragment (row, k column t + 4 u) of k8 step kk lies at off[h][u] + 256 kk
  const int gq = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16 + gq;
  const int box = r0 / 32, f0 = dw_feature(r0 % 32), f1 = dw_feature(r0 % 32 + 8);
  int off[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    off[0][u] = box * (kBK * 32) + (t + 4 * u) * 32 + swizzle(f0, t + 4 * u);
    off[1][u] = box * (kBK * 32) + (t + 4 * u) * 32 + swizzle(f1, t + 4 * u);
  }
  int it = 0;
  for (long long w = blockIdx.x; w < g.items; w += gridDim.x) {
    const DwItem item = dw_item(g, w);
    const bool idle = item.m0 + 64 * (threadIdx.x / 128) >= g.m;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int c = 0; c < item.chunks; ++c, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* const st = smem + s * T::kStageBytes;
      if (!idle) {
        const float* const as = reinterpret_cast<const float*>(st + 2 * T::kBBytes);
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          split_rna<true>(as[off[0][0] + 256 * kk], ah[kk][0], al[kk][0]);
          split_rna<true>(as[off[1][0] + 256 * kk], ah[kk][1], al[kk][1]);
          split_rna<true>(as[off[0][1] + 256 * kk], ah[kk][2], al[kk][2]);
          split_rna<true>(as[off[1][1] + 256 * kk], ah[kk][3], al[kk][3]);
        }
        mma_stage<BN>(acc, part, ah, al, desc_sw128(st), desc_sw128(st + T::kBBytes));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (idle) continue;
    // accumulator 4 j + e: feature f0 (f1 for e >= 2), column 8 j + 2 t (+ 1 for odd e)
    const long long fr[2] = {item.m0 + 32 * box + f0, item.m0 + 32 * box + f1};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long f = fr[e >> 1];
        const int col = item.n0 * BN + 8 * j + 2 * t + (e & 1);
        if (f < g.m && col < g.n) {
          const int sg = segment_of(g.nbeg, g.nseg, col);
          const int width = g.nbeg[sg + 1] - g.nbeg[sg];
          g.part[sg][item.split * g.slice + f * width + (col - g.nbeg[sg])] = acc[4 * j + e];
        }
      }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Host helpers that keep state are static: each library that includes this
// header (K1's, K2's and K3's, loaded side by side) keeps its own, where a
// static local of an inline function is one symbol merged across the
// libraries.
//
// A 2-D tensor map of a (outer, inner) row-major f32 array: boxes of
// box_outer x box_inner in the 128-byte swizzle, zeros past the edges.
// cuTensorMapEncodeTiled is reached through the CUDA runtime's entry-point
// query, so that the library links no -lcuda.
static cudaError_t encode_2d(CUtensorMap* map, const float* a, long long outer, int inner,
                             int box_outer, int box_inner) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A kernel's shared-memory allowance, set once a device, and the device's
// SMs (the persistent grid), read once.
constexpr int kMaxDevices = 64;
template <auto Kernel, size_t Bytes>
static cudaError_t prepare(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < kMaxDevices && done[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Bytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}
static cudaError_t device_sms(int device, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  if (device < kMaxDevices && (*sms = known[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) known[device] = *sms;
  return err;
}

// One persistent launch of Kernel over `work` items: a CTA an SM at most.
template <auto Kernel, size_t Bytes, typename Args>
inline cudaError_t launch_persistent(const CUtensorMap& map, const Args& g, long long work,
                                     cudaStream_t st) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = prepare<Kernel, Bytes>(device);
  if (err == cudaSuccess) err = device_sms(device, &sms);
  if (err != cudaSuccess) return err;
  const unsigned ctas = (unsigned)(work < sms ? work : sms);
  void* args[] = {const_cast<CUtensorMap*>(&map), const_cast<Args*>(&g)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(Kernel), dim3(ctas), dim3(kThreads), args,
                         Bytes, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// kKind 0: K1/K2's row product; 1: K3's gradient one layer down; 2: K3's recompute.
template <int BN, bool kTma, int kKind>
inline cudaError_t launch_rows_t(const CUtensorMap& map, const RowsArgs& g, cudaStream_t st) {
  const long long tiles = ((g.rows + kBM - 1) / kBM) * g.tiles_n;
  constexpr size_t bytes = Tile<BN>::kSmemBytes;
  if constexpr (kKind == 0) return launch_persistent<rows_wgmma_kernel<BN, kTma>, bytes>(map, g, tiles, st);
  else return launch_persistent<bwd_rows_kernel<BN, kTma, kKind == 2>, bytes>(map, g, tiles, st);
}

template <int kKind>
inline cudaError_t launch_rows_kind(int bn, RowsArgs g, cudaStream_t st) {
  if (g.rows <= 0) return cudaSuccess;
  if (g.aseg == 0) {   // one segment: A itself
    g.aseg = 1;
    g.kbeg[1] = g.k;
  }
  if (g.nseg < 1 || g.nseg > kMaxSeg || g.aseg > kMaxSeg || g.kbeg[g.aseg] != g.k || g.k < 1 ||
      g.n < 1 || (bn != 128 && bn != 64) ||
      (kKind == 2 && (g.aseg != 1 || g.nseg != 1 || g.w == nullptr || g.wnorm2 == nullptr ||
                      g.chain_n < 0 || g.chain_n > kMaxChain ||
                      (g.chain_n > 0 && (g.chain_buf == nullptr || g.chain_x == nullptr)))))
    return cudaErrorInvalidValue;
  g.tiles_n = (g.n + bn - 1) / bn;
  g.k_chunks = (g.k + kBK - 1) / kBK;
  CUtensorMap map = {};
  const bool tma = g.aseg == 1 && g.k % 4 == 0 && aligned16(g.a[0]);
  if (tma) {
    const cudaError_t err = encode_2d(&map, g.a[0], g.rows, g.k, kBM, kBK);
    if (err != cudaSuccess) return err;
  }
  if (bn == 128)
    return tma ? launch_rows_t<128, true, kKind>(map, g, st) : launch_rows_t<128, false, kKind>(map, g, st);
  return tma ? launch_rows_t<64, true, kKind>(map, g, st) : launch_rows_t<64, false, kKind>(map, g, st);
}

// Launches one row product with a column tile of bn (128 or 64) columns on
// the split W^T at g.wsplit (split_weights_kernel, the same bn).
inline cudaError_t launch_rows(int bn, RowsArgs g, cudaStream_t st) {
  return launch_rows_kind<0>(bn, g, st);
}

// K3's: the recompute with its ties re-decided (ties), or a plain row
// product (the recompute without re-decision, the gradients one layer down).
inline cudaError_t launch_bwd_rows(int bn, const RowsArgs& g, bool ties, cudaStream_t st) {
  return ties ? launch_rows_kind<2>(bn, g, st) : launch_rows_kind<1>(bn, g, st);
}

template <int BN, bool kTma>
inline cudaError_t launch_dw_t(const CUtensorMap& map, const DwArgs& g, cudaStream_t st) {
  return launch_persistent<bwd_dw_kernel<BN, kTma>, DwTile<BN>::kSmemBytes>(map, g, g.items, st);
}

// Launches one weight gradient with a column tile of bn (128 or 64) columns,
// in `splits` splits of g.rows_per_split rows.
inline cudaError_t launch_dw(int bn, DwArgs g, long long splits, cudaStream_t st) {
  if (g.batch <= 0) return cudaSuccess;
  if (g.nseg < 1 || g.nseg > kMaxSeg || g.nbeg[g.nseg] != g.n || g.m < 1 || g.n < 1 ||
      (bn != 128 && bn != 64) || g.rows_per_split < 1 || g.rows_per_split % kBK != 0 ||
      splits < 1 || splits * g.rows_per_split < g.batch ||
      (splits - 1) * g.rows_per_split >= g.batch)
    return cudaErrorInvalidValue;
  g.tiles_m = (g.m + kBM - 1) / kBM;
  g.tiles_n = (g.n + bn - 1) / bn;
  g.items = (long long)g.tiles_m * g.tiles_n * splits;
  bool vec = true;
  for (int s = 0; s < g.nseg; ++s)
    vec = vec && aligned16(g.g[s]) && g.nbeg[s] % 4 == 0 && g.nbeg[s + 1] % 4 == 0;
  g.g_vec = vec;
  CUtensorMap map = {};
  const bool tma = g.m % 4 == 0 && aligned16(g.a);
  if (tma) {
    const cudaError_t err = encode_2d(&map, g.a, g.batch, g.m, kBK, 32);
    if (err != cudaSuccess) return err;
  }
  if (bn == 128) return tma ? launch_dw_t<128, true>(map, g, st) : launch_dw_t<128, false>(map, g, st);
  return tma ? launch_dw_t<64, true>(map, g, st) : launch_dw_t<64, false>(map, g, st);
}

// Splits up to kMaxPrep layers' B in one launch: K1/K2's kernel, or (bwd)
// K3's under its own name.
inline cudaError_t launch_split(PrepArgs p, cudaStream_t st, bool bwd = false) {
  if (p.n_layers < 1 || p.n_layers > kMaxPrep) return cudaErrorInvalidValue;
  int blocks = 0;
  for (int i = 0; i < p.n_layers; ++i) {
    p.l[i].tile0 = blocks;
    blocks += p.l[i].k_chunks * (p.l[i].n_pad / 32);
  }
  if (bwd) bwd_split_kernel<<<blocks, 256, 0, st>>>(p);
  else split_weights_kernel<<<blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace atlasvae
