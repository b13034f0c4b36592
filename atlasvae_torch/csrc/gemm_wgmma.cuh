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

struct RowsArgs {
  const float* a;               // (rows, k) row-major
  long long rows;
  int k;
  int n;                        // columns: the segments' widths summed
  int nseg;
  int nbeg[kMaxSeg + 1];        // segment s holds columns [nbeg[s], nbeg[s + 1])
  const float* bias[kMaxSeg];
  float* out[kMaxSeg];          // (rows, width of s) row-major
  int relu;
  int tiles_n;
  int k_chunks;                 // stages of 32 k
  const float* wsplit;          // the pre-split W^T (split_weights_kernel)
};

// One layer of a pre-pass: its W segments, as RowsArgs has them, and where
// its split W^T goes.
struct PrepLayer {
  const float* w[kMaxSeg];      // (k, width of s) row-major
  int nbeg[kMaxSeg + 1];
  int nseg;
  int k;
  int bn;                       // the layer's column tile
  int k_chunks;
  int n_pad;                    // columns rounded up to whole tiles
  int tile0;                    // its first 32 x 32 block in the launch
  float* dst;
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

// W^T of each layer, split: block (column tile j, stage c) of a layer is
// 2 x bn x 32 floats, hi then lo, row n of the tile holding W[c * 32 .. + 31]
// [n] swizzled, zero past the edges.  A CTA transposes one 32 x 32 block
// through shared memory: read along n, written along k.
__global__ void __launch_bounds__(256) split_weights_kernel(const __grid_constant__ PrepArgs p) {
  __shared__ float t[32][33];
  int li = 0;
  while (li + 1 < p.n_layers && (int)blockIdx.x >= p.l[li + 1].tile0) ++li;
  const PrepLayer& L = p.l[li];
  const int b = blockIdx.x - L.tile0;
  const int kc = b / (L.n_pad / 32), n0 = (b % (L.n_pad / 32)) * 32;
  const int lane = threadIdx.x % 32, wy = threadIdx.x / 32;
  const int n = n0 + lane;
  int s = 0;
  while (s + 1 < L.nseg && n >= L.nbeg[s + 1]) ++s;
  const bool col_ok = n < L.nbeg[L.nseg];
  const int width = L.nbeg[s + 1] - L.nbeg[s];
#pragma unroll
  for (int i = wy; i < 32; i += 8) {
    const int k = kc * 32 + i;
    t[i][lane] = col_ok && k < L.k ? L.w[s][(long long)k * width + (n - L.nbeg[s])] : 0.f;
  }
  __syncthreads();
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

// tf32::split by integer operations: hi = x rounded to TF32 (nearest, ties
// away from zero: half a TF32 ulp added to the bits, the 13 low bits
// cleared), lo = the rest so rounded; the same words as cvt.rna.tf32.f32
// for every finite x, on the integer pipe.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_rna(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// A's fragments of a stage's four k8 steps, split: (r0, q), (r0 + 8, q),
// (r0, q + 4), (r0 + 8, q + 4) for q = 8 kk + t; (r0 + 8) % 8 == r0 % 8 == gq
__device__ __forceinline__ void load_fragments(const float* as, int r0, int gq, int t,
                                               uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int q = 8 * kk + t;
    split_rna(as[r0 * kBK + swizzle(q, gq)], ah[kk][0], al[kk][0]);
    split_rna(as[(r0 + 8) * kBK + swizzle(q, gq)], ah[kk][1], al[kk][1]);
    split_rna(as[r0 * kBK + swizzle(q + 4, gq)], ah[kk][2], al[kk][2]);
    split_rna(as[(r0 + 8) * kBK + swizzle(q + 4, gq)], ah[kk][3], al[kk][3]);
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

// One CTA an SM walks the output tiles blockIdx.x, + gridDim.x, ...: the
// producer runs on into the next tile's stages while the consumers write
// this one out, so a tile costs no launch and no pipeline fill.
template <int BN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    rows_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ RowsArgs g) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* const tile_out = reinterpret_cast<float*>(smem + S * T::kStageBytes);
  __shared__ uint64_t full[S], empty[S];
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
    const long long step = 4ll * g.k;
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
          float* const as = reinterpret_cast<float*>(st + 2 * T::kBBytes);
          const bool k_ok = c * kBK + q < g.k;
          const float* src = g.a + (m0 + rb) * g.k + c * kBK + q;
#pragma unroll 8
          for (int i = 0; i < kBM / 4; ++i, src += step) {
            const bool ok = k_ok && rb + 4 * i < valid;
            tf32::copy4(as + (i & 1 ? d1 : d0) + (i / 2) * 8 * kBK, ok ? src : g.a, ok);
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
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int c = 0; c < g.k_chunks; ++c, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* const st = smem + s * T::kStageBytes;
      uint32_t ah[4][4], al[4][4];
      load_fragments(reinterpret_cast<const float*>(st + 2 * T::kBBytes), r0, gq, t, ah, al);
      const uint64_t bh = desc_sw128(st), bl = desc_sw128(st + T::kBBytes);
      // each k8 step's three products in a fresh accumulator, the small ones
      // first, added to the running sum by an f32 add (see the note on
      // accumulation above).  A k8 step is 32 bytes further along each row
      // of the swizzled tile.
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
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: the tile through shared memory (once every consumer is done
    // reading the last tile's), then out by rows
    const long long m0 = tile / g.tiles_n * kBM;
    const int n0 = (int)(tile % g.tiles_n) * BN;
    consumers_sync();
    // accumulator 4 j + e: row r0 (+ 8 for e >= 2), column 8 j + 2 t (+ 1 for odd e)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(tile_out + r0 * T::kOutStride + 8 * j + 2 * t) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile_out + (r0 + 8) * T::kOutStride + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    consumers_sync();
    const int col = threadIdx.x % BN, n = n0 + col;
    if (n < g.n) {
      int s = 0;
      while (s + 1 < g.nseg && n >= g.nbeg[s + 1]) ++s;
      const int width = g.nbeg[s + 1] - g.nbeg[s];
      const float bias = __ldg(g.bias[s] + (n - g.nbeg[s]));
      float* const out = g.out[s] + (n - g.nbeg[s]);
      for (int r = threadIdx.x / BN; r < kBM; r += kConsumers / BN) {
        const long long m = m0 + r;
        if (m >= g.rows) break;
        float v = tile_out[r * T::kOutStride + col] + bias;
        if (g.relu) v = fmaxf(v, 0.f);
        out[m * width] = v;
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Host helpers that keep state are static: each library that includes this
// header (K1's and K2's, loaded side by side) keeps its own, where a static
// local of an inline function is one symbol merged across the libraries.
//
// A's tensor map: (rows, k) f32, boxes of 128 rows x 32 k in the 128-byte
// swizzle, zeros past the edges.  cuTensorMapEncodeTiled is reached through
// the CUDA runtime's entry-point query, so that the library links no -lcuda.
static cudaError_t encode_a(CUtensorMap* map, const float* a, long long rows, int k) {
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
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(float)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel's shared-memory allowance, set once a device, and the device's
// SMs (the persistent grid), read once.
constexpr int kMaxDevices = 64;
template <int BN, bool kTma>
static cudaError_t prepare(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < kMaxDevices && done[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(rows_wgmma_kernel<BN, kTma>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Tile<BN>::kSmemBytes);
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

template <int BN, bool kTma>
inline cudaError_t launch_t(const CUtensorMap& map, const RowsArgs& g, cudaStream_t st) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = prepare<BN, kTma>(device);
  if (err == cudaSuccess) err = device_sms(device, &sms);
  if (err != cudaSuccess) return err;
  const long long tiles = ((g.rows + kBM - 1) / kBM) * g.tiles_n;
  const unsigned ctas = (unsigned)(tiles < sms ? tiles : sms);
  rows_wgmma_kernel<BN, kTma><<<ctas, kThreads, Tile<BN>::kSmemBytes, st>>>(map, g);
  return cudaGetLastError();
}

// Launches one row product with a column tile of bn (128 or 64) columns on
// the split W^T at g.wsplit (split_weights_kernel, the same bn).
inline cudaError_t launch_rows(int bn, RowsArgs g, cudaStream_t st) {
  if (g.rows <= 0) return cudaSuccess;
  if (g.nseg < 1 || g.nseg > kMaxSeg || g.k < 1 || g.n < 1 || (bn != 128 && bn != 64))
    return cudaErrorInvalidValue;
  g.tiles_n = (g.n + bn - 1) / bn;
  g.k_chunks = (g.k + kBK - 1) / kBK;
  CUtensorMap map = {};
  const bool tma = g.k % 4 == 0 && aligned16(g.a);
  if (tma) {
    const cudaError_t err = encode_a(&map, g.a, g.rows, g.k);
    if (err != cudaSuccess) return err;
  }
  if (bn == 128) return tma ? launch_t<128, true>(map, g, st) : launch_t<128, false>(map, g, st);
  return tma ? launch_t<64, true>(map, g, st) : launch_t<64, false>(map, g, st);
}

// Splits up to kMaxPrep layers' W^T in one launch.
inline cudaError_t launch_split(PrepArgs p, cudaStream_t st) {
  if (p.n_layers < 1 || p.n_layers > kMaxPrep) return cudaErrorInvalidValue;
  int blocks = 0;
  for (int i = 0; i < p.n_layers; ++i) {
    p.l[i].tile0 = blocks;
    blocks += p.l[i].k_chunks * (p.l[i].n_pad / 32);
  }
  split_weights_kernel<<<blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace atlasvae
