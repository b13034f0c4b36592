// K6: backward of K5, the weight and bias gradients of
//   out = relu(maxpool_SAME(conv2d_VALID(x, w)) + b)
// for the gradient g of out.  The input gets none: this block reads data.
//
// Replaces atlasvae/ops/fused_conv.py:130 _bwd_kernel (Pallas, TPU).  That
// kernel summed dW/db into output blocks revisited by a grid that runs in
// order on one core.  Here CTAs run in parallel and in no order, so, as in
// fused_vae_bwd.cu:
//   * the grid is a function of the shape and a constant, not of the card's
//     SM count; each CTA sums its share of the pixels into its own slice of
//     a scratch buffer, each element by one thread (no float atomics);
//   * conv_reduce_partials adds the slices in a fixed order.
// So the result is the same bits on every call and every card.
//
// Every route recomputes each pooled pixel's window with K5's own arithmetic
// (in float, and in the bf16 band route: K5's chain of FMAs), keeps the
// first position that reaches the largest value (rows, then columns: XLA's
// select-and-scatter order), masks g by zmax + b > 0 and adds g times that
// position's input patch to dW and g to db.  A NaN carries as in the plain
// version: a NaN conv output is its window's value and its mask is off; an
// input that is not finite gives the taps it meets at the window's other
// positions the NaN of the plain version's dense product (nonfinite_taps;
// the bf16 register route's product is dense already).  Two routes, chosen
// from the shape by ops/fused_conv_cuda.py `route`, as K5's are:
//
// * The register route (conv_pool_relu_bwd_tiles_kernel in float; its bf16
//   form below): 3x3 taps, one channel, a 2x2 pool and at most 128 maps,
//   the jet-ID CNN's first block.
//   A thread owns four maps, as in K5's register route: their taps and bias
//   in registers, loaded once, and their 36 dW and 4 db sums in registers
//   over a fixed run of pooled pixels.  A pixel costs one 4x4 patch (8-byte
//   loads where W is even) and one 16-byte load of g (where M % 4 == 0).
//   The routed position is known only at run time and differs between the
//   four maps, so the 3x3 sub-patch is picked with selects (a row, then a
//   column), never by a run-time index into the patch, which would put it
//   in local memory.  The CTA adds its threads' sums over the pixel slots
//   in shared memory, in slot order, into its slice.
// * The band route (conv_pool_relu_bwd_kernel), every other shape the gate
//   takes: per work item (a few images by a band of pooled rows,
//   fused_conv.cuh) and tile of maps, (1) a thread per (pooled pixel, map)
//   recomputes the window from rows and weights in shared memory and leaves
//   the routed gradient and the offset of its patch in shared memory; (2) a
//   thread per (tap, map) walks the item's pixels in order and sums
//   patch[tap] * gradient, a thread per map the gradient for db.  Step 2
//   spends three shared-memory loads on an FMA.
//
// Bound on an H100 at the jet-ID training batch (5,000 x 16x16x1, 3x3, 100
// maps, pool 2x2), float: x 5.1 MB and g 98 MB read, 4 KB written: 0.031 ms
// at 3.35 TB/s; 1.91 GFLOP to recompute and pool the conv, 0.47 GFLOP for
// dW and db: 0.0355 ms at 67 TFLOP/s of f32.  Operations bound it, not g's
// read.
//
// bf16 (the _bf16 entry points; x, w, b and g all bf16).  The band route
// widens each bf16 value to float where it loads it, g too, and runs as in
// float.  The register route's bf16 form is a kernel of its own,
// conv_pool_relu_bwd_tc_kernel, for the tensor cores (fused_conv.cuh, tc_*).
// What bounds it: g's read (49 MB: 0.0154 ms at 3.35 TB/s) at the jet-ID
// batch; its 2.4 GFLOP of products would take 0.036 ms on the f32 CUDA
// cores and take 3 us on the bf16 tensor cores.  The design: the recompute
// is K5's (the same fragments, the same mma, so the argmax and the ReLU mask
// see the bits K5 pooled); dW^T and db come from a second mma whose A
// operand is built in registers from the first one's accumulators (g at the
// routed position, 0 elsewhere: exact in bf16) and whose B operand is the
// routed patches, with a column of ones for db; g comes into shared memory
// by cp.async a chunk ahead, x through L1 as in K5; the mma's f32 sums,
// which do not round to nearest, are folded into f32 sums in shared memory
// every kTcFold chunks, so their error does not grow with the batch.  What
// holds it now: the routing (argmax, mask,
// packing) and the operands' shared-memory loads, at 128 registers a thread
// (the 64 f32 dW/db accumulators), so two CTAs an SM, 4 warps a scheduler
// to hide the mma and load latencies: about four times the byte bound
// (PERF.md §6).  In every form the partial slices hold floats, and
// conv_reduce_partials rounds each finished dW and db element once to the
// dtype of w and b, as the Pallas kernel's wrapper casts its float sums
// back.
#include <cstdint>

#include "fused_conv.cuh"

namespace atlasvae {

constexpr int kMaxParts = 264;  // the band route's partial slices at most
constexpr long long kMaxScratch = 1LL << 25;  // floats of scratch (128 MB) at most

// The plain version's weight gradient is a dense product: every conv pixel
// of a window adds x times its gradient, 0 at all but the routed one, so an
// input that is not finite (NaN, or inf: inf x 0) makes the taps it meets at
// the window's other positions NaN; the routes add g times the routed patch
// only.  Where a window's sum of conv outputs is not finite (rare: it is
// finite wherever its inputs are, but for an overflow, where this finds
// nothing), this writes NaN into the map's column of the CTA's slice
// (part_m[k M], tap k) for each such tap: NaN absorbs every later sum, so
// the order of these stores does not matter.
__device__ __noinline__ void nonfinite_taps(const ConvShape& s, const float* xs_img, int ylo,
                                            int oy, int ox, int by, int bx, float* part_m) {
  for (int t = 0; t < s.ph; ++t) {
    const int y = oy * s.ph + t - s.plh;
    if (y < 0 || y >= s.Hc) continue;
    for (int q = 0; q < s.pw; ++q) {
      const int x0 = ox * s.pw + q - s.plw;
      if (x0 < 0 || x0 >= s.Wc || (y == by && x0 == bx)) continue;
      for (int k = 0; k < s.K; ++k) {
        const float v = xs_img[(y - ylo + k / s.kwC) * s.WC + x0 * s.C + k % s.kwC];
        if (!(fabsf(v) < INFINITY)) part_m[(size_t)k * s.M] = __uint_as_float(0x7FFFFFFFu);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv_pool_relu_bwd_kernel(const __grid_constant__ ConvArgs<T> a) {
  extern __shared__ float smem[];
  const ConvShape& s = a.s;
  const ConvPlan& p = a.p;
  float* const ws = smem;
  float* const xs = ws + (size_t)s.K * p.mt;
  float* const gz = xs + (size_t)p.nb * p.rows_in * s.WC;
  int* const patch = reinterpret_cast<int*>(gz + (size_t)p.nb * p.rb * s.Wo * p.mt);
  const int img_stride = p.rows_in * s.WC;
  const int n_params = s.K * s.M + s.M;
  float* const part = a.partial + (size_t)blockIdx.x * n_params;
  bool weights_staged = false;

  for (int i = threadIdx.x; i < n_params; i += kConvThreads) part[i] = 0.f;

  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
    const ConvItem it = conv_item(s, p, item);
    __syncthreads();  // the previous item is done with xs, gz and patch
    conv_stage_rows(a, it, xs);
    for (int tile = 0; tile < p.n_mtiles; ++tile) {
      const int m0 = tile * p.mt;
      const int mcur = min(p.mt, s.M - m0);
      if (p.n_mtiles > 1 || !weights_staged) {
        __syncthreads();  // the previous tile is done with ws, gz and patch
        conv_stage_weights(a, m0, mcur, ws);
        weights_staged = true;
      }
      __syncthreads();

      const int total = it.npix * mcur;
      for (int o = threadIdx.x; o < total; o += kConvThreads) {
        const int m = o % mcur;
        const int pix = o / mcur;
        int img, oy, ox, by, bx;
        float total;
        conv_pixel_of(s, it, pix, &img, &oy, &ox);
        const float* const xs_img = xs + (size_t)img * img_stride;
        const float zmax = conv_pool_pixel(s, xs_img, it.ylo, oy, ox, ws + m, p.mt, &by, &bx,
                                           &total);
        float gr = 0.f;
        if (by >= 0 && zmax + load_widened(a.b + m0 + m) > 0.f)
          gr = load_widened(a.g + (((size_t)(it.n0 + img) * s.Ho + oy) * s.Wo + ox) * s.M + m0 +
                            m);
        gz[pix * p.mt + m] = gr;
        // a masked pixel points at its routed patch too: 0 times its inputs
        patch[pix * p.mt + m] = by >= 0 ? img * img_stride + (by - it.ylo) * s.WC + bx * s.C : 0;
        if (!(fabsf(total) < INFINITY))
          nonfinite_taps(s, xs_img, it.ylo, oy, ox, by, bx, part + m0 + m);
      }
      __syncthreads();

      for (int q = threadIdx.x; q < (s.K + 1) * mcur; q += kConvThreads) {
        const int k = q / mcur;
        const int m = q - k * mcur;
        const float* gm = gz + m;
        float acc = 0.f;
        if (k < s.K) {
          const int* pm = patch + m;
          const float* xk = xs + (k / s.kwC) * s.WC + k % s.kwC;  // tap (dy, dx, c)
          for (int pix = 0; pix < it.npix; ++pix)
            acc = fmaf(xk[pm[pix * p.mt]], gm[pix * p.mt], acc);
        } else {
          for (int pix = 0; pix < it.npix; ++pix) acc += gm[pix * p.mt];
        }
        part[(size_t)k * s.M + m0 + m] += acc;   // k == K: the db row
      }
    }
  }
}

// The register route.  blockDim (map groups, pixel slots), as K5's
// conv_pool_relu_tiles_kernel: thread (mg, slot) of CTA c takes maps
// 4 mg .. 4 mg + 3 of pooled pixels c * slots * per_thread + slot + k * slots,
// k < per_thread, and partial slice c.
constexpr int kTileParts = 264;   // CTAs, and partial slices, at most
constexpr int kTileRed = 10 * 4 * 256;   // (9 taps + db) x 4 maps x 256 threads

// The register route's nonfinite_taps, for the thread's maps over its pixels
// again: bit 9 j + k where tap k of map j meets an input that is not finite
// at a window position other than the routed one.  Out of line, and run only
// where the pixel loop met a window whose sum is not finite: inside the loop
// the same work took the kernel from 126 registers to 162 and from two CTAs
// an SM to one, 1.8x the time at the jet-ID batch on an H100
// (probes/conv_backward.py).
template <typename T>
__device__ __noinline__ unsigned long long nonfinite_tile_taps(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, int H, int W,
    int M, int Ho, int Wo, int pixels, int first, int slots, int per_thread, bool vec2) {
  const int Hc = H - 2, Wc = W - 2;
  float wr[9][4], br[4];
  tile_load_weights(w, b, M, 4 * threadIdx.x, wr, br);
  unsigned long long nan_taps = 0;
  for (int k = 0; k < per_thread; ++k) {
    const int pix = first + k * slots;
    if (pix >= pixels) return nan_taps;
    const int ox = pix % Wo, rest = pix / Wo;
    const int y0 = 2 * (rest % Ho), x0 = 2 * ox;
    float patch[4][4], best[4], total;
    int at[4];
    tile_load_patch(x + (size_t)(rest / Ho) * H * W, H, W, y0, x0, vec2, patch);
    tile_pool_window<true>(patch, wr, Hc, Wc, y0, x0, best, at, total);
    if (fabsf(total) < INFINITY) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (y0 + a / 2 >= Hc || x0 + a % 2 >= Wc) continue;
      unsigned taps = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        taps |= (fabsf(patch[a / 2 + t / 3][a % 2 + t % 3]) < INFINITY ? 0u : 1u) << t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (a != at[j]) nan_taps |= (unsigned long long)taps << (9 * j);
    }
  }
  return nan_taps;
}

template <typename T>
__global__ void __launch_bounds__(256)
conv_pool_relu_bwd_tiles_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                const T* __restrict__ b, const T* __restrict__ g,
                                float* __restrict__ partial, int H, int W, int M, int Ho, int Wo,
                                int pixels, int per_thread, bool vec2, bool vec4) {
  __shared__ __align__(16) float red[kTileRed];
  const int groups = blockDim.x, slots = blockDim.y;
  const int m0 = 4 * threadIdx.x;
  const int Hc = H - 2, Wc = W - 2;
  float wr[9][4], br[4], dw[9][4], db[4];
  bool nonfinite = false;   // a window's sum of conv outputs was not finite
  tile_load_weights(w, b, M, m0, wr, br);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    db[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) dw[k][j] = 0.f;
  }
  const int first = blockIdx.x * slots * per_thread + threadIdx.y;
  // (image, oy, ox) of the pixel, stepped by the slot stride, not divided anew
  const int step_x = slots % Wo, step_y = slots / Wo;
  int ox = first % Wo, oy = first / Wo % Ho, img = first / Wo / Ho;
#pragma unroll 1
  for (int k = 0; k < per_thread; ++k) {
    const int pix = first + k * slots;
    if (pix >= pixels) break;
    const int y0 = 2 * oy, x0 = 2 * ox;
    const T* gp = g + (size_t)pix * M + m0;
    float gv[4];
    if (vec4) {
      const float4 t = load_quad(gp);
      gv[0] = t.x;
      gv[1] = t.y;
      gv[2] = t.z;
      gv[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = m0 + j < M ? load_widened(gp + j) : 0.f;
    }
    float patch[4][4], best[4], total;
    int at[4];
    tile_load_patch(x + (size_t)img * H * W, H, W, y0, x0, vec2, patch);
    tile_pool_window<true>(patch, wr, Hc, Wc, y0, x0, best, at, total);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gr = best[j] + br[j] > 0.f ? gv[j] : 0.f;   // the ReLU's mask
      const bool down = at[j] >= 2, right = (at[j] & 1) != 0;
      float rows[3][4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int c = 0; c < 4; ++c) rows[dy][c] = down ? patch[dy + 1][c] : patch[dy][c];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          dw[3 * dy + dx][j] =
              fmaf(right ? rows[dy][dx + 1] : rows[dy][dx], gr, dw[3 * dy + dx][j]);
      db[j] += gr;
    }
    nonfinite |= !(fabsf(total) < INFINITY);
    ox += step_x;
    oy += step_y;
    if (ox >= Wo) {
      ox -= Wo;
      ++oy;
    }
    if (oy >= Ho) {
      img += oy / Ho;
      oy %= Ho;
    }
  }

  if (nonfinite) {
    const unsigned long long nan_taps = nonfinite_tile_taps(x, w, b, H, W, M, Ho, Wo, pixels,
                                                            first, slots, per_thread, vec2);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        if (nan_taps >> (9 * j + k) & 1ull) dw[k][j] = __uint_as_float(0x7FFFFFFFu);
  }

  // red[slot][k][4 mg + j], k = 9 for db; then thread i adds element i of
  // every slot, in slot order, into the CTA's slice (dW (9, M), then db).
  const int mp = 4 * groups, n = 10 * mp;
  float* const mine = red + threadIdx.y * n + m0;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    *reinterpret_cast<float4*>(mine + k * mp) = make_float4(dw[k][0], dw[k][1], dw[k][2], dw[k][3]);
  *reinterpret_cast<float4*>(mine + 9 * mp) = make_float4(db[0], db[1], db[2], db[3]);
  __syncthreads();
  float* const part = partial + (size_t)blockIdx.x * 10 * M;
  for (int i = threadIdx.y * groups + threadIdx.x; i < n; i += groups * slots) {
    const int k = i / mp, m = i - k * mp;
    if (m >= M) continue;
    float sum = 0.f;
    for (int sl = 0; sl < slots; ++sl) sum += red[sl * n + i];
    part[k * M + m] = sum;
  }
}

// The bf16 register route on the tensor cores (fused_conv.cuh, tc_*).  CTA
// c takes chunks c * per_cta .. (c + 1) * per_cta - 1 of 16 pooled pixels,
// per_cta = kTcWarps * per_warp; its warp v takes chunks v, v + kTcWarps, ...
// of them, in order, and the CTA writes partial slice c.  A chunk's g block
// (16 x M bf16, contiguous) comes into the warp's slice of shared memory by
// 16-byte cp.async, the next chunk's while this one runs.
//
// Per group and tile of 16 maps a lane recomputes K5's two products and pool
// (the same fragments, the same mma; a group's loads issued a group ahead,
// a tile's products one tile ahead), keeps g of pooled pixel t where
// zmax + b > 0, and puts it at the routed position of a zero block: the
// lane's accumulators are laid out as the A fragment of
//   dW^T (16 maps x 8 taps) += Gc^T (16 maps x 16 conv pixels) . P (16 conv
//   pixels x 8 taps),
// two more products a tile: taps 0..7, then tap 8 and a column of ones,
// which gives db.  Gc holds g or 0, exact in bf16.  The mma's f32 sums do
// not round to nearest, so a run of them is kept short: every kTcFold
// chunks, and after its last, a warp adds its accumulators into f32 sums of
// its own in shared memory and clears them (a run grows with N otherwise:
// 120 products a warp at the 20,000-jet chunk).  At the end the CTA adds
// its warps' sums in warp order.
constexpr int kTcParts = 264;   // CTAs, and partial slices, at most
constexpr int kTcFold = 8;      // chunks a warp sums in the mma's accumulators

// A warp's f32 sums: lane l's taps 2 t, 2 t + 1 of tile j, acc[j][0][i], at
// (4 j + i) 32 + l; tap 8 and db, acc[j][1][i] of the lanes with t = 0, at
// 128 n_mtiles + (4 j + i) 8 + g.  A lane touches its own sums only.
__host__ __device__ __forceinline__ int tc_sums_per_warp(int n_mtiles) {
  return 160 * n_mtiles;
}

__device__ __forceinline__ int tc_sum_index(int n_mtiles, int k, int m) {   // tap k, map m
  const int j = m / 16, h = m % 16 / 8, g = m % 8;
  return k < 8 ? (4 * j + 2 * h + k % 2) * 32 + 4 * g + k / 2
               : 128 * n_mtiles + (4 * j + 2 * h + k - 8) * 8 + g;
}

// Shared memory: TcWeights, the g stages (two a warp), the warps' sums.
inline size_t tc_bwd_smem(const TcShape& s) {
  return sizeof(TcWeights) + (size_t)kTcWarps * 2 * kTcChunk * s.M * sizeof(unsigned short) +
         (size_t)kTcWarps * tc_sums_per_warp(s.n_mtiles) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// P (16 conv pixels x 8 taps) of pooled pixel p for the dW product: lane
// (gq, t) gives rows (r, q) at tap gq (dy, dx) in the first tile, tap 8 in
// the second where gq = 0 (a column of ones where gq = 1, the rest 0).  Raw
// bf16 bits, loaded a group ahead of their use.
template <bool kAllValid>
__device__ __forceinline__ void tc_dw_load(const TcShape& s, const TcPixel& p, int gq, int dy,
                                           int dx, unsigned (&raw)[2][4]) {
  const unsigned W = s.W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const unsigned o = (r + dy) * W + dx, o8 = (r + 2) * W + 2;
    raw[r][0] = tc_x<kAllValid>(s, p, r + dy, dx, o);
    raw[r][1] = tc_x<kAllValid>(s, p, r + dy, dx + 1, o + 1);
    raw[r][2] = gq == 0 ? tc_x<kAllValid>(s, p, r + 2, 2, o8) : 0u;
    raw[r][3] = gq == 0 ? tc_x<kAllValid>(s, p, r + 2, 3, o8 + 1) : 0u;
  }
}

__device__ __forceinline__ void tc_dw_pack(const unsigned (&raw)[2][4], int gq,
                                           unsigned (&bp)[2][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bp[0][r] = pack_bf16(raw[r][0], raw[r][1]);
    bp[1][r] = gq == 1 ? pack_bf16(kBf16One, kBf16One) : pack_bf16(raw[r][2], raw[r][3]);
  }
}

template <bool kAllValid>
__global__ void __launch_bounds__(32 * kTcWarps, 2)
conv_pool_relu_bwd_tc_kernel(const unsigned short* __restrict__ x,
                             const unsigned short* __restrict__ w,
                             const unsigned short* __restrict__ b,
                             const unsigned short* __restrict__ g,
                             float* __restrict__ partial, const TcShape s, int per_warp,
                             bool vec) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  TcWeights* const tw = reinterpret_cast<TcWeights*>(tc_smem);
  unsigned short* const stage_all = reinterpret_cast<unsigned short*>(tc_smem + sizeof(TcWeights));
  tc_stage_weights(w, b, s.M, tw);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gq = lane / 4, t = lane % 4;
  const int M = s.M, chunk_len = kTcChunk * M;
  unsigned short* const stage = stage_all + (size_t)warp * 2 * chunk_len;
  float* const sums = reinterpret_cast<float*>(stage_all + (size_t)kTcWarps * 2 * chunk_len);
  float* const mine = sums + warp * tc_sums_per_warp(s.n_mtiles);
  for (int i = lane; i < tc_sums_per_warp(s.n_mtiles); i += 32) mine[i] = 0.f;
  int tdy[2], tdx[2];
  tc_lane_taps(lane, tdy, tdx);
  const int tap_dy = gq / 3, tap_dx = gq % 3;   // tap gq of the dW product's first tile

  float acc[kTcMTiles][2][4];
#pragma unroll
  for (int j = 0; j < kTcMTiles; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][u][i] = 0.f;

  const int n_chunks = (s.pixels + kTcChunk - 1) / kTcChunk;
  const int first = blockIdx.x * kTcWarps * per_warp + warp;
  int count = 0;   // this warp's chunks: first + kTcWarps * k, k < count
  while (count < per_warp && first + kTcWarps * count < n_chunks) ++count;

  auto stage_in = [&](int k) {   // chunk k of this warp -> stage buffer k % 2
    const int c0 = (first + kTcWarps * k) * kTcChunk;
    const int n = min(kTcChunk, s.pixels - c0) * M;
    const unsigned short* src = g + (size_t)c0 * M;
    unsigned short* dst = stage + (k % 2) * chunk_len;
    int done = 0;
    if (vec) {
      for (int i = lane; i < n / 8; i += 32) cp_async16(dst + 8 * i, src + 8 * i);
      done = n / 8 * 8;
    }
    for (int i = done + lane; i < n; i += 32) dst[i] = __ldg(src + i);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // both products' input operands of the group at p0, loaded a group ahead
  unsigned raw[2][3], rawp[2][4];
  auto load = [&](int p0) {
    tc_conv_load<kAllValid>(s, tc_pixel<kAllValid>(x, s, p0 + gq / 2), gq % 2, t, tdy, tdx, raw);
    tc_dw_load<kAllValid>(s, tc_pixel<kAllValid>(x, s, p0 + t), gq, tap_dy, tap_dx, rawp);
  };

  load(first * kTcChunk);
  if (count > 0) stage_in(0);
#pragma unroll 1
  for (int k = 0; k < count; ++k) {
    if (k + 1 < count) stage_in(k + 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    const unsigned short* gs = stage + (k % 2) * chunk_len;
    const int c0 = (first + kTcWarps * k) * kTcChunk;
#pragma unroll 1
    for (int grp = 0; grp < kTcChunk / 4; ++grp) {
      const int p0 = c0 + 4 * grp;
      unsigned bf[2][2], bp[2][2];
      tc_conv_pack(raw, bf);
      tc_dw_pack(rawp, gq, bp);
      load(grp + 1 < kTcChunk / 4 ? p0 + 4 : (first + kTcWarps * (k + 1)) * kTcChunk);
      const TcPixel pe = tc_pixel<kAllValid>(x, s, p0 + t);
      const unsigned short* grow = gs + (4 * grp + t) * M;
      float z[2][4];
      tc_conv_tile(tw->a[0][lane], bf, z);
#pragma unroll
      for (int j = 0; j < kTcMTiles; ++j) {
        if (j >= s.n_mtiles) break;
        float zn[2][4];   // the next tile's products, in flight during this tile's routing
        tc_conv_tile(tw->a[j + 1 < kTcMTiles ? j + 1 : j][lane], bf, zn);
        const float2 bias = tw->bias[j][lane];
        unsigned lo[2], hi[2];   // Gc^T of map half h: positions 0, 1 and 2, 3
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * j + gq + 8 * h;
          const bool live = pe.live && m < M;
          tc_route(z, h, pe, h ? bias.y : bias.x, live, live ? grow[m] : 0u, &lo[h], &hi[h]);
        }
        const uint4 a = make_uint4(lo[0], lo[1], hi[0], hi[1]);
        mma_bf16(a, bp[0][0], bp[0][1], acc[j][0]);
        mma_bf16(a, bp[1][0], bp[1][1], acc[j][1]);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) z[r][i] = zn[r][i];
      }
    }
    if ((k + 1) % kTcFold == 0 || k + 1 == count) {   // the accumulators -> the warp's sums
#pragma unroll
      for (int j = 0; j < kTcMTiles; ++j) {
        if (j >= s.n_mtiles) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mine[(4 * j + i) * 32 + lane] += acc[j][0][i];
          if (t == 0) mine[128 * s.n_mtiles + (4 * j + i) * 8 + gq] += acc[j][1][i];
          acc[j][0][i] = acc[j][1][i] = 0.f;
        }
      }
    }
    __syncwarp();   // done with this buffer before chunk k + 2 is staged into it
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // thread i adds element i of every warp's sums, in warp order, into the
  // CTA's slice (dW (9, M), then db)
  __syncthreads();
  float* const part = partial + (size_t)blockIdx.x * 10 * M;
  for (int i = threadIdx.x; i < 10 * M; i += blockDim.x) {
    const int at = tc_sum_index(s.n_mtiles, i / M, i % M);
    float sum = 0.f;
    for (int v = 0; v < kTcWarps; ++v) sum += sums[v * tc_sums_per_warp(s.n_mtiles) + at];
    part[i] = sum;
  }
}

// out[i] = the sum over slices j of partial[j][i], rounded once to T.
// Warp v of a CTA adds the slices of its run, v * span .. (v + 1) * span -
// 1, in slice order for 32 consecutive i; then the warps' sums are added in
// warp order.  The order depends on n_parts alone.
constexpr int kReduceWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kReduceWarps)
conv_reduce_partials(const float* __restrict__ partial, int n_parts, int n_params,
                     T* __restrict__ out) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  const int span = (n_parts + kReduceWarps - 1) / kReduceWarps;
  const int j1 = min(n_parts, (warp + 1) * span);
  float sum = 0.f;
  if (i < n_params) {
#pragma unroll 8
    for (int j = warp * span; j < j1; ++j) sum += partial[(size_t)j * n_params + i];
  }
  sums[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && i < n_params) {
    float total = 0.f;
#pragma unroll
    for (int v = 0; v < kReduceWarps; ++v) total += sums[v][lane];
    out[i] = narrow<T>(total);
  }
}

template <typename T>
int conv_reduce(const float* partial, int n_parts, int n_params, T* out, cudaStream_t s) {
  conv_reduce_partials<T><<<(n_params + 31) / 32, 32 * kReduceWarps, 0, s>>>(partial, n_parts,
                                                                             n_params, out);
  return (int)cudaGetLastError();
}

// The register route's launch: (groups, slots) threads a CTA, per_thread
// pixels a thread; returns the number of CTAs (= partial slices), or -1
// for a shape it does not take.
inline int conv_tiles_plan(int N, int H, int W, int M, int* groups, int* slots,
                           int* per_thread) {
  if (N < 1 || H < 3 || W < 3 || M < 1 || M > kTileMaps) return -1;
  const long long pixels = (long long)N * ((H - 1) / 2) * ((W - 1) / 2);
  *groups = (M + 3) / 4;
  *slots = 256 / *groups;
  const long long per_thread_ = ((pixels + kTileParts - 1) / kTileParts + *slots - 1) / *slots;
  const long long per_cta = *slots * per_thread_;
  const long long parts = (pixels + per_cta - 1) / per_cta;
  if (parts * per_cta > 2147483647LL) return -1;   // 32-bit pixel indices
  *per_thread = (int)per_thread_;
  return (int)parts;
}

// The bf16 tensor-core route's launch: per_warp chunks a warp; returns the
// number of CTAs (= partial slices), or -1 for a shape it does not take.
inline int conv_tc_plan(int N, int H, int W, int M, TcShape* s, int* per_warp) {
  if (!tc_shape(N, H, W, M, s) || tc_bwd_smem(*s) > kConvMaxSmem) return -1;
  const long long n_chunks = (s->pixels + kTcChunk - 1) / kTcChunk;
  *per_warp = (int)((n_chunks + (long long)kTcParts * kTcWarps - 1) / ((long long)kTcParts * kTcWarps));
  const long long per_cta = (long long)kTcWarps * *per_warp;
  return (int)((n_chunks + per_cta - 1) / per_cta);
}

template <typename T>
int conv_bwd_prepare(int N, int H, int W, int C, int kh, int kw, int M, int ph, int pw,
                     ConvArgs<T>* a) {
  if (!conv_shape(N, H, W, C, kh, kw, M, ph, pw, &a->s)) return -1;
  if (!conv_plan(a->s, true, &a->p)) return -2;
  long long parts = a->p.items < kMaxParts ? a->p.items : kMaxParts;
  const long long room = kMaxScratch / (a->s.K * a->s.M + a->s.M);
  if (parts > room) parts = room;   // room >= 63 at the widest shape of the gate
  return (int)parts;
}

// The band route: grads = dW (K*M elements, the (kh, kw, C, M) layout)
// followed by db (M); partial: (n_parts, K*M + M) float scratch with
// n_parts from atlasvae_conv_backward_parts.  Returns 0, a cudaError or the
// negative codes of that function.
template <typename T>
int conv_backward_bands(const void* x, const void* w, const void* b, const void* g,
                        void* partial, int n_parts, void* grads, int N, int H, int W, int C,
                        int kh, int kw, int M, int ph, int pw, void* stream) {
  ConvArgs<T> a = {};
  const int parts = conv_bwd_prepare(N, H, W, C, kh, kw, M, ph, pw, &a);
  if (parts < 0) return parts;
  if (parts != n_parts) return (int)cudaErrorInvalidValue;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.b = static_cast<const T*>(b);
  a.g = static_cast<const T*>(g);
  a.partial = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(conv_pool_relu_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)a.p.smem);
  if (err != cudaSuccess) return (int)err;
  conv_pool_relu_bwd_kernel<T><<<parts, kConvThreads, a.p.smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return conv_reduce(a.partial, parts, a.s.K * a.s.M + a.s.M, static_cast<T*>(grads), s);
}

// The register route at x (N, H, W, 1), w (3, 3, 1, M), g (N, Ho, Wo, M)
// for a 2x2 pool: grads = dW (9*M elements, the (3, 3, 1, M) layout)
// followed by db (M); partial: (n_parts, 10*M) float scratch with n_parts
// from atlasvae_conv_backward_tiles_parts.  Returns 0, a cudaError or -1.
template <typename T>
int conv_backward_tiles(const void* x, const void* w, const void* b, const void* g,
                        void* partial, int n_parts, void* grads, int N, int H, int W, int M,
                        void* stream) {
  int groups, slots, per_thread;
  const int parts = conv_tiles_plan(N, H, W, M, &groups, &slots, &per_thread);
  if (parts < 0) return parts;
  if (parts != n_parts) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2, Wo = (W - 1) / 2;
  const bool vec2 = W % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const bool vec4 = M % 4 == 0 && reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv_pool_relu_bwd_tiles_kernel<T><<<parts, dim3(groups, slots), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(g), static_cast<float*>(partial), H, W, M, Ho, Wo,
      N * Ho * Wo, per_thread, vec2, vec4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return conv_reduce(static_cast<const float*>(partial), parts, 10 * M, static_cast<T*>(grads),
                     s);
}

// The bf16 register route: as conv_backward_tiles, on the tensor cores,
// with n_parts from atlasvae_conv_backward_tiles_parts_bf16.
inline int conv_backward_tc(const void* x, const void* w, const void* b, const void* g,
                            void* partial, int n_parts, void* grads, int N, int H, int W, int M,
                            void* stream) {
  TcShape s;
  int per_warp;
  const int parts = conv_tc_plan(N, H, W, M, &s, &per_warp);
  if (parts < 0) return parts;
  if (parts != n_parts) return (int)cudaErrorInvalidValue;
  int sms;
  const int setup = tc_device_setup(&conv_pool_relu_bwd_tc_kernel<true>,
                                    &conv_pool_relu_bwd_tc_kernel<false>, kConvMaxSmem, &sms);
  if (setup) return setup;
  const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const size_t smem = tc_bwd_smem(s);
  const auto* xs = static_cast<const unsigned short*>(x);
  const auto* ws = static_cast<const unsigned short*>(w);
  const auto* bs = static_cast<const unsigned short*>(b);
  const auto* gs = static_cast<const unsigned short*>(g);
  float* ps = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 2 == 0 && W % 2 == 0)   // Hc and Wc even: every window position exists
    conv_pool_relu_bwd_tc_kernel<true><<<parts, 32 * kTcWarps, smem, st>>>(xs, ws, bs, gs, ps, s,
                                                                          per_warp, vec);
  else
    conv_pool_relu_bwd_tc_kernel<false><<<parts, 32 * kTcWarps, smem, st>>>(xs, ws, bs, gs, ps,
                                                                           s, per_warp, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return conv_reduce(ps, parts, 10 * M, static_cast<bf16*>(grads), st);
}

}  // namespace atlasvae

// Number of partial slices (rows of the scratch buffer) the band route uses
// at this shape, in float and bf16 alike; -1 for a shape outside the gate,
// -2 when one pooled row of one image does not fit a CTA's shared memory.
extern "C" int atlasvae_conv_backward_parts(int N, int H, int W, int C, int kh, int kw, int M,
                                            int ph, int pw) {
  atlasvae::ConvArgs<float> a = {};
  return atlasvae::conv_bwd_prepare(N, H, W, C, kh, kw, M, ph, pw, &a);
}

// The register route's partial slices at x (N, H, W, 1), w (3, 3, 1, M):
// float, and bf16 (_bf16, the tensor-core kernel), or -1 for a shape it
// does not take (M above 128, an image smaller than the taps, 2^31 pooled
// pixels).
extern "C" int atlasvae_conv_backward_tiles_parts(int N, int H, int W, int M) {
  int groups, slots, per_thread;
  return atlasvae::conv_tiles_plan(N, H, W, M, &groups, &slots, &per_thread);
}

extern "C" int atlasvae_conv_backward_tiles_parts_bf16(int N, int H, int W, int M) {
  atlasvae::TcShape s;
  int per_warp;
  return atlasvae::conv_tc_plan(N, H, W, M, &s, &per_warp);
}

// The entry points: float (x, w, b, g and grads all float32) and _bf16 (all
// bf16), the band route and the register route of each.
extern "C" int atlasvae_conv_backward(const void* x, const void* w, const void* b, const void* g,
                                      void* partial, int n_parts, void* grads, int N, int H,
                                      int W, int C, int kh, int kw, int M, int ph, int pw,
                                      void* stream) {
  return atlasvae::conv_backward_bands<float>(x, w, b, g, partial, n_parts, grads, N, H, W, C,
                                              kh, kw, M, ph, pw, stream);
}

extern "C" int atlasvae_conv_backward_bf16(const void* x, const void* w, const void* b,
                                           const void* g, void* partial, int n_parts,
                                           void* grads, int N, int H, int W, int C, int kh,
                                           int kw, int M, int ph, int pw, void* stream) {
  return atlasvae::conv_backward_bands<atlasvae::bf16>(x, w, b, g, partial, n_parts, grads, N,
                                                       H, W, C, kh, kw, M, ph, pw, stream);
}

extern "C" int atlasvae_conv_backward_tiles(const void* x, const void* w, const void* b,
                                            const void* g, void* partial, int n_parts,
                                            void* grads, int N, int H, int W, int M,
                                            void* stream) {
  return atlasvae::conv_backward_tiles<float>(x, w, b, g, partial, n_parts, grads, N, H, W, M,
                                              stream);
}

extern "C" int atlasvae_conv_backward_tiles_bf16(const void* x, const void* w, const void* b,
                                                 const void* g, void* partial, int n_parts,
                                                 void* grads, int N, int H, int W, int M,
                                                 void* stream) {
  return atlasvae::conv_backward_tc(x, w, b, g, partial, n_parts, grads, N, H, W, M, stream);
}
