// Shared by K5 (fused_conv.cu) and K6 (fused_conv_bwd.cu): the shape of the
// jet-ID input block relu(maxpool_SAME(conv2d_VALID(x, w)) + b), how a CTA's
// work is cut, and the recompute both kernels run.
//
// x is (N, H, W, C) channels-last, w is (kh, kw, C, M) read as a (K, M)
// matrix with K = kh*kw*C and the taps in (dy, dx, c) order, the pool window
// equals its stride and pads as XLA's SAME does: total = Ho*ph - Hc rows, the
// low side gets total / 2.  Conv pixels outside the conv output are skipped,
// never clamped.
//
// A work item is (a group of nb images) x (a band of rb pooled rows).  Its
// input rows sit in shared memory beside one tile of the weights (K x mt);
// items whose maps do not fit one tile walk the tiles in turn.  The float
// register routes of both (tile_* below) keep no rows in shared memory: a
// thread holds four maps' taps and one pooled pixel's input patch in
// registers.  Every float route, and the bf16 band route, sums the taps of a
// conv pixel with the same chain of FMAs, so the backward sees the bits the
// forward pooled.
//
// x, w, b, the output and g are all float or all bf16 (the element type T
// of the kernels).  On the FMA routes a bf16 value is widened to float where
// it is loaded (a product of two bf16 values is exact in float) and
// everything after runs as the float kernels run; an output is rounded once,
// where it is stored (narrow).  Shared memory and the partial sums hold
// floats either way.
//
// The bf16 register route (tc_* below) runs on the tensor cores instead: an
// implicit GEMM with mma.sync m16n8k16 (bf16 in, f32 sums).  At the jet-ID
// training batch its FMA form did 1.76 GFLOP of scalar products, 0.026 ms at
// the f32 CUDA-core peak, above the 0.0154 ms its bytes take, so no FMA
// design could reach the byte bound; on the tensor cores the products take
// 2 us, and what is left is the pool or the routing a (pooled pixel, map)
// and the operands' loads, a few hundred instructions a group of four pooled
// pixels.  K5 and K6 build the same fragments in the same tap order and run
// the same mma on them, so K6's argmax and ReLU mask see the bits K5 pooled.
// The float routes keep the FMA chain.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "nan_math.cuh"

namespace atlasvae {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float load_widened(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_widened(const bf16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Two consecutive floats, 8 bytes aligned (the float register routes).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Four consecutive floats, 16 bytes aligned.
__device__ __forceinline__ float4 load_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) { return __float2bfloat16_rn(v); }

// Four floats stored as one 16-byte word.
__device__ __forceinline__ void store_quad(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

constexpr int kConvThreads = 256;
constexpr size_t kConvMaxSmem = 232448;  // a CTA's shared memory on sm_90
constexpr int kConvMaxK = 512;           // the gate of ops/fused_conv.py `supported`
constexpr int kConvMaxM = 1024;

struct ConvShape {
  int N, H, W, C, kh, kw, M, ph, pw;
  int Hc, Wc, Ho, Wo, plh, plw, K, WC, kwC;
};

struct ConvPlan {
  int nb;        // images a work item
  int rb;        // pooled rows a band
  int mt;        // maps a weight tile
  int rows_in;   // input rows staged per image, at most
  int n_bands, n_mtiles;
  long long items;
  size_t smem;
};

inline bool conv_shape(int N, int H, int W, int C, int kh, int kw, int M, int ph, int pw,
                       ConvShape* s) {
  if (N < 1 || C < 1 || kh < 1 || kw < 1 || M < 1 || ph < 1 || pw < 1 || H < kh || W < kw)
    return false;
  if ((long long)kh * kw * C > kConvMaxK || M > kConvMaxM) return false;
  s->N = N; s->H = H; s->W = W; s->C = C; s->kh = kh; s->kw = kw; s->M = M;
  s->ph = ph; s->pw = pw;
  s->Hc = H - kh + 1;
  s->Wc = W - kw + 1;
  s->Ho = (s->Hc + ph - 1) / ph;
  s->Wo = (s->Wc + pw - 1) / pw;
  s->plh = (s->Ho * ph - s->Hc) / 2;
  s->plw = (s->Wo * pw - s->Wc) / 2;
  s->K = kh * kw * C;
  s->WC = W * C;
  s->kwC = kw * C;
  return true;
}

// The backward keeps, per pooled pixel and map of an item, the routed
// gradient and the offset of its conv pixel's patch: 8 bytes each.
inline size_t conv_smem(const ConvShape& s, const ConvPlan& p, bool backward) {
  size_t words = (size_t)s.K * p.mt + (size_t)p.nb * p.rows_in * s.WC;
  if (backward) words += 2 * (size_t)p.nb * p.rb * s.Wo * p.mt;
  return words * sizeof(float);
}

inline int conv_rows_in(const ConvShape& s, int rb) {
  const int rows = rb * s.ph + s.kh - 1;
  return rows < s.H ? rows : s.H;
}

// Soft targets keep a few CTAs on an SM (weights 64 KB, rows 32 KB, the
// backward's routing 96 KB); then whatever still exceeds a CTA's shared
// memory shrinks, images first, then rows, then maps.  False if one pooled
// row of one image and one map do not fit.
inline bool conv_plan(const ConvShape& s, bool backward, ConvPlan* p) {
  const size_t kWeights = 64 << 10, kRows = 32 << 10, kRoute = 96 << 10;
  p->mt = (int)(kWeights / sizeof(float) / s.K);
  if (p->mt < 32) p->mt = 32;
  if (p->mt > s.M) p->mt = s.M;
  auto rows_bytes = [&](int nb, int rb) {
    return (size_t)nb * conv_rows_in(s, rb) * s.WC * sizeof(float);
  };
  auto route_bytes = [&](int nb, int rb) {
    return backward ? (size_t)nb * rb * s.Wo * p->mt * 8 : (size_t)0;
  };
  p->rb = s.Ho;
  while (p->rb > 1 && (rows_bytes(1, p->rb) > kRows || route_bytes(1, p->rb) > kRoute))
    p->rb = (p->rb + 1) / 2;
  p->nb = backward ? 4 : 8;
  if (p->nb > s.N) p->nb = s.N;
  while (p->nb > 1 && (rows_bytes(p->nb, p->rb) > kRows || route_bytes(p->nb, p->rb) > kRoute))
    --p->nb;
  for (;;) {
    p->rows_in = conv_rows_in(s, p->rb);
    p->smem = conv_smem(s, *p, backward);
    if (p->smem <= kConvMaxSmem) break;
    if (p->nb > 1) --p->nb;
    else if (p->rb > 1) p->rb = (p->rb + 1) / 2;
    else if (p->mt > 1) p->mt = (p->mt + 1) / 2;
    else return false;
  }
  p->n_bands = (s.Ho + p->rb - 1) / p->rb;
  p->n_mtiles = (s.M + p->mt - 1) / p->mt;
  p->items = (long long)((s.N + p->nb - 1) / p->nb) * p->n_bands;
  return true;
}

template <typename T>
struct ConvArgs {
  ConvShape s;
  ConvPlan p;
  const T* x;        // (N, H, W, C)
  const T* w;        // (K, M)
  const T* b;        // (M,)
  T* out;            // forward: (N, Ho, Wo, M)
  const T* g;        // backward: (N, Ho, Wo, M)
  float* partial;    // backward: (grid, K*M + M), one slice a CTA
};

// What an item covers, worked out the same way by both kernels.
struct ConvItem {
  int n0, nb, oy0, n_rows, ylo, rows, npix;
};

__device__ __forceinline__ ConvItem conv_item(const ConvShape& s, const ConvPlan& p,
                                              long long item) {
  ConvItem it;
  const int band = (int)(item % p.n_bands);
  it.n0 = (int)(item / p.n_bands) * p.nb;
  it.nb = min(p.nb, s.N - it.n0);
  it.oy0 = band * p.rb;
  const int oy1 = min(it.oy0 + p.rb, s.Ho);
  it.n_rows = oy1 - it.oy0;
  it.ylo = max(it.oy0 * s.ph - s.plh, 0);
  const int yhi = min(oy1 * s.ph - s.plh - 1, s.Hc - 1);
  it.rows = yhi - it.ylo + s.kh;   // input rows ylo .. yhi + kh - 1
  it.npix = it.nb * it.n_rows * s.Wo;
  return it;
}

// The item's input rows -> xs, image after image, rows_in * WC floats apart.
template <typename T>
__device__ __forceinline__ void conv_stage_rows(const ConvArgs<T>& a, const ConvItem& it,
                                                float* xs) {
  const ConvShape& s = a.s;
  const int len = it.rows * s.WC;
  for (int img = 0; img < it.nb; ++img) {
    const T* src = a.x + ((size_t)(it.n0 + img) * s.H + it.ylo) * s.WC;
    float* dst = xs + (size_t)img * a.p.rows_in * s.WC;
    for (int i = threadIdx.x; i < len; i += kConvThreads) dst[i] = load_widened(src + i);
  }
}

// Maps m0 .. m0 + mcur of the weights -> ws[k * mt + m].
template <typename T>
__device__ __forceinline__ void conv_stage_weights(const ConvArgs<T>& a, int m0, int mcur,
                                                   float* ws) {
  const int mt = a.p.mt;
  for (int i = threadIdx.x; i < a.s.K * mcur; i += kConvThreads) {
    const int k = i / mcur, m = i - k * mcur;
    ws[k * mt + m] = load_widened(a.w + (size_t)k * a.s.M + m0 + m);
  }
}

// The pooled pixel (oy, ox) of one staged image for the map at ws + m: the
// largest conv output of its window and the conv pixel (*by, *bx) of the
// first position that reaches it, scanning rows then columns (a window of
// -inf values: its first position, as XLA's z == y routes it).  A NaN is the
// window's value (max_nan); its position is then any of the window's, which
// K6 masks off (NaN + b > 0 is false: it routes 0 x its patch, and the x * 0
// terms of the window's other positions come from nonfinite_taps).  The
// taps are summed in (dy, dx, c) order, one FMA each.  *total: the sum of
// the window's conv outputs, not finite where an input of the window is not.
__device__ __forceinline__ float conv_pool_pixel(const ConvShape& s, const float* xs_img,
                                                 int ylo, int oy, int ox, const float* wm,
                                                 int mt, int* by, int* bx, float* total) {
  float best = -INFINITY;
  *total = 0.f;
  *by = -1;
  *bx = -1;
  for (int t = 0; t < s.ph; ++t) {
    const int y = oy * s.ph + t - s.plh;
    if (y < 0 || y >= s.Hc) continue;
    for (int q = 0; q < s.pw; ++q) {
      const int x0 = ox * s.pw + q - s.plw;
      if (x0 < 0 || x0 >= s.Wc) continue;
      float acc = 0.f;
      const float* wp = wm;
      for (int dy = 0; dy < s.kh; ++dy) {
        const float* xr = xs_img + (y - ylo + dy) * s.WC + x0 * s.C;
        for (int j = 0; j < s.kwC; ++j) {
          acc = fmaf(xr[j], *wp, acc);
          wp += mt;
        }
      }
      *total += acc;
      if (*by < 0 || !(acc <= best)) {   // a later tie does not take over
        *by = y;
        *bx = x0;
      }
      best = max_nan(best, acc);
    }
  }
  return best;
}

// pixel index within an item -> (image, pooled row, pooled column)
__device__ __forceinline__ void conv_pixel_of(const ConvShape& s, const ConvItem& it, int pix,
                                              int* img, int* oy, int* ox) {
  *ox = pix % s.Wo;
  const int r = pix / s.Wo;
  *oy = it.oy0 + r % it.n_rows;
  *img = r / it.n_rows;
}

// The register routes of K5 and K6: 3x3 taps, one channel, a 2x2 pool
// (which pads only on the high side) and at most kTileMaps maps.  A thread
// keeps four consecutive maps, m0 .. m0 + 3, and walks pooled pixels.
constexpr int kTileMaps = 128;   // ops/fused_conv_cuda.py TILE_MAX_MAPS

// The 9 taps and the bias of the thread's four maps; 0 past M.
template <typename T>
__device__ __forceinline__ void tile_load_weights(const T* __restrict__ w,
                                                  const T* __restrict__ b, int M, int m0,
                                                  float (&wr)[9][4], float (&br)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = m0 + j < M;
#pragma unroll
    for (int k = 0; k < 9; ++k) wr[k][j] = live ? load_widened(w + (size_t)k * M + m0 + j) : 0.f;
    br[j] = live ? load_widened(b + m0 + j) : 0.f;
  }
}

// The 4x4 input patch at rows y0.., columns x0.. of one H x W image, 0
// outside it.  vec2 (W even, the image aligned to two elements): two pair
// loads a row, which then lie inside the image.
template <typename T>
__device__ __forceinline__ void tile_load_patch(const T* __restrict__ img, int H, int W,
                                                int y0, int x0, bool vec2,
                                                float (&patch)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T* row = img + (size_t)(y0 + i) * W + x0;
    const bool inside = y0 + i < H;
    if (vec2) {
      const float2 lo = inside ? load_pair(row) : make_float2(0.f, 0.f);
      const float2 hi = inside ? load_pair(row + 2) : make_float2(0.f, 0.f);
      patch[i][0] = lo.x;
      patch[i][1] = lo.y;
      patch[i][2] = hi.x;
      patch[i][3] = hi.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        patch[i][j] = inside && x0 + j < W ? load_widened(row + j) : 0.f;
    }
  }
}

// The pool window whose first conv pixel is (y0, x0): for each of the four
// maps the largest conv output (max_nan: a NaN is the window's value) and its
// position at = 2 t + q, the first strictly greater one in row order (in a
// NaN window any position: see conv_pool_pixel), positions at or past
// (Hc, Wc) skipped.  kRoute (K6): also the positions, and total: the sum of
// the first map's conv outputs over the window, not finite where an input of
// it is not; K5 reads the values only.
// Each conv pixel is one chain of FMAs from 0 in (dy, dx) order, the band
// route's chain, so both routes of K5 and K6 see the same bits.
template <bool kRoute>
__device__ __forceinline__ void tile_pool_window(const float (&patch)[4][4],
                                                 const float (&wr)[9][4], int Hc, int Wc,
                                                 int y0, int x0, float (&best)[4],
                                                 int (&at)[4], float& total) {
  total = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    best[j] = -INFINITY;
    at[j] = 0;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool valid = y0 + t < Hc && x0 + q < Wc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = fmaf(patch[t + dy][q + dx], wr[3 * dy + dx][j], acc);
        // selects, not a branch on valid: as a branch this cost K5's and K6's
        // register routes 6% and 14% on an H100 (probes/conv_backward.py)
        if constexpr (kRoute) {
          if (j == 0) total += valid ? acc : 0.f;
          if (valid && !(acc <= best[j])) at[j] = 2 * t + q;   // a later tie does not take over
        }
        best[j] = max_nan(best[j], valid ? acc : -INFINITY);
      }
    }
}

// ---- The bf16 register route on the tensor cores (tc_*) ----
//
// A warp runs groups of four consecutive pooled pixels, all maps, as
//   z (16 maps x 8 conv pixels) = W^T (16 maps x 16 taps) . P^T (16 taps x 8
//   conv pixels),
// mma.sync.m16n8k16 with the 9 taps (dy, dx) in 3 dy + dx order padded to 16
// with zeros, two products a tile of 16 maps: window row r = 0 and r = 1.
// Column 2 t + q of the product of row r is position (r, q) of pooled pixel
// t of the group, so lane (g = lane / 4, t = lane % 4) ends with all four
// positions of pooled pixel t for maps g and g + 8 in its accumulators, and
// the pool, the argmax, the bias and the clamp run in its registers.  Each
// product of two bf16 values is exact in f32; the mma sums them in f32.
constexpr int kTcWarps = 8;                  // warps a CTA
constexpr int kTcChunk = 16;                 // pooled pixels a warp stages at once: 4 groups
constexpr int kTcMTiles = kTileMaps / 16;    // tiles of 16 maps, at most
constexpr unsigned kBf16One = 0x3F80u;       // 1.0 in bf16
constexpr int kTcMaxDevices = 64;

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1).
struct FastDiv {
  unsigned mul;
  int shift;
};

inline FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  FastDiv f;
  f.shift = l;
  f.mul = (unsigned)(((1ULL << 32) * ((1ULL << l) - (unsigned long long)d)) /
                     (unsigned long long)d + 1);
  return f;
}

__device__ __forceinline__ int divide(const FastDiv& f, int n) {
  return (int)((__umulhi((unsigned)n, f.mul) + (unsigned)n) >> f.shift);
}

struct TcShape {
  int N, H, W, M, Ho, Wo, n_mtiles;
  int pixels;     // N * Ho * Wo pooled pixels
  FastDiv wo, ho;
};

inline bool tc_shape(int N, int H, int W, int M, TcShape* s) {
  if (N < 1 || H < 3 || W < 3 || M < 1 || M > kTileMaps) return false;
  s->N = N; s->H = H; s->W = W; s->M = M;
  s->Ho = (H - 1) / 2;   // ceil((H - 2) / 2)
  s->Wo = (W - 1) / 2;
  const long long pixels = (long long)N * s->Ho * s->Wo;
  if (pixels > 2147483647LL - (1LL << 24)) return false;   // 32-bit pixel indices
  s->pixels = (int)pixels;
  s->n_mtiles = (M + 15) / 16;
  s->wo = fast_div(s->Wo);
  s->ho = fast_div(s->Ho);
  return true;
}

// Once a device, at its first launch: its SM count, and, where smem > 0,
// the dynamic shared memory cap of both forms of a kernel raised to smem.
// Returns 0 or a cudaError.  Static: each library (and each build of one,
// loaded side by side) keeps its own table, where a static local of an
// inline function would be one object for the whole process.
template <typename Kernel>
static int tc_device_setup(Kernel all_valid, Kernel edges, size_t smem, int* sms) {
  static std::atomic<int> known[kTcMaxDevices];   // SM counts, 0 until set up
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kTcMaxDevices) return (int)cudaErrorInvalidDevice;
  int n = known[device].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess && smem > 0)
      err = cudaFuncSetAttribute(all_valid, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err == cudaSuccess && smem > 0)
      err = cudaFuncSetAttribute(edges, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    known[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return 0;
}

// d += a . b, one m16n8k16 product of bf16 pairs into f32.
__device__ __forceinline__ void mma_bf16(const uint4& a, unsigned b0, unsigned b1, float (&d)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(unsigned lo, unsigned hi) { return lo | hi << 16; }

// The weights as A fragments and the bias, per tile of 16 maps and lane, in
// shared memory: a.x holds taps 2 t, 2 t + 1 of map 16 j + g, a.y those of
// map 16 j + g + 8, a.z and a.w tap 8 of the two maps where t = 0 (the
// zero-padded taps 9..15 elsewhere); 0 past M, all kTcMTiles tiles.  Built
// once a CTA.
struct TcWeights {
  uint4 a[kTcMTiles][32];
  float2 bias[kTcMTiles][32];
};

__device__ __forceinline__ void tc_stage_weights(const unsigned short* __restrict__ w,
                                                 const unsigned short* __restrict__ b, int M,
                                                 TcWeights* tw) {
  for (int i = threadIdx.x; i < kTcMTiles * 32; i += blockDim.x) {
    const int j = i / 32, lane = i % 32, g = lane / 4, t = lane % 4;
    const int m0 = 16 * j + g, m1 = m0 + 8;
    auto wk = [&](int k, int m) -> unsigned { return m < M ? __ldg(w + (size_t)k * M + m) : 0u; };
    uint4 a;
    a.x = pack_bf16(wk(2 * t, m0), wk(2 * t + 1, m0));
    a.y = pack_bf16(wk(2 * t, m1), wk(2 * t + 1, m1));
    a.z = t == 0 ? wk(8, m0) : 0u;
    a.w = t == 0 ? wk(8, m1) : 0u;
    tw->a[j][lane] = a;
    tw->bias[j][lane] =
        make_float2(m0 < M ? __uint_as_float((unsigned)__ldg(b + m0) << 16) : 0.f,
                    m1 < M ? __uint_as_float((unsigned)__ldg(b + m1) << 16) : 0.f);
  }
}

__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// One pooled pixel's window: where its first conv pixel (y0, x0) lies in x,
// whether the pixel exists, and which window positions lie inside the conv
// output (position 0 always does; kAllValid: Hc and Wc even, all do).  A
// pixel past the last one stands in the last one's place, so its loads stay
// inside x; whatever it computes is dropped.
struct TcPixel {
  const unsigned short* at;
  int y0, x0;
  bool live, v1, v2, v3;
};

template <bool kAllValid>
__device__ __forceinline__ TcPixel tc_pixel(const unsigned short* __restrict__ x, const TcShape& s,
                                            int pix) {
  TcPixel p;
  p.live = pix < s.pixels;
  if (!p.live) pix = s.pixels - 1;
  const int rest = divide(s.wo, pix);
  const int img = divide(s.ho, rest);
  p.x0 = 2 * (pix - rest * s.Wo);
  p.y0 = 2 * (rest - img * s.Ho);
  p.at = x + (size_t)img * s.H * s.W + p.y0 * s.W + p.x0;
  p.v1 = kAllValid || p.x0 + 1 < s.W - 2;
  p.v2 = kAllValid || p.y0 + 1 < s.H - 2;
  p.v3 = p.v1 && p.v2;
  return p;
}

// x at (y0 + dy, x0 + dx) of the pixel's image as bf16 bits, 0 outside the
// image (only a tap of a position outside the conv output lies there); off
// is dy * W + dx, unsigned so that the address takes one wide multiply-add.
template <bool kAllValid>
__device__ __forceinline__ unsigned tc_x(const TcShape& s, const TcPixel& p, int dy, int dx,
                                         unsigned off) {
  if (!kAllValid && (p.y0 + dy >= s.H || p.x0 + dx >= s.W)) return 0u;
  return __ldg(p.at + off);
}

// The taps 2 t, 2 t + 1 a lane gives the conv's B fragments, as (dy, dx).
__device__ __forceinline__ void tc_lane_taps(int lane, int (&tdy)[2], int (&tdx)[2]) {
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tdy[i] = (2 * t + i) / 3;
    tdx[i] = (2 * t + i) % 3;
  }
}

// The B fragments (P^T, 16 taps x 8 conv pixels) of window rows r = 0, 1:
// lane (g, t) gives conv pixel (r, q = g % 2) of p, the group's pooled pixel
// g / 2, at taps 2 t, 2 t + 1 and, where t = 0, tap 8.  Loaded as raw bf16
// bits a group ahead of their use, packed when the group starts.
template <bool kAllValid>
__device__ __forceinline__ void tc_conv_load(const TcShape& s, const TcPixel& p, int q, int t,
                                             const int (&tdy)[2], const int (&tdx)[2],
                                             unsigned (&raw)[2][3]) {
  const unsigned W = s.W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    raw[r][0] = tc_x<kAllValid>(s, p, r + tdy[0], q + tdx[0], (r + tdy[0]) * W + q + tdx[0]);
    raw[r][1] = tc_x<kAllValid>(s, p, r + tdy[1], q + tdx[1], (r + tdy[1]) * W + q + tdx[1]);
    raw[r][2] = t == 0 ? tc_x<kAllValid>(s, p, r + 2, q + 2, (r + 2) * W + q + 2) : 0u;
  }
}

__device__ __forceinline__ void tc_conv_pack(const unsigned (&raw)[2][3], unsigned (&bf)[2][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf[r][0] = pack_bf16(raw[r][0], raw[r][1]);
    bf[r][1] = raw[r][2];
  }
}

// The conv outputs of one tile of 16 maps for the group: z[r] holds
// positions (r, 0), (r, 1) of pooled pixel t for map 16 j + g (z[r][0],
// z[r][1]) and map 16 j + g + 8 (z[r][2], z[r][3]).
__device__ __forceinline__ void tc_conv_tile(const uint4& a, const unsigned (&bf)[2][2],
                                             float (&z)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) z[r][i] = 0.f;
    mma_bf16(a, bf[r][0], bf[r][1], z[r]);
  }
}

// The window's positions of map half h (0: map g, 1: map g + 8), -inf at
// a position outside the conv output (position 0 always lies inside).
__device__ __forceinline__ void tc_window(const float (&z)[2][4], int h, const TcPixel& p,
                                          float (&v)[4]) {
  v[0] = z[0][2 * h];
  v[1] = p.v1 ? z[0][2 * h + 1] : -INFINITY;
  v[2] = p.v2 ? z[1][2 * h] : -INFINITY;
  v[3] = p.v3 ? z[1][2 * h + 1] : -INFINITY;
}

// g routed to the window's first position that reaches its largest value
// (rows, then columns: the FMA routes' first strictly greater one) where
// zmax + b > 0, as the two bf16 pairs of Gc^T that hold map half h's
// positions (0, 1) and (2, 3); 0 elsewhere.
__device__ __forceinline__ void tc_route(const float (&z)[2][4], int h, const TcPixel& p,
                                         float bias, bool live, unsigned g16, unsigned* lo,
                                         unsigned* hi) {
  float v[4];
  tc_window(z, h, p, v);
  const float zmax = max_nan(max_nan(v[0], v[1]), max_nan(v[2], v[3]));
  const unsigned gr = live && zmax + bias > 0.f ? g16 : 0u;
  const bool e0 = v[0] == zmax, e1 = v[1] == zmax, e2 = v[2] == zmax;
  *lo = e0 ? gr : e1 ? gr << 16 : 0u;
  *hi = e0 || e1 ? 0u : e2 ? gr : gr << 16;
}

// The window's largest value (K5): the value tc_route routes by.
__device__ __forceinline__ float tc_max(const float (&z)[2][4], int h, const TcPixel& p) {
  float v[4];
  tc_window(z, h, p, v);
  return max_nan(max_nan(v[0], v[1]), max_nan(v[2], v[3]));
}

}  // namespace atlasvae
