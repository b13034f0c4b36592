// K5: the jet-ID towers' input block in one pass,
//   out = relu(maxpool_SAME(conv2d_VALID(x, w)) + b),
// writing only the pooled block.
//
// Replaces atlasvae/ops/fused_conv.py:112 _fwd_kernel (Pallas, TPU).  That
// kernel built an im2col patch matrix per conv row and fed the matrix unit;
// its layout (W on the lane axis, K and M padded to the tile) is the TPU's
// and has no place here.  Two routes, chosen from the shape by
// ops/fused_conv_cuda.py `route`:
//
// * The register route (conv_pool_relu_tiles_kernel in float; its bf16 form
//   below): 3x3 taps, one channel, a 2x2 pool and at most 128 maps, the
//   jet-ID CNN's first block.
//   A thread keeps the 9 taps and the bias of four consecutive maps in
//   registers, loaded once, and walks a few pooled pixels: it loads the
//   pixel's 4x4 input patch into registers once, sums the four conv pixels
//   of the window for its four maps from them, keeps the largest of each,
//   adds the bias, clamps at 0 and writes the four maps as one 16-byte
//   store.  Threads run over the maps first, then the pixels, so a warp
//   writes consecutive words of the channels-last output.
// * The band route (conv_pool_relu_kernel), every other shape the gate takes
//   (more channels, other taps and pools, up to 1024 maps): a CTA takes work
//   items of a few images by a band of pooled rows (fused_conv.cuh), keeps
//   their input rows and a tile of the weights in shared memory, and a
//   thread owns one (pooled pixel, map) at a time, reading both operands of
//   each FMA from shared memory.
//
// In float both sum each conv pixel's taps with the same chain of FMAs,
// from 0 in (dy, dx, c) order, and keep the first position of the window
// that reaches the maximum (rows, then columns, strictly greater), as K6
// (fused_conv_bwd.cu) recomputes them.  A NaN is carried as XLA carries it
// (nan_math.cuh): a NaN conv output is its window's value, and the ReLU
// keeps it.
//
// Bound on an H100 at the jet-ID training batch (5,000 x 16x16x1, 3x3, 100
// maps, pool 2x2), float: 5.1 MB read, 98 MB written, 1.8 GFLOP: the write
// bounds it (0.03 ms at 3.35 TB/s; 0.026 ms of f32 work at 67 TFLOP/s).  The
// pre-pool block (392 MB) never exists.
//
// bf16 (the _bf16 entry points; x, w, b and out all bf16).  The band route
// widens each bf16 value to float where it loads it and runs as in float,
// rounding the output once to bf16 where it stores it (fused_conv.cuh
// `narrow`).  The register route's bf16 form is a kernel of its own,
// conv_pool_relu_tc_kernel, for the tensor cores (fused_conv.cuh, tc_*).
// What bounds it: at the jet-ID training batch the bytes halve (x 2.6 MB,
// out 49 MB: 0.0154 ms at 3.35 TB/s), and its 1.76 GFLOP of products take
// 0.026 ms on the f32 CUDA cores, so an FMA form cannot reach the byte
// bound; on the bf16 tensor cores they take 2 us.  The design: an implicit
// GEMM, mma.sync m16n8k16 (bf16 in, f32 sums) with the 9 taps padded to 16;
// each lane ends with the four window positions of its pooled pixel, so the
// pool, the bias and the clamp run in its registers; the weights' fragments
// sit in registers, loaded once; each warp gathers 16 pooled pixels x M
// maps in shared memory and writes them with 16-byte stores; a group's
// input loads go out a group ahead, to device memory through L1 (x is 5% of
// the bytes: a CTA's span of x staged in shared memory by cp.async, with
// two barriers a step of 128 pooled pixels, measured 18-29% slower).  What
// holds it now is instruction issue
// (a few hundred a group of four pooled pixels, most of them the pool and
// the stores' staging), at about twice the byte bound (PERF.md §6).  The
// pool keeps the largest value only (max.NaN): K6 picks the same value, and
// its position, from the same products.
#include <cstdint>

#include "fused_conv.cuh"

namespace atlasvae {

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv_pool_relu_kernel(const __grid_constant__ ConvArgs<T> a) {
  extern __shared__ float smem[];
  const ConvShape& s = a.s;
  const ConvPlan& p = a.p;
  float* const ws = smem;
  float* const xs = smem + (size_t)s.K * p.mt;
  const size_t img_stride = (size_t)p.rows_in * s.WC;
  bool weights_staged = false;

  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
    const ConvItem it = conv_item(s, p, item);
    __syncthreads();  // the previous item is done with xs
    conv_stage_rows(a, it, xs);
    for (int tile = 0; tile < p.n_mtiles; ++tile) {
      const int m0 = tile * p.mt;
      const int mcur = min(p.mt, s.M - m0);
      if (p.n_mtiles > 1 || !weights_staged) {
        __syncthreads();  // the previous tile is done with ws
        conv_stage_weights(a, m0, mcur, ws);
        weights_staged = true;
      }
      __syncthreads();
      const int total = it.npix * mcur;
      for (int o = threadIdx.x; o < total; o += kConvThreads) {
        const int m = o % mcur;
        int img, oy, ox, by, bx;
        float total;
        conv_pixel_of(s, it, o / mcur, &img, &oy, &ox);
        const float z = conv_pool_pixel(s, xs + img * img_stride, it.ylo, oy, ox, ws + m,
                                        p.mt, &by, &bx, &total);
        a.out[(((size_t)(it.n0 + img) * s.Ho + oy) * s.Wo + ox) * s.M + m0 + m] =
            narrow<T>(relu_nan(z + load_widened(a.b + m0 + m)));
      }
    }
  }
}

// The register route (fused_conv.cuh: kTileMaps, the tile_* helpers).
// blockDim (map groups, pixel slots): thread (mg, slot) takes maps
// 4 mg .. 4 mg + 3 of pooled pixels first + k * slots, k < kTilePixels.
constexpr int kTilePixels = 8;

template <typename T>
__global__ void __launch_bounds__(256)
conv_pool_relu_tiles_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ b, T* __restrict__ out, int H, int W,
                            int M, int Ho, int Wo, int pixels, bool vec2, bool vec4) {
  const int m0 = 4 * threadIdx.x;
  const int Hc = H - 2, Wc = W - 2;
  float wr[9][4], br[4];
  tile_load_weights(w, b, M, m0, wr, br);
  const int first = blockIdx.x * blockDim.y * kTilePixels + threadIdx.y;
#pragma unroll 2
  for (int k = 0; k < kTilePixels; ++k) {
    const int pix = first + k * blockDim.y;
    if (pix >= pixels) break;
    const int ox = pix % Wo, rest = pix / Wo;
    const int oy = rest % Ho;
    const int y0 = 2 * oy, x0 = 2 * ox;
    float patch[4][4], best[4], total;
    int at[4];
    tile_load_patch(x + (size_t)(rest / Ho) * H * W, H, W, y0, x0, vec2, patch);
    tile_pool_window<false>(patch, wr, Hc, Wc, y0, x0, best, at, total);
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = relu_nan(best[j] + br[j]);
    T* dst = out + (size_t)pix * M + m0;
    if (vec4) {
      store_quad(dst, o);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + j < M) dst[j] = narrow<T>(o[j]);
    }
  }
}

// The bf16 register route on the tensor cores (fused_conv.cuh, tc_*).  Warp
// v of the grid takes chunks v, v + warps, ... of 16 pooled pixels (four
// groups of four); a chunk's pooled block (16 x M bf16, contiguous in out)
// is gathered in the warp's slice of shared memory and written with 16-byte
// stores.  Each group's input loads are issued a group ahead, and each
// tile's products one tile ahead of its pool.  A lane holds its A fragments
// and biases of every tile in registers (48 of them): two CTAs an SM, but no
// shared-memory load a tile.
template <bool kAllValid>
__global__ void __launch_bounds__(32 * kTcWarps, 2)
conv_pool_relu_tc_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                         const unsigned short* __restrict__ b, unsigned short* __restrict__ out,
                         const TcShape s, bool vec) {
  __shared__ TcWeights tw;
  __shared__ __align__(16) unsigned short stage[kTcWarps][kTcChunk * kTileMaps];
  tc_stage_weights(w, b, s.M, &tw);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  unsigned short* const st = stage[warp];
  int tdy[2], tdx[2];
  tc_lane_taps(lane, tdy, tdx);
  const int n_chunks = (s.pixels + kTcChunk - 1) / kTcChunk, stride = gridDim.x * kTcWarps;
  int chunk = blockIdx.x * kTcWarps + warp;
  uint4 wa[kTcMTiles];
  float2 wb[kTcMTiles];
#pragma unroll
  for (int j = 0; j < kTcMTiles; ++j) {
    wa[j] = tw.a[j][lane];
    wb[j] = tw.bias[j][lane];
  }
  unsigned raw[2][3];
  tc_conv_load<kAllValid>(s, tc_pixel<kAllValid>(x, s, chunk * kTcChunk + g / 2), g % 2, t, tdy,
                          tdx, raw);
  for (; chunk < n_chunks; chunk += stride) {
    const int c0 = chunk * kTcChunk;
#pragma unroll 1
    for (int grp = 0; grp < kTcChunk / 4; ++grp) {
      const int p0 = c0 + 4 * grp;
      unsigned bf[2][2];
      tc_conv_pack(raw, bf);
      const int next = grp + 1 < kTcChunk / 4 ? p0 + 4 : (chunk + stride) * kTcChunk;
      tc_conv_load<kAllValid>(s, tc_pixel<kAllValid>(x, s, next + g / 2), g % 2, t, tdy, tdx,
                              raw);
      const TcPixel pe = tc_pixel<kAllValid>(x, s, p0 + t);
      unsigned short* const row = st + (4 * grp + t) * s.M;
      float z[2][4];
      tc_conv_tile(wa[0], bf, z);
#pragma unroll
      for (int j = 0; j < kTcMTiles; ++j) {
        if (j >= s.n_mtiles) break;
        float zn[2][4];   // the next tile's products, in flight during this tile's pool
        tc_conv_tile(wa[j + 1 < kTcMTiles ? j + 1 : j], bf, zn);
        const float2 bias = wb[j];
        const unsigned o = bf16x2_bits(relu_nan(tc_max(z, 0, pe) + bias.x),
                                       relu_nan(tc_max(z, 1, pe) + bias.y));
        const int m = 16 * j + g;
        if (m < s.M) row[m] = (unsigned short)(o & 0xffffu);
        if (m + 8 < s.M) row[m + 8] = (unsigned short)(o >> 16);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) z[r][i] = zn[r][i];
      }
    }
    __syncwarp();
    // the chunk's rows -> out; a chunk starts 32 M bytes into out, so on a
    // 16-byte aligned out the 16-byte words line up
    const int n = min(kTcChunk, s.pixels - c0) * s.M;
    unsigned short* const dst = out + (size_t)c0 * s.M;
    int done = 0;
    if (vec) {
      const uint4* src4 = reinterpret_cast<const uint4*>(st);
      uint4* dst4 = reinterpret_cast<uint4*>(dst);
      for (int i = lane; i < n / 8; i += 32) dst4[i] = src4[i];
      done = n / 8 * 8;
    }
    for (int i = done + lane; i < n; i += 32) dst[i] = st[i];
    __syncwarp();
  }
}

// The band route: out (N, Ho, Wo, M).  Returns 0, a cudaError, -1 for a
// shape outside the gate (K = kh*kw*C <= 512, M <= 1024, the kernel inside
// the image) or -2 when one pooled row of one image does not fit a CTA's
// shared memory.
template <typename T>
int conv_forward_bands(const void* x, const void* w, const void* b, void* out, int N, int H,
                       int W, int C, int kh, int kw, int M, int ph, int pw, void* stream) {
  ConvArgs<T> a = {};
  if (!conv_shape(N, H, W, C, kh, kw, M, ph, pw, &a.s)) return -1;
  if (!conv_plan(a.s, false, &a.p)) return -2;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.b = static_cast<const T*>(b);
  a.out = static_cast<T*>(out);
  cudaError_t err = cudaFuncSetAttribute(conv_pool_relu_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)a.p.smem);
  if (err != cudaSuccess) return (int)err;
  const long long cap = 132 * 8;  // 8 CTAs of 256 threads fill an SM; a constant, not the card's
  const int grid = (int)(a.p.items < cap ? a.p.items : cap);
  conv_pool_relu_kernel<T><<<grid, kConvThreads, a.p.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The register route: x (N, H, W, 1), w (3, 3, 1, M), out (N, Ho, Wo, M)
// for a 2x2 pool.  Returns 0, a cudaError, or -1 for a shape it does not
// take (M above 128, an image smaller than the taps, 2^31 pooled pixels).
template <typename T>
int conv_forward_tiles(const void* x, const void* w, const void* b, void* out, int N, int H,
                       int W, int M, void* stream) {
  if (N < 1 || H < 3 || W < 3 || M < 1 || M > kTileMaps) return -1;
  const int Ho = (H - 2 + 1) / 2, Wo = (W - 2 + 1) / 2;
  const long long pixels = (long long)N * Ho * Wo;
  if (pixels > 2147483647LL - 256LL * kTilePixels) return -1;
  const int groups = (M + 3) / 4;
  const int slots = 256 / groups;
  const long long per_cta = (long long)slots * kTilePixels;
  const long long grid = (pixels + per_cta - 1) / per_cta;
  const bool vec2 = W % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const bool vec4 = M % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  conv_pool_relu_tiles_kernel<T><<<(unsigned)grid, dim3(groups, slots), 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), H, W, M, Ho, Wo, (int)pixels, vec2, vec4);
  return (int)cudaGetLastError();
}

// The bf16 register route: as conv_forward_tiles, on the tensor cores.  The
// grid fills the card once, two CTAs an SM (__launch_bounds__; each CTA
// stages the weights once); the output does not depend on it.
inline int conv_forward_tc(const void* x, const void* w, const void* b, void* out, int N, int H,
                           int W, int M, void* stream) {
  TcShape s;
  if (!tc_shape(N, H, W, M, &s)) return -1;
  const bool all_valid = H % 2 == 0 && W % 2 == 0;   // Hc and Wc even
  int sms;
  const int err = tc_device_setup(&conv_pool_relu_tc_kernel<true>,
                                  &conv_pool_relu_tc_kernel<false>, 0, &sms);
  if (err) return err;
  const long long n_chunks = (s.pixels + kTcChunk - 1) / kTcChunk;
  const long long need = (n_chunks + kTcWarps - 1) / kTcWarps;
  const int grid = (int)(need < 2LL * sms ? need : 2LL * sms);
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* xs = static_cast<const unsigned short*>(x);
  const auto* ws = static_cast<const unsigned short*>(w);
  const auto* bs = static_cast<const unsigned short*>(b);
  auto* os = static_cast<unsigned short*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (all_valid)
    conv_pool_relu_tc_kernel<true><<<grid, 32 * kTcWarps, 0, st>>>(xs, ws, bs, os, s, vec);
  else
    conv_pool_relu_tc_kernel<false><<<grid, 32 * kTcWarps, 0, st>>>(xs, ws, bs, os, s, vec);
  return (int)cudaGetLastError();
}

}  // namespace atlasvae

// The entry points: float (x, w, b, out all float32) and _bf16 (all bf16),
// the band route and the register route of each, with the returns above.
extern "C" int atlasvae_conv_pool_relu(const void* x, const void* w, const void* b, void* out,
                                       int N, int H, int W, int C, int kh, int kw, int M, int ph,
                                       int pw, void* stream) {
  return atlasvae::conv_forward_bands<float>(x, w, b, out, N, H, W, C, kh, kw, M, ph, pw,
                                             stream);
}

extern "C" int atlasvae_conv_pool_relu_bf16(const void* x, const void* w, const void* b,
                                            void* out, int N, int H, int W, int C, int kh,
                                            int kw, int M, int ph, int pw, void* stream) {
  return atlasvae::conv_forward_bands<atlasvae::bf16>(x, w, b, out, N, H, W, C, kh, kw, M, ph,
                                                      pw, stream);
}

extern "C" int atlasvae_conv_pool_relu_tiles(const void* x, const void* w, const void* b,
                                             void* out, int N, int H, int W, int M,
                                             void* stream) {
  return atlasvae::conv_forward_tiles<float>(x, w, b, out, N, H, W, M, stream);
}

extern "C" int atlasvae_conv_pool_relu_tiles_bf16(const void* x, const void* w, const void* b,
                                                  void* out, int N, int H, int W, int M,
                                                  void* stream) {
  return atlasvae::conv_forward_tc(x, w, b, out, N, H, W, M, stream);
}
