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
// * The register route (conv_pool_relu_tiles_kernel): 3x3 taps, one
//   channel, a 2x2 pool and at most 128 maps, the jet-ID CNN's first block.
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
// Both sum each conv pixel's taps with the same chain of FMAs, from 0 in
// (dy, dx, c) order, and keep the first position of the window that reaches
// the maximum (rows, then columns, strictly greater), as K6
// (fused_conv_bwd.cu) recomputes them.
//
// Both routes come in float and in bf16 (the _bf16 entry points; x, w, b
// and out all bf16): bf16 is widened to float where it is loaded, the sums,
// the pool, the bias and the clamp run in float as the Pallas kernel's f32
// accumulation does, and the output is rounded once to bf16 where it is
// stored (fused_conv.cuh `narrow`).  The register route then writes four
// maps as one 8-byte store.  At the jet-ID training batch in bf16 the bytes
// halve (x 2.6 MB, out 49 MB: 0.015 ms at 3.35 TB/s) and the float work
// bounds it (0.026 ms at 67 TFLOP/s).
//
// Bound on an H100 at the jet-ID training batch (5,000 x 16x16x1, 3x3, 100
// maps, pool 2x2): 5.1 MB read, 98 MB written, 1.8 GFLOP: the write bounds
// it (0.03 ms at 3.35 TB/s; 0.026 ms of f32 work at 67 TFLOP/s).  The
// pre-pool block (392 MB) never exists.
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
        conv_pixel_of(s, it, o / mcur, &img, &oy, &ox);
        const float z = conv_pool_pixel(s, xs + img * img_stride, it.ylo, oy, ox, ws + m,
                                        p.mt, &by, &bx);
        a.out[(((size_t)(it.n0 + img) * s.Ho + oy) * s.Wo + ox) * s.M + m0 + m] =
            narrow<T>(fmaxf(z + load_widened(a.b + m0 + m), 0.f));
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
    float patch[4][4], best[4];
    int at[4];
    tile_load_patch(x + (size_t)(rest / Ho) * H * W, H, W, y0, x0, vec2, patch);
    tile_pool_window(patch, wr, Hc, Wc, y0, x0, best, at);
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = fmaxf(best[j] + br[j], 0.f);
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
  return atlasvae::conv_forward_tiles<atlasvae::bf16>(x, w, b, out, N, H, W, M, stream);
}
