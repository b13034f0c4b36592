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
// Both routes recompute each pooled pixel's window with K5's own chain of
// FMAs, keep the first position that reaches the largest value (rows, then
// columns: XLA's select-and-scatter order), mask g by zmax + b > 0 and add
// g times that position's input patch to dW and g to db.  Two routes, chosen
// from the shape by ops/fused_conv_cuda.py `route`, as K5's are:
//
// * The register route (conv_pool_relu_bwd_tiles_kernel): 3x3 taps, one
//   channel, a 2x2 pool and at most 128 maps, the jet-ID CNN's first block.
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
// Both routes come in float and in bf16 (the _bf16 entry points; x, w, b
// and g all bf16): each bf16 value is widened to float where it is loaded,
// g too, the recompute, the mask and every sum run in float exactly as in
// the float kernels, and the partial slices stay float; conv_reduce_partials
// rounds each finished dW and db element once to bf16, the dtype of w and
// b, as the Pallas kernel's wrapper casts its float sums back.
//
// Bound on an H100 at the jet-ID training batch (5,000 x 16x16x1, 3x3, 100
// maps, pool 2x2): x 5.1 MB and g 98 MB read, 4 KB written: 0.031 ms at 3.35
// TB/s; 1.91 GFLOP to recompute and pool the conv, 0.47 GFLOP for dW and
// db: 0.0355 ms at 67 TFLOP/s of f32.  Operations bound it, not g's read.
#include <cstdint>

#include "fused_conv.cuh"

namespace atlasvae {

constexpr int kMaxParts = 264;  // the band route's partial slices at most
constexpr long long kMaxScratch = 1LL << 25;  // floats of scratch (128 MB) at most

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
        conv_pixel_of(s, it, pix, &img, &oy, &ox);
        const float zmax = conv_pool_pixel(s, xs + (size_t)img * img_stride, it.ylo, oy, ox,
                                           ws + m, p.mt, &by, &bx);
        float gr = 0.f;
        if (by >= 0 && zmax + load_widened(a.b + m0 + m) > 0.f)
          gr = load_widened(a.g + (((size_t)(it.n0 + img) * s.Ho + oy) * s.Wo + ox) * s.M + m0 +
                            m);
        gz[pix * p.mt + m] = gr;
        // a masked pixel points at the item's first patch: 0 * finite = 0
        patch[pix * p.mt + m] =
            gr != 0.f ? img * img_stride + (by - it.ylo) * s.WC + bx * s.C : 0;
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
    float patch[4][4], best[4];
    int at[4];
    tile_load_patch(x + (size_t)img * H * W, H, W, y0, x0, vec2, patch);
    tile_pool_window(patch, wr, Hc, Wc, y0, x0, best, at);
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

}  // namespace atlasvae

// Number of partial slices (rows of the scratch buffer) the band route uses
// at this shape, in float and bf16 alike; -1 for a shape outside the gate,
// -2 when one pooled row of one image does not fit a CTA's shared memory.
extern "C" int atlasvae_conv_backward_parts(int N, int H, int W, int C, int kh, int kw, int M,
                                            int ph, int pw) {
  atlasvae::ConvArgs<float> a = {};
  return atlasvae::conv_bwd_prepare(N, H, W, C, kh, kw, M, ph, pw, &a);
}

// The register route's partial slices at x (N, H, W, 1), w (3, 3, 1, M),
// in float and bf16 alike, or -1 for a shape it does not take (M above 128,
// an image smaller than the taps, 2^31 pooled pixels).
extern "C" int atlasvae_conv_backward_tiles_parts(int N, int H, int W, int M) {
  int groups, slots, per_thread;
  return atlasvae::conv_tiles_plan(N, H, W, M, &groups, &slots, &per_thread);
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
  return atlasvae::conv_backward_tiles<atlasvae::bf16>(x, w, b, g, partial, n_parts, grads, N,
                                                       H, W, M, stream);
}
