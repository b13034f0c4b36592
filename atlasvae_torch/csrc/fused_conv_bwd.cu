// K6: backward of K5, the weight and bias gradients of
//   out = relu(maxpool_SAME(conv2d_VALID(x, w)) + b)
// for the gradient g of out.  The input gets none: this block reads data.
//
// Replaces atlasvae/ops/fused_conv.py:130 _bwd_kernel (Pallas, TPU).  That
// kernel summed dW/db into output blocks revisited by a grid that runs in
// order on one core.  Here CTAs run in parallel and in no order, so, as in
// fused_vae_bwd.cu:
//   * the grid is at most kMaxParts CTAs (a constant, not the card's SM
//     count); CTA i takes work items i, i + grid, ... and sums into its own
//     slice of a scratch buffer, each element by one thread (no float
//     atomics);
//   * a second kernel adds the slices in slice order.
// So the result is the same bits on every call and every card.
//
// Per work item (a few images by a band of pooled rows, fused_conv.cuh) and
// tile of maps:
//   1. a thread per (pooled pixel, map) recomputes the window's conv outputs
//      with K5's own chain of FMAs, finds the largest and the first position
//      that reaches it (rows, then columns: XLA's select-and-scatter order),
//      masks g by zmax + b > 0, and leaves the routed gradient and the
//      offset of that position's patch in shared memory;
//   2. a thread per (tap, map) walks the item's pixels in order and sums
//      patch[tap] * gradient; a thread per map sums the gradient for db.
//
// Bound on an H100 at the jet-ID training batch (5,000 x 16x16x1, 3x3, 100
// maps, pool 2x2): x 5.1 MB and g 98 MB read, 3.6 KB written; 1.8 GFLOP of
// recompute and 0.44 GFLOP of dW (one FMA per pooled pixel, tap and map):
// the read of g bounds it (0.031 ms at 3.35 TB/s; 0.033 ms of f32 work at
// 67 TFLOP/s).  Step 2 spends three shared-memory loads on an FMA; tiling it
// over taps in registers is the next step.
#include "fused_conv.cuh"

namespace atlasvae {

constexpr int kMaxParts = 264;  // partial slices: 2 per SM of an H100, fixed
constexpr long long kMaxScratch = 1LL << 25;  // floats of scratch (128 MB) at most

__global__ void __launch_bounds__(kConvThreads)
conv_pool_relu_bwd_kernel(const __grid_constant__ ConvArgs a) {
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
        if (by >= 0 && zmax + __ldg(a.b + m0 + m) > 0.f)
          gr = __ldg(a.g + (((size_t)(it.n0 + img) * s.Ho + oy) * s.Wo + ox) * s.M + m0 + m);
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

// out[i] = sum over slices j = 0, 1, ... of partial[j][i], in slice order.
__global__ void conv_reduce_partials(const float* __restrict__ partial, int n_parts,
                                     int n_params, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  float sum = 0.f;
  for (int j = 0; j < n_parts; ++j) sum += partial[(size_t)j * n_params + i];
  out[i] = sum;
}

inline int conv_bwd_prepare(int N, int H, int W, int C, int kh, int kw, int M, int ph, int pw,
                            ConvArgs* a) {
  if (!conv_shape(N, H, W, C, kh, kw, M, ph, pw, &a->s)) return -1;
  if (!conv_plan(a->s, true, &a->p)) return -2;
  long long parts = a->p.items < kMaxParts ? a->p.items : kMaxParts;
  const long long room = kMaxScratch / (a->s.K * a->s.M + a->s.M);
  if (parts > room) parts = room;   // room >= 63 at the widest shape of the gate
  return (int)parts;
}

}  // namespace atlasvae

// Number of partial slices (rows of the scratch buffer) the backward uses
// at this shape; -1 for a shape outside the gate, -2 when one pooled row of
// one image does not fit a CTA's shared memory.
extern "C" int atlasvae_conv_backward_parts(int N, int H, int W, int C, int kh, int kw, int M,
                                            int ph, int pw) {
  atlasvae::ConvArgs a = {};
  return atlasvae::conv_bwd_prepare(N, H, W, C, kh, kw, M, ph, pw, &a);
}

// grads: dW (K*M floats, the (kh, kw, C, M) layout) followed by db (M);
// partial: (n_parts, K*M + M) scratch with n_parts from
// atlasvae_conv_backward_parts.  Returns 0, a cudaError or the negative
// codes above.
extern "C" int atlasvae_conv_backward(const void* x, const void* w, const void* b, const void* g,
                                      void* partial, int n_parts, void* grads, int N, int H,
                                      int W, int C, int kh, int kw, int M, int ph, int pw,
                                      void* stream) {
  using namespace atlasvae;
  ConvArgs a = {};
  const int parts = conv_bwd_prepare(N, H, W, C, kh, kw, M, ph, pw, &a);
  if (parts < 0) return parts;
  if (parts != n_parts) return (int)cudaErrorInvalidValue;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.g = static_cast<const float*>(g);
  a.partial = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(conv_pool_relu_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)a.p.smem);
  if (err != cudaSuccess) return (int)err;
  conv_pool_relu_bwd_kernel<<<parts, kConvThreads, a.p.smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_params = a.s.K * a.s.M + a.s.M;
  conv_reduce_partials<<<(n_params + 255) / 256, 256, 0, s>>>(a.partial, parts, n_params,
                                                               static_cast<float*>(grads));
  return (int)cudaGetLastError();
}
