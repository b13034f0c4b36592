// K5: the jet-ID towers' input block in one pass,
//   out = relu(maxpool_SAME(conv2d_VALID(x, w)) + b),
// writing only the pooled block.
//
// Replaces atlasvae/ops/fused_conv.py:112 _fwd_kernel (Pallas, TPU).  That
// kernel built an im2col patch matrix per conv row and fed the matrix unit;
// its layout (W on the lane axis, K and M padded to the tile) is the TPU's
// and has no place here.  Here a CTA takes work items of a few images by a
// band of pooled rows (fused_conv.cuh), keeps their input rows and a tile of
// the weights in shared memory, and a thread owns one (pooled pixel, map)
// at a time: it sums the taps of every conv pixel of the window, keeps the
// largest, adds the bias and clamps at 0.  Maps run fastest over the
// threads, so a warp reads one broadcast input word and consecutive weights
// per FMA and writes consecutive output words.
//
// Bound on an H100 at the jet-ID training batch (5,000 x 16x16x1, 3x3, 100
// maps, pool 2x2): 5.1 MB read, 98 MB written, 1.8 GFLOP: the write bounds
// it (0.03 ms at 3.35 TB/s; 0.026 ms of f32 work at 67 TFLOP/s).  The
// pre-pool block (392 MB) never exists.  Two shared-memory loads per FMA keep
// this kernel at a fraction of the f32 peak: register tiles over the window
// and the maps are the next step.
#include "fused_conv.cuh"

namespace atlasvae {

__global__ void __launch_bounds__(kConvThreads)
conv_pool_relu_kernel(const __grid_constant__ ConvArgs a) {
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
            fmaxf(z + __ldg(a.b + m0 + m), 0.f);
      }
    }
  }
}

}  // namespace atlasvae

// out (N, Ho, Wo, M).  Returns 0, a cudaError, -1 for a shape outside the
// gate (K = kh*kw*C <= 512, M <= 1024, the kernel inside the image) or -2
// when one pooled row of one image does not fit a CTA's shared memory.
extern "C" int atlasvae_conv_pool_relu(const void* x, const void* w, const void* b, void* out,
                                       int N, int H, int W, int C, int kh, int kw, int M, int ph,
                                       int pw, void* stream) {
  using namespace atlasvae;
  ConvArgs a = {};
  if (!conv_shape(N, H, W, C, kh, kw, M, ph, pw, &a.s)) return -1;
  if (!conv_plan(a.s, false, &a.p)) return -2;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.out = static_cast<float*>(out);
  cudaError_t err = cudaFuncSetAttribute(conv_pool_relu_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)a.p.smem);
  if (err != cudaSuccess) return (int)err;
  const long long cap = 132 * 8;  // 8 CTAs of 256 threads fill an SM; a constant, not the card's
  const int grid = (int)(a.p.items < cap ? a.p.items : cap);
  conv_pool_relu_kernel<<<grid, kConvThreads, a.p.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
