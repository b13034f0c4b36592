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
// items whose maps do not fit one tile walk the tiles in turn.  Both kernels
// sum the taps of a conv pixel with the same chain of FMAs, so the backward
// sees the bits the forward pooled.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace atlasvae {

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

struct ConvArgs {
  ConvShape s;
  ConvPlan p;
  const float* x;    // (N, H, W, C)
  const float* w;    // (K, M)
  const float* b;    // (M,)
  float* out;        // forward: (N, Ho, Wo, M)
  const float* g;    // backward: (N, Ho, Wo, M)
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
__device__ __forceinline__ void conv_stage_rows(const ConvArgs& a, const ConvItem& it,
                                                float* xs) {
  const ConvShape& s = a.s;
  const int len = it.rows * s.WC;
  for (int img = 0; img < it.nb; ++img) {
    const float* src = a.x + ((size_t)(it.n0 + img) * s.H + it.ylo) * s.WC;
    float* dst = xs + (size_t)img * a.p.rows_in * s.WC;
    for (int i = threadIdx.x; i < len; i += kConvThreads) dst[i] = __ldg(src + i);
  }
}

// Maps m0 .. m0 + mcur of the weights -> ws[k * mt + m].
__device__ __forceinline__ void conv_stage_weights(const ConvArgs& a, int m0, int mcur,
                                                   float* ws) {
  const int mt = a.p.mt;
  for (int i = threadIdx.x; i < a.s.K * mcur; i += kConvThreads) {
    const int k = i / mcur, m = i - k * mcur;
    ws[k * mt + m] = __ldg(a.w + (size_t)k * a.s.M + m0 + m);
  }
}

// The pooled pixel (oy, ox) of one staged image for the map at ws + m: the
// largest conv output of its window and the conv pixel (*by, *bx) of the
// first position that reaches it, scanning rows then columns.  The taps are
// summed in (dy, dx, c) order, one FMA each.
__device__ __forceinline__ float conv_pool_pixel(const ConvShape& s, const float* xs_img,
                                                 int ylo, int oy, int ox, const float* wm,
                                                 int mt, int* by, int* bx) {
  float best = -INFINITY;
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
      if (acc > best) {   // strictly: a later tie does not take over
        best = acc;
        *by = y;
        *bx = x0;
      }
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

}  // namespace atlasvae
