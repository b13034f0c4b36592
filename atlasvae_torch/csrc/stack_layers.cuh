// K1 and K2's layer-wise route: a dense stack wider than the fused body
// takes well, run as the segments ops/fused_vae.py::forward_plan cuts it
// into, every launch of one forward from one host call.
//
// Why: at constituents-mode width (312 -> 256 -> 128 -> 64 + 2 x 32) the first
// fused body dropped to 32-row tiles to fit two 312-wide activation buffers,
// and restaged every layer's weights through shared memory for each of
// them: 500 KB of weights per 32 rows, with scalar loads that overlapped no
// FMA.  It ran at about 8 TFLOP/s on an H100, 4-4.5x slower
// than cuBLAS.  Here a wide layer (input or output wider than 128) is one
// row product over the whole batch on wgmma (gemm_wgmma.cuh), whose tile
// reads each weight chunk once per 128 rows, and whose output goes through
// device memory to the next segment: one round trip of the activation, as
// K3's layer-wise route accepts.  The row products' weights are first split
// into TF32 hi/lo words and transposed, every wide layer of the call in one
// pre-pass launch, into the scratch `wsplit`.  A run of narrow layers stays
// one launch of the fused body, activations on chip.
//
// A stack of any depth: a run of narrow layers is cut into fused segments of
// at most kMaxHidden hidden layers each (the fused body's StackArgs holds no
// more) and no more layers than fit one CTA of the fused body (every layer
// up to 128 x 128 does alone), which pass activations through buf0/buf1 as
// row segments do.
//
// segments: n_segments x kSegmentInts ints (kind, first layer, last layer
// exclusive, column tile, output buffer), the stack's layers counted with
// the heads as layer n_hidden; buf0/buf1: scratch of the sizes the plan
// gives; wsplit: the row segments' split weights, wg::split_floats each, in
// order.  Returns the first CUDA error.
#pragma once

#include "dense_stack.cuh"
#include "gemm_wgmma.cuh"

namespace atlasvae {

constexpr int kSegmentInts = 5;
constexpr int kFusedSegment = 0;
constexpr int kRowSegment = 1;
constexpr int kTileCols[2] = {128, 64};  // a row segment's column tile: FORWARD_TILE_COLS

// A whole stack as the caller's arrays hold it, any depth (host side only:
// each launch copies what it needs into its own bounded arguments).
struct StackView {
  const float* x;              // (batch, dims[0]) row-major
  long long batch;
  int n_hidden;
  const int* dims;             // n_hidden + 1 widths
  const float* const* w;       // n_hidden (dims[i], dims[i + 1]) row-major
  const float* const* b;
  int n_heads;
  const int* head_dims;
  const float* const* hw;      // n_heads (dims[n_hidden], head_dims[h])
  const float* const* hb;
  float* const* out;           // n_heads (batch, head_dims[h])
  int final_relu;
};

// Layers [first, last) of v as the arguments of one fused-body launch on
// input `in`: layers first .. last - 2 are its hidden layers, last - 1 its
// head, which is the stack's heads (last == n_hidden + 1) or the next hidden
// layer, written with ReLU to `out`.  False if the segment is deeper than the
// fused body takes.
inline bool fused_segment(const StackView& v, int first, int last, const float* in, float* out,
                          StackArgs* f) {
  *f = StackArgs{};
  f->x = in;
  f->batch = v.batch;
  f->n_hidden = last - first - 1;
  if (f->n_hidden < 0 || f->n_hidden > kMaxHidden) return false;
  f->max_width = 0;
  for (int i = 0; i <= f->n_hidden; ++i) {
    f->dims[i] = v.dims[first + i];
    if (f->dims[i] > f->max_width) f->max_width = f->dims[i];
  }
  for (int i = 0; i < f->n_hidden; ++i) {
    f->w[i] = v.w[first + i];
    f->b[i] = v.b[first + i];
  }
  if (last == v.n_hidden + 1) {
    f->n_heads = v.n_heads;
    for (int h = 0; h < v.n_heads; ++h) {
      f->head_dims[h] = v.head_dims[h];
      f->hw[h] = v.hw[h];
      f->hb[h] = v.hb[h];
      f->out[h] = v.out[h];
    }
    f->final_relu = v.final_relu;
  } else {
    f->n_heads = 1;
    f->head_dims[0] = v.dims[last];
    f->hw[0] = v.w[last - 1];
    f->hb[0] = v.b[last - 1];
    f->out[0] = out;
    f->final_relu = 1;
  }
  return true;
}

// The fused body over the whole stack: one launch.
inline cudaError_t forward_fused(const StackView& v, cudaStream_t st) {
  if (v.n_heads < 1 || v.n_heads > kMaxHeads) return cudaErrorInvalidValue;
  StackArgs f;
  if (!fused_segment(v, 0, v.n_hidden + 1, v.x, nullptr, &f)) return cudaErrorInvalidValue;
  return launch_dense_stack(f, st);
}

// Layer `first` of v (a hidden layer, or the heads' columns together) as
// the W side of a pre-pass entry.
inline wg::PrepLayer prep_layer(const StackView& v, int first, int bn, float* dst) {
  wg::PrepLayer p = {};
  p.k = v.dims[first];
  if (first == v.n_hidden) {
    p.nseg = v.n_heads;
    for (int h = 0; h < v.n_heads; ++h) {
      p.nbeg[h + 1] = p.nbeg[h] + v.head_dims[h];
      p.w[h] = v.hw[h];
    }
  } else {
    p.nseg = 1;
    p.nbeg[1] = v.dims[first + 1];
    p.w[0] = v.w[first];
  }
  p.n = p.nbeg[p.nseg];
  p.bn = bn;
  p.k_chunks = (p.k + wg::kBK - 1) / wg::kBK;
  p.n_pad = (p.nbeg[p.nseg] + bn - 1) / bn * bn;
  p.dst = dst;
  return p;
}

inline cudaError_t forward_layers(const StackView& v, int n_segments, const int* segments,
                                  float* buf0, float* buf1, float* wsplit, cudaStream_t st) {
  const int n_layers = v.n_hidden + 1;
  if (v.n_hidden < 0 || v.n_heads < 1 || v.n_heads > kMaxHeads) return cudaErrorInvalidValue;
  if (n_segments < 1 || n_segments > n_layers) return cudaErrorInvalidValue;
  float* const buf[2] = {buf0, buf1};
  // check the whole plan before the first launch
  int expect = 0;
  for (int s = 0; s < n_segments; ++s) {
    const int* g = segments + kSegmentInts * s;
    const bool last_segment = s == n_segments - 1;
    if (g[1] != expect || g[2] <= g[1] || g[2] > n_layers ||
        (g[0] == kFusedSegment && g[2] - g[1] - 1 > kMaxHidden) || (g[0] != kFusedSegment &&
        (g[0] != kRowSegment || g[2] != g[1] + 1 || g[3] < 0 || g[3] >= 2)) ||
        (last_segment ? g[4] != -1 : (g[4] < 0 || g[4] > 1 || buf[g[4]] == nullptr)))
      return cudaErrorInvalidValue;
    expect = g[2];
  }
  if (expect != n_layers) return cudaErrorInvalidValue;
  if (v.batch <= 0) return cudaSuccess;

  // the pre-pass: every row segment's W^T split, in segment order, kMaxPrep a launch
  wg::PrepArgs prep = {};
  float* dst = wsplit;
  for (int s = 0; s < n_segments; ++s) {
    const int* g = segments + kSegmentInts * s;
    if (g[0] != kRowSegment) continue;
    if (wsplit == nullptr) return cudaErrorInvalidValue;
    const wg::PrepLayer& l = prep.l[prep.n_layers++] = prep_layer(v, g[1], kTileCols[g[3]], dst);
    dst += wg::split_floats(l.k, l.nbeg[l.nseg], l.bn);
    if (prep.n_layers == wg::kMaxPrep) {
      const cudaError_t err = wg::launch_split(prep, st);
      if (err != cudaSuccess) return err;
      prep.n_layers = 0;
    }
  }
  if (prep.n_layers > 0) {
    const cudaError_t err = wg::launch_split(prep, st);
    if (err != cudaSuccess) return err;
  }

  const float* in = v.x;
  for (int s = 0; s < n_segments; ++s) {
    const int* g = segments + kSegmentInts * s;
    const int first = g[1], last = g[2];
    const bool heads = last == n_layers;
    float* const out = heads ? nullptr : buf[g[4]];
    cudaError_t err;
    if (g[0] == kFusedSegment) {
      StackArgs f;
      fused_segment(v, first, last, in, out, &f);
      err = launch_dense_stack(f, st);
    } else {
      // one layer: a hidden layer (bias + ReLU) or the heads' columns together
      wg::RowsArgs r = {};
      r.a[0] = in;
      r.rows = v.batch;
      r.k = v.dims[first];
      if (heads) {
        r.nseg = v.n_heads;
        for (int h = 0; h < v.n_heads; ++h) {
          r.nbeg[h + 1] = r.nbeg[h] + v.head_dims[h];
          r.bias[h] = v.hb[h];
          r.out[h] = v.out[h];
        }
        r.relu = v.final_relu;
      } else {
        r.nseg = 1;
        r.nbeg[1] = v.dims[first + 1];
        r.bias[0] = v.b[first];
        r.out[0] = out;
        r.relu = 1;
      }
      r.n = r.nbeg[r.nseg];
      r.wsplit = wsplit;
      wsplit += wg::split_floats(r.k, r.n, kTileCols[g[3]]);
      err = wg::launch_rows(kTileCols[g[3]], r, st);
    }
    if (err != cudaSuccess) return err;
    in = out;
  }
  return cudaSuccess;
}

}  // namespace atlasvae
