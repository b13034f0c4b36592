// K1: fused dense-stack forward (the VAE decoder on the scoring path).
//
// Replaces atlasvae/ops/fused_mlp.py:_kernel (Pallas, TPU): ReLU hidden
// layers, then a linear or ReLU final layer, with the running activation
// kept on chip.  On the TPU the widths were padded to 128 lanes and the
// batch to 512-row tiles; here the kernel masks the ragged last tile and
// every width itself (dense_stack.cuh).
//
// Bound on an H100: the canonical decoder 10->20->40->80->12 does
// 2*(10*20 + 20*40 + 40*80 + 80*12) = 10,320 FLOP per row against 88 bytes
// of HBM traffic (40 in, 48 out), about 117 FLOP/byte: above the f32
// CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte), so it is bound by
// operations, not bandwidth.  The fused body (dense_stack.cuh) keeps every
// intermediate activation of a warp's 16 rows in registers (no HBM round trip
// between layers) and runs the products on the tensor cores in 3xTF32.
// The constituents-mode decoder 32->64/128/256->312 (246 kFLOP a row) takes
// the layer-wise route (stack_layers.cuh), as K2's encoder does.
#include "stack_layers.cuh"

namespace {

// The stack's last layer is its one head.  `out` must outlive the view.
atlasvae::StackView make_view(const void* x, long long batch, int n_layers, const int* dims,
                              const void* const* weights, const void* const* biases,
                              float* const* out, int final_relu) {
  atlasvae::StackView v = {};
  v.x = static_cast<const float*>(x);
  v.batch = batch;
  v.n_hidden = n_layers - 1;
  v.dims = dims;
  v.w = reinterpret_cast<const float* const*>(weights);
  v.b = reinterpret_cast<const float* const*>(biases);
  v.n_heads = 1;
  v.head_dims = dims + n_layers;
  v.hw = v.w + v.n_hidden;
  v.hb = v.b + v.n_hidden;
  v.out = out;
  v.final_relu = final_relu;
  return v;
}

}  // namespace

// The fused body: the whole stack in one launch (at most kMaxHidden + 1 layers).
extern "C" int atlasvae_fused_mlp_forward(const void* x, long long batch, int n_layers,
                                          const int* dims, const void* const* weights,
                                          const void* const* biases, void* out, int final_relu,
                                          void* stream) {
  if (n_layers < 1) return (int)cudaErrorInvalidValue;
  float* const outs[1] = {static_cast<float*>(out)};
  return (int)atlasvae::forward_fused(
      make_view(x, batch, n_layers, dims, weights, biases, outs, final_relu),
      static_cast<cudaStream_t>(stream));
}

// The layer-wise route: the segments of ops/fused_vae.py::forward_plan, any depth.
extern "C" int atlasvae_fused_mlp_forward_layers(const void* x, long long batch, int n_layers,
                                                 const int* dims, const void* const* weights,
                                                 const void* const* biases, void* out,
                                                 int final_relu, int n_segments,
                                                 const int* segments, void* buf0, void* buf1,
                                                 void* wsplit, void* stream) {
  if (n_layers < 1) return (int)cudaErrorInvalidValue;
  float* const outs[1] = {static_cast<float*>(out)};
  return (int)atlasvae::forward_layers(
      make_view(x, batch, n_layers, dims, weights, biases, outs, final_relu), n_segments,
      segments, static_cast<float*>(buf0), static_cast<float*>(buf1),
      static_cast<float*>(wsplit), static_cast<cudaStream_t>(stream));
}
