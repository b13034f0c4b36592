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
// f32 FMAs, not bandwidth.  The design keeps every intermediate activation in
// shared memory (no HBM round trip between layers) and gives each thread an
// 8x4 register tile, so that each pair of shared-memory loads feeds 32 FMAs.
// The constituents-mode decoder 32->64/128/256->312 (246 kFLOP a row) takes
// the layer-wise route (stack_layers.cuh), as K2's encoder does.
#include "stack_layers.cuh"

namespace {

atlasvae::StackArgs make_args(const void* x, long long batch, int n_layers, const int* dims,
                              const void* const* weights, const void* const* biases, void* out,
                              int final_relu) {
  using namespace atlasvae;
  StackArgs a = {};
  a.x = static_cast<const float*>(x);
  a.batch = batch;
  a.n_hidden = n_layers - 1;
  a.max_width = 0;
  for (int i = 0; i < n_layers; ++i) {
    a.dims[i] = dims[i];
    if (dims[i] > a.max_width) a.max_width = dims[i];
  }
  for (int i = 0; i < a.n_hidden; ++i) {
    a.w[i] = static_cast<const float*>(weights[i]);
    a.b[i] = static_cast<const float*>(biases[i]);
  }
  a.n_heads = 1;
  a.head_dims[0] = dims[n_layers];
  a.hw[0] = static_cast<const float*>(weights[n_layers - 1]);
  a.hb[0] = static_cast<const float*>(biases[n_layers - 1]);
  a.out[0] = static_cast<float*>(out);
  a.final_relu = final_relu;
  return a;
}

}  // namespace

// The fused body: the whole stack in one launch.
extern "C" int atlasvae_fused_mlp_forward(const void* x, long long batch, int n_layers,
                                          const int* dims, const void* const* weights,
                                          const void* const* biases, void* out, int final_relu,
                                          void* stream) {
  using namespace atlasvae;
  if (n_layers < 1 || n_layers > kMaxHidden + 1) return (int)cudaErrorInvalidValue;
  return (int)launch_dense_stack(
      make_args(x, batch, n_layers, dims, weights, biases, out, final_relu),
      static_cast<cudaStream_t>(stream));
}

// The layer-wise route: the segments of ops/fused_vae.py::forward_plan.
extern "C" int atlasvae_fused_mlp_forward_layers(const void* x, long long batch, int n_layers,
                                                 const int* dims, const void* const* weights,
                                                 const void* const* biases, void* out,
                                                 int final_relu, int n_segments,
                                                 const int* segments, void* buf0, void* buf1,
                                                 void* stream) {
  using namespace atlasvae;
  if (n_layers < 1 || n_layers > kMaxHidden + 1) return (int)cudaErrorInvalidValue;
  return (int)forward_layers(make_args(x, batch, n_layers, dims, weights, biases, out, final_relu),
                             n_segments, segments, static_cast<float*>(buf0),
                             static_cast<float*>(buf1), static_cast<cudaStream_t>(stream));
}
