// K2: stack forward with n linear heads (the VAE encoder on the scoring
// path, and again for the Latent metric; every training forward).
//
// Replaces atlasvae/ops/fused_vae.py:_stack_fwd_kernel (Pallas, TPU): a
// ReLU hidden stack, then n_heads linear heads on the last hidden
// activation.  The TPU kernel padded every width to 128 lanes and wrote
// each head to its own padded block; here the heads are computed as one
// concatenated layer (mean|logvar share the read of the last activation)
// and each head's columns are written straight to its own output.
//
// Bound on an H100: the canonical encoder 12->80->40->20, heads 2x(20->10),
// does 2*(12*80 + 80*40 + 40*20 + 2*20*10) = 10,720 FLOP per row against
// 128 bytes of HBM traffic (48 in, 80 out), about 84 FLOP/byte: above the
// f32 CUDA-core ridge (20 FLOP/byte), so it is bound by operations.  The
// fused body (dense_stack.cuh) keeps a warp's rows in registers through every
// layer and runs the products on the tensor cores in 3xTF32, the weights on
// chip once a persistent CTA.  The constituents-mode
// encoder 312->256/128/64 + 2x32 does 250 kFLOP a row, 3.7 ms of f32 work
// at 1,000,003 rows; it takes the layer-wise route (stack_layers.cuh), whose
// wide layers run on the tensor cores in 3xTF32.
#include "stack_layers.cuh"

namespace {

atlasvae::StackView make_view(const void* x, long long batch, int n_hidden, const int* dims,
                              const void* const* weights, const void* const* biases, int n_heads,
                              const int* head_dims, const void* const* head_weights,
                              const void* const* head_biases, void* const* outs) {
  atlasvae::StackView v = {};
  v.x = static_cast<const float*>(x);
  v.batch = batch;
  v.n_hidden = n_hidden;
  v.dims = dims;
  v.w = reinterpret_cast<const float* const*>(weights);
  v.b = reinterpret_cast<const float* const*>(biases);
  v.n_heads = n_heads;
  v.head_dims = head_dims;
  v.hw = reinterpret_cast<const float* const*>(head_weights);
  v.hb = reinterpret_cast<const float* const*>(head_biases);
  v.out = reinterpret_cast<float* const*>(outs);
  v.final_relu = 0;
  return v;
}

}  // namespace

// The fused body: the whole stack in one launch (at most kMaxHidden hidden layers).
extern "C" int atlasvae_stack_forward(const void* x, long long batch, int n_hidden,
                                      const int* dims, const void* const* weights,
                                      const void* const* biases, int n_heads,
                                      const int* head_dims, const void* const* head_weights,
                                      const void* const* head_biases, void* const* outs,
                                      void* stream) {
  return (int)atlasvae::forward_fused(
      make_view(x, batch, n_hidden, dims, weights, biases, n_heads, head_dims, head_weights,
                head_biases, outs),
      static_cast<cudaStream_t>(stream));
}

// The layer-wise route: the segments of ops/fused_vae.py::forward_plan, any depth.
extern "C" int atlasvae_stack_forward_layers(
    const void* x, long long batch, int n_hidden, const int* dims, const void* const* weights,
    const void* const* biases, int n_heads, const int* head_dims,
    const void* const* head_weights, const void* const* head_biases, void* const* outs,
    int n_segments, const int* segments, void* buf0, void* buf1, void* wsplit,
    void* stream) {
  return (int)atlasvae::forward_layers(
      make_view(x, batch, n_hidden, dims, weights, biases, n_heads, head_dims, head_weights,
                head_biases, outs),
      n_segments, segments, static_cast<float*>(buf0), static_cast<float*>(buf1),
      static_cast<float*>(wsplit), static_cast<cudaStream_t>(stream));
}
