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
// f32 CUDA-core ridge (20 FLOP/byte), so it is bound by f32 FMAs.  The
// design keeps the activations in shared memory and feeds 32 FMAs from each
// three shared-memory vector loads (dense_stack.cuh).  The constituents-mode
// encoder 312->256/128/64 + 2x32 does 250 kFLOP a row, 3.7 ms of f32 work
// at 1,000,003 rows; it takes the layer-wise route (stack_layers.cuh), whose
// wide layers run on the tensor cores in 3xTF32.
#include "stack_layers.cuh"

namespace {

atlasvae::StackArgs make_args(const void* x, long long batch, int n_hidden, const int* dims,
                              const void* const* weights, const void* const* biases, int n_heads,
                              const int* head_dims, const void* const* head_weights,
                              const void* const* head_biases, void* const* outs) {
  using namespace atlasvae;
  StackArgs a = {};
  a.x = static_cast<const float*>(x);
  a.batch = batch;
  a.n_hidden = n_hidden;
  a.max_width = 0;
  for (int i = 0; i <= n_hidden; ++i) {
    a.dims[i] = dims[i];
    if (dims[i] > a.max_width) a.max_width = dims[i];
  }
  for (int i = 0; i < n_hidden; ++i) {
    a.w[i] = static_cast<const float*>(weights[i]);
    a.b[i] = static_cast<const float*>(biases[i]);
  }
  a.n_heads = n_heads;
  for (int h = 0; h < n_heads; ++h) {
    a.head_dims[h] = head_dims[h];
    a.hw[h] = static_cast<const float*>(head_weights[h]);
    a.hb[h] = static_cast<const float*>(head_biases[h]);
    a.out[h] = static_cast<float*>(outs[h]);
  }
  a.final_relu = 0;
  return a;
}

bool valid(int n_hidden, int n_heads) {
  using namespace atlasvae;
  return n_hidden >= 0 && n_hidden <= kMaxHidden && n_heads >= 1 && n_heads <= kMaxHeads;
}

}  // namespace

// The fused body: the whole stack in one launch.
extern "C" int atlasvae_stack_forward(const void* x, long long batch, int n_hidden,
                                      const int* dims, const void* const* weights,
                                      const void* const* biases, int n_heads,
                                      const int* head_dims, const void* const* head_weights,
                                      const void* const* head_biases, void* const* outs,
                                      void* stream) {
  if (!valid(n_hidden, n_heads)) return (int)cudaErrorInvalidValue;
  return (int)atlasvae::launch_dense_stack(
      make_args(x, batch, n_hidden, dims, weights, biases, n_heads, head_dims, head_weights,
                head_biases, outs),
      static_cast<cudaStream_t>(stream));
}

// The layer-wise route: the segments of ops/fused_vae.py::forward_plan.
extern "C" int atlasvae_stack_forward_layers(
    const void* x, long long batch, int n_hidden, const int* dims, const void* const* weights,
    const void* const* biases, int n_heads, const int* head_dims,
    const void* const* head_weights, const void* const* head_biases, void* const* outs,
    int n_segments, const int* segments, void* buf0, void* buf1, void* stream) {
  if (!valid(n_hidden, n_heads)) return (int)cudaErrorInvalidValue;
  return (int)atlasvae::forward_layers(
      make_args(x, batch, n_hidden, dims, weights, biases, n_heads, head_dims, head_weights,
                head_biases, outs),
      n_segments, segments, static_cast<float*>(buf0), static_cast<float*>(buf1),
      static_cast<cudaStream_t>(stream));
}
