// Maxima, minima and ReLU that carry a NaN, as XLA's max and min do (the
// JAX package's jnp.maximum / jnp.minimum / jax.nn.relu).  fmaxf(x, y) and
// fminf(x, y) return the other operand where one is a NaN, so fmaxf(z, 0)
// turned a NaN pre-activation into 0 and fmaxf(s, 1e-30) a NaN sum into the
// floor.  PTX max.NaN / min.NaN (sm_80 and later) is one instruction, as
// fmaxf is (FMNMX with .NAN in the SASS): a NaN operand gives the canonical
// NaN, 0x7FFFFFFF.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace atlasvae {

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float relu_nan(float v) { return max_nan(v, 0.f); }

}  // namespace atlasvae
