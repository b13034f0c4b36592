// K4: staged exp-domain Sinkhorn EMD between paired jets, one scalar per pair.
//
// Replaces atlasvae/ops/emd_pallas.py:_kernel (Pallas, TPU).  From two
// (B, n, 3) constituent clouds in (pt, y, phi) it computes, per jet pair,
// what atlasvae_torch/ops/emd.py:_sinkhorn_emd computes: n_stages epsilon
// stages ending at eps_final, in each the Gibbs kernel K = exp((f + g - C) /
// eps) held fixed while u = a / (K v), v = b / (K^T u) iterate from u = v = 1,
// the duals absorbed into (f, g) at the stage's end; then the masked plan,
// Altschuler rounding onto the transport polytope and
// EMD = <plan, C> * min(sum p, sum q) + |sum p - sum q|.
//
// The TPU kernel padded n to 128 lanes, blocked jets to fill its on-chip
// memory and kept the cost matrix, its transpose and both Gibbs kernels there.
// Two routes here, chosen from n by ops/emd_cuda.py `route`:
//
// * The register route (emd_tile_kernel, n <= 128).  A pair's n x n matrices
//   are cut into 2-D tiles, one a thread: thread (tr, tc) of a pair's
//   TR x TC threads holds rows tr*RA .. tr*RA + RA - 1 and columns
//   tc*CB .. tc*CB + CB - 1 of K in registers.  The cost matrix is built once
//   and kept in shared memory, each thread's tile in its own slots, for the
//   n_stages + 1 Gibbs kernels and the epilogue; the Gibbs kernels divide by
//   eps with a branch-free exact sequence (div_markstein), so a thread's 49
//   quotients interleave.  K v is a register partial a row, reduce-scattered
//   over the TC lanes of the row group by shuffles; the lane left with a
//   row's sum divides out its u and writes it to shared memory, where the
//   row group reads it back.  K^T u goes the same way over the row groups of
//   a warp and, where a pair spans warps, through shared memory in warp
//   order.  At n <= 32 a pair is one warp or half of one, several pairs a
//   CTA, and an iteration needs no barrier; at n = 100 a pair is 256
//   threads of 7 x 7 values.
// * The wide route (emd_wide_kernel, up to MAX_CONST = 233): one CTA a pair,
//   K (n x n, row stride n|1) in shared memory and one thread a row, the
//   cost matrix recomputed from the 2n coordinates whenever a stage rebuilds
//   K and in the epilogue.  Thread i sums row i of K against v (the odd row
//   stride keeps the 32 rows of a warp in 32 banks), then thread j sums
//   column j against u.
//
// Bound on an H100: the inputs are 24n bytes a pair and the output 4, against
// 4 n^2 n_iters FLOP in the iterations alone (4e6 at n = 100, 100 iterations):
// some 1,700 FLOP per byte, so operations, not bytes, bound it.  Beside the
// iterations, each of the 11 Gibbs kernels costs an IEEE division and an expf
// an element, which the FLOP bound counts as one operation each.
//
// Every sum is taken in a fixed order (in order within a thread, a fixed
// shuffle tree across lanes, warps in order), so repeated calls give the
// same bits.  Arithmetic follows the plain version: expf, logf, IEEE division and
// square root (the build has no --use_fast_math), and explicit round-to-
// nearest intrinsics where the compiler would otherwise contract a multiply
// and an add into an FMA that the plain version does not have (the cost
// matrix enters an exponent divided by eps = 0.01, which magnifies its last
// bit a hundredfold).  Both routes build each element of C and K by the same
// expressions, so they differ only in the order of their sums.
#include <cuda_runtime.h>

namespace atlasvae {

constexpr int kMaxDynamicSmem = 232448;  // 227 KB: the most one CTA can get on sm_90
constexpr int kVectors = 14;             // per-constituent arrays kept beside K
constexpr float kFloor = 1e-30f;

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

inline size_t emd_smem_bytes(int n) {
  return sizeof(float) * ((size_t)kVectors * round_up4(n) + (size_t)n * (n | 1));
}

// DeltaR / R between constituent (yp, php) and (yq, phq), phi difference
// wrapped to [-pi, pi) with a floored modulo (fmodf keeps the dividend's sign).
__device__ __forceinline__ float pair_cost(float yp, float php, float yq, float phq, float r) {
  const float kPi = 3.14159265358979323846f;
  const float kTwoPi = 6.28318530717958647692f;
  const float dy = __fsub_rn(yp, yq);
  float m = fmodf(__fadd_rn(__fsub_rn(php, phq), kPi), kTwoPi);
  if (m < 0.0f) m = __fadd_rn(m, kTwoPi);
  const float dphi = __fsub_rn(m, kPi);
  const float dr = __fsqrt_rn(__fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dphi, dphi)));
  return __fdiv_rn(dr, r);
}

// sum_j row[j] * x[j], j < n; x is 16-byte aligned and padded to a multiple of
// four with zeros, row is not aligned (odd stride).
__device__ __forceinline__ float row_dot(const float* __restrict__ row, const float* __restrict__ x,
                                         int n) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  const int n_vec = n & ~3;
  for (int j = 0; j < n_vec; j += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(x + j);
    s0 = fmaf(row[j], x4.x, s0);
    s1 = fmaf(row[j + 1], x4.y, s1);
    s2 = fmaf(row[j + 2], x4.z, s2);
    s3 = fmaf(row[j + 3], x4.w, s3);
  }
  for (int j = n_vec; j < n; ++j) s0 = fmaf(row[j], x[j], s0);
  return (s0 + s1) + (s2 + s3);
}

// sum_i col[i * ld] * x[i], i < n.
__device__ __forceinline__ float col_dot(const float* __restrict__ col, int ld,
                                         const float* __restrict__ x, int n) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  const int n_vec = n & ~3;
  for (int i = 0; i < n_vec; i += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(x + i);
    s0 = fmaf(col[i * ld], x4.x, s0);
    s1 = fmaf(col[(i + 1) * ld], x4.y, s1);
    s2 = fmaf(col[(i + 2) * ld], x4.z, s2);
    s3 = fmaf(col[(i + 3) * ld], x4.w, s3);
  }
  for (int i = n_vec; i < n; ++i) s0 = fmaf(col[i * ld], x[i], s0);
  return (s0 + s1) + (s2 + s3);
}

__global__ void __launch_bounds__(256)
emd_wide_kernel(const float* __restrict__ p, const float* __restrict__ q,
                float* __restrict__ out, int n, float r, int n_iters, int n_stages,
                double eps_final) {
  extern __shared__ __align__(16) float smem[];
  const int n4 = round_up4(n), ld = n | 1;
  float* u = smem;           // scaling vectors, zero past n
  float* v = u + n4;
  float* a = v + n4;         // normalised marginals
  float* b = a + n4;
  float* f = b + n4;         // duals
  float* g = f + n4;
  float* pt_p = g + n4;      // max(pt, 0)
  float* pt_q = pt_p + n4;
  float* y_p = pt_q + n4;
  float* phi_p = y_p + n4;
  float* y_q = phi_p + n4;
  float* phi_q = y_q + n4;
  float* err_a = phi_q + n4;
  float* err_b = err_a + n4;
  float* K = err_b + n4;     // Gibbs kernel, then the plan: n rows of stride ld

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const bool live = tid < n;
  const float* pj = p + (size_t)blockIdx.x * n * 3;
  const float* qj = q + (size_t)blockIdx.x * n * 3;

  // blockDim.x >= n4: one thread per slot, padding slots zeroed
  if (tid < n4) {
    pt_p[tid] = live ? fmaxf(pj[3 * tid], 0.0f) : 0.0f;
    y_p[tid] = live ? pj[3 * tid + 1] : 0.0f;
    phi_p[tid] = live ? pj[3 * tid + 2] : 0.0f;
    pt_q[tid] = live ? fmaxf(qj[3 * tid], 0.0f) : 0.0f;
    y_q[tid] = live ? qj[3 * tid + 1] : 0.0f;
    phi_q[tid] = live ? qj[3 * tid + 2] : 0.0f;
    f[tid] = 0.0f;
    g[tid] = 0.0f;
    u[tid] = 0.0f;
    v[tid] = 0.0f;
    err_a[tid] = 0.0f;
    err_b[tid] = 0.0f;
  }
  __syncthreads();
  // every thread takes both totals itself, in the same order
  float sum_p = 0.0f, sum_q = 0.0f;
  for (int i = 0; i < n; ++i) {
    sum_p += pt_p[i];
    sum_q += pt_q[i];
  }
  if (tid < n4) {
    a[tid] = __fdiv_rn(pt_p[tid], fmaxf(sum_p, kFloor));
    b[tid] = __fdiv_rn(pt_q[tid], fmaxf(sum_q, kFloor));
  }
  __syncthreads();

  const int base = n_iters / n_stages, rem = n_iters % n_stages;
  for (int s = 0; s < n_stages; ++s) {
    const float eps = (float)(eps_final * (1.0 + 9.0 * (1.0 - (s + 1.0) / n_stages)));
    // K = exp((f + g - C) / eps): a warp takes a row, its lanes the columns
    for (int i = warp; i < n; i += n_warps) {
      const float fi = f[i], yi = y_p[i], phii = phi_p[i];
      for (int j = lane; j < n; j += 32) {
        const float c = pair_cost(yi, phii, y_q[j], phi_q[j], r);
        K[i * ld + j] = expf(__fdiv_rn(__fsub_rn(__fadd_rn(fi, g[j]), c), eps));
      }
    }
    if (live) {
      u[tid] = 1.0f;
      v[tid] = 1.0f;
    }
    __syncthreads();
    const int iters = base + (s < rem ? 1 : 0);
    for (int it = 0; it < iters; ++it) {
      if (live) u[tid] = __fdiv_rn(a[tid], fmaxf(row_dot(K + tid * ld, v, n), kFloor));
      __syncthreads();
      if (live) v[tid] = __fdiv_rn(b[tid], fmaxf(col_dot(K + tid, ld, u, n), kFloor));
      __syncthreads();
    }
    if (live) {
      f[tid] = __fadd_rn(f[tid], __fmul_rn(eps, logf(fmaxf(u[tid], kFloor))));
      g[tid] = __fadd_rn(g[tid], __fmul_rn(eps, logf(fmaxf(v[tid], kFloor))));
    }
    __syncthreads();
  }

  // plan = exp((-C + f + g) / eps_final), zero where either constituent is dead
  const float eps_last = (float)eps_final;
  for (int i = warp; i < n; i += n_warps) {
    const float fi = f[i], yi = y_p[i], phii = phi_p[i];
    const float mask_i = pt_p[i] > 0.0f ? 1.0f : 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float c = pair_cost(yi, phii, y_q[j], phi_q[j], r);
      const float e = expf(__fdiv_rn(__fadd_rn(__fadd_rn(-c, fi), g[j]), eps_last));
      K[i * ld + j] = __fmul_rn(__fmul_rn(e, mask_i), pt_q[j] > 0.0f ? 1.0f : 0.0f);
    }
  }
  __syncthreads();
  // Altschuler rounding: rows down to their marginals, then columns, then the
  // missing mass as a rank-one term of the two deficits
  if (live) {
    float* row = K + tid * ld;
    float total = 0.0f;
    for (int j = 0; j < n; ++j) total += row[j];
    const float scale = fminf(__fdiv_rn(a[tid], fmaxf(total, kFloor)), 1.0f);
    for (int j = 0; j < n; ++j) row[j] = __fmul_rn(row[j], scale);
  }
  __syncthreads();
  if (live) {
    float* col = K + tid;
    float total = 0.0f;
    for (int i = 0; i < n; ++i) total += col[i * ld];
    const float scale = fminf(__fdiv_rn(b[tid], fmaxf(total, kFloor)), 1.0f);
    for (int i = 0; i < n; ++i) col[i * ld] = __fmul_rn(col[i * ld], scale);
  }
  __syncthreads();
  if (live) {
    float row_total = 0.0f, col_total = 0.0f;
    for (int j = 0; j < n; ++j) row_total += K[tid * ld + j];
    for (int i = 0; i < n; ++i) col_total += K[i * ld + tid];
    err_a[tid] = __fsub_rn(a[tid], row_total);
    err_b[tid] = __fsub_rn(b[tid], col_total);
  }
  __syncthreads();
  float deficit = 0.0f;
  for (int i = 0; i < n; ++i) deficit += fabsf(err_a[i]);
  deficit = fmaxf(deficit, kFloor);
  // <plan + err_a err_b^T / deficit, C>: a partial sum per row, then thread 0
  if (live) {
    const float* row = K + tid * ld;
    const float yi = y_p[tid], phii = phi_p[tid], ea = err_a[tid];
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float c = pair_cost(yi, phii, y_q[j], phi_q[j], r);
      const float plan = __fadd_rn(row[j], __fdiv_rn(__fmul_rn(ea, err_b[j]), deficit));
      acc = __fadd_rn(acc, __fmul_rn(plan, c));
    }
    u[tid] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float transport = 0.0f;
    for (int i = 0; i < n; ++i) transport += u[i];
    out[blockIdx.x] = __fadd_rn(__fmul_rn(transport, fminf(sum_p, sum_q)),
                                fabsf(__fsub_rn(sum_p, sum_q)));
  }
}


// ---------------------------------------------------------------------------
// The register route
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
// The cost of a padding slot: exp((f + g - kPadCost) / eps) is exactly 0 for
// any dual and any eps the sequence below takes, and kPadCost stays inside
// markstein_exact's range.
constexpr float kPadCost = 0x1p80f;

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

// A pair is TR x TC threads; thread t = tr * TC + tc holds K's rows
// tr*RA + a (a < RA) and columns tc*CB + b (b < CB).  A CTA holds PAIRS
// pairs, and __launch_bounds__ asks for MIN_CTAS CTAs an SM.
template <int TR_, int TC_, int RA_, int CB_, int PAIRS_, int MIN_CTAS_>
struct EmdTile {
  static constexpr int TR = TR_, TC = TC_, RA = RA_, CB = CB_;
  static constexpr int MIN_CTAS = MIN_CTAS_;
  static constexpr int G = TR * TC;                   // threads a pair
  static constexpr int NR = TR * RA, NC = TC * CB;    // rows, columns the tiles cover
  static constexpr int RV = pow2_at_least(RA), CV = pow2_at_least(CB);  // scatter widths
  static constexpr int WARPS = G < 32 ? 1 : G / 32;   // warps a pair spans
  static constexpr int LANES = G < 32 ? G : 32;       // a pair's lanes in one warp
  static constexpr int PAIRS = PAIRS_;                // pairs a CTA
  static constexpr int THREADS = G * PAIRS;
  static constexpr int PC = TC * CV;                  // a column exchange: CV slots a column group
  // floats of shared memory a pair: the cost tiles, six vectors, u and v
  // (and, across warps, the warps' partial column sums)
  static constexpr int SMEM = RA * CB * G + 3 * NR + 3 * NC + TR * RV +
                              (WARPS > 1 ? (WARPS + 1) * PC : PC);
  static_assert((TC & (TC - 1)) == 0 && (G & (G - 1)) == 0 && TC <= 32, "power-of-two lanes");
  static_assert(RV <= TC, "a row group's lanes hold a row sum each after the scatter");
  static_assert(WARPS > 1 || CV <= TR, "a warp's row groups hold a column sum each");
  static_assert(NR % 4 == 0 && NC % 4 == 0, "16-byte aligned vectors");
};

// Resident CTAs an SM (the register cap) as measured best on an H100: three
// where K leaves room, two at 8 x 8 values a thread.
using EmdTile8 = EmdTile<4, 4, 2, 2, 16, 4>;        // 16 threads a pair, two pairs a warp
using EmdTile16 = EmdTile<4, 8, 4, 2, 8, 3>;        // a warp a pair
using EmdTile20 = EmdTile<4, 8, 5, 3, 8, 3>;        // the score CLI's default jet (--n_const 20)
using EmdTile32 = EmdTile<4, 8, 8, 4, 8, 3>;
using EmdTile64 = EmdTile<8, 16, 8, 4, 2, 3>;       // four warps a pair
using EmdTile112 = EmdTile<16, 16, 7, 7, 1, 3>;     // eight warps a pair: n = 100
using EmdTile128 = EmdTile<16, 16, 8, 8, 1, 2>;

// x / d rounded to nearest for a divisor d fixed over many quotients, from
// rd = RN(1/d) by Markstein's sequence: q1 is within an ulp of x / d after
// one correction, and q1 + RN(x - d q1) rd rounds to RN(x / d) (Markstein's
// theorem; the remainders are exact by FMA).  It has no branch, so the
// compiler interleaves the quotients of a tile, where __fdiv_rn guards each
// one with a branch to its slow path.  The theorem needs the remainders
// exact and nothing to overflow: markstein_exact says where that holds (x
// and the quotient well inside the normal range, so a remainder's quantum,
// about x's ulp times 2^-23, is still representable); the caller takes
// div_ieee for the rest.
__device__ __forceinline__ float div_markstein(float x, float d, float rd) {
  const float q0 = __fmul_rn(x, rd);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, d, x), rd, q0);
  return __fmaf_rn(__fmaf_rn(-q1, d, x), rd, q1);
}

__device__ __forceinline__ bool markstein_exact(float x, float d, float quotient) {
  const float m = fabsf(x), mq = fabsf(quotient);
  return d >= 0x1p-60f && d <= 0x1p60f &&
         (x == 0.f || (m >= 0x1p-90f && m <= 0x1p100f && mq >= 0x1p-100f && mq <= 0x1p100f));
}

// markstein_exact for a divisor in [2^-10, 2^10], on x's bits alone: 0, or
// |x| in [2^-90, 2^90], so that the quotient lies in [2^-100, 2^100].
__device__ __forceinline__ bool x_in_markstein_range(float x) {
  const unsigned m = __float_as_uint(x) & 0x7fffffffu;
  return m == 0u || m - 0x12800000u <= 0x6c800000u - 0x12800000u;
}

// The rare quotient outside markstein_exact: kept out of line, so the hot
// loops stay small.
__device__ __noinline__ float div_ieee(float x, float d) { return __fdiv_rn(x, d); }

// Halving reduce-scatter of W values over the lanes xor-offsets O, O/2, ..,
// LO: a level sends the half of its values that the partner keeps and adds
// the half it keeps itself, so each sum is taken in one fixed order by one
// side; once a lane holds one value, a level adds it to its partner's, the
// same two values on both sides.  After it x[0 .. W_END - 1] hold the sums
// of values scatter_first() onwards.
template <int W, int O, int LO, int V>
__device__ __forceinline__ void scatter(float (&x)[V], int lane) {
  if constexpr (O >= LO) {
    if constexpr (W > 1) {
      constexpr int H = W / 2;
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = upper ? x[k] : x[k + H];
        const float keep = upper ? x[k + H] : x[k];
        x[k] = keep + __shfl_xor_sync(kFull, send, O);
      }
      scatter<H, O / 2, LO>(x, lane);
    } else {
      x[0] += __shfl_xor_sync(kFull, x[0], O);
      scatter<1, O / 2, LO>(x, lane);
    }
  }
}

template <int W, int O, int LO>
__device__ __forceinline__ int scatter_first(int lane) {
  if constexpr (O >= LO && W > 1)
    return ((lane & O) ? W / 2 : 0) + scatter_first<W / 2, O / 2, LO>(lane);
  else
    return 0;
}

// The offsets that a scatter of W values spends on butterflies: the lanes
// that differ only there hold the same sums.
template <int W, int O, int LO>
__host__ __device__ constexpr int scatter_twins() {
  if constexpr (O < LO) return 0;
  else if constexpr (W > 1) return scatter_twins<W / 2, O / 2, LO>();
  else return O | scatter_twins<1, O / 2, LO>();
}

template <int W, int O, int LO>
__host__ __device__ constexpr int scatter_kept() {
  if constexpr (O < LO || W == 1) return W;
  else return scatter_kept<W / 2, O / 2, LO>();
}

// W consecutive floats of shared memory, 16-byte aligned where W allows.
template <int W>
__device__ __forceinline__ void load_vec(float (&dst)[W], const float* src) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(src)[k];
      dst[4 * k] = t.x;
      dst[4 * k + 1] = t.y;
      dst[4 * k + 2] = t.z;
      dst[4 * k + 3] = t.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const float2 t = reinterpret_cast<const float2*>(src)[k];
      dst[2 * k] = t.x;
      dst[2 * k + 1] = t.y;
    }
  } else {
    dst[0] = src[0];
  }
}

// Sum over the TC lanes of a row group: every lane gets the same bits (each
// step adds the same two values on both sides).
template <int TC, int V>
__device__ __forceinline__ void sum_over_tc(float (&x)[V]) {
#pragma unroll
  for (int off = TC / 2; off > 0; off >>= 1)
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] += __shfl_xor_sync(kFull, x[v], off);
}

// Sum over all row groups of the pair (V <= CV values), in every thread; a
// pair that spans warps adds the warps' sums in warp order.
template <class T, int V>
__device__ __forceinline__ void sum_over_tr(float (&x)[V], float* part, int warp, int lane,
                                            int tc) {
  static_assert(V <= T::CV, "the exchange holds CV values a column group");
#pragma unroll
  for (int off = T::TC; off < T::LANES; off <<= 1)   // the row groups that share a warp
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] += __shfl_xor_sync(kFull, x[v], off);
  if constexpr (T::WARPS > 1) {
    __syncthreads();  // the exchange's last readers are done
    if (lane < T::TC)
#pragma unroll
      for (int v = 0; v < V; ++v) part[warp * T::PC + tc * V + v] = x[v];
    __syncthreads();
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float s = part[tc * V + v];
      for (int w = 1; w < T::WARPS; ++w) s += part[w * T::PC + tc * V + v];
      x[v] = s;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_CTAS)
emd_tile_kernel(const float* __restrict__ p, const float* __restrict__ q,
                float* __restrict__ out, long long batch, int n, float r, int n_iters,
                int n_stages, double eps_final) {
  constexpr int TR = T::TR, TC = T::TC, RA = T::RA, CB = T::CB, G = T::G, NR = T::NR, NC = T::NC;
  constexpr int RV = T::RV, CV = T::CV, PC = T::PC;
  extern __shared__ __align__(16) float smem[];
  const int tl = threadIdx.x % G, slot = threadIdx.x / G;
  const int tr = tl / TC, tc = tl % TC;
  const int lane = threadIdx.x & 31, warp = tl / 32;
  const int row0 = tr * RA, col0 = tc * CB;  // the tile's first row and column
  const long long pair = (long long)blockIdx.x * T::PAIRS + slot;
  const bool active = pair < batch;
  float* const cost = smem + (size_t)slot * T::SMEM;  // tile element (a, b) at [(a*CB + b)*G + tl]
  float* const ptp = cost + RA * CB * G;              // max(pt, 0)
  float* const av = ptp + NR;                         // normalised marginals
  float* const f = av + NR;                           // duals
  float* const ptq = f + NR;
  float* const bv = ptq + NC;
  float* const g = bv + NC;
  float* const us = g + NC;                           // u, a row group's RV slots each
  float* const part = us + TR * RV;                   // across warps: WARPS x PC partial
                                                      // column sums; in one warp: v
  float* const vfin = part + T::WARPS * PC;           // across warps: v, CV slots a column group
  const float* const pj = p + (active ? pair : 0) * n * 3;
  const float* const qj = q + (active ? pair : 0) * n * 3;

  // the constituents, zero past n; (y, phi) wait in av, f, bv, g for the
  // cost matrix
  for (int x = tl; x < NR; x += G) {
    const bool live = active && x < n;
    ptp[x] = live ? fmaxf(pj[3 * x], 0.f) : 0.f;
    av[x] = live ? pj[3 * x + 1] : 0.f;
    f[x] = live ? pj[3 * x + 2] : 0.f;
  }
  for (int x = tl; x < NC; x += G) {
    const bool live = active && x < n;
    ptq[x] = live ? fmaxf(qj[3 * x], 0.f) : 0.f;
    bv[x] = live ? qj[3 * x + 1] : 0.f;
    g[x] = live ? qj[3 * x + 2] : 0.f;
  }
  if (T::WARPS > 1)
    for (int x = tl; x < PC; x += G) vfin[x] = 0.f;  // the padding columns' v
  __syncthreads();
  // the cost matrix, once: DeltaR / R, and kPadCost outside the n x n block
#pragma unroll 1
  for (int e = 0; e < RA * CB; ++e) {
    const int i = row0 + e / CB, j = col0 + e % CB;
    cost[e * G + tl] = i < n && j < n ? pair_cost(av[i], f[i], bv[j], g[j], r) : kPadCost;
  }
  float sp[1] = {0.f}, sq[1] = {0.f};
#pragma unroll
  for (int a = 0; a < RA; ++a) sp[0] += ptp[row0 + a];
#pragma unroll
  for (int b = 0; b < CB; ++b) sq[0] += ptq[col0 + b];
  sum_over_tr<T>(sp, part, warp, lane, tc);
  sum_over_tc<TC>(sq);
  const float sum_p = sp[0], sum_q = sq[0];
  __syncthreads();  // the coordinates are read
  for (int x = tl; x < NR; x += G) {
    av[x] = __fdiv_rn(ptp[x], fmaxf(sum_p, kFloor));
    f[x] = 0.f;
  }
  for (int x = tl; x < NC; x += G) {
    bv[x] = __fdiv_rn(ptq[x], fmaxf(sum_q, kFloor));
    g[x] = 0.f;
  }
  __syncthreads();

  // After the row scatter a lane holds the sum of row my_row; one lane of
  // its twins divides out u and writes it for the row group.  After the
  // column scatter (in one warp) a lane holds column my_col's sum, and one
  // of its twins writes v; across warps the lanes keep COL_KEPT sums from
  // col_first on, and thread tl finishes column tl.
  constexpr int ROW_TWINS = scatter_twins<RV, TC / 2, 1>();
  constexpr int COL_HI = T::WARPS > 1 ? 16 : T::LANES / 2;
  constexpr int COL_TWINS = scatter_twins<CV, COL_HI, TC>();
  constexpr int COL_KEPT = scatter_kept<CV, COL_HI, TC>();
  const int ridx = scatter_first<RV, TC / 2, 1>(lane);
  const bool row_writer = (lane & ROW_TWINS) == 0;
  const int my_row = row0 + ridx;
  const bool row_owner = row_writer && ridx < RA && my_row < n;
  const int col_first = scatter_first<CV, COL_HI, TC>(lane);
  const bool col_writer = (lane & COL_TWINS) == 0;
  const int my_col = T::WARPS > 1 ? tl : col0 + col_first;
  const int col_slot = T::WARPS > 1 ? tl / CB * CV + tl % CB : tc * CV + col_first;
  const bool col_owner = (T::WARPS > 1 ? tl < NC : col_writer && col_first < CB) && my_col < n;
  const float my_a = row_owner ? av[my_row] : 0.f;
  const float my_b = col_owner ? bv[my_col] : 0.f;

  // K = exp((f + g - C) / eps) (the final plan: exp((-C + f + g) / eps),
  // masked), each sum in the plain version's order; the padding's cost makes
  // it exactly 0 outside the n x n block
  auto exponent = [](float c, float fi, float gj, bool plan) {
    return plan ? __fadd_rn(__fadd_rn(-c, fi), gj) : __fsub_rn(__fadd_rn(fi, gj), c);
  };
  float K[RA][CB];
  auto build = [&](float eps, bool plan) {
    const float reps = __frcp_rn(eps);
    const bool eps_ok = eps >= 0x1p-10f && eps <= 0x1p10f;
    float gc[CB], mc[CB];  // mc, mi: the plan's masks of dead constituents
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      gc[b] = g[col0 + b];
      mc[b] = ptq[col0 + b] > 0.f ? 1.f : 0.f;
    }
    bool redo = false;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float fi = f[row0 + a], mi = ptp[row0 + a] > 0.f ? 1.f : 0.f;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const float x = exponent(cost[(a * CB + b) * G + tl], fi, gc[b], plan);
        redo |= !x_in_markstein_range(x);
        const float e = expf(div_markstein(x, eps, reps));
        K[a][b] = plan ? __fmul_rn(__fmul_rn(e, mi), mc[b]) : e;
      }
    }
    if (redo || !eps_ok) {
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int b = 0; b < CB; ++b) {
          const float x = exponent(cost[(a * CB + b) * G + tl], f[row0 + a], gc[b], plan);
          if (eps_ok && x_in_markstein_range(x)) continue;
          const float e = row0 + a < n && col0 + b < n ? expf(div_ieee(x, eps)) : 0.f;
          const float mi = ptp[row0 + a] > 0.f ? 1.f : 0.f;
          K[a][b] = plan ? __fmul_rn(__fmul_rn(e, mi), mc[b]) : e;
        }
    }
  };

  float u[RV], v[CV];
  const int base = n_iters / n_stages, rem = n_iters % n_stages;
  for (int s = 0; s < n_stages; ++s) {
    const float eps = (float)(eps_final * (1.0 + 9.0 * (1.0 - (s + 1.0) / n_stages)));
    build(eps, false);
#pragma unroll
    for (int b = 0; b < CV; ++b) v[b] = col0 + b < n && b < CB ? 1.f : 0.f;
    float um = 1.f, vm = 1.f;
    const int iters = base + (s < rem ? 1 : 0);
    for (int it = 0; it < iters; ++it) {
      // u = a / (K v)
      float rs[RV];
#pragma unroll
      for (int a = 0; a < RV; ++a) {
        rs[a] = 0.f;
        if (a < RA)
#pragma unroll
          for (int b = 0; b < CB; ++b) rs[a] = fmaf(K[a][b], v[b], rs[a]);
      }
      scatter<RV, TC / 2, 1>(rs, lane);
      if (row_owner) um = __fdiv_rn(my_a, fmaxf(rs[0], kFloor));
      if (row_writer) us[tr * RV + ridx] = um;
      __syncwarp();
      load_vec(u, us + tr * RV);
      // v = b / (K^T u)
      float cs[CV];
#pragma unroll
      for (int b = 0; b < CV; ++b) {
        cs[b] = 0.f;
        if (b < CB)
#pragma unroll
          for (int a = 0; a < RA; ++a) cs[b] = fmaf(K[a][b], u[a], cs[b]);
      }
      scatter<CV, COL_HI, TC>(cs, lane);
      if constexpr (T::WARPS > 1) {
        if (col_writer)
#pragma unroll
          for (int k = 0; k < COL_KEPT; ++k) part[warp * PC + tc * CV + col_first + k] = cs[k];
        __syncthreads();
        if (col_owner) {
          float t = part[col_slot];
          for (int w = 1; w < T::WARPS; ++w) t += part[w * PC + col_slot];
          vm = __fdiv_rn(my_b, fmaxf(t, kFloor));
          vfin[col_slot] = vm;
        }
        __syncthreads();
        load_vec(v, vfin + tc * CV);
      } else {
        if (col_owner) vm = __fdiv_rn(my_b, fmaxf(cs[0], kFloor));
        if (col_writer) part[col_slot] = vm;
        __syncwarp();
        load_vec(v, part + tc * CV);
      }
    }
    __syncthreads();  // every lane has read f and g for this stage's K
    if (row_owner) f[my_row] = __fadd_rn(f[my_row], __fmul_rn(eps, logf(fmaxf(um, kFloor))));
    if (col_owner) g[my_col] = __fadd_rn(g[my_col], __fmul_rn(eps, logf(fmaxf(vm, kFloor))));
    __syncthreads();
  }

  // the plan at eps_final, zero where either constituent is dead; then
  // Altschuler rounding: rows down to their marginals, then columns, then the
  // missing mass as a rank-one term of the two deficits
  build((float)eps_final, true);
  float ea[RA], eb[CB];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    ea[a] = 0.f;
#pragma unroll
    for (int b = 0; b < CB; ++b) ea[a] += K[a][b];
  }
  sum_over_tc<TC>(ea);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const float scale = fminf(__fdiv_rn(av[row0 + a], fmaxf(ea[a], kFloor)), 1.f);
#pragma unroll
    for (int b = 0; b < CB; ++b) K[a][b] = __fmul_rn(K[a][b], scale);
  }
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    eb[b] = 0.f;
#pragma unroll
    for (int a = 0; a < RA; ++a) eb[b] += K[a][b];
  }
  sum_over_tr<T>(eb, part, warp, lane, tc);
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const float scale = fminf(__fdiv_rn(bv[col0 + b], fmaxf(eb[b], kFloor)), 1.f);
#pragma unroll
    for (int a = 0; a < RA; ++a) K[a][b] = __fmul_rn(K[a][b], scale);
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    ea[a] = 0.f;
#pragma unroll
    for (int b = 0; b < CB; ++b) ea[a] += K[a][b];
  }
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    eb[b] = 0.f;
#pragma unroll
    for (int a = 0; a < RA; ++a) eb[b] += K[a][b];
  }
  sum_over_tc<TC>(ea);
  sum_over_tr<T>(eb, part, warp, lane, tc);
  float deficit[1] = {0.f};
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    ea[a] = __fsub_rn(av[row0 + a], ea[a]);
    deficit[0] += fabsf(ea[a]);
  }
#pragma unroll
  for (int b = 0; b < CB; ++b) eb[b] = __fsub_rn(bv[col0 + b], eb[b]);
  sum_over_tr<T>(deficit, part, warp, lane, tc);
  const float d = fmaxf(deficit[0], kFloor), rd = __frcp_rn(d);
  // <plan + err_a err_b^T / deficit, C>: a tile at a time, then the lanes
  float acc[1] = {0.f};
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const float x = __fmul_rn(ea[a], eb[b]);
      float quot = div_markstein(x, d, rd);
      if (!markstein_exact(x, d, quot)) quot = div_ieee(x, d);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(__fadd_rn(K[a][b], quot), cost[(a * CB + b) * G + tl]));
    }
  sum_over_tc<TC>(acc);
  sum_over_tr<T>(acc, part, warp, lane, tc);
  if (active && tl == 0)
    out[pair] = __fadd_rn(__fmul_rn(acc[0], fminf(sum_p, sum_q)), fabsf(__fsub_rn(sum_p, sum_q)));
}

template <class T>
int launch_tiles(const float* p, const float* q, float* out, long long batch, int n, float r,
                 int n_iters, int n_stages, double eps_final, cudaStream_t stream) {
  if (n > T::NR || n > T::NC) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)T::SMEM * T::PAIRS;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(emd_tile_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = (batch + T::PAIRS - 1) / T::PAIRS;
  emd_tile_kernel<T><<<(unsigned)grid, T::THREADS, smem, stream>>>(p, q, out, batch, n, r,
                                                                   n_iters, n_stages, eps_final);
  return (int)cudaGetLastError();
}

}  // namespace atlasvae

// The wide route: one CTA a pair, K in shared memory, n <= MAX_CONST.
extern "C" int atlasvae_emd_sinkhorn_wide(const void* p, const void* q, void* out,
                                          long long batch, int n, float r_param, int n_iters,
                                          int n_stages, double eps_final, void* stream) {
  using namespace atlasvae;
  if (batch < 1 || batch > 2147483647LL || n < 1 || n_iters < 0 || n_stages < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = emd_smem_bytes(n);
  if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(emd_wide_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = ((n + 31) / 32) * 32;
  emd_wide_kernel<<<(unsigned)batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q), static_cast<float*>(out), n,
      r_param, n_iters, n_stages, eps_final);
  return (int)cudaGetLastError();
}

// The register route for jets of at most `tile` constituents, tile one of
// 8, 16, 20, 32, 64, 112, 128 (ops/emd_cuda.py TILES).
extern "C" int atlasvae_emd_sinkhorn_tiles(const void* p, const void* q, void* out,
                                           long long batch, int n, float r_param, int n_iters,
                                           int n_stages, double eps_final, int tile,
                                           void* stream) {
  using namespace atlasvae;
  if (batch < 1 || batch > 2147483647LL || n < 1 || n_iters < 0 || n_stages < 1)
    return (int)cudaErrorInvalidValue;
  const float* pp = static_cast<const float*>(p);
  const float* qq = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tile_type) {
    return launch_tiles<decltype(tile_type)>(pp, qq, o, batch, n, r_param, n_iters, n_stages,
                                             eps_final, s);
  };
  switch (tile) {
    case 8: return run(EmdTile8{});
    case 16: return run(EmdTile16{});
    case 20: return run(EmdTile20{});
    case 32: return run(EmdTile32{});
    case 64: return run(EmdTile64{});
    case 112: return run(EmdTile112{});
    case 128: return run(EmdTile128{});
    default: return (int)cudaErrorInvalidValue;
  }
}
