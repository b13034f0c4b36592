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
// The TPU kernel padded n to 128 lanes (any n), blocked jets to fill its
// on-chip memory and kept the cost matrix, its transpose and both Gibbs
// kernels there.  Three routes here, chosen from n by ops/emd_cuda.py `route`:
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
// * The cluster route (the same kernel, 128 < n <= 352): a pair is one
//   thread-block cluster of CLUSTER = 2, 4 or 8 CTAs, CTA `rank` holding rows
//   rank*NR .. rank*NR + NR - 1 and every column, as the register route's
//   tiles (at most 66 values a thread), with those rows of the cost matrix
//   built once in its shared memory.  A row lies inside one CTA, so K v is
//   the register route's reduce-scatter unchanged.  K^T u: each CTA sums its
//   column partials over its warps and stores them into every CTA's copy of
//   a small exchange through distributed shared memory (st.async, each store
//   counted on the receiving CTA's mbarrier); a CTA waits on its own
//   mbarrier alone, not on a cluster barrier, then adds the CTAs' partials in
//   rank order, so every CTA holds the same v bit for bit and no v is sent
//   back.  The exchange has two halves used in turn: a CTA sends into a half
//   again only after it has received every CTA's next exchange, which each
//   CTA sends after reading that half.  The totals over rows (sum p, the
//   plan's column sums, the deficit, the transport) cross the cluster the
//   same way.
// * The wide route (emd_wide_kernel, any n): one CTA of 256 threads a pair,
//   K and the per-constituent vectors in a scratch buffer in device memory
//   that the wrapper allocates, loops over rows (a warp a row) and columns (a
//   thread a column), the cost matrix recomputed from the coordinates
//   whenever a stage rebuilds K and in the epilogue.  It is there to be
//   right at every width; the register and cluster routes are the fast ones.
//
// Bound on an H100: the inputs are 24n bytes a pair and the output 4, against
// 4 n^2 n_iters FLOP in the iterations alone (4e6 at n = 100, 100 iterations):
// some 1,700 FLOP per byte, so operations, not bytes, bound it.  Beside the
// iterations, each of the 11 Gibbs kernels costs an IEEE division and an expf
// an element, which the FLOP bound counts as one operation each.
//
// Every sum is taken in a fixed order (in order within a thread, a fixed
// shuffle tree across lanes, warps in order, a cluster's CTAs in rank order),
// so repeated calls give the same bits.  Arithmetic follows the plain version:
// expf, logf, IEEE division and square root (the build has no
// --use_fast_math), and explicit round-to-nearest intrinsics where the
// compiler would otherwise contract a multiply and an add into an FMA that the
// plain version does not have (the cost matrix enters an exponent divided by
// eps = 0.01, which magnifies its last bit a hundredfold).  Every route builds
// each element of C and K by the same expressions, so they differ only in the
// order of their sums.  Its maxima, minima and floors carry a NaN as the
// plain version's clamps do (nan_math.cuh): a NaN or infinite pt or
// coordinate gives the plain version's NaN EMD, not a finite one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "nan_math.cuh"

namespace cg = cooperative_groups;

namespace atlasvae {

constexpr int kVectors = 14;             // per-constituent arrays of the wide route
constexpr int kWideThreads = 256;
constexpr float kFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// Floats of device scratch a pair of the wide route: the vectors, then K.
__host__ __device__ inline size_t wide_scratch_floats(int n) {
  return (size_t)kVectors * round_up4(n) + (size_t)n * n;
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

// Sum over a warp's lanes by a fixed xor tree: every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// The wide route
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWideThreads)
emd_wide_kernel(const float* __restrict__ p, const float* __restrict__ q,
                float* __restrict__ out, float* scratch, int n, float r, int n_iters,
                int n_stages, double eps_final) {
  const int n4 = round_up4(n);
  float* const u = scratch + (size_t)blockIdx.x * wide_scratch_floats(n);  // zero past n
  float* const v = u + n4;
  float* const a = v + n4;         // normalised marginals
  float* const b = a + n4;
  float* const f = b + n4;         // duals
  float* const g = f + n4;
  float* const pt_p = g + n4;      // max(pt, 0)
  float* const pt_q = pt_p + n4;
  float* const y_p = pt_q + n4;
  float* const phi_p = y_p + n4;
  float* const y_q = phi_p + n4;
  float* const phi_q = y_q + n4;
  float* const err_a = phi_q + n4;
  float* const err_b = err_a + n4;
  float* const K = err_b + n4;     // Gibbs kernel, then the plan: n x n, row-major
  __shared__ float deficit_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_threads = blockDim.x, n_warps = n_threads >> 5;
  const float* pj = p + (size_t)blockIdx.x * n * 3;
  const float* qj = q + (size_t)blockIdx.x * n * 3;
  auto row_of = [&](int i) { return K + (size_t)i * n; };

  for (int x = tid; x < n4; x += n_threads) {
    const bool live = x < n;
    pt_p[x] = live ? max_nan(pj[3 * x], 0.0f) : 0.0f;
    y_p[x] = live ? pj[3 * x + 1] : 0.0f;
    phi_p[x] = live ? pj[3 * x + 2] : 0.0f;
    pt_q[x] = live ? max_nan(qj[3 * x], 0.0f) : 0.0f;
    y_q[x] = live ? qj[3 * x + 1] : 0.0f;
    phi_q[x] = live ? qj[3 * x + 2] : 0.0f;
    f[x] = g[x] = u[x] = v[x] = err_a[x] = err_b[x] = 0.0f;
  }
  __syncthreads();
  // every thread takes both totals itself, in the same order
  float sum_p = 0.0f, sum_q = 0.0f;
  for (int i = 0; i < n; ++i) {
    sum_p += pt_p[i];
    sum_q += pt_q[i];
  }
  for (int x = tid; x < n4; x += n_threads) {
    a[x] = __fdiv_rn(pt_p[x], max_nan(sum_p, kFloor));
    b[x] = __fdiv_rn(pt_q[x], max_nan(sum_q, kFloor));
  }
  __syncthreads();

  const int base = n_iters / n_stages, rem = n_iters % n_stages;
  for (int s = 0; s < n_stages; ++s) {
    const float eps = (float)(eps_final * (1.0 + 9.0 * (1.0 - (s + 1.0) / n_stages)));
    // K = exp((f + g - C) / eps): a warp takes a row, its lanes the columns
    for (int i = warp; i < n; i += n_warps) {
      const float fi = f[i], yi = y_p[i], phii = phi_p[i];
      float* const row = row_of(i);
      for (int j = lane; j < n; j += 32) {
        const float c = pair_cost(yi, phii, y_q[j], phi_q[j], r);
        row[j] = expf(__fdiv_rn(__fsub_rn(__fadd_rn(fi, g[j]), c), eps));
      }
    }
    for (int x = tid; x < n; x += n_threads) u[x] = v[x] = 1.0f;
    __syncthreads();
    const int iters = base + (s < rem ? 1 : 0);
    for (int it = 0; it < iters; ++it) {
      for (int i = warp; i < n; i += n_warps) {
        const float* const row = row_of(i);
        float acc = 0.0f;
        for (int j = lane; j < n; j += 32) acc = fmaf(row[j], v[j], acc);
        acc = warp_sum(acc);
        if (lane == 0) u[i] = __fdiv_rn(a[i], max_nan(acc, kFloor));
      }
      __syncthreads();
      for (int j = tid; j < n; j += n_threads) {
        float acc = 0.0f;
        for (int i = 0; i < n; ++i) acc = fmaf(row_of(i)[j], u[i], acc);
        v[j] = __fdiv_rn(b[j], max_nan(acc, kFloor));
      }
      __syncthreads();
    }
    for (int x = tid; x < n; x += n_threads) {
      f[x] = __fadd_rn(f[x], __fmul_rn(eps, logf(max_nan(u[x], kFloor))));
      g[x] = __fadd_rn(g[x], __fmul_rn(eps, logf(max_nan(v[x], kFloor))));
    }
    __syncthreads();
  }

  // plan = exp((-C + f + g) / eps_final), zero where either constituent is dead
  const float eps_last = (float)eps_final;
  for (int i = warp; i < n; i += n_warps) {
    const float fi = f[i], yi = y_p[i], phii = phi_p[i];
    const float mask_i = pt_p[i] > 0.0f ? 1.0f : 0.0f;
    float* const row = row_of(i);
    for (int j = lane; j < n; j += 32) {
      const float c = pair_cost(yi, phii, y_q[j], phi_q[j], r);
      const float e = expf(__fdiv_rn(__fadd_rn(__fadd_rn(-c, fi), g[j]), eps_last));
      row[j] = __fmul_rn(__fmul_rn(e, mask_i), pt_q[j] > 0.0f ? 1.0f : 0.0f);
    }
  }
  __syncthreads();
  // Altschuler rounding: rows down to their marginals, then columns, then the
  // missing mass as a rank-one term of the two deficits
  for (int i = warp; i < n; i += n_warps) {
    float* const row = row_of(i);
    float total = 0.0f;
    for (int j = lane; j < n; j += 32) total += row[j];
    const float scale = min_nan(__fdiv_rn(a[i], max_nan(warp_sum(total), kFloor)), 1.0f);
    for (int j = lane; j < n; j += 32) row[j] = __fmul_rn(row[j], scale);
  }
  __syncthreads();
  for (int j = tid; j < n; j += n_threads) {
    float total = 0.0f;
    for (int i = 0; i < n; ++i) total += row_of(i)[j];
    const float scale = min_nan(__fdiv_rn(b[j], max_nan(total, kFloor)), 1.0f);
    for (int i = 0; i < n; ++i) row_of(i)[j] = __fmul_rn(row_of(i)[j], scale);
  }
  __syncthreads();
  for (int i = warp; i < n; i += n_warps) {
    const float* const row = row_of(i);
    float total = 0.0f;
    for (int j = lane; j < n; j += 32) total += row[j];
    total = warp_sum(total);
    if (lane == 0) err_a[i] = __fsub_rn(a[i], total);
  }
  for (int j = tid; j < n; j += n_threads) {
    float total = 0.0f;
    for (int i = 0; i < n; ++i) total += row_of(i)[j];
    err_b[j] = __fsub_rn(b[j], total);
  }
  __syncthreads();
  if (tid == 0) {
    float deficit = 0.0f;
    for (int i = 0; i < n; ++i) deficit += fabsf(err_a[i]);
    deficit_total = max_nan(deficit, kFloor);
  }
  __syncthreads();
  const float deficit = deficit_total;
  // <plan + err_a err_b^T / deficit, C>: a partial sum per row, then thread 0
  for (int i = warp; i < n; i += n_warps) {
    const float* const row = row_of(i);
    const float yi = y_p[i], phii = phi_p[i], ea = err_a[i];
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float c = pair_cost(yi, phii, y_q[j], phi_q[j], r);
      const float plan = __fadd_rn(row[j], __fdiv_rn(__fmul_rn(ea, err_b[j]), deficit));
      acc = __fadd_rn(acc, __fmul_rn(plan, c));
    }
    acc = warp_sum(acc);
    if (lane == 0) u[i] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float transport = 0.0f;
    for (int i = 0; i < n; ++i) transport += u[i];
    out[blockIdx.x] = __fadd_rn(__fmul_rn(transport, min_nan(sum_p, sum_q)),
                                fabsf(__fsub_rn(sum_p, sum_q)));
  }
}


// ---------------------------------------------------------------------------
// The register route and the cluster route
// ---------------------------------------------------------------------------

// The cost of a padding slot: exp((f + g - kPadCost) / eps) is exactly 0 for
// any dual and any eps the sequence below takes, and kPadCost stays inside
// markstein_exact's range.
constexpr float kPadCost = 0x1p80f;

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

// A pair is TR x TC threads a CTA, in CLUSTER CTAs; thread t = tr * TC + tc
// of CTA `rank` holds K's rows rank*NR + tr*RA + a (a < RA) and columns
// tc*CB + b (b < CB).  A CTA holds PAIRS pairs (one in a cluster), and
// __launch_bounds__ asks for MIN_CTAS CTAs an SM.
template <int TR_, int TC_, int RA_, int CB_, int PAIRS_, int MIN_CTAS_, int CLUSTER_ = 1>
struct EmdTile {
  static constexpr int TR = TR_, TC = TC_, RA = RA_, CB = CB_;
  static constexpr int MIN_CTAS = MIN_CTAS_, CLUSTER = CLUSTER_;
  static constexpr int G = TR * TC;                   // threads a pair a CTA
  static constexpr int NR = TR * RA, NC = TC * CB;    // rows, columns the tiles cover
  static constexpr int RV = pow2_at_least(RA), CV = pow2_at_least(CB);  // scatter widths
  static constexpr int WARPS = G < 32 ? 1 : G / 32;   // warps a pair spans
  static constexpr int LANES = G < 32 ? G : 32;       // a pair's lanes in one warp
  static constexpr int PAIRS = PAIRS_;                // pairs a CTA
  static constexpr int THREADS = G * PAIRS;
  static constexpr int PC = TC * CV;                  // a column exchange: CV slots a column group
  static constexpr int OWN = (NC + G - 1) / G;        // columns a thread finishes, across warps
  static constexpr int WIDEST = NC < CLUSTER * NR ? NC : CLUSTER * NR;  // the widest jet
  // floats of shared memory a pair: the cost tiles, six vectors, u and v
  // (and, across warps, the warps' partial column sums; in a cluster, the
  // two halves of the CTAs' exchange)
  static constexpr int SMEM = RA * CB * G + 3 * NR + 3 * NC + TR * RV +
                              (WARPS > 1 ? (WARPS + 1) * PC : PC) +
                              (CLUSTER > 1 ? 2 * CLUSTER * PC + 4 : 0);
  static_assert((TC & (TC - 1)) == 0 && (G & (G - 1)) == 0 && TC <= 32, "power-of-two lanes");
  static_assert(RV <= TC, "a row group's lanes hold a row sum each after the scatter");
  static_assert(WARPS > 1 || CV <= TR, "a warp's row groups hold a column sum each");
  static_assert(NR % 4 == 0 && NC % 4 == 0, "16-byte aligned vectors");
  static_assert(CLUSTER == 1 || (PAIRS == 1 && WARPS > 1), "a cluster holds one pair in warps");
  static_assert(OWN == 1 || WARPS > 1, "in one warp a lane finishes one column");
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
// The cluster route: CTAs a pair and the widest jet each takes
// (ops/emd_cuda.py CLUSTERS).  Rows are split over the CTAs, every CTA holds
// every column.
using EmdCluster2 = EmdTile<16, 16, 6, 11, 1, 2, 2>;  // 96 rows x 176 columns a CTA: n <= 176
using EmdCluster4 = EmdTile<8, 32, 8, 8, 1, 2, 4>;    // 64 x 256: n <= 256 (255: uint8 counts)
using EmdCluster8 = EmdTile<8, 32, 6, 11, 1, 1, 8>;   // 48 x 352: n <= 352
static_assert(EmdCluster2::WIDEST == 176 && EmdCluster4::WIDEST == 256 &&
              EmdCluster8::WIDEST == 352, "ops/emd_cuda.py CLUSTERS");

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

// A cluster's exchange: two halves of CLUSTER x PC floats, CTA k's values
// at [k * PC, (k + 1) * PC) of a half, and an mbarrier a half in this CTA's
// shared memory (bar: the first one's shared address), each half's phase
// parity a bit of `phases`.
struct Exchange {
  float* xch;
  unsigned bar;
  int half;
  unsigned phases;
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of the same shared memory location in the cluster's CTA `rank`.
__device__ __forceinline__ unsigned in_cta(unsigned address, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(address), "r"(rank));
  return out;
}

// Sum over the cluster's CTAs, in rank order, of each CTA's x[v] at slot
// at[v] of the exchange (no slot where at[v] < 0).  The threads that
// `publish` store their values into every CTA's copy of the current half,
// each CTA `sent` values into each; thread 0 of every CTA expects the
// cluster's CLUSTER * sent stores on its own mbarrier, every thread waits for
// them there and adds the CTAs' values from its own copy, so every CTA gets
// the same bits.
template <class T, int V>
__device__ __forceinline__ void cluster_sum(float (&x)[V], const int (&at)[V], bool publish,
                                            int sent, Exchange& ex) {
  const int rank = (int)cg::this_cluster().block_rank();
  float* const mine = ex.xch + ex.half * T::CLUSTER * T::PC;
  const unsigned bar = ex.bar + 8u * ex.half;
  if (threadIdx.x == 0)
    asm volatile("{\n .reg .b64 state;\n"
                 " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
                 :: "r"(bar), "r"(4u * T::CLUSTER * sent) : "memory");
  if (publish) {
    const unsigned base = shared_address(mine + rank * T::PC);
#pragma unroll 1
    for (int k = 0; k < T::CLUSTER; ++k) {
      const unsigned theirs = in_cta(base, k), their_bar = in_cta(bar, k);
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (at[v] >= 0)
          asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
                       :: "r"(theirs + 4u * at[v]), "f"(x[v]), "r"(their_bar) : "memory");
    }
  }
  // a lost store would hang the card: trap after some seconds instead
  const unsigned parity = (ex.phases >> ex.half) & 1u;
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (tries > (1u << 26)) __trap();
  }
  ex.phases ^= 1u << ex.half;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (at[v] >= 0) {
      float s = mine[at[v]];
      for (int k = 1; k < T::CLUSTER; ++k) s += mine[k * T::PC + at[v]];
      x[v] = s;
    }
  ex.half ^= 1;
}

// Sum over all row groups of the pair (V <= CV values), in every thread; a
// pair that spans warps adds the warps' sums in warp order, a cluster the
// CTAs' sums in rank order.
template <class T, int V>
__device__ __forceinline__ void sum_over_tr(float (&x)[V], float* part, int warp, int lane,
                                            int tc, Exchange& ex) {
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
  if constexpr (T::CLUSTER > 1) {
    int at[V];
#pragma unroll
    for (int v = 0; v < V; ++v) at[v] = tc * V + v;
    cluster_sum<T>(x, at, warp == 0 && lane < T::TC, T::TC * V, ex);
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_CTAS)
emd_tile_kernel(const float* __restrict__ p, const float* __restrict__ q,
                float* __restrict__ out, long long batch, int n, float r, int n_iters,
                int n_stages, double eps_final) {
  constexpr int TR = T::TR, TC = T::TC, RA = T::RA, CB = T::CB, G = T::G, NR = T::NR, NC = T::NC;
  constexpr int RV = T::RV, CV = T::CV, PC = T::PC, OWN = T::OWN;
  extern __shared__ __align__(16) float smem[];
  const int tl = threadIdx.x % G, slot = threadIdx.x / G;
  const int tr = tl / TC, tc = tl % TC;
  const int lane = threadIdx.x & 31, warp = tl / 32;
  const int row0 = tr * RA, col0 = tc * CB;  // the tile's first row (of this CTA's) and column
  // a cluster's CTA `rank` holds rows rank*NR onwards, n_rows of them live
  const int rank = T::CLUSTER > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long pair = T::CLUSTER > 1 ? (long long)(blockIdx.x / T::CLUSTER)
                                        : (long long)blockIdx.x * T::PAIRS + slot;
  const int n_rows = n - rank * NR;
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
  Exchange ex = {vfin + PC, 0u, 0, 0u};               // in a cluster: 2 halves x CLUSTER x PC,
  if constexpr (T::CLUSTER > 1)                       // then their mbarriers
    ex.bar = shared_address(ex.xch + 2 * T::CLUSTER * PC);
  const float* const pj = p + ((active ? pair : 0) * n + rank * NR) * 3;  // this CTA's rows
  const float* const qj = q + (active ? pair : 0) * n * 3;

  // the constituents, zero past n; (y, phi) wait in av, f, bv, g for the
  // cost matrix
  for (int x = tl; x < NR; x += G) {
    const bool live = active && x < n_rows;
    ptp[x] = live ? max_nan(pj[3 * x], 0.f) : 0.f;
    av[x] = live ? pj[3 * x + 1] : 0.f;
    f[x] = live ? pj[3 * x + 2] : 0.f;
  }
  for (int x = tl; x < NC; x += G) {
    const bool live = active && x < n;
    ptq[x] = live ? max_nan(qj[3 * x], 0.f) : 0.f;
    bv[x] = live ? qj[3 * x + 1] : 0.f;
    g[x] = live ? qj[3 * x + 2] : 0.f;
  }
  if (T::WARPS > 1)
    for (int x = tl; x < PC; x += G) vfin[x] = 0.f;  // the padding columns' v
  if constexpr (T::CLUSTER > 1) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   "mbarrier.init.shared::cta.b64 [%1], 1;\n"
                   "fence.mbarrier_init.release.cluster;"
                   :: "r"(ex.bar), "r"(ex.bar + 8u) : "memory");
    }
    cg::this_cluster().sync();  // every CTA runs, its mbarriers set, before any store to it
  } else {
    __syncthreads();
  }
  // the cost matrix, once: DeltaR / R, and kPadCost outside the n x n block
#pragma unroll 1
  for (int e = 0; e < RA * CB; ++e) {
    const int i = row0 + e / CB, j = col0 + e % CB;
    cost[e * G + tl] = i < n_rows && j < n ? pair_cost(av[i], f[i], bv[j], g[j], r) : kPadCost;
  }
  float sp[1] = {0.f}, sq[1] = {0.f};
#pragma unroll
  for (int a = 0; a < RA; ++a) sp[0] += ptp[row0 + a];
#pragma unroll
  for (int b = 0; b < CB; ++b) sq[0] += ptq[col0 + b];
  sum_over_tr<T>(sp, part, warp, lane, tc, ex);
  sum_over_tc<TC>(sq);
  const float sum_p = sp[0], sum_q = sq[0];
  __syncthreads();  // the coordinates are read
  for (int x = tl; x < NR; x += G) {
    av[x] = __fdiv_rn(ptp[x], max_nan(sum_p, kFloor));
    f[x] = 0.f;
  }
  for (int x = tl; x < NC; x += G) {
    bv[x] = __fdiv_rn(ptq[x], max_nan(sum_q, kFloor));
    g[x] = 0.f;
  }
  __syncthreads();

  // After the row scatter a lane holds the sum of row my_row; one lane of
  // its twins divides out u and writes it for the row group.  After the
  // column scatter (in one warp) a lane holds column my_col's sum, and one
  // of its twins writes v; across warps the lanes keep COL_KEPT sums from
  // col_first on, and thread tl finishes columns tl, tl + G, ...
  constexpr int ROW_TWINS = scatter_twins<RV, TC / 2, 1>();
  constexpr int COL_HI = T::WARPS > 1 ? 16 : T::LANES / 2;
  constexpr int COL_TWINS = scatter_twins<CV, COL_HI, TC>();
  constexpr int COL_KEPT = scatter_kept<CV, COL_HI, TC>();
  const int ridx = scatter_first<RV, TC / 2, 1>(lane);
  const bool row_writer = (lane & ROW_TWINS) == 0;
  const int my_row = row0 + ridx;
  const bool row_owner = row_writer && ridx < RA && my_row < n_rows;
  const int col_first = scatter_first<CV, COL_HI, TC>(lane);
  const bool col_writer = (lane & COL_TWINS) == 0;
  int my_col[OWN], col_slot[OWN];
  bool col_owner[OWN];
  float my_b[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int c = tl + o * G;
    my_col[o] = T::WARPS > 1 ? c : col0 + col_first;
    col_slot[o] = T::WARPS > 1 ? c / CB * CV + c % CB : tc * CV + col_first;
    col_owner[o] = (T::WARPS > 1 ? c < NC : col_writer && col_first < CB) && my_col[o] < n;
    my_b[o] = col_owner[o] ? bv[my_col[o]] : 0.f;
  }
  const float my_a = row_owner ? av[my_row] : 0.f;

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
          const float e = row0 + a < n_rows && col0 + b < n ? expf(div_ieee(x, eps)) : 0.f;
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
    float um = 1.f, vm[OWN];
#pragma unroll
    for (int o = 0; o < OWN; ++o) vm[o] = 1.f;
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
      if (row_owner) um = __fdiv_rn(my_a, max_nan(rs[0], kFloor));
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
        float t[OWN];
        auto finish = [&](int o) {  // v of the owner's column from its sum
          vm[o] = __fdiv_rn(my_b[o], max_nan(t[o], kFloor));
          vfin[col_slot[o]] = vm[o];
        };
#pragma unroll
        for (int o = 0; o < OWN; ++o)
          if (col_owner[o]) {
            t[o] = part[col_slot[o]];
            for (int w = 1; w < T::WARPS; ++w) t[o] += part[w * PC + col_slot[o]];
            // one CTA: at once, in the loop (the register route, 1.5% slower after it)
            if constexpr (T::CLUSTER == 1) finish(o);
          }
        if constexpr (T::CLUSTER > 1) {  // every column's sum over the cluster, its owner's slot
          int at[OWN];
#pragma unroll
          for (int o = 0; o < OWN; ++o) at[o] = col_owner[o] ? col_slot[o] : -1;
          cluster_sum<T>(t, at, true, n, ex);
#pragma unroll
          for (int o = 0; o < OWN; ++o)
            if (col_owner[o]) finish(o);
        }
        __syncthreads();
        load_vec(v, vfin + tc * CV);
      } else {
        if (col_owner[0]) vm[0] = __fdiv_rn(my_b[0], max_nan(cs[0], kFloor));
        if (col_writer) part[col_slot[0]] = vm[0];
        __syncwarp();
        load_vec(v, part + tc * CV);
      }
    }
    __syncthreads();  // every lane has read f and g for this stage's K
    if (row_owner) f[my_row] = __fadd_rn(f[my_row], __fmul_rn(eps, logf(max_nan(um, kFloor))));
#pragma unroll
    for (int o = 0; o < OWN; ++o)
      if (col_owner[o])
        g[my_col[o]] = __fadd_rn(g[my_col[o]], __fmul_rn(eps, logf(max_nan(vm[o], kFloor))));
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
    const float scale = min_nan(__fdiv_rn(av[row0 + a], max_nan(ea[a], kFloor)), 1.f);
#pragma unroll
    for (int b = 0; b < CB; ++b) K[a][b] = __fmul_rn(K[a][b], scale);
  }
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    eb[b] = 0.f;
#pragma unroll
    for (int a = 0; a < RA; ++a) eb[b] += K[a][b];
  }
  sum_over_tr<T>(eb, part, warp, lane, tc, ex);
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const float scale = min_nan(__fdiv_rn(bv[col0 + b], max_nan(eb[b], kFloor)), 1.f);
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
  sum_over_tr<T>(eb, part, warp, lane, tc, ex);
  float deficit[1] = {0.f};
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    ea[a] = __fsub_rn(av[row0 + a], ea[a]);
    deficit[0] += fabsf(ea[a]);
  }
#pragma unroll
  for (int b = 0; b < CB; ++b) eb[b] = __fsub_rn(bv[col0 + b], eb[b]);
  sum_over_tr<T>(deficit, part, warp, lane, tc, ex);
  const float d = max_nan(deficit[0], kFloor), rd = __frcp_rn(d);
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
  sum_over_tr<T>(acc, part, warp, lane, tc, ex);
  if (active && tl == 0 && rank == 0)
    out[pair] = __fadd_rn(__fmul_rn(acc[0], min_nan(sum_p, sum_q)), fabsf(__fsub_rn(sum_p, sum_q)));
}

template <class T>
int launch_tiles(const float* p, const float* q, float* out, long long batch, int n, float r,
                 int n_iters, int n_stages, double eps_final, cudaStream_t stream) {
  if (n > T::WIDEST || batch > 2147483647LL / T::CLUSTER) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)T::SMEM * T::PAIRS;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(emd_tile_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = T::CLUSTER > 1 ? batch * T::CLUSTER : (batch + T::PAIRS - 1) / T::PAIRS;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3(T::THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = T::CLUSTER;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = T::CLUSTER > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&config, emd_tile_kernel<T>, p, q, out, batch, n, r,
                                       n_iters, n_stages, eps_final);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

inline bool valid_problem(long long batch, int n, int n_iters, int n_stages) {
  return batch >= 1 && batch <= 2147483647LL && n >= 1 && n_iters >= 0 && n_stages >= 1;
}

}  // namespace atlasvae

// The wide route: one CTA a pair, K and the vectors in `scratch`, device
// memory of at least batch * wide_scratch_floats(n) floats (ops/emd_cuda.py
// `wide_scratch_floats`).  Any n.
extern "C" int atlasvae_emd_sinkhorn_wide(const void* p, const void* q, void* out, void* scratch,
                                          long long batch, int n, float r_param, int n_iters,
                                          int n_stages, double eps_final, void* stream) {
  using namespace atlasvae;
  if (!valid_problem(batch, n, n_iters, n_stages) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  emd_wide_kernel<<<(unsigned)batch, kWideThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q), static_cast<float*>(out),
      static_cast<float*>(scratch), n, r_param, n_iters, n_stages, eps_final);
  return (int)cudaGetLastError();
}

// The register route for jets of at most `tile` constituents, tile one of
// 8, 16, 20, 32, 64, 112, 128 (ops/emd_cuda.py TILES), and the cluster route
// for jets of at most 176, 256 or 352, on clusters of `cluster` = 2, 4 or 8
// CTAs (ops/emd_cuda.py CLUSTERS).
extern "C" int atlasvae_emd_sinkhorn_tiles(const void* p, const void* q, void* out,
                                           long long batch, int n, float r_param, int n_iters,
                                           int n_stages, double eps_final, int tile,
                                           void* stream) {
  using namespace atlasvae;
  if (!valid_problem(batch, n, n_iters, n_stages)) return (int)cudaErrorInvalidValue;
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

extern "C" int atlasvae_emd_sinkhorn_cluster(const void* p, const void* q, void* out,
                                             long long batch, int n, float r_param, int n_iters,
                                             int n_stages, double eps_final, int cluster,
                                             void* stream) {
  using namespace atlasvae;
  if (!valid_problem(batch, n, n_iters, n_stages)) return (int)cudaErrorInvalidValue;
  const float* pp = static_cast<const float*>(p);
  const float* qq = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tile_type) {
    return launch_tiles<decltype(tile_type)>(pp, qq, o, batch, n, r_param, n_iters, n_stages,
                                             eps_final, s);
  };
  switch (cluster) {
    case 2: return run(EmdCluster2{});
    case 4: return run(EmdCluster4{});
    case 8: return run(EmdCluster8{});
    default: return (int)cudaErrorInvalidValue;
  }
}
