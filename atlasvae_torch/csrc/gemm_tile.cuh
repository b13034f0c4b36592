// Register-tiled float32 GEMM tile on the CUDA cores: the building block of
// K3's layer-wise route (fused_vae_bwd.cu), written so that the wide forward
// kernels (K1, K2) can reuse it.
//
// One CTA of 256 threads computes a BM x BN output tile, TM x TN outputs a
// thread, as C[i][j] = sum_k A(i, k) B(k, j) over a range of k.  Each operand
// lies in device memory in one of two layouts:
//   k_contig = 1: element (i, k) at p[i * ld + k], contiguous along k (a
//                 row-major activation read along its features, or a weight
//                 read transposed); it may be cut along k into up to kMaxSeg
//                 segments, each with its own pointer and stride (the heads
//                 of a stack, concatenated without a copy);
//   k_contig = 0: element (i, k) at p[k * ld + i], contiguous along i.
// Chunks of kBK values of k are staged in shared memory k-major (As[k][i],
// Bs[k][j]), double-buffered: the next chunk's global loads are issued into
// registers before the current chunk's FMAs and stored after them, so one
// barrier a chunk separates the two buffers.  A k_contig operand is
// transposed while it is stored (cp.async copies bytes as they lie and cannot
// transpose, so the staging goes through registers for every layout alike).
// Every global load is 16 bytes a thread with neighbouring threads on
// neighbouring addresses when the operand allows it (`vec`: strides, segment
// edges and pointers 16-byte aligned), else four checked 4-byte loads.  Rows
// of shared memory are padded by 4 floats: the transposed stores of a warp
// hit 32 distinct banks, and every fragment read stays a float4.
//
// A thread's TM rows are TM / 4 float4 groups spread BM / (TM / 4) apart (and
// its columns likewise), so the 8 threads of a quarter-warp read 128
// consecutive bytes: no bank conflicts.  Per k a thread reads TM / 4 + TN / 4
// float4 and issues TM * TN FMAs: 16 FMAs a shared-memory read at 8 x 8 a
// thread (the 128 x 128 tile of the wide products), 8 at 4 x 4.
#pragma once

#include <cuda_runtime.h>

namespace atlasvae {
namespace gemm {

constexpr int kThreads = 256;
constexpr int kBK = 8;       // k values of one staged chunk
constexpr int kMaxSeg = 4;

struct Operand {
  const float* p[kMaxSeg];
  long long ld[kMaxSeg];
  int kbeg[kMaxSeg + 1];  // segment s holds k in [kbeg[s], kbeg[s + 1]) (k_contig only)
  int nseg;
  int k_contig;
  int vec;                // 16-byte loads
  long long extent;       // i < extent; zero beyond
};

template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int kTX = BN / TN;  // threads along the columns
  static constexpr int kTY = BM / TM;  // ... and along the rows
  static_assert(kTX * kTY == kThreads, "one output tile per 256 threads");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  static constexpr int kJobsA = BM * kBK / 4;  // float4 loads of a chunk of A
  static constexpr int kJobsB = BN * kBK / 4;
  static_assert(kJobsA <= kThreads && kJobsB <= kThreads, "at most one load a thread");
  static constexpr int kSA = BM + 4;
  static constexpr int kSB = BN + 4;
  static constexpr int kSmemFloats = 2 * kBK * (kSA + kSB);
  // the output row (column) of a thread's fragment element i
  __device__ static int row(int ty, int i) { return (i / 4) * 4 * kTY + ty * 4 + (i % 4); }
  __device__ static int col(int tx, int j) { return (j / 4) * 4 * kTX + tx * 4 + (j % 4); }
};

__device__ __forceinline__ int segment_of(const Operand& o, long long k) {
  int s = 0;
  while (s + 1 < o.nseg && k >= o.kbeg[s + 1]) ++s;
  return s;
}

// Element (i, k), zero past the edges.
__device__ __forceinline__ float element(const Operand& o, long long i, long long k,
                                         long long k_end) {
  if (i >= o.extent || k >= k_end) return 0.f;
  if (!o.k_contig) return __ldg(o.p[0] + k * o.ld[0] + i);
  const int s = segment_of(o, k);
  return __ldg(o.p[s] + i * o.ld[s] + (k - o.kbeg[s]));
}

// One thread's share of a chunk: four elements along the operand's
// contiguous axis, (i, k..k+3) or (i..i+3, k).  E is the tile's extent
// along i (BM or BN).
template <int E>
__device__ __forceinline__ float4 load_job(const Operand& o, long long i0, long long k0,
                                           long long k_end, int job) {
  long long i, k;
  if (o.k_contig) {
    i = i0 + job / (kBK / 4);
    k = k0 + (job % (kBK / 4)) * 4;
  } else {
    k = k0 + job / (E / 4);
    i = i0 + (job % (E / 4)) * 4;
  }
  if (o.vec) {
    // k_contig: k and every segment edge are multiples of 4; else i and extent
    if (i >= o.extent || k >= k_end) return make_float4(0.f, 0.f, 0.f, 0.f);
    if (!o.k_contig) return __ldg(reinterpret_cast<const float4*>(o.p[0] + k * o.ld[0] + i));
    const int s = segment_of(o, k);
    return __ldg(reinterpret_cast<const float4*>(o.p[s] + i * o.ld[s] + (k - o.kbeg[s])));
  }
  if (o.k_contig)
    return make_float4(element(o, i, k, k_end), element(o, i, k + 1, k_end),
                       element(o, i, k + 2, k_end), element(o, i, k + 3, k_end));
  return make_float4(element(o, i, k, k_end), element(o, i + 1, k, k_end),
                     element(o, i + 2, k, k_end), element(o, i + 3, k, k_end));
}

// Store a job's four elements into a k-major buffer of row stride E + 4.
template <int E>
__device__ __forceinline__ void store_job(int k_contig, float* buf, int job, float4 v) {
  constexpr int S = E + 4;
  if (k_contig) {
    const int i = job / (kBK / 4);
    const int kq = (job % (kBK / 4)) * 4;
    buf[kq * S + i] = v.x;
    buf[(kq + 1) * S + i] = v.y;
    buf[(kq + 2) * S + i] = v.z;
    buf[(kq + 3) * S + i] = v.w;
  } else {
    const int kk = job / (E / 4);
    const int iq = (job % (E / 4)) * 4;
    *reinterpret_cast<float4*>(buf + kk * S + iq) = v;
  }
}

// acc[r][c] = sum over k in [k_begin, k_end) of A(m0 + row(r), k) B(k, n0 + col(c));
// with want_colsum also colsum[c] = sum over k of B(k, n0 + col(c)) (the
// bias gradient beside a weight gradient), in the threads of the first row
// group (ty == 0) only: the others would repeat it.  Ends with a barrier, so
// the caller may reuse smem.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void mainloop(const Operand& A, const Operand& B, long long m0,
                                         long long n0, long long k_begin, long long k_end,
                                         float* smem, float (&acc)[TM][TN], float (&colsum)[TN],
                                         bool want_colsum) {
  using T = Tile<BM, BN, TM, TN>;
  float* const As = smem;
  float* const Bs = smem + 2 * kBK * T::kSA;
  const int tid = threadIdx.x;
  const int tx = tid % T::kTX, ty = tid / T::kTX;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int c = 0; c < TN; ++c) colsum[c] = 0.f;

  // this thread's load of a chunk (job tid, where the chunk has one)
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb = ra;
  auto fetch = [&](long long k0) {
    if (tid < T::kJobsA) ra = load_job<BM>(A, m0, k0, k_end, tid);
    if (tid < T::kJobsB) rb = load_job<BN>(B, n0, k0, k_end, tid);
  };
  auto stash = [&](int buf) {
    if (tid < T::kJobsA) store_job<BM>(A.k_contig, As + buf * kBK * T::kSA, tid, ra);
    if (tid < T::kJobsB) store_job<BN>(B.k_contig, Bs + buf * kBK * T::kSB, tid, rb);
  };
  const long long n_chunks = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (n_chunks > 0) {
    fetch(k_begin);
    stash(0);
  }
  __syncthreads();
  for (long long c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    if (more) fetch(k_begin + (c + 1) * kBK);  // next chunk in flight while this one's FMAs run
    const float* as = As + (c & 1) * kBK * T::kSA;
    const float* bs = Bs + (c & 1) * kBK * T::kSB;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int f = 0; f < TM / 4; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(as + kk * T::kSA + f * 4 * T::kTY + ty * 4);
        a[4 * f] = v.x; a[4 * f + 1] = v.y; a[4 * f + 2] = v.z; a[4 * f + 3] = v.w;
      }
#pragma unroll
      for (int f = 0; f < TN / 4; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * T::kSB + f * 4 * T::kTX + tx * 4);
        b[4 * f] = v.x; b[4 * f + 1] = v.y; b[4 * f + 2] = v.z; b[4 * f + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
      if (want_colsum && ty == 0) {
#pragma unroll
        for (int j = 0; j < TN; ++j) colsum[j] += b[j];
      }
    }
    if (more) stash((int)((c + 1) & 1));
    __syncthreads();
  }
}

}  // namespace gemm
}  // namespace atlasvae
