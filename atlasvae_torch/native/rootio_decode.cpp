// Native fast path for decoding STL-vector TBranchElement baskets.
//
// Mirrors the per-entry layout parsed by the pure-Python decoder in
// atlasvae_torch/etl/rootio.py (Tree._stl_array): each entry is
//   [bytecount:4][version:2 (| kStreamedMemberWise -> +2 inner version)]
//   [outer count n:4]
//   depth 1: n * isz element bytes
//   depth 2: n times ([inner count m:4][m * isz element bytes])
// All integers big-endian.  Element bytes are byteswapped to native
// little-endian while copying, so the Python side views them with the
// native dtype and never pays a byteswapping concatenate.
//
// The Python loop costs ~12 us/entry (struct.unpack per header); this
// loop costs ~30 ns/entry, turning the ETL's basket decode from the
// conversion bottleneck into noise.  The reference gets the same job done
// inside uproot's compiled interpreters (ref tools/root_utils.py:16-28);
// this is the framework-native analog.
//
// Built at first use by atlasvae_torch/native (g++ -O2 -shared -fPIC, into
// the port's build directory) and called from atlasvae_torch/etl/rootnative.py
// over ctypes (a plain C ABI, no pybind11).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

static inline uint32_t be32(const unsigned char* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16)
         | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
static inline uint16_t be16(const unsigned char* p) {
    return uint16_t((uint16_t(p[0]) << 8) | uint16_t(p[1]));
}

// Copy n big-endian elements of size isz, swapping to little-endian.
// (The elements land native-endian so the Python side never pays a
// byteswapping concatenate over the whole branch.)
static inline void copy_swapped(unsigned char* dst, const unsigned char* src,
                                long long n, int isz) {
    switch (isz) {
    case 1:
        memcpy(dst, src, (size_t) n);
        break;
    case 2:
        for (long long i = 0; i < n; ++i) {
            dst[2 * i] = src[2 * i + 1];
            dst[2 * i + 1] = src[2 * i];
        }
        break;
    case 4:
        for (long long i = 0; i < n; ++i) {
            dst[4 * i] = src[4 * i + 3];
            dst[4 * i + 1] = src[4 * i + 2];
            dst[4 * i + 2] = src[4 * i + 1];
            dst[4 * i + 3] = src[4 * i];
        }
        break;
    default:  // 8
        for (long long i = 0; i < n; ++i)
            for (int b = 0; b < 8; ++b)
                dst[8 * i + b] = src[8 * i + 7 - b];
    }
}

extern "C" {

// Decode the STL entries of one decompressed basket payload.
//
//   payload / plen   decompressed basket bytes
//   starts[n_entries] byte offset of each entry's bytecount word
//   depth            1 (vector<T>) or 2 (vector<vector<T>>)
//   isz              element size in bytes
//   flat / flat_cap  output element bytes (caller-allocated)
//   outer[n_entries] outer count per entry
//   inner / inner_cap inner count per inner vector (depth 2 only)
//
// Returns 0 on success and fills flat_len / n_inner.  On malformed
// input returns a negative code (err_entry = offending entry index):
//   -1 entry header reaches past the payload
//   -2 negative element count
//   -3 element data reaches past the payload
//   -4 output bound exceeded (overlapping/duplicated entry offsets)
long long rio_decode_stl(const unsigned char* payload, long long plen,
                         const long long* starts, long long n_entries,
                         int depth, int isz,
                         unsigned char* flat, long long flat_cap,
                         long long* flat_len,
                         long long* outer,
                         long long* inner, long long inner_cap,
                         long long* n_inner, long long* err_entry)
{
    const uint16_t kMemberWise = 0x4000;  // kStreamedMemberWise
    long long fl = 0, ni = 0;
    *err_entry = -1;
    for (long long e = 0; e < n_entries; ++e) {
        long long pos = starts[e];
        if (pos < 0 || pos + 6 > plen) { *err_entry = e; return -1; }
        pos += 4;                          // skip the bytecount word
        uint16_t ver = be16(payload + pos);
        pos += 2;
        if (ver & kMemberWise) {           // inner-class version word
            if (pos + 2 > plen) { *err_entry = e; return -1; }
            pos += 2;
        }
        if (pos + 4 > plen) { *err_entry = e; return -1; }
        int32_t n = (int32_t) be32(payload + pos);
        pos += 4;
        if (n < 0) { *err_entry = e; return -2; }
        outer[e] = n;
        if (depth == 1) {
            long long nbytes = (long long) n * isz;
            if (pos + nbytes > plen) { *err_entry = e; return -3; }
            if (fl + nbytes > flat_cap) { *err_entry = e; return -4; }
            copy_swapped(flat + fl, payload + pos, n, isz);
            fl += nbytes;
            continue;
        }
        for (int32_t j = 0; j < n; ++j) {
            if (pos + 4 > plen) { *err_entry = e; return -1; }
            int32_t m = (int32_t) be32(payload + pos);
            pos += 4;
            if (m < 0) { *err_entry = e; return -2; }
            long long nbytes = (long long) m * isz;
            if (pos + nbytes > plen) { *err_entry = e; return -3; }
            if (fl + nbytes > flat_cap || ni >= inner_cap) {
                *err_entry = e; return -4;
            }
            copy_swapped(flat + fl, payload + pos, m, isz);
            fl += nbytes;
            pos += nbytes;
            inner[ni++] = m;
        }
    }
    *flat_len = fl;
    *n_inner = ni;
    return 0;
}

}  // extern "C"

// IEEE-754 double -> half, round-to-nearest-even, converting directly
// from the double bits (no intermediate float32, so no double rounding
// — same contract as numpy's float64 -> float16 cast, which the fused
// jet kernel below must match bit-for-bit).
static inline uint16_t d2h(double value) {
    uint64_t d;
    memcpy(&d, &value, 8);
    uint16_t sign = (uint16_t)((d >> 48) & 0x8000u);
    uint32_t exp = (uint32_t)((d >> 52) & 0x7ffu);
    uint64_t man = d & 0xfffffffffffffULL;
    if (exp == 0x7ffu) {                       // inf / nan
        if (man == 0) return (uint16_t)(sign | 0x7c00u);
        uint32_t h = (uint32_t)(man >> 42);    // keep top payload bits
        return (uint16_t)(sign | 0x7c00u | h | (h == 0));
    }
    if (exp == 0) return sign;                 // double subnormal -> +-0
    int e = (int)exp - 1023 + 15;
    if (e >= 0x1f) return (uint16_t)(sign | 0x7c00u);   // overflow -> inf
    man |= 0x10000000000000ULL;                // implicit bit (53-bit mantissa)
    if (e <= 0) {                              // half subnormal / zero
        if (e < -11) return sign;              // below half of min subnormal
        int shift = 43 - e;                    // 53-bit mantissa -> 10 bits
        uint64_t half_man = man >> shift;
        uint64_t rem = man & ((1ULL << shift) - 1);
        uint64_t halfway = 1ULL << (shift - 1);
        if (rem > halfway || (rem == halfway && (half_man & 1)))
            ++half_man;
        return (uint16_t)(sign | (uint16_t)half_man);
    }
    uint64_t half_man = man & 0xfffffffffffffULL;  // drop implicit bit again
    uint64_t keep = half_man >> 42;
    uint64_t rem = half_man & ((1ULL << 42) - 1);
    uint16_t h = (uint16_t)(sign | ((uint32_t)e << 10) | (uint32_t)keep);
    if (rem > (1ULL << 41) || (rem == (1ULL << 41) && (keep & 1)))
        ++h;                                   // carry may bump exp: correct
    return h;
}

extern "C" {

// Bulk double -> half cast (exposed so tests can verify d2h's
// round-to-nearest-even against numpy's float64 -> float16 cast over
// adversarial inputs: halfway points, subnormals, overflow, nan).
void rio_d2h(const double* src, long long n, uint16_t* dst) {
    for (long long i = 0; i < n; ++i) dst[i] = d2h(src[i]);
}

// Fused final_jets kernel: constituent (pt, eta, phi) -> canonicalized,
// pt-ordered (E,px,py,pz) float16 blocks + summed-jet kinematics, one
// pass per jet with O(C) scratch.  This is the native equivalent of the
// reference's 32-process TLorentzVector fan-out
// (ref tools/root_utils.py:55-90 final_jets/transform_jets) and replaces
// the numpy pipeline in atlasvae_torch/etl/lorentz.py for the ETL hot path —
// the numpy version allocates ~20 (J, C[,4]) float64 temporaries, which
// dominates convert() wall time at ntuple scale.  Semantics mirror
// lorentz.py (masking, guards, clip constants, stable pt sort with NaN
// keys last, direct double->half rounding); the only divergence from
// the numpy path is accumulation order (sequential here vs numpy's
// pairwise sums, and the 4-vector total summed pre-sort), worth at
// most 1 float16 ulp when a double lands on a rounding halfway point.
//
//   pt/eta/phi   (J, C) float64, zero-padded, C-contiguous
//   flat         (J, C*4) float16 out: canonicalized (E,px,py,pz) per
//                constituent, descending-pt order
//   e/ptc/mc     (J,) float16 out: summed E, pt_calo, m_calo
//
// Rows are independent: callers may slice [lo, hi) and run chunks on a
// thread pool (ctypes releases the GIL).
long long rio_final_jets(const double* pt, const double* eta,
                         const double* phi, long long J, long long C,
                         uint16_t* flat, uint16_t* e_out,
                         uint16_t* ptc_out, uint16_t* mc_out)
{
    if (J < 0 || C <= 0) return -1;
    std::vector<double> p4((size_t)C * 4);
    std::vector<double> key((size_t)C);
    std::vector<int> order((size_t)C);
    std::vector<unsigned char> live((size_t)C);
    for (long long j = 0; j < J; ++j) {
        const double* rpt = pt + j * C;
        const double* ret = eta + j * C;
        const double* rph = phi + j * C;
        // (pt, eta, phi, m=0) -> (E, px, py, pz), masked by pt > 0
        // (lorentz.py pt_eta_phi_m_to_epxpypz + the alive mask in
        // root2h5.final_jets), accumulating the jet 4-vector
        double tE = 0, tx = 0, ty = 0, tz = 0;
        for (long long c = 0; c < C; ++c) {
            double* q = &p4[(size_t)c * 4];
            double P = rpt[c];
            if (P == 0.0 && ret[c] == 0.0 && rph[c] == 0.0) {
                // exact-zero padding: the numpy path's trig of zeros is
                // exact +0 everywhere (cos(0)=1 * 0 = +0, masked * 0),
                // so skipping the whole chain for these slots is
                // value-identical and leaves the accumulator sums
                // bit-identical (padding contributes exactly +-0).
                // Only the signed zeros the later rotations would
                // smear over the dead slots differ — the documented
                // parity contract (see tests) compares zeros by value.
                q[0] = q[1] = q[2] = q[3] = 0.0;
                live[(size_t)c] = 0;
                continue;
            }
            live[(size_t)c] = 1;
            double px = P * std::cos(rph[c]);
            double py = P * std::sin(rph[c]);
            double pz = P * std::sinh(ret[c]);
            double E = std::sqrt(px * px + py * py + pz * pz);
            if (!(P > 0.0)) {
                // mask by multiply, not assignment: the numpy path's
                // `p4 * alive` leaves signed zeros (and NaN) in dead
                // slots, which propagate through the rotations — match
                // it bit-for-bit
                E *= 0.0; px *= 0.0; py *= 0.0; pz *= 0.0;
            }
            q[0] = E; q[1] = px; q[2] = py; q[3] = pz;
            tE += E; tx += px; ty += py; tz += pz;
        }
        // canonicalize_jets step 1+2: RotateZ(-phi_jet) then the
        // longitudinal de-boost (both angles from the pre-rotation total)
        double phi_jet = std::atan2(ty, tx);
        double beta_z = (tE != 0.0) ? tz / std::max(tE, 1e-30) : 0.0;
        double cz = std::cos(-phi_jet), sz = std::sin(-phi_jet);
        double b = std::min(std::max(-beta_z, -1.0 + 1e-12), 1.0 - 1e-12);
        double g = 1.0 / std::sqrt(1.0 - b * b);
        double gb = g * b;
        // apply both, accumulating the energy-weighted (eta, phi)
        // alignment sums (canonicalize_jets step 3 preamble)
        double wphi = 0, weta = 0;
        for (long long c = 0; c < C; ++c) {
            if (!live[(size_t)c]) continue;   // padding: exact zeros stay
            double* q = &p4[(size_t)c * 4];
            double px = cz * q[1] - sz * q[2];
            double py = sz * q[1] + cz * q[2];
            double E = g * q[0] + gb * q[3];
            double pz = gb * q[0] + g * q[3];
            q[0] = E; q[1] = px; q[2] = py; q[3] = pz;
            double p_tot = std::sqrt(px * px + py * py + pz * pz);
            double phic = std::atan2(py, px);
            double etac = 0.0;
            if (p_tot > std::abs(pz) + 1e-30) {
                double ratio = pz / std::max(p_tot, 1e-30);
                ratio = std::min(std::max(ratio, -1.0 + 1e-12), 1.0 - 1e-12);
                etac = std::atanh(ratio);
            }
            double r = std::sqrt(phic * phic + etac * etac);
            bool alive = (std::abs(E) + std::abs(px) + std::abs(py)
                          + std::abs(pz)) > 0.0;
            double wgt = (r > 0.0 && alive) ? E / std::max(r, 1e-30) : 0.0;
            wphi += phic * wgt;
            weta += etac * wgt;
        }
        // step 3: RotateX(-alpha); also the post-transform pt sort key
        // and the summed 4-vector (root2h5.summed_4v)
        double alpha = std::atan2(weta, wphi);
        double cx = std::cos(-alpha), sxa = std::sin(-alpha);
        double sE = 0, spx = 0, spy = 0, spz = 0;
        for (long long c = 0; c < C; ++c) {
            order[(size_t)c] = (int)c;
            if (!live[(size_t)c]) { key[(size_t)c] = 0.0; continue; }
            double* q = &p4[(size_t)c * 4];
            double py = cx * q[2] - sxa * q[3];
            double pz = sxa * q[2] + cx * q[3];
            q[2] = py; q[3] = pz;
            key[(size_t)c] = std::sqrt(q[1] * q[1] + py * py);
            sE += q[0]; spx += q[1]; spy += py; spz += pz;
        }
        // descending pt, ties in original order, NaN keys LAST — the
        // numpy fallback's argsort(-pt, stable) sorts NaN to the end,
        // and a plain `>` comparator would leave NaN rows in place
        std::stable_sort(order.begin(), order.end(),
                         [&](int a, int bi) {
                             double ka = key[(size_t)a], kb = key[(size_t)bi];
                             if (std::isnan(kb)) return !std::isnan(ka);
                             return ka > kb;
                         });
        uint16_t* dst = flat + (size_t)j * C * 4;
        for (long long k = 0; k < C; ++k) {
            const double* q = &p4[(size_t)order[(size_t)k] * 4];
            dst[4 * k + 0] = d2h(q[0]);
            dst[4 * k + 1] = d2h(q[1]);
            dst[4 * k + 2] = d2h(q[2]);
            dst[4 * k + 3] = d2h(q[3]);
        }
        e_out[j] = d2h(sE);
        ptc_out[j] = d2h(std::sqrt(spx * spx + spy * spy));
        double m2 = sE * sE - spx * spx - spy * spy - spz * spz;
        mc_out[j] = d2h(std::sqrt(std::max(0.0, m2)));
    }
    return 0;
}

}  // extern "C"
