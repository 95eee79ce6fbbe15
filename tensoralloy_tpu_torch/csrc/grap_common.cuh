// What the GRAP kernels (grap_kernel.cu, grap_vjp.cu, grap_vjp_bwd.cu)
// share: the compressed monomial basis up to moment 5, its host codes,
// its recurrence, the recurrence's adjoint, the recurrence on dual
// numbers (the monomials' derivative along a direction) and its adjoint;
// the filter bank's values, slopes and curvatures; the launch
// specification; 16-byte chunks of shared memory; the VJP kernels' walk
// of a row's pairs of one slot, compacted; and the launchers' query of
// resident blocks.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kMaxMonomials = 56;         // max_moment 5
constexpr int kMaxFilters = 64;
constexpr int kMaxMoments = 6;

// The monomials in `moment_monomials` order, the code of each as the
// host builds it (ops/fused.py `monomial_codes`: bits 0-2 the degree,
// then 2 bits per sorted axis). The launcher holds the host's codes to
// this table, so the kernel's fixed recurrence below is the host's
// basis.
constexpr unsigned short kCodes[kMaxMonomials] = {
    0,    1,    9,    17,   2,    34,   66,   42,   74,   82,   3,    131,
    259,  163,  291,  323,  171,  299,  331,  339,  4,    516,  1028, 644,
    1156, 1284, 676,  1188, 1316, 1348, 684,  1196, 1324, 1356, 1364, 5,
    2053, 4101, 2565, 4613, 5125, 2693, 4741, 5253, 5381, 2725, 4773, 5285,
    5413, 5445, 2733, 4781, 5293, 5421, 5453, 5461};

// The 56 monomials of (x, y, z) up to degree 5, each the product of its
// prefix monomial and its last axis (the twin's `moment_basis_c`).
template <typename T>
__device__ __forceinline__ void monomials(T x, T y, T z,
                                          T (&m)[kMaxMonomials]) {
  m[0] = T(1); m[1] = x; m[2] = y; m[3] = z; m[4] = m[1] * x;
  m[5] = m[1] * y; m[6] = m[1] * z; m[7] = m[2] * y; m[8] = m[2] * z;
  m[9] = m[3] * z; m[10] = m[4] * x; m[11] = m[4] * y; m[12] = m[4] * z;
  m[13] = m[5] * y; m[14] = m[5] * z; m[15] = m[6] * z; m[16] = m[7] * y;
  m[17] = m[7] * z; m[18] = m[8] * z; m[19] = m[9] * z; m[20] = m[10] * x;
  m[21] = m[10] * y; m[22] = m[10] * z; m[23] = m[11] * y;
  m[24] = m[11] * z; m[25] = m[12] * z; m[26] = m[13] * y;
  m[27] = m[13] * z; m[28] = m[14] * z; m[29] = m[15] * z;
  m[30] = m[16] * y; m[31] = m[16] * z; m[32] = m[17] * z;
  m[33] = m[18] * z; m[34] = m[19] * z; m[35] = m[20] * x;
  m[36] = m[20] * y; m[37] = m[20] * z; m[38] = m[21] * y;
  m[39] = m[21] * z; m[40] = m[22] * z; m[41] = m[23] * y;
  m[42] = m[23] * z; m[43] = m[24] * z; m[44] = m[25] * z;
  m[45] = m[26] * y; m[46] = m[26] * z; m[47] = m[27] * z;
  m[48] = m[28] * z; m[49] = m[29] * z; m[50] = m[30] * y;
  m[51] = m[30] * z; m[52] = m[31] * z; m[53] = m[32] * z;
  m[54] = m[33] * z; m[55] = m[34] * z;
}

enum Algorithm { kSf = 0, kDensity = 1, kMorse = 2, kPexp = 3 };

// What a launch gets beyond its arrays: the filter grid in kernel
// column order and the requested moments.
template <typename T>
struct GrapSpec {
  int algorithm;
  int n_filters;   // K
  int n_mono;      // D
  int n_moments;   // M
  T c0[kMaxFilters];   // sf: eta   density: A     morse: D      pexp: rl
  T c1[kMaxFilters];   // sf: omega density: beta  morse: gamma  pexp: pl
  T c2[kMaxFilters];   //           density: re    morse: r0
  int moment[kMaxMoments];
};

// Fills `spec` from the host tables; false where the host's monomial
// codes are not this file's basis.
template <typename T>
bool make_spec(GrapSpec<T>& spec, int algorithm, int n_filters,
               const double* c0, const double* c1, const double* c2,
               int n_mono, const unsigned short* codes, int n_moments,
               const int* moments) {
  spec.algorithm = algorithm;
  spec.n_filters = n_filters;
  spec.n_mono = n_mono;
  spec.n_moments = n_moments;
  for (int k = 0; k < kMaxFilters; ++k) {
    const bool in = k < n_filters;
    spec.c0[k] = T(in ? c0[k] : 0.0);
    spec.c1[k] = T(in ? c1[k] : 0.0);
    spec.c2[k] = T(in ? c2[k] : 0.0);
  }
  for (int d = 0; d < n_mono; ++d) {
    if (codes[d] != kCodes[d]) return false;
  }
  for (int m = 0; m < kMaxMoments; ++m) {
    spec.moment[m] = m < n_moments ? moments[m] : -1;
  }
  return true;
}

// A filter at distance r, before the cutoff (ops/fused.py twin), from
// its grid row (c0, c1, c2). pexp's exp(-(r / rl)^pl) is taken as
// exp(-2^(pl (log2 r - log2 rl))), with log2 r (`lr`, once per pair),
// log2 rl (`lrl`, once per block) and their difference in double: one
// exp2 a filter in place of a division and a pow.
template <typename T>
__device__ __forceinline__ T filter_value(int algorithm, T c0, T c1, T c2,
                                          double lrl, T r, double lr,
                                          T rc2) {
  switch (algorithm) {
    case kSf: {
      const T d = r - c1;
      return d_exp(-c0 * (d * d) / rc2);
    }
    case kDensity:
      return c0 * d_exp(-c1 * (r / c2 - T(1)));
    case kMorse: {
      const T x = c1 * (r - c2);
      return c0 * (d_exp(T(-2) * x) - T(2) * d_exp(-x));
    }
    default:
      return d_exp(-d_exp2(T(double(c1) * (lr - lrl))));
  }
}

// `filter_value` and its slope d/dr (ops/fused.py
// `grap_filter_and_slope`) together; `inv_r` is 1 / r. pexp costs the
// value's exp2 and exp and a few multiplies: with x = (r / rl)^pl, the
// slope is -pl x / r f.
template <typename T>
__device__ __forceinline__ void filter_value_and_slope(
    int algorithm, T c0, T c1, T c2, double lrl, T r, double lr, T inv_r,
    T rc2, T& f, T& df) {
  switch (algorithm) {
    case kSf: {
      const T d = r - c1;
      f = d_exp(-c0 * (d * d) / rc2);
      df = T(-2) * c0 * d / rc2 * f;
      return;
    }
    case kDensity:
      f = c0 * d_exp(-c1 * (r / c2 - T(1)));
      df = -c1 / c2 * f;
      return;
    case kMorse: {
      const T x = c1 * (r - c2);
      const T e1 = d_exp(-x), e2 = d_exp(T(-2) * x);
      f = c0 * (e2 - T(2) * e1);
      df = T(2) * c0 * c1 * (e1 - e2);
      return;
    }
    default: {
      const T x = d_exp2(T(double(c1) * (lr - lrl)));
      f = d_exp(-x);
      df = -c1 * x * inv_r * f;
      return;
    }
  }
}

// `filter_value_and_slope` and the curvature d2/dr2 (ops/fused.py
// `grap_filter_slope_and_curvature`) together. pexp takes one exp2 and
// one exp for all three: with x = (r / rl)^pl and t = pl x / r,
// f' = -t f and f'' = f (t^2 - pl (pl - 1) x / r^2).
template <typename T>
__device__ __forceinline__ void filter_value_slope_curvature(
    int algorithm, T c0, T c1, T c2, double lrl, T r, double lr, T inv_r,
    T rc2, T& f, T& df, T& d2f) {
  switch (algorithm) {
    case kSf: {
      const T d = r - c1;
      f = d_exp(-c0 * (d * d) / rc2);
      const T k = T(2) * c0 * d / rc2;
      df = -k * f;
      d2f = (k * k - T(2) * c0 / rc2) * f;
      return;
    }
    case kDensity: {
      f = c0 * d_exp(-c1 * (r / c2 - T(1)));
      const T b = c1 / c2;
      df = -b * f;
      d2f = b * b * f;
      return;
    }
    case kMorse: {
      const T x = c1 * (r - c2);
      const T e1 = d_exp(-x), e2 = d_exp(T(-2) * x);
      f = c0 * (e2 - T(2) * e1);
      df = T(2) * c0 * c1 * (e1 - e2);
      d2f = T(2) * c0 * c1 * c1 * (T(2) * e2 - e1);
      return;
    }
    default: {
      const T x = d_exp2(T(double(c1) * (lr - lrl)));
      f = d_exp(-x);
      const T t = c1 * x * inv_r;
      df = -t * f;
      d2f = f * (t * t - c1 * (c1 - T(1)) * x * inv_r * inv_r);
      return;
    }
  }
}

// Elements of T in a 16-byte chunk of shared memory: 4 floats, 2 doubles.
template <typename T>
constexpr int kChunk = 16 / sizeof(T);

__device__ __forceinline__ void load_chunk(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_chunk(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}

__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_chunk(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// v[0, 4) = p[0, 4), 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* v) {
#pragma unroll
  for (int q = 0; q < 4; q += kChunk<T>) load_chunk(p + q, v + q);
}

// p[0, 4) = v[0, 4), 16-byte aligned.
template <typename T>
__device__ __forceinline__ void store4(T* p, const T* v) {
#pragma unroll
  for (int q = 0; q < 4; q += kChunk<T>) store_chunk(p + q, v + q);
}

// (gx, gy, gz) += the gradient of sum_d dm[d] m_d(x, y, z) w.r.t. the
// unit vector, by running `monomials` backwards: each m[d] = m[p] * a
// sends dm[d] * m[p] to a's gradient and dm[d] * a to dm[p]. `dm` is
// consumed.
#define TAT_ADJ(d, p, a) \
  g##a += dm[d] * m[p];  \
  dm[p] += dm[d] * a;
template <typename T>
__device__ __forceinline__ void monomials_adjoint(
    T x, T y, T z, const T (&m)[kMaxMonomials], T (&dm)[kMaxMonomials],
    T& gx, T& gy, T& gz) {
  TAT_ADJ(55, 34, z) TAT_ADJ(54, 33, z) TAT_ADJ(53, 32, z)
  TAT_ADJ(52, 31, z) TAT_ADJ(51, 30, z) TAT_ADJ(50, 30, y)
  TAT_ADJ(49, 29, z) TAT_ADJ(48, 28, z) TAT_ADJ(47, 27, z)
  TAT_ADJ(46, 26, z) TAT_ADJ(45, 26, y) TAT_ADJ(44, 25, z)
  TAT_ADJ(43, 24, z) TAT_ADJ(42, 23, z) TAT_ADJ(41, 23, y)
  TAT_ADJ(40, 22, z) TAT_ADJ(39, 21, z) TAT_ADJ(38, 21, y)
  TAT_ADJ(37, 20, z) TAT_ADJ(36, 20, y) TAT_ADJ(35, 20, x)
  TAT_ADJ(34, 19, z) TAT_ADJ(33, 18, z) TAT_ADJ(32, 17, z)
  TAT_ADJ(31, 16, z) TAT_ADJ(30, 16, y) TAT_ADJ(29, 15, z)
  TAT_ADJ(28, 14, z) TAT_ADJ(27, 13, z) TAT_ADJ(26, 13, y)
  TAT_ADJ(25, 12, z) TAT_ADJ(24, 11, z) TAT_ADJ(23, 11, y)
  TAT_ADJ(22, 10, z) TAT_ADJ(21, 10, y) TAT_ADJ(20, 10, x)
  TAT_ADJ(19, 9, z) TAT_ADJ(18, 8, z) TAT_ADJ(17, 7, z)
  TAT_ADJ(16, 7, y) TAT_ADJ(15, 6, z) TAT_ADJ(14, 5, z)
  TAT_ADJ(13, 5, y) TAT_ADJ(12, 4, z) TAT_ADJ(11, 4, y)
  TAT_ADJ(10, 4, x) TAT_ADJ(9, 3, z) TAT_ADJ(8, 2, z)
  TAT_ADJ(7, 2, y) TAT_ADJ(6, 1, z) TAT_ADJ(5, 1, y)
  TAT_ADJ(4, 1, x)
  gx += dm[1];
  gy += dm[2];
  gz += dm[3];
}
#undef TAT_ADJ

// The row's pairs of one slot, compacted (`for_each_batch`): `v`
// [5 + Extra, kList] holds r, mask, ux, uy, uz of each (then the Extra
// arrays `for_each_batch_staging` stages) and `entry` [kList] its index
// in the row.
template <typename T>
struct Stage {
  T* v;
  int* entry;
};

// Calls batch(first, nb) for each run stage[first, first + nb) of at most
// Batch compacted pairs of `slot_value` in the row at `base`, in row
// order, with the stage written; returns the pairs. The warp reads mask
// and slot of Span entries at once, and each lane the geometry of its
// own pairs, and their entries of the Extra arrays `extra`, in one round
// (a masked entry's is never read); ballots place them. The stage holds
// Span + Batch pairs (`kList`).
template <int Batch, int Span, int Extra, typename T, typename F>
__device__ __forceinline__ int for_each_batch_staging(
    const T* __restrict__ rij, const T* __restrict__ ux,
    const T* __restrict__ uy, const T* __restrict__ uz,
    const T* __restrict__ slot, const T* __restrict__ mask,
    const T* const* extra, size_t base, int n, T slot_value,
    const Stage<T>& st, F&& batch) {
  constexpr int kList = Span + Batch;
  constexpr int kVals = 5 + Extra;
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  __syncwarp();   // the last walk's readers are done with the stage
  int count = 0, total = 0;   // pairs waiting in the stage; pairs run
  for (int j0 = 0; j0 < n; j0 += Span) {
    constexpr int kE = Span / 32;   // entries a lane
    T mk[kE], sl[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int j = j0 + lane + 32 * i;
      mk[i] = j < n ? mask[base + j] : T(0);
      sl[i] = j < n ? slot[base + j] : T(-1);
    }
    bool act[kE];
    T v[kVals][kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const size_t idx = base + j0 + lane + 32 * i;
      act[i] = mk[i] > T(0) && sl[i] == slot_value;
      v[0][i] = act[i] ? rij[idx] : T(0);
      v[1][i] = mk[i];
      v[2][i] = act[i] ? ux[idx] : T(0);
      v[3][i] = act[i] ? uy[idx] : T(0);
      v[4][i] = act[i] ? uz[idx] : T(0);
#pragma unroll
      for (int e = 0; e < Extra; ++e) {
        v[5 + e][i] = act[i] ? extra[e][idx] : T(0);
      }
    }
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const unsigned ballot = __ballot_sync(kFull, act[i]);
      if (act[i]) {
        const int q = count + __popc(ballot & lanes_below);
#pragma unroll
        for (int a = 0; a < kVals; ++a) st.v[a * kList + q] = v[a][i];
        st.entry[q] = j0 + lane + 32 * i;
      }
      count += __popc(ballot);
    }
    const bool last = j0 + Span >= n;
    int done = 0;
    while (count - done >= Batch || (last && count > done)) {
      const int nb = min(Batch, count - done);
      __syncwarp();   // the stage is written; the last batch is done
      batch(done, nb);
      done += nb;
    }
    total += done;
    if (done > 0 && !last) {   // carry the rest to the stage's front
      const int rest = count - done;
      __syncwarp();
      T c[kVals];
      int e = 0;
      if (lane < rest) {
#pragma unroll
        for (int a = 0; a < kVals; ++a) c[a] = st.v[a * kList + done + lane];
        e = st.entry[done + lane];
      }
      __syncwarp();
      if (lane < rest) {
#pragma unroll
        for (int a = 0; a < kVals; ++a) st.v[a * kList + lane] = c[a];
        st.entry[lane] = e;
      }
      count = rest;
    }
  }
  return total;
}

// `for_each_batch_staging` of the geometry alone.
template <int Batch, int Span, typename T, typename F>
__device__ __forceinline__ int for_each_batch(
    const T* __restrict__ rij, const T* __restrict__ ux,
    const T* __restrict__ uy, const T* __restrict__ uz,
    const T* __restrict__ slot, const T* __restrict__ mask, size_t base,
    int n, T slot_value, const Stage<T>& st, F&& batch) {
  return for_each_batch_staging<Batch, Span, 0>(
      rij, ux, uy, uz, slot, mask, static_cast<const T* const*>(nullptr),
      base, n, slot_value, st, static_cast<F&&>(batch));
}

// The monomials and their derivative along a = (ax, ay, az) as dual
// numbers: md[d] = a . grad_u m_d, run with `monomials`' recurrence
// (each m[d] = m[p] * u_axis gives md[d] = md[p] * u_axis + m[p] a_axis).
#define TAT_DUAL(d, p, a) \
  m[d] = m[p] * a;        \
  md[d] = md[p] * a + m[p] * t##a;
template <typename T>
__device__ __forceinline__ void monomials_dual(T x, T y, T z, T tx, T ty,
                                               T tz, T (&m)[kMaxMonomials],
                                               T (&md)[kMaxMonomials]) {
  m[0] = T(1); m[1] = x; m[2] = y; m[3] = z;
  md[0] = T(0); md[1] = tx; md[2] = ty; md[3] = tz;
  TAT_DUAL(4, 1, x) TAT_DUAL(5, 1, y) TAT_DUAL(6, 1, z)
  TAT_DUAL(7, 2, y) TAT_DUAL(8, 2, z) TAT_DUAL(9, 3, z)
  TAT_DUAL(10, 4, x) TAT_DUAL(11, 4, y) TAT_DUAL(12, 4, z)
  TAT_DUAL(13, 5, y) TAT_DUAL(14, 5, z) TAT_DUAL(15, 6, z)
  TAT_DUAL(16, 7, y) TAT_DUAL(17, 7, z) TAT_DUAL(18, 8, z)
  TAT_DUAL(19, 9, z) TAT_DUAL(20, 10, x) TAT_DUAL(21, 10, y)
  TAT_DUAL(22, 10, z) TAT_DUAL(23, 11, y) TAT_DUAL(24, 11, z)
  TAT_DUAL(25, 12, z) TAT_DUAL(26, 13, y) TAT_DUAL(27, 13, z)
  TAT_DUAL(28, 14, z) TAT_DUAL(29, 15, z) TAT_DUAL(30, 16, y)
  TAT_DUAL(31, 16, z) TAT_DUAL(32, 17, z) TAT_DUAL(33, 18, z)
  TAT_DUAL(34, 19, z) TAT_DUAL(35, 20, x) TAT_DUAL(36, 20, y)
  TAT_DUAL(37, 20, z) TAT_DUAL(38, 21, y) TAT_DUAL(39, 21, z)
  TAT_DUAL(40, 22, z) TAT_DUAL(41, 23, y) TAT_DUAL(42, 23, z)
  TAT_DUAL(43, 24, z) TAT_DUAL(44, 25, z) TAT_DUAL(45, 26, y)
  TAT_DUAL(46, 26, z) TAT_DUAL(47, 27, z) TAT_DUAL(48, 28, z)
  TAT_DUAL(49, 29, z) TAT_DUAL(50, 30, y) TAT_DUAL(51, 30, z)
  TAT_DUAL(52, 31, z) TAT_DUAL(53, 32, z) TAT_DUAL(54, 33, z)
  TAT_DUAL(55, 34, z)
}
#undef TAT_DUAL

// (gx, gy, gz) += the gradient w.r.t. the unit vector of
// sum_d (dm[d] m_d + dmd[d] md_d), md the monomials' derivative along
// (tx, ty, tz) (`monomials_dual`, whose values m, md it takes): the dual
// recurrence run backwards. Each m[d] = m[p] * a sends dm[d] m[p] to a's
// gradient and dm[d] a to dm[p]; each md[d] = md[p] * a + m[p] ta sends
// dmd[d] md[p] to a's gradient, dmd[d] a to dmd[p] and dmd[d] ta to
// dm[p]. `dm` and `dmd` are consumed.
#define TAT_DUAL_ADJ(d, p, a)                  \
  g##a += dm[d] * m[p] + dmd[d] * md[p];       \
  dm[p] += dm[d] * a + dmd[d] * t##a;          \
  dmd[p] += dmd[d] * a;
template <typename T>
__device__ __forceinline__ void monomials_dual_adjoint(
    T x, T y, T z, T tx, T ty, T tz, const T (&m)[kMaxMonomials],
    const T (&md)[kMaxMonomials], T (&dm)[kMaxMonomials],
    T (&dmd)[kMaxMonomials], T& gx, T& gy, T& gz) {
  TAT_DUAL_ADJ(55, 34, z) TAT_DUAL_ADJ(54, 33, z) TAT_DUAL_ADJ(53, 32, z)
  TAT_DUAL_ADJ(52, 31, z) TAT_DUAL_ADJ(51, 30, z) TAT_DUAL_ADJ(50, 30, y)
  TAT_DUAL_ADJ(49, 29, z) TAT_DUAL_ADJ(48, 28, z) TAT_DUAL_ADJ(47, 27, z)
  TAT_DUAL_ADJ(46, 26, z) TAT_DUAL_ADJ(45, 26, y) TAT_DUAL_ADJ(44, 25, z)
  TAT_DUAL_ADJ(43, 24, z) TAT_DUAL_ADJ(42, 23, z) TAT_DUAL_ADJ(41, 23, y)
  TAT_DUAL_ADJ(40, 22, z) TAT_DUAL_ADJ(39, 21, z) TAT_DUAL_ADJ(38, 21, y)
  TAT_DUAL_ADJ(37, 20, z) TAT_DUAL_ADJ(36, 20, y) TAT_DUAL_ADJ(35, 20, x)
  TAT_DUAL_ADJ(34, 19, z) TAT_DUAL_ADJ(33, 18, z) TAT_DUAL_ADJ(32, 17, z)
  TAT_DUAL_ADJ(31, 16, z) TAT_DUAL_ADJ(30, 16, y) TAT_DUAL_ADJ(29, 15, z)
  TAT_DUAL_ADJ(28, 14, z) TAT_DUAL_ADJ(27, 13, z) TAT_DUAL_ADJ(26, 13, y)
  TAT_DUAL_ADJ(25, 12, z) TAT_DUAL_ADJ(24, 11, z) TAT_DUAL_ADJ(23, 11, y)
  TAT_DUAL_ADJ(22, 10, z) TAT_DUAL_ADJ(21, 10, y) TAT_DUAL_ADJ(20, 10, x)
  TAT_DUAL_ADJ(19, 9, z) TAT_DUAL_ADJ(18, 8, z) TAT_DUAL_ADJ(17, 7, z)
  TAT_DUAL_ADJ(16, 7, y) TAT_DUAL_ADJ(15, 6, z) TAT_DUAL_ADJ(14, 5, z)
  TAT_DUAL_ADJ(13, 5, y) TAT_DUAL_ADJ(12, 4, z) TAT_DUAL_ADJ(11, 4, y)
  TAT_DUAL_ADJ(10, 4, x) TAT_DUAL_ADJ(9, 3, z) TAT_DUAL_ADJ(8, 2, z)
  TAT_DUAL_ADJ(7, 2, y) TAT_DUAL_ADJ(6, 1, z) TAT_DUAL_ADJ(5, 1, y)
  TAT_DUAL_ADJ(4, 1, x)
  gx += dm[1];
  gy += dm[2];
  gz += dm[3];
}
#undef TAT_DUAL_ADJ

// Blocks of `kernel` resident on the current device at `threads` threads
// and `smem` bytes of dynamic shared memory a block, after raising the
// kernel's shared-memory limit to `smem` (a launch asking for more than
// the limit is refused, so the limit only grows). Asked of the runtime
// once per (device, kernel, threads, smem) and kept: a server launches
// one kernel at one size again and again.
[[maybe_unused]] cudaError_t resident_blocks(const void* kernel,
                                             int threads, size_t smem,
                                             int* blocks) {
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, size_t> limits;
  static std::map<std::tuple<int, const void*, int, size_t>, int> resident;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_tuple(device, kernel, threads, smem);
  const auto hit = resident.find(key);
  if (hit != resident.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  size_t& limit = limits[std::make_pair(device, kernel)];
  if (smem > limit) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    limit = smem;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    threads, smem);
  if (e != cudaSuccess) return e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  resident.emplace(key, *blocks);
  return cudaSuccess;
}

}  // namespace
