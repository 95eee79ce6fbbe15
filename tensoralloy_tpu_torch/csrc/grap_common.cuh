// What the GRAP kernels (grap_kernel.cu, grap_vjp.cu) share: the
// compressed monomial basis up to moment 5, its host codes and its
// recurrence; the filter bank's values and slopes; the launch
// specification; 16-byte chunks of shared memory; and the launchers'
// query of resident blocks.
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
