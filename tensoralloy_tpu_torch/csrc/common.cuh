// Device helpers shared by the descriptor kernels: full-precision math
// overloads for float and double, and the five smooth cutoff functions
// of tensoralloy_tpu_torch/ops/cutoffs.py, selected by CUTOFF_IDS.
//
// Full-precision exp/pow/cos/sqrt are used on purpose (no fast-math
// intrinsics): parity with the plain PyTorch twins at float64 depends
// on them.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr double kPi = 3.14159265358979323846;

// Cutoff id (ops/cutoffs.py CUTOFF_IDS) and the radius-derived
// constants, computed in double on the host as the Python twin does.
template <typename T>
struct Cutoff {
  int id;
  T rc;
  T rcs;      // deepmd: 2/3 rc
  T rc_rcs;   // deepmd: rc - rcs
  T d;        // tersoff: 0.1 rc
  T big_r;    // tersoff: rc - d
};

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_sin(float x) { return sinf(x); }
__device__ __forceinline__ double d_sin(double x) { return sin(x); }
__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T clamp_to(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T cutoff_value(const Cutoff<T>& c, T r) {
  switch (c.id) {
    case 0: {  // cosine
      T z = r / c.rc;
      if (z > T(1)) z = T(1);
      return T(0.5) * (d_cos(z * T(kPi)) + T(1));
    }
    case 1: {  // polynomial, gamma = 5
      T z = r / c.rc;
      if (z > T(1)) z = T(1);
      const T g = T(5);
      return T(1) + g * d_pow(z, g + T(1)) - (g + T(1)) * d_pow(z, g);
    }
    case 2: {  // meam, window = rc
      const T x = clamp_to((c.rc - r) / c.rc, T(0), T(1));
      const T y = T(1) - d_pow(T(1) - x, T(4));
      return y * y;
    }
    case 3: {  // deepmd, rcs = 2/3 rc
      const T z = clamp_to((r - c.rcs) / c.rc_rcs, T(0), T(1));
      const T recip = r > T(0) ? T(1) / r : T(0);
      return recip * (T(0.5) * d_cos(T(kPi) * z) + T(0.5));
    }
    default: {  // tersoff, d = 0.1 rc
      const T z = clamp_to((r - c.big_r) / c.d, T(-1), T(1));
      return T(0.5) - T(0.5) * d_sin(T(0.5 * kPi) * z);
    }
  }
}

template <typename T>
Cutoff<T> make_cutoff(int id, double rc) {
  Cutoff<T> c;
  c.id = id;
  c.rc = T(rc);
  const double rcs = (2.0 / 3.0) * rc;
  c.rcs = T(rcs);
  c.rc_rcs = T(rc - rcs);
  const double d = 0.1 * rc;
  c.d = T(d);
  c.big_r = T(rc - d);
  return c;
}

}  // namespace
