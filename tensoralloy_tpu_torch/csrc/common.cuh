// Device helpers shared by the descriptor kernels: full-precision math
// overloads for float and double, and the five smooth cutoff functions
// of tensoralloy_tpu_torch/ops/cutoffs.py, selected by CUTOFF_IDS.
//
// Full-precision exp/pow/cos/sqrt are used on purpose (no fast-math
// intrinsics): parity with the plain PyTorch twins at float64 depends
// on them. The cutoffs multiply by reciprocals of their radii, computed
// in double on the host, and take cos(pi z) and sin(pi z) as cospi and
// sinpi, whose argument reduction is exact: each differs from the
// twin's division and cos(z * pi) by an ulp or so, and costs a
// fraction of it. Integer powers are products.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

// Cutoff id (ops/cutoffs.py CUTOFF_IDS) and the radius-derived
// constants, computed in double on the host as the Python twin does.
template <typename T>
struct Cutoff {
  int id;
  T rc;
  T inv_rc;      // 1 / rc
  T rcs;         // deepmd: 2/3 rc
  T rc_rcs;      // deepmd: rc - rcs
  T inv_rc_rcs;  // deepmd: 1 / (rc - rcs)
  T d;           // tersoff: d = 0.1 rc
  T inv_d;       // tersoff: 1 / d
  T big_r;       // tersoff: rc - d
};

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double d_exp2(double x) { return exp2(x); }
__device__ __forceinline__ float d_cospi(float x) { return cospif(x); }
__device__ __forceinline__ double d_cospi(double x) { return cospi(x); }
__device__ __forceinline__ float d_sinpi(float x) { return sinpif(x); }
__device__ __forceinline__ double d_sinpi(double x) { return sinpi(x); }
__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }

constexpr unsigned kFull = 0xffffffffu;   // every lane of a warp

// The entry's slot as an index, or -1 where the entry is masked or its
// slot is no integer in [0, n_slots) (the twins' [slot == s] mask).
template <typename T>
__device__ __forceinline__ int entry_slot(T mk, T sl, int n_slots) {
  if (!(mk > T(0)) || !(sl >= T(0)) || !(sl < T(n_slots))) return -1;
  const int s = static_cast<int>(sl);
  return T(s) == sl ? s : -1;
}

template <typename T>
__device__ __forceinline__ T clamp_to(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T cutoff_value(const Cutoff<T>& c, T r) {
  switch (c.id) {
    case 0: {  // cosine
      T z = r * c.inv_rc;
      if (z > T(1)) z = T(1);
      return T(0.5) * (d_cospi(z) + T(1));
    }
    case 1: {  // polynomial, gamma = 5
      T z = r * c.inv_rc;
      if (z > T(1)) z = T(1);
      const T z2 = z * z;
      const T z5 = z2 * z2 * z;
      return T(1) + T(5) * (z5 * z) - T(6) * z5;
    }
    case 2: {  // meam, window = rc
      const T x = clamp_to((c.rc - r) * c.inv_rc, T(0), T(1));
      const T w = (T(1) - x) * (T(1) - x);
      const T y = T(1) - w * w;
      return y * y;
    }
    case 3: {  // deepmd, rcs = 2/3 rc
      const T z = clamp_to((r - c.rcs) * c.inv_rc_rcs, T(0), T(1));
      const T recip = r > T(0) ? T(1) / r : T(0);
      return recip * (T(0.5) * d_cospi(z) + T(0.5));
    }
    default: {  // tersoff, d = 0.1 rc
      const T z = clamp_to((r - c.big_r) * c.inv_d, T(-1), T(1));
      return T(0.5) - T(0.5) * d_sinpi(T(0.5) * z);
    }
  }
}

// d cutoff_value / d r, written out as ops/cutoffs.py `cutoff_and_slope`
// does: 0 where a clamped argument lies outside its open interval.
template <typename T>
__device__ __forceinline__ T cutoff_slope(const Cutoff<T>& c, T r) {
  constexpr T kPi = T(3.14159265358979323846);
  switch (c.id) {
    case 0: {  // cosine
      const T z = r * c.inv_rc;
      return z < T(1) ? T(-0.5) * kPi * c.inv_rc * d_sinpi(z) : T(0);
    }
    case 1: {  // polynomial, gamma = 5
      const T z = r * c.inv_rc;
      if (!(z < T(1))) return T(0);
      const T z4 = (z * z) * (z * z);
      return T(30) * c.inv_rc * (z4 * z - z4);
    }
    case 2: {  // meam, window = rc
      const T x = (c.rc - r) * c.inv_rc;
      if (!(x > T(0) && x < T(1))) return T(0);
      const T w = (T(1) - x) * (T(1) - x) * (T(1) - x);
      return T(-8) * c.inv_rc * (T(1) - w * (T(1) - x)) * w;
    }
    case 3: {  // deepmd, rcs = 2/3 rc
      const T z = (r - c.rcs) * c.inv_rc_rcs;
      const T zc = clamp_to(z, T(0), T(1));
      const T recip = r > T(0) ? T(1) / r : T(0);
      const T ramp = z > T(0) && z < T(1)
                         ? T(-0.5) * kPi * c.inv_rc_rcs * d_sinpi(zc)
                         : T(0);
      return -recip * recip * (T(0.5) * d_cospi(zc) + T(0.5)) +
             recip * ramp;
    }
    default: {  // tersoff, d = 0.1 rc
      const T z = (r - c.big_r) * c.inv_d;
      return z > T(-1) && z < T(1)
                 ? T(-0.25) * kPi * c.inv_d * d_cospi(T(0.5) * z)
                 : T(0);
    }
  }
}

__device__ __forceinline__ void d_sincospi(float x, float* s, float* c) {
  sincospif(x, s, c);
}
__device__ __forceinline__ void d_sincospi(double x, double* s, double* c) {
  sincospi(x, s, c);
}

// `cutoff_value` and `cutoff_slope` together; the cosine cutoff takes
// both from one sincospi.
template <typename T>
__device__ __forceinline__ void cutoff_value_and_slope(const Cutoff<T>& c,
                                                       T r, T& f, T& s) {
  if (c.id != 0) {
    f = cutoff_value(c, r);
    s = cutoff_slope(c, r);
    return;
  }
  constexpr T kPi = T(3.14159265358979323846);
  const T z = r * c.inv_rc;
  if (z < T(1)) {
    T sn, cs;
    d_sincospi(z, &sn, &cs);
    f = T(0.5) * (cs + T(1));
    s = T(-0.5) * kPi * c.inv_rc * sn;
  } else {   // cos(pi) = -1: the value is 0 past rc, and so is the slope
    f = T(0);
    s = T(0);
  }
}

// JAX's derivative of a clamp (ops/cutoffs.py `clamp_weight`): 1 inside
// the open interval, 1/2 at a bound (jnp.minimum and jnp.maximum pass
// half the gradient at a tie), 0 outside. JAX clamps z = t / s, a
// division; t / s meets a bound +-1 (or 0) exactly where t == +-s (or
// t == 0), so the test is made on t, not on z: a product with 1 / s may
// round onto a bound or off it. Each cutoff's t and s:
//   cosine, polynomial  r / rc to (., 1]: r against rc;
//   meam        (rc - r) / rc to [0, 1]: rc - r against 0 and rc;
//   deepmd      (r - rcs) / (rc - rcs) to [0, 1]: r - rcs against 0 and
//               rc - rcs;
//   tersoff     (r - (rc - d)) / d to [-1, 1]: r - (rc - d) against -d, d.
template <typename T>
__device__ __forceinline__ T band_weight(T t, T lo, T hi) {
  return t > lo && t < hi ? T(1) : (t == lo || t == hi ? T(0.5) : T(0));
}

template <typename T>
__device__ __forceinline__ T below_weight(T r, T rc) {
  return r < rc ? T(1) : (r == rc ? T(0.5) : T(0));
}

// d2 cutoff_value / d r2, written out as ops/cutoffs.py
// `cutoff_slope_and_curvature` does, JAX's also at the knots: with w the
// clamp's derivative (`band_weight`), the clamp's part of the curvature
// takes w^2 (a quarter at a knot, 0 outside), deepmd's ramp through 1/r'
// takes w and its 1/r part stays whole.
template <typename T>
__device__ __forceinline__ T cutoff_curvature(const Cutoff<T>& c, T r) {
  constexpr T kPi = T(3.14159265358979323846);
  switch (c.id) {
    case 0: {  // cosine
      const T z = r * c.inv_rc;
      const T w = kPi * c.inv_rc;
      const T cw = below_weight(r, c.rc);
      return cw * cw * (T(-0.5) * w * w * d_cospi(z < T(1) ? z : T(1)));
    }
    case 1: {  // polynomial, gamma = 5
      T z = r * c.inv_rc;
      if (z > T(1)) z = T(1);
      const T cw = below_weight(r, c.rc);
      return cw * cw *
             (z * z * z * (T(150) * z - T(120)) * c.inv_rc * c.inv_rc);
    }
    case 2: {  // meam, window = rc
      const T x = clamp_to((c.rc - r) * c.inv_rc, T(0), T(1));
      const T u2 = (T(1) - x) * (T(1) - x);
      const T cw = band_weight(c.rc - r, T(0), c.rc);
      return cw * cw *
             (T(8) * c.inv_rc * c.inv_rc * (T(7) * u2 * u2 * u2 - T(3) * u2));
    }
    case 3: {  // deepmd, rcs = 2/3 rc
      const T zc = clamp_to((r - c.rcs) * c.inv_rc_rcs, T(0), T(1));
      const T recip = r > T(0) ? T(1) / r : T(0);
      const T w = kPi * c.inv_rc_rcs;
      const T cw = band_weight(r - c.rcs, T(0), c.rc_rcs);
      const T ramp = cw * (T(-0.5) * w * d_sinpi(zc));
      const T bend = cw * cw * (T(-0.5) * w * w * d_cospi(zc));
      const T s = T(0.5) * d_cospi(zc) + T(0.5);
      return (T(2) * s * recip - T(2) * ramp) * recip * recip + bend * recip;
    }
    default: {  // tersoff, d = 0.1 rc
      const T z = clamp_to((r - c.big_r) * c.inv_d, T(-1), T(1));
      const T w = kPi * c.inv_d;
      const T cw = band_weight(r - c.big_r, -c.d, c.d);
      return cw * cw * (T(0.125) * w * w * d_sinpi(T(0.5) * z));
    }
  }
}

// `cutoff_value`, `cutoff_slope` and `cutoff_curvature` together; the
// cosine cutoff takes all three from one sincospi.
template <typename T>
__device__ __forceinline__ void cutoff_value_slope_curvature(
    const Cutoff<T>& c, T r, T& f, T& s, T& k) {
  if (c.id != 0) {
    f = cutoff_value(c, r);
    s = cutoff_slope(c, r);
    k = cutoff_curvature(c, r);
    return;
  }
  constexpr T kPi = T(3.14159265358979323846);
  const T z = r * c.inv_rc;
  const T w = kPi * c.inv_rc;
  if (z < T(1)) {
    T sn, cs;
    d_sincospi(z, &sn, &cs);
    f = T(0.5) * (cs + T(1));
    s = T(-0.5) * w * sn;
    k = T(-0.5) * w * w * cs;
  } else {   // past rc the value, slope and curvature are 0
    f = T(0);
    s = T(0);
    k = T(0);
  }
  // at r == rc JAX's curvature is a quarter of the inside value (cos(pi)
  // = -1), past it 0; decided on r, as the product z may round either way
  if (!(r < c.rc)) k = r == c.rc ? T(0.125) * w * w : T(0);
}

template <typename T>
Cutoff<T> make_cutoff(int id, double rc) {
  Cutoff<T> c;
  c.id = id;
  c.rc = T(rc);
  c.inv_rc = T(1.0 / rc);
  const double rcs = (2.0 / 3.0) * rc;
  c.rcs = T(rcs);
  c.rc_rcs = T(rc - rcs);
  c.inv_rc_rcs = T(1.0 / (rc - rcs));
  const double d = 0.1 * rc;
  c.d = T(d);
  c.inv_d = T(1.0 / d);
  c.big_r = T(rc - d);
  return c;
}

}  // namespace
