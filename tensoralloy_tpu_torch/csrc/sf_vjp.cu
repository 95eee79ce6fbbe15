// Vector-Jacobian products of the Behler symmetry-function descriptors
// (G2 radial, G4 angular) for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// The backward of the Pallas TPU kernels `_g2_kernel` and `_g4_kernel`
// of tensoralloy_tpu/ops/fused.py, whose custom VJP is `jax.vjp` of the
// XLA references `_g2_ref_dense` / `_g4_ref_dense`. The Python wrappers
// (`g2_vjp_kernel`, `g4_vjp_kernel`), their closed-form plain versions
// (`g2_vjp_reference`, `g4_vjp_reference`) and the autograd Functions
// that call them are in tensoralloy_tpu_torch/ops/fused.py; the formulas
// are written out in those references' docstrings.
//
// Inputs are the forward's dense [rows, n] rows (distances, the slot as
// a float, a 0/1 mask) and a cotangent gbar [batch, rows, n_slots *
// n_params] (batch > 1: a committee's members, each its own cotangent,
// one launch). Outputs are [batch, rows, n]: G2 d/d rij, G4 d/d rij,
// d/d rik, d/d rjk. Every entry's derivative depends on its own geometry
// and on its slot's row of gbar only, so each is written once to its own
// place: no scatter, no atomic, the same bits at every run. A masked
// entry, or one whose slot is outside [0, n_slots), gets exactly 0 and
// its geometry is not read.
//
// What binds them on an H100: the bytes, as in the forwards. A pass
// reads the three (G2) or five (G4) input rows once and writes one (G2)
// or three (G4) output rows per batch member; the gbar row of an atom
// (S * T values) is read by the warp's lanes from L1. Per entry G2
// costs a cutoff and its slope and per grid row one exp2; G4 three
// cutoffs and slopes and per grid row an exp and a power or two (integer
// zeta by multiplies). What the design does about it:
//   * one warp per atom row, 4 rows a block, lanes on neighbouring
//     entries, so every load and store of the warp is 32 neighbouring
//     elements; no shared memory and no barrier;
//   * a lane's entry is computed once for all batch members: the
//     geometry, cutoffs and slopes are kept in registers and only the
//     grid loop (which reads each member's gbar row) repeats;
//   * the constants of the grid (-eta log2(e) / rc^2, 2 eta / rc^2 for
//     G2; 2^(1-zeta) and the integer zeta for G4) are folded on the host
//     in double and arrive as a kernel argument.
// A simple kernel first: the padding of a row still costs its lanes a
// read of mask and slot (rows are filled from the front, so a warp skips
// no work but issues no math for them).
// Full-precision exp/pow (common.cuh): float64 parity with the closed
// form depends on them.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParams = 64;

template <typename T>
struct G2VjpGrid {
  T scale[kMaxParams];  // -eta log2(e) / rc^2
  T slope[kMaxParams];  // 2 eta / rc^2
  T omega[kMaxParams];
};

template <typename T>
struct G4VjpGrid {
  T beta[kMaxParams];
  T gamma[kMaxParams];
  T zeta[kMaxParams];
  T scale[kMaxParams];    // 2^(1 - zeta)
  int izeta[kMaxParams];  // zeta where it is an integer in 1..16, else 0
};

__device__ __forceinline__ float d_exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double d_exp2(double x) { return exp2(x); }

// x^k by multiplies, k >= 0.
template <typename T>
__device__ __forceinline__ T int_pow(T x, int k) {
  T r = T(1);
  for (int i = 0; i < k; ++i) r *= x;
  return r;
}

// The entry's slot as an index, or -1 where the entry is masked or its
// slot is no integer in [0, n_slots) (the twins' [slot == s] mask).
template <typename T>
__device__ __forceinline__ int entry_slot(T mk, T sl, int n_slots) {
  if (!(mk > T(0)) || !(sl >= T(0)) || !(sl < T(n_slots))) return -1;
  const int s = static_cast<int>(sl);
  return T(s) == sl ? s : -1;
}

// d<gbar, G2>/d rij[b, row, j] = mask^2 sum_t gbar[b, row, s, t]
//   e_t (fc'(r) - fc(r) 2 eta_t (r - omega_t) / rc^2),
//   e_t = exp(-eta_t (r - omega_t)^2 / rc^2), s the entry's slot
template <typename T>
__global__ void __launch_bounds__(kThreads)
g2_vjp_kernel(const T* __restrict__ gbar, const T* __restrict__ rij,
              const T* __restrict__ slot, const T* __restrict__ mask,
              T* __restrict__ out, int batch, int rows, int n, int n_slots,
              int n_params, G2VjpGrid<T> grid, Cutoff<T> cut) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * n;
  const size_t width = static_cast<size_t>(n_slots) * n_params;
  const size_t plane = static_cast<size_t>(rows) * n;
  for (int j = lane; j < n; j += 32) {
    const T mk = mask[base + j];
    const int s = entry_slot(mk, slot[base + j], n_slots);
    if (s < 0) {
      for (int b = 0; b < batch; ++b) out[b * plane + base + j] = T(0);
      continue;
    }
    const T r = rij[base + j];
    const T fc = cutoff_value(cut, r) * mk;
    const T dfc = cutoff_slope(cut, r) * mk;
    for (int b = 0; b < batch; ++b) {
      const T* g = gbar + (static_cast<size_t>(b) * rows + row) * width +
                   static_cast<size_t>(s) * n_params;
      T acc = T(0);
      for (int t = 0; t < n_params; ++t) {
        const T d = r - grid.omega[t];
        const T e = d_exp2(grid.scale[t] * (d * d));
        acc += g[t] * e * (dfc - fc * grid.slope[t] * d);
      }
      out[b * plane + base + j] = acc * mk;
    }
  }
}

// d<gbar, G4>/d(rij, rik, rjk) of each triple (ops/fused.py
// `g4_vjp_reference`): with a, b, c the three distances,
//   d/da = fc3 (C dcos/da + Z 2a / rc^2) + V fc'(a) fc(b) fc(c), ...
// C = sum_t w_t P_t' E_t, Z = -sum_t w_t beta_t P_t E_t, V = sum_t w_t
// P_t E_t, w_t = gbar[b, row, s, t] mask^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
g4_vjp_kernel(const T* __restrict__ gbar, const T* __restrict__ rij,
              const T* __restrict__ rik, const T* __restrict__ rjk,
              const T* __restrict__ slot, const T* __restrict__ mask,
              T* __restrict__ out_a, T* __restrict__ out_b,
              T* __restrict__ out_c, int batch, int rows, int n,
              int n_slots, int n_params, G4VjpGrid<T> grid, Cutoff<T> cut,
              T inv_rc2) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * n;
  const size_t width = static_cast<size_t>(n_slots) * n_params;
  const size_t plane = static_cast<size_t>(rows) * n;
  for (int j = lane; j < n; j += 32) {
    const T mk = mask[base + j];
    const int s = entry_slot(mk, slot[base + j], n_slots);
    if (s < 0) {
      for (int b = 0; b < batch; ++b) {
        const size_t o = b * plane + base + j;
        out_a[o] = T(0);
        out_b[o] = T(0);
        out_c[o] = T(0);
      }
      continue;
    }
    const T a = rij[base + j], b_ = rik[base + j], c = rjk[base + j];
    const T a2 = a * a, b2 = b_ * b_, c2 = c * c;
    const T z = (a2 + b2 + c2) * inv_rc2;
    const T two_ab = T(2) * a * b_;
    const T cos_theta = (a2 + b2 - c2) / two_ab;
    const T dcos_a = (a2 - b2 + c2) / (two_ab * a);
    const T dcos_b = (b2 - a2 + c2) / (two_ab * b_);
    const T dcos_c = -c / (a * b_);
    const T fa = cutoff_value(cut, a), fb = cutoff_value(cut, b_),
            fcc = cutoff_value(cut, c);
    const T sa = cutoff_slope(cut, a), sb = cutoff_slope(cut, b_),
            sc = cutoff_slope(cut, c);
    const T fc3 = fa * fb * fcc;
    const T mm = mk * mk;
    for (int bb = 0; bb < batch; ++bb) {
      const T* g = gbar + (static_cast<size_t>(bb) * rows + row) * width +
                   static_cast<size_t>(s) * n_params;
      T coef_c = T(0), coef_z = T(0), coef_v = T(0);
      for (int t = 0; t < n_params; ++t) {
        const T arg = T(1) + grid.gamma[t] * cos_theta;
        const T base_t = arg > T(0) ? arg : T(0);
        const int iz = grid.izeta[t];
        const T pw = iz > 0 ? int_pow(base_t, iz) : d_pow(base_t, grid.zeta[t]);
        const T pw1 = arg > T(0)
                          ? (iz > 0 ? int_pow(base_t, iz - 1)
                                    : d_pow(base_t, grid.zeta[t] - T(1)))
                          : T(0);
        const T e = d_exp(-grid.beta[t] * z) * g[t];
        const T p = grid.scale[t] * pw * e;
        coef_v += p;
        coef_z -= grid.beta[t] * p;
        coef_c += grid.scale[t] * grid.zeta[t] * grid.gamma[t] * pw1 * e;
      }
      coef_c *= mm;
      coef_z *= mm;
      coef_v *= mm;
      const size_t o = bb * plane + base + j;
      out_a[o] = fc3 * (coef_c * dcos_a + coef_z * T(2) * a * inv_rc2) +
                 coef_v * sa * fb * fcc;
      out_b[o] = fc3 * (coef_c * dcos_b + coef_z * T(2) * b_ * inv_rc2) +
                 coef_v * fa * sb * fcc;
      out_c[o] = fc3 * (coef_c * dcos_c + coef_z * T(2) * c * inv_rc2) +
                 coef_v * fa * fb * sc;
    }
  }
}

bool bad_args(int batch, int rows, int n, int n_slots, int n_params,
              int cutoff_id) {
  return batch <= 0 || rows <= 0 || n <= 0 || n_slots <= 0 ||
         n_params <= 0 || n_params > kMaxParams || cutoff_id < 0 ||
         cutoff_id > 4;
}

[[maybe_unused]] int blocks_for(int rows) {
  return (rows + kWarps - 1) / kWarps;
}

template <typename T>
[[maybe_unused]] int launch_g2_vjp(const T* gbar, const T* rij,
                                   const T* slot, const T* mask, T* out,
                                   int batch, int rows, int n, int n_slots,
                                   int n_params, const double* eta,
                                   const double* omega, double rc,
                                   int cutoff_id, void* stream) {
  if (bad_args(batch, rows, n, n_slots, n_params, cutoff_id)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr double kLog2E = 1.4426950408889634074;
  G2VjpGrid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    grid.scale[t] = T(-eta[t] * kLog2E / (rc * rc));
    grid.slope[t] = T(2.0 * eta[t] / (rc * rc));
    grid.omega[t] = T(omega[t]);
  }
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  g2_vjp_kernel<T><<<blocks_for(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      gbar, rij, slot, mask, out, batch, rows, n, n_slots, n_params, grid,
      cut);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
[[maybe_unused]] int launch_g4_vjp(const T* gbar, const T* rij,
                                   const T* rik, const T* rjk,
                                   const T* slot, const T* mask, T* out_a,
                                   T* out_b, T* out_c, int batch, int rows,
                                   int n, int n_slots, int n_params,
                                   const double* beta, const double* gamma,
                                   const double* zeta, double rc,
                                   int cutoff_id, void* stream) {
  if (bad_args(batch, rows, n, n_slots, n_params, cutoff_id)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  G4VjpGrid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    grid.beta[t] = T(beta[t]);
    grid.gamma[t] = T(gamma[t]);
    grid.zeta[t] = T(zeta[t]);
    grid.scale[t] = T(std::pow(2.0, 1.0 - zeta[t]));
    const bool whole = zeta[t] >= 1.0 && zeta[t] <= 16.0 &&
                       zeta[t] == std::floor(zeta[t]);
    grid.izeta[t] = whole ? static_cast<int>(zeta[t]) : 0;
  }
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T inv_rc2 = T(1.0 / (rc * rc));
  g4_vjp_kernel<T><<<blocks_for(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      gbar, rij, rik, rjk, slot, mask, out_a, out_b, out_c, batch, rows, n,
      n_slots, n_params, grid, cut, inv_rc2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). A build that defines
// SF_VJP_ENTRY as 0..3 compiles that one entry point only (four
// compilers share the file); without it, all four.
#ifdef SF_VJP_ENTRY
#define SF_VJP_HAS_ENTRY(i) (SF_VJP_ENTRY == (i))
#else
#define SF_VJP_HAS_ENTRY(i) 1
#endif

extern "C" {

#if SF_VJP_HAS_ENTRY(0)
int sf_g2_vjp_f32(const float* gbar, const float* rij, const float* slot,
                  const float* mask, float* out, int batch, int rows, int n,
                  int n_slots, int n_params, const double* eta,
                  const double* omega, double rc, int cutoff_id,
                  void* stream) {
  return launch_g2_vjp<float>(gbar, rij, slot, mask, out, batch, rows, n,
                              n_slots, n_params, eta, omega, rc, cutoff_id,
                              stream);
}
#endif

#if SF_VJP_HAS_ENTRY(1)
int sf_g2_vjp_f64(const double* gbar, const double* rij, const double* slot,
                  const double* mask, double* out, int batch, int rows,
                  int n, int n_slots, int n_params, const double* eta,
                  const double* omega, double rc, int cutoff_id,
                  void* stream) {
  return launch_g2_vjp<double>(gbar, rij, slot, mask, out, batch, rows, n,
                               n_slots, n_params, eta, omega, rc, cutoff_id,
                               stream);
}
#endif

#if SF_VJP_HAS_ENTRY(2)
int sf_g4_vjp_f32(const float* gbar, const float* rij, const float* rik,
                  const float* rjk, const float* slot, const float* mask,
                  float* out_a, float* out_b, float* out_c, int batch,
                  int rows, int n, int n_slots, int n_params,
                  const double* beta, const double* gamma,
                  const double* zeta, double rc, int cutoff_id,
                  void* stream) {
  return launch_g4_vjp<float>(gbar, rij, rik, rjk, slot, mask, out_a, out_b,
                              out_c, batch, rows, n, n_slots, n_params,
                              beta, gamma, zeta, rc, cutoff_id, stream);
}
#endif

#if SF_VJP_HAS_ENTRY(3)
int sf_g4_vjp_f64(const double* gbar, const double* rij, const double* rik,
                  const double* rjk, const double* slot, const double* mask,
                  double* out_a, double* out_b, double* out_c, int batch,
                  int rows, int n, int n_slots, int n_params,
                  const double* beta, const double* gamma,
                  const double* zeta, double rc, int cutoff_id,
                  void* stream) {
  return launch_g4_vjp<double>(gbar, rij, rik, rjk, slot, mask, out_a,
                               out_b, out_c, batch, rows, n, n_slots,
                               n_params, beta, gamma, zeta, rc, cutoff_id,
                               stream);
}
#endif

}  // extern "C"
