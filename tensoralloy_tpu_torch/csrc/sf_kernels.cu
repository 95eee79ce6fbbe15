// Behler symmetry-function descriptors (G2 radial, G4 angular) for
// NVIDIA Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels `_g2_kernel` and `_g4_kernel` of
// tensoralloy_tpu/ops/fused.py. The Python wrappers, their plain
// PyTorch twins and the autograd Functions are in
// tensoralloy_tpu_torch/ops/fused.py.
//
// Inputs are the dense per-atom layout: [rows, n] row-major arrays of
// distances, the slot index carried as a float, and a 0/1 mask. Padded
// slots hold finite garbage geometry, so a slot whose mask is not > 0 is
// skipped before anything is computed from it (this also covers G4's
// division by r_ij * r_ik). Output is [rows, n_slots * n_params] in
// (slot, param) order.
//
// What bounds it on an H100: each element is read once (3 arrays for G2,
// 5 for G4) and costs one cutoff plus n_params exp (and pow for G4); no
// matmul. At the serving widths (n = 128 / 256, n_params = 5 / 4) the
// reads dominate, so the design keeps each element's work in registers
// and writes only the reduced row:
//   * one block of 128 threads per atom row; threads stride over n;
//   * the grid parameters, the cutoff id and radius arrive as kernel
//     arguments (a struct in the constant bank);
//   * per slot, each thread accumulates its n_params partial sums in
//     registers (the template bound P keeps the array in registers),
//     then warp shuffles and one shared-memory step reduce each column.
// Full-precision exp/pow/cos are used on purpose (common.cuh).

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParams = 64;

template <typename T>
struct G2Grid {
  T eta[kMaxParams];
  T omega[kMaxParams];
};

template <typename T>
struct G4Grid {
  T beta[kMaxParams];
  T gamma[kMaxParams];
  T zeta[kMaxParams];
  T scale[kMaxParams];  // 2^(1 - zeta)
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Reduce acc[t] over the block and write out_row[t], t < n_params.
template <typename T, int P>
__device__ __forceinline__ void reduce_store(const T (&acc)[P],
                                             T (*partial)[P],
                                             int n_params, T* out_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < P; ++t) {
    if (t < n_params) {
      const T v = warp_sum(acc[t]);
      if (lane == 0) partial[warp][t] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < n_params) {
    T v = partial[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += partial[w][threadIdx.x];
    out_row[threadIdx.x] = v;
  }
  __syncthreads();
}

// G2[a, s, t] = sum_j [slot_aj == s] mask_aj fc(r_aj)
//               exp(-eta_t (r_aj - omega_t)^2 / rc^2)
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
g2_kernel(const T* __restrict__ rij, const T* __restrict__ slot,
          const T* __restrict__ mask, T* __restrict__ out, int n,
          int n_slots, int n_params, G2Grid<T> grid, Cutoff<T> cut,
          T rc2) {
  __shared__ T partial[kWarps][P];
  const size_t row = blockIdx.x;
  const T* r_row = rij + row * n;
  const T* s_row = slot + row * n;
  const T* m_row = mask + row * n;
  T* out_row = out + row * n_slots * n_params;
  for (int s = 0; s < n_slots; ++s) {
    const T slot_value = T(s);
    T acc[P];
#pragma unroll
    for (int t = 0; t < P; ++t) acc[t] = T(0);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const T m = m_row[j];
      if (!(m > T(0)) || s_row[j] != slot_value) continue;
      const T r = r_row[j];
      const T w = cutoff_value(cut, r) * m;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        if (t < n_params) {
          const T d = r - grid.omega[t];
          acc[t] += d_exp(-grid.eta[t] * (d * d / rc2)) * w;
        }
      }
    }
    reduce_store<T, P>(acc, partial, n_params, out_row + s * n_params);
  }
}

// G4[a, s, t] = sum_{triples j<k of a} [slot == s] mask
//   2^(1-zeta) max(1 + gamma cos theta, 0)^zeta
//   exp(-beta (r_ij^2 + r_ik^2 + r_jk^2) / rc^2) fc(r_ij) fc(r_ik) fc(r_jk)
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
g4_kernel(const T* __restrict__ rij, const T* __restrict__ rik,
          const T* __restrict__ rjk, const T* __restrict__ slot,
          const T* __restrict__ mask, T* __restrict__ out, int n,
          int n_slots, int n_params, G4Grid<T> grid, Cutoff<T> cut,
          T rc2) {
  __shared__ T partial[kWarps][P];
  const size_t row = blockIdx.x;
  const size_t base = row * n;
  T* out_row = out + row * n_slots * n_params;
  for (int s = 0; s < n_slots; ++s) {
    const T slot_value = T(s);
    T acc[P];
#pragma unroll
    for (int t = 0; t < P; ++t) acc[t] = T(0);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const T m = mask[base + j];
      if (!(m > T(0)) || slot[base + j] != slot_value) continue;
      const T a = rij[base + j];
      const T b = rik[base + j];
      const T c = rjk[base + j];
      const T a2 = a * a, b2 = b * b, c2 = c * c;
      const T z = (a2 + b2 + c2) / rc2;
      const T cos_theta = (a2 + b2 - c2) / (T(2) * a * b);
      const T fc3 = cutoff_value(cut, a) * cutoff_value(cut, b) *
                    cutoff_value(cut, c);
#pragma unroll
      for (int t = 0; t < P; ++t) {
        if (t < n_params) {
          T base_t = T(1) + grid.gamma[t] * cos_theta;
          if (base_t < T(0)) base_t = T(0);
          const T v = grid.scale[t] * d_pow(base_t, grid.zeta[t]) *
                      d_exp(-grid.beta[t] * z) * fc3;
          acc[t] += v * m;
        }
      }
    }
    reduce_store<T, P>(acc, partial, n_params, out_row + s * n_params);
  }
}

bool bad_args(int rows, int n, int n_slots, int n_params, int cutoff_id) {
  return rows <= 0 || n <= 0 || n_slots <= 0 || n_params <= 0 ||
         n_params > kMaxParams || cutoff_id < 0 || cutoff_id > 4;
}

// Smallest register-array bound P >= n_params.
template <typename F>
int dispatch_params(int n_params, F&& launch) {
  if (n_params <= 4) return launch(std::integral_constant<int, 4>());
  if (n_params <= 8) return launch(std::integral_constant<int, 8>());
  if (n_params <= 16) return launch(std::integral_constant<int, 16>());
  if (n_params <= 32) return launch(std::integral_constant<int, 32>());
  return launch(std::integral_constant<int, 64>());
}

template <typename T>
int launch_g2(const T* rij, const T* slot, const T* mask, T* out, int rows,
              int n, int n_slots, int n_params, const double* eta,
              const double* omega, double rc, int cutoff_id, void* stream) {
  if (bad_args(rows, n, n_slots, n_params, cutoff_id)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  G2Grid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    grid.eta[t] = T(eta[t]);
    grid.omega[t] = T(omega[t]);
  }
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T rc2 = T(rc * rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_params(n_params, [&](auto p) {
    g2_kernel<T, decltype(p)::value><<<rows, kThreads, 0, st>>>(
        rij, slot, mask, out, n, n_slots, n_params, grid, cut, rc2);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_g4(const T* rij, const T* rik, const T* rjk, const T* slot,
              const T* mask, T* out, int rows, int n, int n_slots,
              int n_params, const double* beta, const double* gamma,
              const double* zeta, double rc, int cutoff_id, void* stream) {
  if (bad_args(rows, n, n_slots, n_params, cutoff_id)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  G4Grid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    grid.beta[t] = T(beta[t]);
    grid.gamma[t] = T(gamma[t]);
    grid.zeta[t] = T(zeta[t]);
    grid.scale[t] = T(std::pow(2.0, 1.0 - zeta[t]));
  }
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T rc2 = T(rc * rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_params(n_params, [&](auto p) {
    g4_kernel<T, decltype(p)::value><<<rows, kThreads, 0, st>>>(
        rij, rik, rjk, slot, mask, out, n, n_slots, n_params, grid, cut,
        rc2);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success).
extern "C" {

int sf_g2_f32(const float* rij, const float* slot, const float* mask,
              float* out, int rows, int n, int n_slots, int n_params,
              const double* eta, const double* omega, double rc,
              int cutoff_id, void* stream) {
  return launch_g2<float>(rij, slot, mask, out, rows, n, n_slots, n_params,
                          eta, omega, rc, cutoff_id, stream);
}

int sf_g2_f64(const double* rij, const double* slot, const double* mask,
              double* out, int rows, int n, int n_slots, int n_params,
              const double* eta, const double* omega, double rc,
              int cutoff_id, void* stream) {
  return launch_g2<double>(rij, slot, mask, out, rows, n, n_slots,
                           n_params, eta, omega, rc, cutoff_id, stream);
}

int sf_g4_f32(const float* rij, const float* rik, const float* rjk,
              const float* slot, const float* mask, float* out, int rows,
              int n, int n_slots, int n_params, const double* beta,
              const double* gamma, const double* zeta, double rc,
              int cutoff_id, void* stream) {
  return launch_g4<float>(rij, rik, rjk, slot, mask, out, rows, n, n_slots,
                          n_params, beta, gamma, zeta, rc, cutoff_id,
                          stream);
}

int sf_g4_f64(const double* rij, const double* rik, const double* rjk,
              const double* slot, const double* mask, double* out, int rows,
              int n, int n_slots, int n_params, const double* beta,
              const double* gamma, const double* zeta, double rc,
              int cutoff_id, void* stream) {
  return launch_g4<double>(rij, rik, rjk, slot, mask, out, rows, n,
                           n_slots, n_params, beta, gamma, zeta, rc,
                           cutoff_id, stream);
}

}  // extern "C"
