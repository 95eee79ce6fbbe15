// What the symmetry-function kernels (sf_kernels.cu, sf_vjp.cu) share:
// G4's wide loads of a 256-entry span, the launchers' alignment check and
// their dispatch on the grid's size.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLaneEntries = 8;                    // G4 entries a lane owns
constexpr int kSpan = 32 * kLaneEntries;           // G4 entries a warp reads

// A lane's 8 entries of the span at j0: v[0, 4) = p[j0 + 4 lane, + 4)
// and v[4, 8) = p[j0 + 128 + 4 lane, + 4), zero past n, so each warp
// load reads 512 contiguous bytes. 16-byte loads where `vec` (row and
// pointer aligned) and the 4 entries lie inside the row.
__device__ __forceinline__ void load_quad(const float* p, int j, int n,
                                          bool vec, float* v) {
  if (vec && j + 4 <= n) {
    const float4 a = *reinterpret_cast<const float4*>(p + j);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = j + i < n ? p[j + i] : 0.f;
  }
}

__device__ __forceinline__ void load_quad(const double* p, int j, int n,
                                          bool vec, double* v) {
  if (vec && j + 4 <= n) {
    const double2 a = *reinterpret_cast<const double2*>(p + j);
    const double2 b = *reinterpret_cast<const double2*>(p + j + 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = j + i < n ? p[j + i] : 0.0;
  }
}

// A lane's 8 entries of the span at j0 of the row at p.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int j0, int n, bool vec,
                                      T (&v)[kLaneEntries]) {
  const int lane = threadIdx.x & 31;
  load_quad(p, j0 + 4 * lane, n, vec, v);
  load_quad(p, j0 + kSpan / 2 + 4 * lane, n, vec, v + 4);
}

[[maybe_unused]] bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

}  // namespace
