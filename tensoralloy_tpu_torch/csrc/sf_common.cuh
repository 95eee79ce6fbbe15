// What the symmetry-function kernels (sf_kernels.cu, sf_vjp.cu,
// sf_vjp_bwd.cu) share: 16-byte loads and stores of quads, the G2 VJP
// kernels' row walk by quads, the G4 VJP kernels' by a 256-entry span
// compacted into a per-warp stage with the zero stores of its entries
// of no slot, a warp's copy of a row's cotangent, the reduce-scatter of
// per-lane sums, the G2 grid's folded constants, the launchers'
// alignment check and their dispatch on the grid's size.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kLaneEntries = 8;                    // span entries a lane owns
constexpr int kSpan = 32 * kLaneEntries;           // entries a warp reads
constexpr int kMaxGridRows = 64;                   // kMaxParams
// Bytes of a warp's stage of its row's cotangent gbar (n_slots * n_params
// values a member) in the G2 VJP kernels and the second-order kernels;
// the G2 VJP kernel walks as many members together as it holds
constexpr int kGbarStageBytes = 8192;

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

// Zeros at p[0, 4), 16-byte aligned where `vec`.
__device__ __forceinline__ void store_zero_quad(float* p, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = 0.f;
  }
}

__device__ __forceinline__ void store_zero_quad(double* p, bool vec) {
  if (vec) {
    *reinterpret_cast<double2*>(p) = make_double2(0.0, 0.0);
    *reinterpret_cast<double2*>(p + 2) = make_double2(0.0, 0.0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = 0.0;
  }
}

// v[0, 4) to p[j, j + 4) within the row's n entries: one 16-byte store
// where `vec` and the quad lies inside the row.
__device__ __forceinline__ void store_quad(float* p, int j, int n, bool vec,
                                           const float (&v)[4]) {
  if (vec && j + 4 <= n) {
    *reinterpret_cast<float4*>(p + j) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j + i < n) p[j + i] = v[i];
    }
  }
}

__device__ __forceinline__ void store_quad(double* p, int j, int n, bool vec,
                                           const double (&v)[4]) {
  if (vec && j + 4 <= n) {
    *reinterpret_cast<double2*>(p + j) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + j + 2) = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j + i < n) p[j + i] = v[i];
    }
  }
}

// The row walk of the G2 VJP kernels (g2_vjp, g2_vjp_bwd): G2's work an
// entry is a cutoff and an exp2 a grid row, too little to pay for a
// compaction or for a load that waits on the mask. Lane l takes the
// quads of entries [j, j + 4), j = 4 l, 4 l + 128, ..., of the row, and
// issues every load of a quad before any math, as the forward does: one
// 16-byte load each of mask, slot, x and y (each warp load 512
// contiguous bytes) where `vec`; y may be null (zeros). Then
// quad(j, mk, sv, any, x, y): `sv` each entry's slot, -1 where it is
// masked or its slot is not in [0, n_slots), `any` whether one is real.
// A quad stores its four outputs as one 16-byte store; a quad of padding
// stores zeros and computes nothing, though its x and y were read.
template <typename T, typename Quad>
__device__ __forceinline__ void walk_quads(const T* mask_row,
                                           const T* slot_row,
                                           const T* x_row, const T* y_row,
                                           int n, int n_slots, bool vec,
                                           Quad&& quad) {
  for (int j = 4 * (threadIdx.x & 31); j < n; j += 128) {
    T mk[4], sl[4], x[4], y[4] = {T(0), T(0), T(0), T(0)};
    load_quad(mask_row, j, n, vec, mk);
    load_quad(slot_row, j, n, vec, sl);
    load_quad(x_row, j, n, vec, x);
    if (y_row != nullptr) load_quad(y_row, j, n, vec, y);
    int sv[4];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sv[i] = entry_slot(mk[i], sl[i], n_slots);   // -1 past n (mask 0)
      any |= sv[i] >= 0;
    }
    quad(j, mk, sv, any, x, y);
  }
}

// A warp's stage of one span's real entries, in row order: each one's
// index in the row, slot and mask.
template <typename T>
struct SpanStage {
  int j[kSpan];
  int s[kSpan];
  T m[kSpan];
};

// The row walk of the G4 VJP kernels (g4_vjp, g4_vjp_bwd), whose work an
// entry is large. Reads the lane's 8 mask and slot
// entries of the span at j0 (two 16-byte loads of each, all issued
// before any math) and places the span's entries with mask > 0 and a
// slot in [s0, s0 + ns) in `st` in row order: the lanes' first quads,
// then their second, each placed by a warp prefix sum of its count (holes
// and interleaved slots are fine). -> their number. `sv` gets each of
// the lane's entries' slot, -1 where it is masked or its slot is not in
// [0, n_slots). The caller calls __syncwarp() before it reads `st`.
template <typename T>
__device__ __forceinline__ int stage_span(const T* mask_row,
                                          const T* slot_row, int j0, int n,
                                          int n_slots, int s0, int ns,
                                          bool vec, SpanStage<T>& st,
                                          int (&sv)[kLaneEntries]) {
  const int lane = threadIdx.x & 31;
  T mk[kLaneEntries], sl[kLaneEntries];
  load8(mask_row, j0, n, vec, mk);
  load8(slot_row, j0, n, vec, sl);
#pragma unroll
  for (int i = 0; i < kLaneEntries; ++i) {
    sv[i] = entry_slot(mk[i], sl[i], n_slots);   // -1 past n (mask 0)
  }
  __syncwarp();   // the last span's readers are done with the stage
  int count = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int c = 0;
#pragma unroll
    for (int i = 4 * h; i < 4 * h + 4; ++i) {
      c += sv[i] >= s0 && sv[i] < s0 + ns;
    }
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int pos = count + incl - c;
#pragma unroll
    for (int i = 4 * h; i < 4 * h + 4; ++i) {
      if (sv[i] >= s0 && sv[i] < s0 + ns) {
        st.j[pos] = j0 + h * (kSpan / 2) + 4 * lane + (i - 4 * h);
        st.s[pos] = sv[i];
        st.m[pos] = mk[i];
        ++pos;
      }
    }
    count += __shfl_sync(kFull, incl, 31);
  }
  return count;
}

// The span's entries of no slot (sv < 0) inside the row set to 0 in each
// of the K outputs, in the planes of members [b0, b1) (plane b at
// out + b * plane, the row at `base`): a quad with none as one 16-byte
// store an output and member.
template <typename T, int K>
__device__ __forceinline__ void zero_unslotted(
    const int (&sv)[kLaneEntries], int j0, int n, bool vec,
    T* const (&outs)[K], size_t base, size_t plane, int b0, int b1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + h * (kSpan / 2) + 4 * lane;
    const bool none = sv[4 * h] < 0 && sv[4 * h + 1] < 0 &&
                      sv[4 * h + 2] < 0 && sv[4 * h + 3] < 0;
    for (int b = b0; b < b1; ++b) {
      const size_t o = b * plane + base + j;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (none && j + 4 <= n) {
          store_zero_quad(outs[k] + o, vec);
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (sv[4 * h + i] < 0 && j + i < n) outs[k][o + i] = T(0);
        }
      }
    }
  }
}

// dst[i] = src[i] for i < count by the warp's lanes (a row's cotangent
// into the warp's stage); the caller calls __syncwarp() before reading.
template <typename T>
__device__ __forceinline__ void warp_copy(T* dst, const T* __restrict__ src,
                                          int count) {
  for (int i = threadIdx.x & 31; i < count; i += 32) dst[i] = src[i];
}

// Sum each of the SB * P accumulators over the warp and store the
// columns of slots < ns and parameters < n_params to
// out[ss * n_params + t]. A reduce-scatter: each xor step halves the
// values a lane holds (the lane keeps one half and adds its partner's),
// so V values cost V - 1 shuffles, not 5 V; once one value is left, the
// remaining steps add it across the lanes that share its column. The
// lanes' order of addition is fixed: the same sums give the same bits.
template <typename T, int P, int SB>
__device__ __forceinline__ void reduce_store(const T (&acc)[SB][P], int ns,
                                             int n_params, T* out) {
  constexpr int V = SB * P;
  const int lane = threadIdx.x & 31;
  T a[V];
#pragma unroll
  for (int ss = 0; ss < SB; ++ss) {
#pragma unroll
    for (int t = 0; t < P; ++t) a[ss * P + t] = acc[ss][t];
  }
  int width = V;   // values the lane holds: a[0, width)
  int first = 0;   // flat index (ss * P + t) of a[0]
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (width > 1) {
      const int half = width / 2;
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < half) {
          const T send = upper ? a[i] : a[i + half];
          const T keep = upper ? a[i + half] : a[i];
          a[i] = keep + __shfl_xor_sync(kFull, send, off);
        }
      }
      if (upper) first += half;
      width = half;
    } else {
      a[0] += __shfl_xor_sync(kFull, a[0], off);
    }
  }
  // a value summed over the steps left after width reached 1 is the same
  // in the lanes that differ in the low bits: the lowest of them stores
  constexpr int kSharing = V >= 32 ? 1 : 32 / V;
  if ((lane & (kSharing - 1)) != 0) return;
#pragma unroll
  for (int i = 0; i < (V + 31) / 32; ++i) {
    const int ss = (first + i) / P, t = (first + i) % P;
    if (ss < ns && t < n_params) out[ss * n_params + t] = a[i];
  }
}

// acc[ss][t] += x where ss is the entry's slot less s0 (the select of each
// register keeps the accumulators out of local memory); one slot a pass
// needs no select.
template <typename T, int P, int SB>
__device__ __forceinline__ void add_to_slot(T (&acc)[SB][P], int t, int ss,
                                            T x) {
  if (SB == 1) {
    acc[0][t] += x;
  } else {
#pragma unroll
    for (int k = 0; k < SB; ++k) acc[k][t] += k == ss ? x : T(0);
  }
}

// G2's grid as its VJP kernels take it, folded on the host in double.
template <typename T>
struct G2VjpGrid {
  T scale[kMaxGridRows];  // -eta log2(e) / rc^2
  T slope[kMaxGridRows];  // 2 eta / rc^2
  T omega[kMaxGridRows];
};

template <typename T>
G2VjpGrid<T> make_g2_vjp_grid(const double* eta, const double* omega,
                              double rc, int n_params) {
  constexpr double kLog2E = 1.4426950408889634074;
  G2VjpGrid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    grid.scale[t] = T(-eta[t] * kLog2E / (rc * rc));
    grid.slope[t] = T(2.0 * eta[t] / (rc * rc));
    grid.omega[t] = T(omega[t]);
  }
  return grid;
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
