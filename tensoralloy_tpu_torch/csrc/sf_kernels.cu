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
// slots hold finite garbage geometry, so nothing is computed from an
// entry whose mask is not > 0 (this also covers G4's division by
// r_ij * r_ik). Output is [rows, n_slots * n_params] in (slot, param)
// order.
//
// What binds them on an H100: each element is read once (3 arrays for
// G2, 5 for G4) and costs one cutoff (three for G4) plus n_params exp
// (and pow for G4); no matmul. At the serving widths (n = 128 / 256,
// n_params = 5 / 4) the reads bind: 168 MB for G4 at 32769 rows of 256,
// 0.050 ms at 3.35 TB/s; 50 MB for G2 at 32769 rows of 128, 0.015 ms,
// beside which its math (about 80 instructions an entry) is a
// co-limit. The grid parameters, the cutoff id and radius arrive as
// kernel arguments (a struct in the constant bank).
//   * G2: one warp per atom row, 4 rows a block, no shared memory and no
//     block barrier. The launch has at most 16 blocks an SM and a warp
//     strides over the rows; about 10 blocks are resident on an SM, each
//     warp with one row's twelve loads (1.5 KB at n = 128) started before
//     any math, 60 KB in flight an SM. A lane takes entries l, l + 32,
//     l + 64 and l + 96 of a 128-entry span, so every warp load reads 32
//     neighbouring elements whatever the row's alignment, and since rows
//     are filled from the front, a pass whose 32 entries are all masked
//     is skipped by the whole warp: as many passes as a compaction of
//     the real entries would leave, without its staging. A masked entry
//     reads r = 1 with weight 0 (no divergent branch). Each term is one
//     exp2: -eta log2(e) / rc^2 is folded on the host, in double; four
//     terms run with no branch between them. An entry's terms go to its
//     slot's accumulators in registers, up to 4 slots a pass over the row
//     (a template bound; one slot alone has no per-term select), and a
//     reduce-scatter of xor shuffles (V - 1 shuffles for V columns) leaves
//     each column in a lane of its own to store.
//   * G4: one warp per atom row, kWarps rows per block, no block
//     barrier. A lane reads 8 entries of a 256-entry span as two
//     16-byte loads per array (each warp load 512 contiguous bytes),
//     all five arrays' loads issued before any math.
//     Warp ballots compact the span's real entries (mask > 0) into a
//     per-warp stage in shared memory; one lane per entry computes
//     them, so masked tails cost no lanes and the per-entry math is one
//     copy of code. Each entry's terms go to its slot's accumulators in
//     registers (SB slots at a time, a template bound; more slots read
//     the row again, from cache). The reduction is xor shuffles only.
//     An integer zeta (1..16) is raised by multiplies, others by
//     full-precision pow.
// Full-precision exp/pow/cos are used on purpose (common.cuh).

#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"
#include "sf_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParams = 64;

template <typename T>
struct G2Grid {
  T scale[kMaxParams];  // -eta log2(e) / rc^2
  T omega[kMaxParams];
};

template <typename T>
struct G4Grid {
  T beta[kMaxParams];
  T gamma[kMaxParams];
  T zeta[kMaxParams];
  T scale[kMaxParams];  // 2^(1 - zeta)
  int izeta[kMaxParams];  // zeta where it is an integer in 1..16, else 0
};

constexpr int kG2Entries = 4;                 // G2 entries a lane owns
constexpr int kG2Span = 32 * kG2Entries;      // G2 entries a warp reads
// Blocks launched per SM, at most: more than are resident at once (10 at
// the served instantiation's 45 registers), so that the blocks still
// waiting fill the launch's tail; each warp strides over 4 rows or so.
// Measured on an H100 at 32769 rows of 128, float, in builds that
// differed in this number alone: 10, 16, 20 and 32 blocks an SM took
// 0.0244, 0.0242, 0.0247 and 0.0251 ms; one row a warp (8193 blocks)
// took a fifth more than 16 an SM.
constexpr int kG2BlocksPerSm = 16;

// A lane's entries of one span of one row.
template <typename T>
struct G2Span {
  T r[kG2Entries], sl[kG2Entries], mk[kG2Entries];
};

// Entries [j0, j0 + kG2Span) of the row at `base`, zeros past n: lane l
// takes entries j0 + 32 i + l, so each of the warp's loads reads 32
// neighbouring elements, whatever the row's alignment. All twelve loads
// are started before any value is used.
template <typename T>
__device__ __forceinline__ void g2_load(const T* __restrict__ rij,
                                        const T* __restrict__ slot,
                                        const T* __restrict__ mask,
                                        size_t base, int j0, int n,
                                        G2Span<T>& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kG2Entries; ++i) {
    const int j = j0 + 32 * i + lane;
    const bool in = j < n;
    v.mk[i] = in ? mask[base + j] : T(0);
    v.sl[i] = in ? slot[base + j] : T(0);
    v.r[i] = in ? rij[base + j] : T(0);
  }
}

// Term t of one entry, weight w, into its slot's accumulator.
template <typename T, int P, int SB>
__device__ __forceinline__ void g2_term(int t, T r, T w, T sl, int s0,
                                        const G2Grid<T>& grid,
                                        T (&acc)[SB][P]) {
  const T d = r - grid.omega[t];
  const T term = d_exp2(grid.scale[t] * (d * d)) * w;
  if (SB == 1) {
    acc[0][t] += term;
  } else {
#pragma unroll
    for (int ss = 0; ss < SB; ++ss) {
      acc[ss][t] += sl == T(s0 + ss) ? term : T(0);
    }
  }
}

// One span's G2 terms into the accumulators of slots [s0, s0 + ns). An
// entry that is masked or of another slot reads r = 1 and weighs 0, as
// in the twin. Rows are filled from the front, so the spans' later
// entries are mostly masked: a pass in which no lane has a real entry
// is skipped by the whole warp.
template <typename T, int P, int SB>
__device__ __forceinline__ void g2_span(const G2Span<T>& v, int s0, int ns,
                                        int n_params, const G2Grid<T>& grid,
                                        const Cutoff<T>& cut,
                                        T (&acc)[SB][P]) {
#pragma unroll
  for (int i = 0; i < kG2Entries; ++i) {
    const T sl = v.sl[i];
    const bool real = v.mk[i] > T(0) && sl >= T(s0) && sl < T(s0 + ns);
    if (!__any_sync(kFull, real)) continue;
    const T r = real ? v.r[i] : T(1);
    const T w = real ? cutoff_value(cut, r) * v.mk[i] : T(0);
    // four terms at a time with no branch between them, so that their
    // exp2 chains overlap; the grid's last rows one by one
#pragma unroll
    for (int t0 = 0; t0 < P; t0 += 4) {
      if (t0 + 4 <= n_params) {
#pragma unroll
        for (int t = t0; t < t0 + 4; ++t) {
          g2_term<T, P, SB>(t, r, w, sl, s0, grid, acc);
        }
      } else {
#pragma unroll
        for (int t = t0; t < t0 + 4; ++t) {
          if (t < n_params) g2_term<T, P, SB>(t, r, w, sl, s0, grid, acc);
        }
      }
    }
  }
}

// G2[a, s, t] = sum_j [slot_aj == s] mask_aj fc(r_aj)
//               exp(-eta_t (r_aj - omega_t)^2 / rc^2)
template <typename T, int P, int SB>
__global__ void __launch_bounds__(kThreads)
g2_kernel(const T* __restrict__ rij, const T* __restrict__ slot,
          const T* __restrict__ mask, T* __restrict__ out, int rows, int n,
          int n_slots, int n_params, G2Grid<T> grid, Cutoff<T> cut) {
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps;
  for (int row = first; row < rows; row += stride) {   // warp-uniform
    const size_t base = static_cast<size_t>(row) * n;
    T* out_row = out + static_cast<size_t>(row) * n_slots * n_params;
    for (int s0 = 0; s0 < n_slots; s0 += SB) {
      const int ns = min(SB, n_slots - s0);
      T acc[SB][P];
#pragma unroll
      for (int ss = 0; ss < SB; ++ss) {
#pragma unroll
        for (int t = 0; t < P; ++t) acc[ss][t] = T(0);
      }
      for (int j0 = 0; j0 < n; j0 += kG2Span) {
        G2Span<T> v;
        g2_load(rij, slot, mask, base, j0, n, v);
        g2_span<T, P, SB>(v, s0, ns, n_params, grid, cut, acc);
      }
      reduce_store<T, P, SB>(acc, ns, n_params, out_row + s0 * n_params);
    }
  }
}

// Sum of v over the warp, in every lane.
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// x^k by k - 1 multiplies, k >= 1.
template <typename T>
__device__ __forceinline__ T int_pow(T x, int k) {
  T r = x;
  for (int i = 1; i < k; ++i) r *= x;
  return r;
}

// One triple's G4 terms into the accumulators of slots [s0, s0 + ns);
// the caller passes only entries with mask > 0.
template <typename T, int P, int SB>
__device__ __forceinline__ void g4_entry(T a, T b, T c, T sl, T mk, int s0,
                                         int ns, int n_params,
                                         const G4Grid<T>& grid,
                                         const Cutoff<T>& cut, T inv_rc2,
                                         T (&acc)[SB][P]) {
  const T a2 = a * a, b2 = b * b, c2 = c * c;
  const T z = (a2 + b2 + c2) * inv_rc2;
  const T cos_theta = (a2 + b2 - c2) / (T(2) * a * b);
  const T fc3 = cutoff_value(cut, a) * cutoff_value(cut, b) *
                cutoff_value(cut, c);
#pragma unroll
  for (int t = 0; t < P; ++t) {
    if (t < n_params) {
      T base_t = T(1) + grid.gamma[t] * cos_theta;
      if (base_t < T(0)) base_t = T(0);
      const T powed = grid.izeta[t] > 0 ? int_pow(base_t, grid.izeta[t])
                                        : d_pow(base_t, grid.zeta[t]);
      const T v = grid.scale[t] * powed * d_exp(-grid.beta[t] * z) * fc3 *
                  mk;
#pragma unroll
      for (int ss = 0; ss < SB; ++ss) {
        if (ss < ns && sl == T(s0 + ss)) acc[ss][t] += v;
      }
    }
  }
}

// G4[a, s, t] = sum_{triples j<k of a} [slot == s] mask
//   2^(1-zeta) max(1 + gamma cos theta, 0)^zeta
//   exp(-beta (r_ij^2 + r_ik^2 + r_jk^2) / rc^2) fc(r_ij) fc(r_ik) fc(r_jk)
template <typename T, int P, int SB>
__global__ void __launch_bounds__(kThreads)
g4_kernel(const T* __restrict__ rij, const T* __restrict__ rik,
          const T* __restrict__ rjk, const T* __restrict__ slot,
          const T* __restrict__ mask, T* __restrict__ out, int rows, int n,
          int n_slots, int n_params, G4Grid<T> grid, Cutoff<T> cut,
          T inv_rc2, bool vec) {
  __shared__ T stage_all[kWarps][5][kSpan];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;   // the whole warp leaves together
  T(*stage)[kSpan] = stage_all[warp];
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t base = static_cast<size_t>(row) * n;
  T* out_row = out + static_cast<size_t>(row) * n_slots * n_params;
  for (int s0 = 0; s0 < n_slots; s0 += SB) {
    const int ns = min(SB, n_slots - s0);
    T acc[SB][P];
#pragma unroll
    for (int ss = 0; ss < SB; ++ss) {
#pragma unroll
      for (int t = 0; t < P; ++t) acc[ss][t] = T(0);
    }
    for (int j0 = 0; j0 < n; j0 += kSpan) {
      T a[kLaneEntries], b[kLaneEntries], c[kLaneEntries];
      T sl[kLaneEntries], mk[kLaneEntries];
      load8(rij + base, j0, n, vec, a);
      load8(rik + base, j0, n, vec, b);
      load8(rjk + base, j0, n, vec, c);
      load8(slot + base, j0, n, vec, sl);
      load8(mask + base, j0, n, vec, mk);
      __syncwarp();   // the last span's readers are done with the stage
      int count = 0;
#pragma unroll
      for (int i = 0; i < kLaneEntries; ++i) {
        const bool active =
            mk[i] > T(0) && sl[i] >= T(s0) && sl[i] < T(s0 + ns);
        const unsigned ballot = __ballot_sync(0xffffffffu, active);
        if (active) {
          const int pos = count + __popc(ballot & lanes_below);
          stage[0][pos] = a[i];
          stage[1][pos] = b[i];
          stage[2][pos] = c[i];
          stage[3][pos] = sl[i];
          stage[4][pos] = mk[i];
        }
        count += __popc(ballot);
      }
      __syncwarp();
      for (int p = lane; p < count; p += 32) {
        g4_entry<T, P, SB>(stage[0][p], stage[1][p], stage[2][p],
                           stage[3][p], stage[4][p], s0, ns, n_params, grid,
                           cut, inv_rc2, acc);
      }
    }
#pragma unroll
    for (int ss = 0; ss < SB; ++ss) {
      if (ss >= ns) continue;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        if (t < n_params) {
          const T v = warp_allsum(acc[ss][t]);
          if (lane == (t & 31)) out_row[(s0 + ss) * n_params + t] = v;
        }
      }
    }
  }
}

bool bad_args(int rows, int n, int n_slots, int n_params, int cutoff_id) {
  return rows <= 0 || n <= 0 || n_slots <= 0 || n_params <= 0 ||
         n_params > kMaxParams || cutoff_id < 0 || cutoff_id > 4;
}

// Streaming multiprocessors of the current device, or 0 with `*e` set.
[[maybe_unused]] int sm_count(cudaError_t* e) {
  int device = 0, sms = 0;
  *e = cudaGetDevice(&device);
  if (*e == cudaSuccess) {
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

template <typename T>
int launch_g2(const T* rij, const T* slot, const T* mask, T* out, int rows,
              int n, int n_slots, int n_params, const double* eta,
              const double* omega, double rc, int cutoff_id, void* stream) {
  if (bad_args(rows, n, n_slots, n_params, cutoff_id)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr double kLog2E = 1.4426950408889634074;
  G2Grid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    grid.scale[t] = T(-eta[t] * kLog2E / (rc * rc));
    grid.omega[t] = T(omega[t]);
  }
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const int most = sm_count(&e) * kG2BlocksPerSm;
  if (e != cudaSuccess) return static_cast<int>(e);
  const int needed = (rows + kWarps - 1) / kWarps;
  const int blocks = needed < most ? needed : most;
  return dispatch_params(n_params, [&](auto p) {
    constexpr int P = decltype(p)::value;
    // slots a pass over the row: SB * P <= 32 accumulators; one slot
    // alone needs no per-term slot select
    constexpr int SB = P <= 8 ? 4 : (P <= 16 ? 2 : 1);
    auto kernel = n_slots == 1 ? g2_kernel<T, P, 1> : g2_kernel<T, P, SB>;
    kernel<<<blocks, kThreads, 0, st>>>(rij, slot, mask, out, rows, n,
                                        n_slots, n_params, grid, cut);
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
    const bool whole = zeta[t] >= 1.0 && zeta[t] <= 16.0 &&
                       zeta[t] == std::floor(zeta[t]);
    grid.izeta[t] = whole ? static_cast<int>(zeta[t]) : 0;
  }
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T inv_rc2 = T(1.0 / (rc * rc));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n * sizeof(T) % 16 == 0 &&
                   aligned16(rij) && aligned16(rik) && aligned16(rjk) &&
                   aligned16(slot) && aligned16(mask);
  const int blocks = (rows + kWarps - 1) / kWarps;
  return dispatch_params(n_params, [&](auto p) {
    constexpr int P = decltype(p)::value;
    // slots a pass: SB * P = 16 accumulators up to P = 16; one slot
    // alone needs no per-entry slot select
    constexpr int SB = P <= 4 ? 4 : (P <= 8 ? 2 : 1);
    auto kernel = n_slots == 1 ? g4_kernel<T, P, 1> : g4_kernel<T, P, SB>;
    kernel<<<blocks, kThreads, 0, st>>>(rij, rik, rjk, slot, mask, out, rows,
                                        n, n_slots, n_params, grid, cut,
                                        inv_rc2, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). A build that defines
// SF_ENTRY as 0..3 compiles that one entry point only, so that four
// compilers can share the file's instantiations between them; without
// it, all four.
#ifdef SF_ENTRY
#define SF_HAS_ENTRY(i) (SF_ENTRY == (i))
#else
#define SF_HAS_ENTRY(i) 1
#endif

extern "C" {

#if SF_HAS_ENTRY(0)
int sf_g2_f32(const float* rij, const float* slot, const float* mask,
              float* out, int rows, int n, int n_slots, int n_params,
              const double* eta, const double* omega, double rc,
              int cutoff_id, void* stream) {
  return launch_g2<float>(rij, slot, mask, out, rows, n, n_slots, n_params,
                          eta, omega, rc, cutoff_id, stream);
}
#endif

#if SF_HAS_ENTRY(1)
int sf_g2_f64(const double* rij, const double* slot, const double* mask,
              double* out, int rows, int n, int n_slots, int n_params,
              const double* eta, const double* omega, double rc,
              int cutoff_id, void* stream) {
  return launch_g2<double>(rij, slot, mask, out, rows, n, n_slots,
                           n_params, eta, omega, rc, cutoff_id, stream);
}
#endif

#if SF_HAS_ENTRY(2)
int sf_g4_f32(const float* rij, const float* rik, const float* rjk,
              const float* slot, const float* mask, float* out, int rows,
              int n, int n_slots, int n_params, const double* beta,
              const double* gamma, const double* zeta, double rc,
              int cutoff_id, void* stream) {
  return launch_g4<float>(rij, rik, rjk, slot, mask, out, rows, n, n_slots,
                          n_params, beta, gamma, zeta, rc, cutoff_id,
                          stream);
}
#endif

#if SF_HAS_ENTRY(3)
int sf_g4_f64(const double* rij, const double* rik, const double* rjk,
              const double* slot, const double* mask, double* out, int rows,
              int n, int n_slots, int n_params, const double* beta,
              const double* gamma, const double* zeta, double rc,
              int cutoff_id, void* stream) {
  return launch_g4<double>(rij, rik, rjk, slot, mask, out, rows, n,
                           n_slots, n_params, beta, gamma, zeta, rc,
                           cutoff_id, stream);
}
#endif

}  // extern "C"
