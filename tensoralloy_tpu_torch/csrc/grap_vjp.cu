// Vector-Jacobian product of the GRAP moment-tensor descriptors for
// NVIDIA Hopper (sm_90a), with a plain C interface for ctypes.
//
// The backward of the Pallas TPU kernel `_grap_kernel` of
// tensoralloy_tpu/ops/fused.py:170, whose custom VJP is `jax.vjp` of the
// XLA reference `_grap_ref_dense`. The Python wrapper `grap_vjp_kernel`,
// its closed-form plain version `grap_vjp_reference` and `GrapFunction`
// are in tensoralloy_tpu_torch/ops/fused.py.
//
// With the forward's notation (grap_kernel.cu), for an atom row and its
// slot s:
//   Pbar[k, d] = P[k, d] sum_m c[k, m] w[d, m],   c = 2 gbar[s, k, m] for
//     a moment above 0, gbar[s, k, m] sign(P0) / sqrt(Q0 + 1e-16) for
//     moment 0 (Q0 = sum_d w[d, m] P[k, d]^2, P0 = P[k, 0]);
//   d/d r_j  = sum_k h_k'(r_j) sum_d Pbar[k, d] m_d(u_j),
//   d/d u_j  = sum_d (d m_d / d u) sum_k Pbar[k, d] h_k(r_j),
// each times the entry's mask; h_k = filter_k fc mask. The unit-vector
// part runs the monomial recurrence backwards (`monomials_adjoint`), the
// chain rule of how `monomials` builds each monomial from its prefix.
// Inputs are the forward's [rows, n] rows and gbar [batch, rows,
// n_slots * K * M] (batch > 1: a committee's members or a linear
// model's coefficients, one launch); outputs four [batch, rows, n]. An
// entry's derivative is written once to its own place (no atomics on
// device memory); a masked entry, or one of no slot, gets exactly 0.
//
// What binds it on an H100: FP32 FMAs, about three times the forward's
// contraction a pair: 2 K D to recompute P, 4 K D to take both sums
// over Pbar (K = 16, D = 56 at the serving shape: 5376 FMA-FLOP a pair).
// The design, a simple one first:
//   * one block of 128 threads per atom row; for each slot two passes
//     over the row, with P and Pbar [K, D] in shared memory (7 KB of
//     float at K = 16, 29 KB at K = 64);
//   * pass 1 recomputes P: 64 entries a step, a thread per entry stages
//     its h [K] and its 56 monomials (in 16-byte chunks, rows padded by
//     one chunk) if it is a pair of the slot, and the block then adds
//     the step to P, each thread a 2 x 4 tile of (filter, monomial) in
//     registers (three shared loads for eight FMAs); a step stops at its
//     last pair of the slot (rows are filled from the front);
//   * per batch member, one barrier forms the [K, M] coefficients and
//     another Pbar;
//   * pass 2: a thread per entry recomputes its monomials and, per
//     filter, h and h', and takes both sums over the filter's row of
//     Pbar with 16-byte loads that every lane reads at once (a
//     broadcast), keeping d/dm [56] in registers; then the adjoint
//     recurrence gives d/du.
// Recomputing P costs about one forward; saving it from the forward
// would cost [rows, S, K, D] of device memory (115 MB at 32769 rows,
// S = 1, K = 16, D = 56, float) and a change to the forward kernel.
// Full-precision exp/pow/sqrt (common.cuh): float64 parity with the
// closed form depends on them.

#include <cuda_runtime.h>

#include <cstddef>
#include <map>
#include <mutex>

#include "common.cuh"
#include "grap_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStage = 64;             // entries staged a step of pass 1
constexpr int kMaxFilters = 64;
constexpr int kMaxMoments = 6;
constexpr int kTK = 2;                 // pass 1: a thread's tile of
constexpr int kTD = 4;                 //   2 filters x 4 monomials
constexpr int kMaxDp = 56;             // kMaxMonomials, a multiple of kTD

enum Algorithm { kSf = 0, kDensity = 1, kMorse = 2, kPexp = 3 };

template <typename T>
struct GrapVjpSpec {
  int algorithm;
  int n_filters;   // K
  int n_mono;      // D
  int n_moments;   // M
  T c0[kMaxFilters];   // sf: eta   density: A     morse: D      pexp: rl
  T c1[kMaxFilters];   // sf: omega density: beta  morse: gamma  pexp: pl
  T c2[kMaxFilters];   //           density: re    morse: r0
  int moment[kMaxMoments];
};

// Shared-memory layout, fixed on the host from (K, D).
struct Layout {
  int kp;   // K padded to kTK
  int dp;   // D padded to kTD
  int ms;   // row stride of the staged monomials: dp and a 16-byte chunk
  int hs;   // row stride of the staged filter values: kp + 1 (odd)
};

// Elements of T in a 16-byte chunk: 4 floats, 2 doubles.
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

// The entry's slot as an index, or -1 where the entry is masked or its
// slot is no integer in [0, n_slots) (the twin's [slot == s] mask).
template <typename T>
__device__ __forceinline__ int entry_slot(T mk, T sl, int n_slots) {
  if (!(mk > T(0)) || !(sl >= T(0)) || !(sl < T(n_slots))) return -1;
  const int s = static_cast<int>(sl);
  return T(s) == sl ? s : -1;
}

// Filter k at distance r before the cutoff (the twin's `_filter_values`)
// and its slope (ops/fused.py `grap_filter_and_slope`), from its grid
// row (c0, c1, c2).
template <typename T>
__device__ __forceinline__ void filter_and_slope(int algorithm, T c0, T c1,
                                                 T c2, T r, T rc2, T& f,
                                                 T& df) {
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
      const T x = d_pow(r / c0, c1);
      f = d_exp(-x);
      df = -c1 * x / r * f;
      return;
    }
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
grap_vjp_kernel(const T* __restrict__ gbar, const T* __restrict__ rij,
                const T* __restrict__ ux, const T* __restrict__ uy,
                const T* __restrict__ uz, const T* __restrict__ slot,
                const T* __restrict__ mask, const T* __restrict__ w,
                T* __restrict__ out_r, T* __restrict__ out_x,
                T* __restrict__ out_y, T* __restrict__ out_z, int batch,
                int rows, int n, int n_slots, Layout lay,
                const __grid_constant__ GrapVjpSpec<T> spec,
                const __grid_constant__ Cutoff<T> cut, T rc2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = kChunk<T>;
  const int K = spec.n_filters, D = spec.n_mono, M = spec.n_moments;
  const int kp = lay.kp, dp = lay.dp;
  T* p_s = reinterpret_cast<T*>(smem_raw);       // [kp, dp] P
  T* pbar_s = p_s + kp * dp;                     // [kp, dp] Pbar
  T* m_s = pbar_s + kp * dp;                     // [kStage, ms] monomials
  T* h_s = m_s + kStage * lay.ms;                // [kStage, hs] filters
  T* w_s = h_s + kStage * lay.hs;                // [dp, M] weights
  T* alpha_s = w_s + dp * kMaxMoments;           // [kp, kMaxMoments]
  // one past the last pair of the step, for even and odd steps: a step
  // resets the next step's while every thread has read the last one's
  int* last_s = reinterpret_cast<int*>(alpha_s + kp * kMaxMoments);

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * n;
  const size_t plane = static_cast<size_t>(rows) * n;
  const size_t width = static_cast<size_t>(n_slots) * K * M;
  for (int i = tid; i < dp * M; i += kThreads) {
    const int d = i / M;
    w_s[i] = d < D ? w[i] : T(0);
  }
  // entries of no slot: 0 in every output
  for (int j = tid; j < n; j += kThreads) {
    if (entry_slot(mask[base + j], slot[base + j], n_slots) >= 0) continue;
    for (int b = 0; b < batch; ++b) {
      const size_t o = b * plane + base + j;
      out_r[o] = T(0);
      out_x[o] = T(0);
      out_y[o] = T(0);
      out_z[o] = T(0);
    }
  }
  const int td_n = dp / kTD, tiles = kp / kTK * td_n;
  if (tid == 0) last_s[0] = last_s[1] = 0;
  int step = 0;

  for (int s = 0; s < n_slots; ++s) {
    // ---- pass 1: P[k, d] = sum_j [slot_j == s] h_k(r_j) m_d(u_j)
    for (int i = tid; i < kp * dp; i += kThreads) p_s[i] = T(0);
    for (int j0 = 0; j0 < n; j0 += kStage, ++step) {
      __syncthreads();   // P zeroed, the last step's tiles read
      if (tid == 0) last_s[(step + 1) & 1] = 0;
      if (tid < kStage) {
        const int j = j0 + tid;
        const bool act =
            j < n && entry_slot(mask[base + j], slot[base + j], n_slots) == s;
        T* h_row = h_s + tid * lay.hs;
        T* m_row = m_s + tid * lay.ms;
        if (act) {
          atomicMax(last_s + (step & 1), tid + 1);
          const T r = rij[base + j];
          const T fc = cutoff_value(cut, r) * mask[base + j];
          for (int k = 0; k < kp; ++k) {
            T f = T(0), df;
            if (k < K) {
              filter_and_slope(spec.algorithm, spec.c0[k], spec.c1[k],
                               spec.c2[k], r, rc2, f, df);
            }
            h_row[k] = f * fc;
          }
          T m[kMaxMonomials];
          monomials(ux[base + j], uy[base + j], uz[base + j], m);
#pragma unroll
          for (int c = 0; c < kMaxDp / V; ++c) {
            if (c * V < dp) {
              T v[V];
#pragma unroll
              for (int q = 0; q < V; ++q) {
                v[q] = c * V + q < D ? m[c * V + q] : T(0);
              }
              store_chunk(m_row + c * V, v);
            }
          }
        } else {
          for (int k = 0; k < kp; ++k) h_row[k] = T(0);
          for (int d = 0; d < dp; ++d) m_row[d] = T(0);
        }
      }
      __syncthreads();
      const int nb = last_s[step & 1];
      for (int tile = tid; tile < tiles; tile += kThreads) {
        const int k0 = tile / td_n * kTK, d0 = tile % td_n * kTD;
        T acc[kTK][kTD];
#pragma unroll
        for (int a = 0; a < kTK; ++a) {
#pragma unroll
          for (int b = 0; b < kTD; ++b) acc[a][b] = T(0);
        }
        for (int p = 0; p < nb; ++p) {
          T hv[kTK], mv[kTD];
#pragma unroll
          for (int a = 0; a < kTK; ++a) hv[a] = h_s[p * lay.hs + k0 + a];
#pragma unroll
          for (int q = 0; q < kTD; q += V) {
            load_chunk(m_s + p * lay.ms + d0 + q, mv + q);
          }
#pragma unroll
          for (int a = 0; a < kTK; ++a) {
#pragma unroll
            for (int b = 0; b < kTD; ++b) {
              acc[a][b] = fma(hv[a], mv[b], acc[a][b]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < kTK; ++a) {
#pragma unroll
          for (int b = 0; b < kTD; ++b) {
            p_s[(k0 + a) * dp + d0 + b] += acc[a][b];
          }
        }
      }
    }
    __syncthreads();   // P complete

    for (int b = 0; b < batch; ++b) {
      // ---- the invariants' coefficients c[k, m], then Pbar
      const T* g = gbar + (static_cast<size_t>(b) * rows + row) * width +
                   static_cast<size_t>(s) * K * M;
      for (int i = tid; i < K * M; i += kThreads) {
        const int k = i / M, mi = i - k * M;
        T a = g[i];
        if (spec.moment[mi] == 0) {
          T q0 = T(0);
          for (int d = 0; d < D; ++d) {
            const T p = p_s[k * dp + d];
            q0 += w_s[d * M + mi] * (p * p);
          }
          const T p0 = p_s[k * dp];
          // sign(0) is 0, as in both frameworks
          const T sgn = p0 > T(0) ? T(1) : (p0 < T(0) ? T(-1) : T(0));
          a = a * sgn / d_sqrt(q0 + T(1e-16));
        } else {
          a = T(2) * a;
        }
        alpha_s[k * kMaxMoments + mi] = a;
      }
      __syncthreads();
      for (int i = tid; i < kp * dp; i += kThreads) {
        const int k = i / dp, d = i - k * dp;
        T c = T(0);
        if (k < K && d < D) {
          for (int mi = 0; mi < M; ++mi) {
            c += alpha_s[k * kMaxMoments + mi] * w_s[d * M + mi];
          }
        }
        pbar_s[i] = p_s[i] * c;
      }
      __syncthreads();

      // ---- pass 2: each pair of slot s
      for (int j = tid; j < n; j += kThreads) {
        if (entry_slot(mask[base + j], slot[base + j], n_slots) != s) {
          continue;
        }
        const T mk = mask[base + j];
        const T r = rij[base + j];
        const T x = ux[base + j], y = uy[base + j], z = uz[base + j];
        const T fc = cutoff_value(cut, r) * mk;
        const T dfc = cutoff_slope(cut, r) * mk;
        T m[kMaxMonomials], dm[kMaxMonomials];
        monomials(x, y, z, m);
#pragma unroll
        for (int d = 0; d < kMaxMonomials; ++d) dm[d] = T(0);
        T gr = T(0);
        for (int k = 0; k < K; ++k) {
          T f, df;
          filter_and_slope(spec.algorithm, spec.c0[k], spec.c1[k],
                           spec.c2[k], r, rc2, f, df);
          const T h = f * fc, dh = df * fc + f * dfc;
          const T* pb = pbar_s + k * dp;
          T t = T(0);
#pragma unroll
          for (int c = 0; c < kMaxDp / V; ++c) {
            if (c * V < dp) {
              T pv[V];
              load_chunk(pb + c * V, pv);
#pragma unroll
              for (int q = 0; q < V; ++q) {
                t = fma(pv[q], m[c * V + q], t);
                dm[c * V + q] = fma(pv[q], h, dm[c * V + q]);
              }
            }
          }
          gr = fma(dh, t, gr);
        }
        T gx = T(0), gy = T(0), gz = T(0);
        monomials_adjoint(x, y, z, m, dm, gx, gy, gz);
        const size_t o = b * plane + base + j;
        out_r[o] = gr * mk;
        out_x[o] = gx * mk;
        out_y[o] = gy * mk;
        out_z[o] = gz * mk;
      }
      __syncthreads();   // the next member rewrites the coefficients
    }
  }
}

// Raise `kernel`'s dynamic shared-memory limit to `smem` where a launch
// needs more than the default 48 KB (a launch asking for more than the
// limit is refused, so the limit only grows); asked once per (device,
// kernel, size) and kept.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, size_t> limits;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> guard(lock);
  size_t& limit = limits[std::make_pair(device, kernel)];
  if (smem > limit) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    limit = smem;
  }
  return cudaSuccess;
}

template <typename T>
[[maybe_unused]] int launch_grap_vjp(
    const T* gbar, const T* rij, const T* ux, const T* uy, const T* uz,
    const T* slot, const T* mask, const T* w, T* out_r, T* out_x, T* out_y,
    T* out_z, int batch, int rows, int n, int n_slots, int algorithm,
    int n_filters, const double* c0, const double* c1, const double* c2,
    int n_mono, const unsigned short* codes, int n_moments,
    const int* moments, double rc, int cutoff_id, void* stream) {
  if (batch <= 0 || rows <= 0 || n <= 0 || n_slots <= 0 ||
      algorithm < kSf || algorithm > kPexp || n_filters <= 0 ||
      n_filters > kMaxFilters || n_mono <= 0 || n_mono > kMaxMonomials ||
      n_moments <= 0 || n_moments > kMaxMoments || cutoff_id < 0 ||
      cutoff_id > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GrapVjpSpec<T> spec;
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
    if (codes[d] != kCodes[d]) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int m = 0; m < kMaxMoments; ++m) {
    spec.moment[m] = m < n_moments ? moments[m] : -1;
  }
  Layout lay;
  lay.kp = (n_filters + kTK - 1) / kTK * kTK;
  lay.dp = (n_mono + kTD - 1) / kTD * kTD;
  lay.ms = lay.dp + kChunk<T>;
  lay.hs = lay.kp + 1;
  const size_t smem =
      sizeof(T) * (2 * lay.kp * lay.dp + kStage * (lay.ms + lay.hs) +
                   kMaxMoments * (lay.dp + lay.kp)) +
      2 * sizeof(int);
  auto kernel = grap_vjp_kernel<T>;
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      gbar, rij, ux, uy, uz, slot, mask, w, out_r, out_x, out_y, out_z,
      batch, rows, n, n_slots, lay, spec, make_cutoff<T>(cutoff_id, rc),
      T(rc * rc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). `w` is a device array
// [n_mono, n_moments] of the input type; the parameter tables and the
// monomial codes are host arrays copied into the launch. A build that
// defines GRAP_VJP_ENTRY as 0 or 1 compiles that one entry point only.
#ifdef GRAP_VJP_ENTRY
#define GRAP_VJP_HAS_ENTRY(i) (GRAP_VJP_ENTRY == (i))
#else
#define GRAP_VJP_HAS_ENTRY(i) 1
#endif

extern "C" {

#if GRAP_VJP_HAS_ENTRY(0)
int grap_vjp_f32(const float* gbar, const float* rij, const float* ux,
                 const float* uy, const float* uz, const float* slot,
                 const float* mask, const float* w, float* out_r,
                 float* out_x, float* out_y, float* out_z, int batch,
                 int rows, int n, int n_slots, int algorithm, int n_filters,
                 const double* c0, const double* c1, const double* c2,
                 int n_mono, const unsigned short* codes, int n_moments,
                 const int* moments, double rc, int cutoff_id,
                 void* stream) {
  return launch_grap_vjp<float>(gbar, rij, ux, uy, uz, slot, mask, w, out_r,
                                out_x, out_y, out_z, batch, rows, n, n_slots,
                                algorithm, n_filters, c0, c1, c2, n_mono,
                                codes, n_moments, moments, rc, cutoff_id,
                                stream);
}
#endif

#if GRAP_VJP_HAS_ENTRY(1)
int grap_vjp_f64(const double* gbar, const double* rij, const double* ux,
                 const double* uy, const double* uz, const double* slot,
                 const double* mask, const double* w, double* out_r,
                 double* out_x, double* out_y, double* out_z, int batch,
                 int rows, int n, int n_slots, int algorithm, int n_filters,
                 const double* c0, const double* c1, const double* c2,
                 int n_mono, const unsigned short* codes, int n_moments,
                 const int* moments, double rc, int cutoff_id,
                 void* stream) {
  return launch_grap_vjp<double>(gbar, rij, ux, uy, uz, slot, mask, w,
                                 out_r, out_x, out_y, out_z, batch, rows, n,
                                 n_slots, algorithm, n_filters, c0, c1, c2,
                                 n_mono, codes, n_moments, moments, rc,
                                 cutoff_id, stream);
}
#endif

}  // extern "C"
