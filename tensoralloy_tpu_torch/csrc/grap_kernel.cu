// GRAP moment-tensor descriptors for NVIDIA Hopper (sm_90a), with a plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_grap_kernel` of
// tensoralloy_tpu/ops/fused.py:170 (with `_grap_pallas` and `fused_grap`).
// The Python wrapper, its plain PyTorch twin and the autograd Function
// are in tensoralloy_tpu_torch/ops/fused.py.
//
// For each atom row a and slot s (neighbor element class):
//   h_k(r) = filter k (sf / density / morse / pexp) times fc(r) mask
//   m_d(u) = the d-th unique monomial of the unit vector, degree <= 5
//   P[s, k, d] = sum_j [slot_aj == s] h_k(r_aj) m_d(u_aj)
//   G[s, k, m] = sum_d w[d, m] P[s, k, d]^2, and for moment 0
//                sign(P[s, k, 0]) sqrt(that + 1e-16)
// Output is [rows, n_slots * K * M] in (slot, filter, moment) order, M
// the requested moments (gaps such as [0, 2, 5] allowed); w is the
// multiplicity tensor's requested columns, computed in double on the
// host.
//
// What bounds it on an H100: the P contraction, 2 A N K D flops (7.5
// GFLOP at 32000 atoms, A = 32769, N = 128, K = 16, D = 56) against about
// 100 MB of input reads, about 75 flop/byte: CUDA-core FMAs bound it, not
// memory. Tensor cores are later work: TF32 would break parity, and
// 3xTF32 or wgmma is a redesign. What the design does about it:
//   * one block of 128 threads per atom row; the row is walked in chunks
//     of up to 128 pairs;
//   * per chunk, the pairs of the current slot whose mask is > 0 are
//     compacted (warp ballots) into shared memory, so masked tails and
//     other slots' pairs cost no FMAs; a masked entry's geometry is never
//     read;
//   * per compacted pair, h_k and the D monomials are staged in shared
//     memory; each monomial is the product of its degree-(m-1) prefix
//     and one more component, as the JAX `moment_basis_c` builds it;
//   * the contraction runs on 2 x 4 register tiles of P (8 FMAs per 6
//     shared-memory loads), accumulated across chunks in shared memory;
//   * the filter table, the monomial tables, the cutoff id and radius
//     constants arrive as __grid_constant__ kernel arguments, so one
//     binary serves every model.
// Dynamic shared memory is sized on the host from (K, D, M, chunk); at
// float64 the chunk shrinks towards 48 KB, and the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize to what it asks for. Full-
// precision pow/exp/sqrt (common.cuh): float64 parity with the twin
// depends on them.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFilters = 64;
constexpr int kMaxMonomials = 56;   // max_moment 5
constexpr int kMaxMoments = 6;
constexpr int kTileK = 2;
constexpr int kTileD = 4;
constexpr size_t kSmemTarget = 48 * 1024;   // the default opt-in limit

enum Algorithm { kSf = 0, kDensity = 1, kMorse = 2, kPexp = 3 };

template <typename T>
struct GrapSpec {
  int algorithm;
  int n_filters;   // K
  int n_mono;      // D
  int n_moments;   // M
  T c0[kMaxFilters];   // sf: eta   density: A     morse: D      pexp: rl
  T c1[kMaxFilters];   // sf: omega density: beta  morse: gamma  pexp: pl
  T c2[kMaxFilters];   //           density: re    morse: r0
  unsigned char parent[kMaxMonomials];  // m_d = m_parent[d] * u_axis[d]
  unsigned char axis[kMaxMonomials];
  int moment[kMaxMoments];
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Filter k at distance r, before the cutoff (ops/fused.py twin).
template <typename T>
__device__ __forceinline__ T filter_value(const GrapSpec<T>& g, int k, T r,
                                          T rc2) {
  switch (g.algorithm) {
    case kSf: {
      const T d = r - g.c1[k];
      return d_exp(-g.c0[k] * (d * d) / rc2);
    }
    case kDensity:
      return g.c0[k] * d_exp(-g.c1[k] * (r / g.c2[k] - T(1)));
    case kMorse: {
      const T x = g.c1[k] * (r - g.c2[k]);
      return g.c0[k] * (d_exp(T(-2) * x) - T(2) * d_exp(-x));
    }
    default:
      return d_exp(-d_pow(r / g.c0[k], g.c1[k]));
  }
}

// Shared-memory layout, in elements of T. The h and m row strides are
// odd, so the per-pair writes of neighbouring threads hit distinct banks.
struct Layout {
  int kp, dp, hs, ms;            // padded K, D; h and m row strides
  int w, p, h, m, r, c, total;   // offsets

  __host__ __device__ Layout(int k, int d, int n_moments, int chunk) {
    kp = round_up(k, kTileK);
    dp = round_up(d, kTileD);
    hs = kp + 1;
    ms = dp + 1;
    w = 0;
    p = w + d * n_moments;
    h = p + kp * dp;
    m = h + chunk * hs;
    r = m + chunk * ms;
    c = r + chunk;
    total = c + chunk;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
grap_kernel(const T* __restrict__ rij, const T* __restrict__ ux,
            const T* __restrict__ uy, const T* __restrict__ uz,
            const T* __restrict__ slot, const T* __restrict__ mask,
            const T* __restrict__ w, T* __restrict__ out, int n,
            int n_slots, int chunk, const __grid_constant__ GrapSpec<T> spec,
            const __grid_constant__ Cutoff<T> cut, T rc2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_count[kWarps];
  const int k_f = spec.n_filters, n_mono = spec.n_mono;
  const int n_mom = spec.n_moments;
  const Layout lay(k_f, n_mono, n_mom, chunk);
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* w_s = smem + lay.w;   // [D, M] invariant weights
  T* p_s = smem + lay.p;   // [kp, dp] P of the current slot
  T* h_s = smem + lay.h;   // [chunk, hs] filter values of compacted pairs
  T* m_s = smem + lay.m;   // [chunk, ms] monomials of compacted pairs
  T* r_s = smem + lay.r;   // [chunk] distances
  T* c_s = smem + lay.c;   // [chunk] cutoff times mask

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const size_t base = row * n;
  T* out_row = out + row * static_cast<size_t>(n_slots * k_f * n_mom);
  const int tiles_d = lay.dp / kTileD;
  const int n_tiles = (lay.kp / kTileK) * tiles_d;

  for (int i = tid; i < n_mono * n_mom; i += kThreads) w_s[i] = w[i];

  for (int s = 0; s < n_slots; ++s) {
    const T slot_value = T(s);
    for (int i = tid; i < lay.kp * lay.dp; i += kThreads) p_s[i] = T(0);

    for (int j0 = 0; j0 < n; j0 += chunk) {
      // the previous chunk's readers are done with h_s, m_s, r_s, c_s
      // (and p_s is zeroed, w_s loaded, before the first chunk)
      __syncthreads();
      const int jj = tid;
      bool active = false;
      size_t idx = 0;
      T m_val = T(0);
      if (jj < chunk && j0 + jj < n) {
        idx = base + j0 + jj;
        m_val = mask[idx];
        active = m_val > T(0) && slot[idx] == slot_value;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, active);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int offset = 0, n_active = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        if (v < warp) offset += warp_count[v];
        n_active += warp_count[v];
      }
      if (n_active == 0) continue;   // uniform across the block
      if (active) {
        const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
        const T r = rij[idx];
        r_s[pos] = r;
        c_s[pos] = cutoff_value(cut, r) * m_val;
        const T u0 = ux[idx], u1 = uy[idx], u2 = uz[idx];
        T* m_row = m_s + pos * lay.ms;
        m_row[0] = T(1);
        for (int d = 1; d < n_mono; ++d) {
          const int ax = spec.axis[d];
          const T u = ax == 0 ? u0 : (ax == 1 ? u1 : u2);
          m_row[d] = m_row[spec.parent[d]] * u;
        }
        for (int d = n_mono; d < lay.dp; ++d) m_row[d] = T(0);
      }
      __syncthreads();

      // filters of the compacted pairs; padded filter rows read zero
      for (int e = tid; e < n_active * lay.kp; e += kThreads) {
        const int k = e / n_active, p = e - k * n_active;
        h_s[p * lay.hs + k] =
            k < k_f ? filter_value(spec, k, r_s[p], rc2) * c_s[p] : T(0);
      }
      __syncthreads();

      // P[k, d] += sum_p h[p, k] m[p, d] on 2 x 4 register tiles
      for (int t = tid; t < n_tiles; t += kThreads) {
        const int k0 = (t / tiles_d) * kTileK;
        const int d0 = (t % tiles_d) * kTileD;
        T acc[kTileK][kTileD];
#pragma unroll
        for (int a = 0; a < kTileK; ++a) {
#pragma unroll
          for (int b = 0; b < kTileD; ++b) {
            acc[a][b] = p_s[(k0 + a) * lay.dp + d0 + b];
          }
        }
        for (int p = 0; p < n_active; ++p) {
          const T* h_row = h_s + p * lay.hs + k0;
          const T* m_row = m_s + p * lay.ms + d0;
          T hv[kTileK], mv[kTileD];
#pragma unroll
          for (int a = 0; a < kTileK; ++a) hv[a] = h_row[a];
#pragma unroll
          for (int b = 0; b < kTileD; ++b) mv[b] = m_row[b];
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
#pragma unroll
            for (int b = 0; b < kTileD; ++b) acc[a][b] += hv[a] * mv[b];
          }
        }
#pragma unroll
        for (int a = 0; a < kTileK; ++a) {
#pragma unroll
          for (int b = 0; b < kTileD; ++b) {
            p_s[(k0 + a) * lay.dp + d0 + b] = acc[a][b];
          }
        }
      }
    }
    __syncthreads();

    // invariants of this slot, (filter, moment) order
    for (int e = tid; e < k_f * n_mom; e += kThreads) {
      const int k = e / n_mom, mi = e - k * n_mom;
      const T* p_row = p_s + k * lay.dp;
      T acc = T(0);
      for (int d = 0; d < n_mono; ++d) {
        const T p = p_row[d];
        acc += w_s[d * n_mom + mi] * (p * p);
      }
      if (spec.moment[mi] == 0) {
        // sign(0) is 0, as in both frameworks (no copysign)
        const T p0 = p_row[0];
        const T sgn = p0 > T(0) ? T(1) : (p0 < T(0) ? T(-1) : T(0));
        acc = sgn * d_sqrt(acc + T(1e-16));
      }
      out_row[s * k_f * n_mom + e] = acc;
    }
    __syncthreads();   // p_s is zeroed again for the next slot
  }
}

template <typename T>
size_t smem_bytes(int k, int d, int n_moments, int chunk) {
  return sizeof(T) *
         static_cast<size_t>(Layout(k, d, n_moments, chunk).total);
}

template <typename T>
int launch_grap(const T* rij, const T* ux, const T* uy, const T* uz,
                const T* slot, const T* mask, const T* w, T* out, int rows,
                int n, int n_slots, int algorithm, int n_filters,
                const double* c0, const double* c1, const double* c2,
                int n_mono, const unsigned char* parent,
                const unsigned char* axis, int n_moments,
                const int* moments, double rc, int cutoff_id,
                void* stream) {
  if (rows <= 0 || n <= 0 || n_slots <= 0 || algorithm < kSf ||
      algorithm > kPexp || n_filters <= 0 || n_filters > kMaxFilters ||
      n_mono <= 0 || n_mono > kMaxMonomials || n_moments <= 0 ||
      n_moments > kMaxMoments || cutoff_id < 0 || cutoff_id > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GrapSpec<T> spec;
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
  for (int d = 0; d < kMaxMonomials; ++d) {
    const bool in = d < n_mono;
    if (in && d > 0 && (parent[d] >= d || axis[d] > 2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    spec.parent[d] = in ? parent[d] : 0;
    spec.axis[d] = in ? axis[d] : 0;
  }
  for (int m = 0; m < kMaxMoments; ++m) {
    spec.moment[m] = m < n_moments ? moments[m] : -1;
  }
  int chunk = kThreads;
  size_t smem = smem_bytes<T>(n_filters, n_mono, n_moments, chunk);
  while (smem > kSmemTarget && chunk > 32) {
    chunk /= 2;
    smem = smem_bytes<T>(n_filters, n_mono, n_moments, chunk);
  }
  // a launch asking for more than the kernel's current limit is refused
  // and never runs, so the limit is set for every launch
  const cudaError_t e = cudaFuncSetAttribute(
      grap_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T rc2 = T(rc * rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  grap_kernel<T><<<rows, kThreads, smem, st>>>(
      rij, ux, uy, uz, slot, mask, w, out, n, n_slots, chunk, spec, cut,
      rc2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). `w` is a device array
// [n_mono, n_moments] of the input type; the parameter tables are host
// arrays copied into the launch.
extern "C" {

int grap_f32(const float* rij, const float* ux, const float* uy,
             const float* uz, const float* slot, const float* mask,
             const float* w, float* out, int rows, int n, int n_slots,
             int algorithm, int n_filters, const double* c0,
             const double* c1, const double* c2, int n_mono,
             const unsigned char* parent, const unsigned char* axis,
             int n_moments, const int* moments, double rc, int cutoff_id,
             void* stream) {
  return launch_grap<float>(rij, ux, uy, uz, slot, mask, w, out, rows, n,
                            n_slots, algorithm, n_filters, c0, c1, c2,
                            n_mono, parent, axis, n_moments, moments, rc,
                            cutoff_id, stream);
}

int grap_f64(const double* rij, const double* ux, const double* uy,
             const double* uz, const double* slot, const double* mask,
             const double* w, double* out, int rows, int n, int n_slots,
             int algorithm, int n_filters, const double* c0,
             const double* c1, const double* c2, int n_mono,
             const unsigned char* parent, const unsigned char* axis,
             int n_moments, const int* moments, double rc, int cutoff_id,
             void* stream) {
  return launch_grap<double>(rij, ux, uy, uz, slot, mask, w, out, rows, n,
                             n_slots, algorithm, n_filters, c0, c1, c2,
                             n_mono, parent, axis, n_moments, moments, rc,
                             cutoff_id, stream);
}

}  // extern "C"
