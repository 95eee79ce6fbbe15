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
// What binds it on an H100: the P contraction's FP32 FMAs. At the
// serving shape (32769 rows of 128 entries, 78 of them real pairs;
// K = 16, D = 56, M = 6, S = 1) it is 2 * 78 * 16 * 56 FLOP a row,
// 4.58 GFLOP in all (0.068 ms at 67 TFLOP/s), against 0.113 GB of input
// and output (0.034 ms at 3.35 TB/s). What the design does about it:
//   * one warp per atom row, kWarps rows per block. One block barrier
//     stages the small tables (weights, filter grid, log2 of the pexp
//     lengths);
//     after it a warp meets only __syncwarp;
//   * the warp reads mask and slot of 64 entries at once (2 per lane,
//     all loads issued together); each lane then reads the geometry of
//     its own real pairs of the current slot (mask > 0; a masked
//     entry's geometry is never read), and warp ballots compact them,
//     with their cutoff, into a per-warp stage in shared memory: two
//     dependent trips to device memory a row;
//   * per batch of 32 compacted pairs, one lane per pair builds the
//     pair's 56 monomials in registers, each the product of its
//     degree-(m-1) prefix and one more component, as `moment_basis_c`
//     builds it (55 multiplies, no table lookups), and stores them to a
//     per-warp tile whose rows are padded by one 16-byte chunk, so the
//     lanes' stores and the contraction's loads both avoid bank
//     conflicts. Then all lanes compute each (pair, filter) value h once
//     into a second tile; pexp takes one exp2 a filter (see
//     filter_value);
//   * the contraction runs in registers: each lane owns a tile of 4
//     filters x 8 monomials (K padded to a power of two, D to 64), so a
//     pair costs one 16-byte load of h (shared by the lanes of one
//     filter block), two of m and 32 FMAs. P stays in registers from
//     the first batch to the last; a lane holds at most 2 tiles, and
//     more filters run in passes over the row;
//   * the invariants come from the accumulators: each lane sums w P^2
//     over its 8 monomials (16-byte loads of a [M, 64] weight table),
//     and a reduce-scatter of 21 xor shuffles adds the 8 lanes of a
//     filter block, leaving each lane 3 of the block's 24 outputs to
//     write.
// float64 runs the same template with tiles twice the size. The launcher
// asks the runtime for the shared-memory limit and the resident blocks
// once per (device, kernel, shared-memory size) and keeps the answers.
// Full-precision exp/exp2/log2/sqrt (common.cuh): float64 parity with the
// twin depends on them.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "grap_common.cuh"

namespace {

constexpr int kWarps = 4;                 // atom rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 32;                // pairs per h / m tile
constexpr int kSpan = 64;                 // entries compacted per step
constexpr int kList = kSpan + kBatch;     // stage: a step + carry
constexpr int kTileK = 4;                 // a lane's tile: 4 filters
constexpr int kTileD = 8;                 //   x 8 monomials
constexpr int kMaxTilesPerLane = 2;
constexpr int kDp = 64;                   // monomials padded: 8 tiles of 8
constexpr int kTilesD = kDp / kTileD;     // lanes of one filter block

// Row stride of the monomial tile: kDp and one chunk more, so that row
// p starts p chunks further round the banks: the lanes' stores (one
// pair a lane) and the contraction's loads (one pair, a chunk a lane)
// both meet no bank conflicts.
template <typename T>
constexpr int kMs = kDp + kChunk<T>;

// Launch shape, fixed on the host from (K, D).
struct Shape {
  int kg;        // filters per pass over the row
  int kgp;       // kg padded to a power of two >= kTileK
};

// Bytes of one warp's tiles: m [kBatch, kMs] and h [kBatch, kgp] of T,
// log2 r [kBatch] in double, and the compacted pairs' r, cutoff, u0,
// u1, u2 [5, kList] of T. Each piece is a multiple of 16 bytes, so the
// m and h rows stay 16-byte aligned.
template <typename T>
__host__ __device__ __forceinline__ int warp_bytes(const Shape& sh) {
  return sizeof(T) * (kBatch * (kMs<T> + sh.kgp) + 5 * kList) +
         sizeof(double) * kBatch;
}

// The warps' tiles, then the invariant weights [M, kDp] of T (16-byte
// aligned: their rows are read as 16-byte chunks), log2 of the pexp
// lengths [K] in double, the filter grid [3, K] of T and the moments
// [M].
template <typename T>
size_t smem_bytes(const Shape& sh, int n_filters, int n_moments) {
  return static_cast<size_t>(kWarps) * warp_bytes<T>(sh) +
         sizeof(double) * n_filters +
         sizeof(T) * (kDp * n_moments + 3 * n_filters) +
         sizeof(int) * n_moments;
}

template <typename T, int TPL>
__global__ void __launch_bounds__(kThreads)
grap_kernel(const T* __restrict__ rij, const T* __restrict__ ux,
            const T* __restrict__ uy, const T* __restrict__ uz,
            const T* __restrict__ slot, const T* __restrict__ mask,
            const T* __restrict__ w, T* __restrict__ out, int rows, int n,
            int n_slots, Shape sh, const __grid_constant__ GrapSpec<T> spec,
            const __grid_constant__ Cutoff<T> cut, T rc2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = spec.n_filters, D = spec.n_mono, M = spec.n_moments;
  T* w_s = reinterpret_cast<T*>(smem_raw + kWarps * warp_bytes<T>(sh));
  double* lrl_s = reinterpret_cast<double*>(w_s + kDp * M);   // [K]
  T* f_s = reinterpret_cast<T*>(lrl_s + K);  // [3, K] filter grid
  int* mom_s = reinterpret_cast<int*>(f_s + 3 * K);   // [M] moments

  const int tid = threadIdx.x;
  for (int i = tid; i < kDp * M; i += kThreads) {
    const int mi = i / kDp, d = i - mi * kDp;
    w_s[i] = d < D ? w[d * M + mi] : T(0);
  }
  for (int mi = tid; mi < M; mi += kThreads) mom_s[mi] = spec.moment[mi];
  for (int k = tid; k < K; k += kThreads) {
    f_s[k] = spec.c0[k];
    f_s[K + k] = spec.c1[k];
    f_s[2 * K + k] = spec.c2[k];
    lrl_s[k] = log2(double(spec.c0[k]));   // pexp: log2 rl
  }
  __syncthreads();   // the only block-wide barrier

  const int lane = tid & 31, warp = tid >> 5;
  T* m_s = reinterpret_cast<T*>(smem_raw + warp * warp_bytes<T>(sh));
  T* h_s = m_s + kBatch * kMs<T>;            // [kBatch, kMs], [kBatch, kgp]
  double* lr_s = reinterpret_cast<double*>(h_s + kBatch * sh.kgp);
  T* stage = reinterpret_cast<T*>(lr_s + kBatch);   // [5, kList]
  const bool pexp = spec.algorithm == kPexp;
  const unsigned lanes_below = (1u << lane) - 1u;
  constexpr int V = kChunk<T>;

  // this lane's tiles: filter block kb[t], monomial block db[t]
  int kb[TPL], db[TPL];
#pragma unroll
  for (int t = 0; t < TPL; ++t) {
    const int tile = lane + 32 * t;
    kb[t] = tile / kTilesD;
    db[t] = tile % kTilesD;
  }

  // persistent warps: a warp takes every (gridDim.x * kWarps)-th row
  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * n;
    T* out_row = out + static_cast<size_t>(row) * n_slots * K * M;
    for (int s = 0; s < n_slots; ++s) {
      const T slot_value = T(s);
      for (int k0 = 0; k0 < K; k0 += sh.kg) {
        const int kg = min(sh.kg, K - k0);
        int kgp = kTileK, k_shift = 2;   // kg padded to a power of two
        while (kgp < kg) {
          kgp <<= 1;
          ++k_shift;
        }
        bool on[TPL];
#pragma unroll
        for (int t = 0; t < TPL; ++t) on[t] = kb[t] * kTileK < kgp;
        // kgp divides 32, so a lane computes h of one filter, kk_h, for
        // every (32 / kgp)-th pair of a batch
        const int kk_h = lane & (kgp - 1);
        const bool k_on = kk_h < kg;
        const int k_h = k0 + (k_on ? kk_h : 0);

        T acc[TPL][kTileK][kTileD];
#pragma unroll
        for (int t = 0; t < TPL; ++t) {
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
#pragma unroll
            for (int b = 0; b < kTileD; ++b) acc[t][a][b] = T(0);
          }
        }

        // Compact the slot's real pairs, kSpan entries a step: each lane
        // reads the geometry of its own real pairs (masked entries are not
        // read) and stores it, with the cutoff, at the pair's place in
        // `stage`. Then run P += h m over each full batch of kBatch pairs;
        // the last step also runs the partial batch left over.
        int count = 0;   // compacted pairs waiting in `stage`
        for (int j0 = 0; j0 < n; j0 += kSpan) {
          constexpr int kE = kSpan / 32;   // entries a lane
          T mk[kE], sl[kE];
#pragma unroll
          for (int i = 0; i < kE; ++i) {
            const int j = j0 + lane + 32 * i;
            mk[i] = j < n ? mask[base + j] : T(0);
            sl[i] = j < n ? slot[base + j] : T(-1);
          }
          bool act[kE];
          T rv[kE], u0v[kE], u1v[kE], u2v[kE];
#pragma unroll
          for (int i = 0; i < kE; ++i) {
            const size_t idx = base + j0 + lane + 32 * i;
            act[i] = mk[i] > T(0) && sl[i] == slot_value;
            rv[i] = act[i] ? rij[idx] : T(0);
            u0v[i] = act[i] ? ux[idx] : T(0);
            u1v[i] = act[i] ? uy[idx] : T(0);
            u2v[i] = act[i] ? uz[idx] : T(0);
          }
#pragma unroll
          for (int i = 0; i < kE; ++i) {
            const unsigned ballot = __ballot_sync(kFull, act[i]);
            if (act[i]) {
              const int q = count + __popc(ballot & lanes_below);
              stage[q] = rv[i];
              stage[kList + q] = cutoff_value(cut, rv[i]) * mk[i];
              stage[2 * kList + q] = u0v[i];
              stage[3 * kList + q] = u1v[i];
              stage[4 * kList + q] = u2v[i];
            }
            count += __popc(ballot);
          }
          const bool last = j0 + kSpan >= n;
          int done = 0;
          while (count - done >= kBatch || (last && count > done)) {
            const int nb = min(kBatch, count - done);
            const T* r_b = stage + done;          // this batch's r
            const T* c_b = stage + kList + done;  // and cutoff
            // the stage is written; the last batch's readers are done with
            // the tiles
            __syncwarp();
            if (lane < nb) {
              const int q = done + lane;
              if (pexp) lr_s[lane] = log2(double(stage[q]));
              T m[kMaxMonomials];
              monomials(stage[2 * kList + q], stage[3 * kList + q],
                        stage[4 * kList + q], m);
              T* m_row = m_s + lane * kMs<T>;
#pragma unroll
              for (int c = 0; c < kDp / V; ++c) {
                T v[V];
#pragma unroll
                for (int q = 0; q < V; ++q) {
                  const int d = c * V + q;   // d < 64; monomials end at 56
                  v[q] = d < kMaxMonomials && d < D
                             ? m[d < kMaxMonomials ? d : 0]
                             : T(0);
                }
                store_chunk(m_row + c * V, v);
              }
            }
            __syncwarp();
            const T c0 = f_s[k_h], c1 = f_s[K + k_h], c2 = f_s[2 * K + k_h];
            const double lrl = lrl_s[k_h];
#pragma unroll 2
            for (int p = lane >> k_shift; p < nb; p += 32 >> k_shift) {
              h_s[(p << k_shift) + kk_h] =
                  k_on ? filter_value(spec.algorithm, c0, c1, c2, lrl,
                                      r_b[p], lr_s[p], rc2) *
                             c_b[p]
                       : T(0);
            }
            __syncwarp();
#pragma unroll 2
            for (int p = 0; p < nb; ++p) {
#pragma unroll
              for (int t = 0; t < TPL; ++t) {
                if (!on[t]) continue;
                T hv[kTileK], mv[kTileD];
                load4(h_s + p * kgp + kb[t] * kTileK, hv);
                const T* m_row = m_s + p * kMs<T> + db[t] * kTileD;
#pragma unroll
                for (int q = 0; q < kTileD / V; ++q) {
                  load_chunk(m_row + q * V, mv + q * V);
                }
#pragma unroll
                for (int a = 0; a < kTileK; ++a) {
#pragma unroll
                  for (int b = 0; b < kTileD; ++b) {
                    acc[t][a][b] = fma(hv[a], mv[b], acc[t][a][b]);
                  }
                }
              }
            }
            done += nb;
          }
          if (done > 0 && !last) {   // carry the rest to the stage's front
            const int rest = count - done;
            __syncwarp();
            T v[5];
#pragma unroll
            for (int a = 0; a < 5; ++a) {
              v[a] = lane < rest ? stage[a * kList + done + lane] : T(0);
            }
            __syncwarp();
            if (lane < rest) {
#pragma unroll
              for (int a = 0; a < 5; ++a) stage[a * kList + lane] = v[a];
            }
            count = rest;
          }
        }

        // invariants of filters [k0, k0 + kg) of slot s
#pragma unroll
        for (int t = 0; t < TPL; ++t) {
          // v[a * kMaxMoments + mi]: this lane's sum of w P^2 over its 8
          // monomials, for its filters a and the moments mi
          T v[kTileK * kMaxMoments];
#pragma unroll
          for (int i = 0; i < kTileK * kMaxMoments; ++i) v[i] = T(0);
          if (on[t]) {
            T sq[kTileK][kTileD];
#pragma unroll
            for (int a = 0; a < kTileK; ++a) {
#pragma unroll
              for (int b = 0; b < kTileD; ++b) {
                sq[a][b] = acc[t][a][b] * acc[t][a][b];
              }
            }
#pragma unroll
            for (int mi = 0; mi < kMaxMoments; ++mi) {
              if (mi >= M) continue;
              T wv[kTileD];
              load4(w_s + mi * kDp + db[t] * kTileD, wv);
              load4(w_s + mi * kDp + db[t] * kTileD + 4, wv + 4);
#pragma unroll
              for (int a = 0; a < kTileK; ++a) {
#pragma unroll
                for (int b = 0; b < kTileD; ++b) {
                  v[a * kMaxMoments + mi] += wv[b] * sq[a][b];
                }
              }
            }
          }
          // reduce-scatter over the 8 lanes of the filter block: each
          // xor step keeps half the values, 24 -> 12 -> 6 -> 3
          T v12[12], v6[6], v3[3];
          {
            const bool hi = lane & 4;
#pragma unroll
            for (int i = 0; i < 12; ++i) {
              const T send = hi ? v[i] : v[12 + i];
              v12[i] = (hi ? v[12 + i] : v[i]) +
                       __shfl_xor_sync(kFull, send, 4);
            }
          }
          {
            const bool hi = lane & 2;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const T send = hi ? v12[i] : v12[6 + i];
              v6[i] = (hi ? v12[6 + i] : v12[i]) +
                      __shfl_xor_sync(kFull, send, 2);
            }
          }
          {
            const bool hi = lane & 1;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const T send = hi ? v6[i] : v6[3 + i];
              v3[i] = (hi ? v6[3 + i] : v6[i]) +
                      __shfl_xor_sync(kFull, send, 1);
            }
          }
          // P[k, 0] of the block's filters: monomial 0 of its first lane
          T p0[kTileK];
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
            p0[a] = __shfl_sync(kFull, acc[t][a][0], lane & ~(kTilesD - 1));
          }
          if (on[t]) {
            const int first = (lane & 4 ? 12 : 0) + (lane & 2 ? 6 : 0) +
                              (lane & 1 ? 3 : 0);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const int i = first + j;
              const int a = i / kMaxMoments, mi = i - a * kMaxMoments;
              const int kk = kb[t] * kTileK + a;
              if (mi >= M || kk >= kg) continue;
              T val = v3[j];
              if (mom_s[mi] == 0) {
                // sign(0) is 0, as in both frameworks (no copysign)
                const T p = a == 0 ? p0[0]
                                   : (a == 1 ? p0[1] : (a == 2 ? p0[2]
                                                               : p0[3]));
                const T sgn = p > T(0) ? T(1) : (p < T(0) ? T(-1) : T(0));
                val = sgn * d_sqrt(val + T(1e-16));
              }
              out_row[(s * K + k0 + kk) * M + mi] = val;
            }
          }
        }
      }
    }
  }
}

template <typename T>
int launch_grap(const T* rij, const T* ux, const T* uy, const T* uz,
                const T* slot, const T* mask, const T* w, T* out, int rows,
                int n, int n_slots, int algorithm, int n_filters,
                const double* c0, const double* c1, const double* c2,
                int n_mono, const unsigned short* codes, int n_moments,
                const int* moments, double rc, int cutoff_id,
                void* stream) {
  if (rows <= 0 || n <= 0 || n_slots <= 0 || algorithm < kSf ||
      algorithm > kPexp || n_filters <= 0 || n_filters > kMaxFilters ||
      n_mono <= 0 || n_mono > kMaxMonomials || n_moments <= 0 ||
      n_moments > kMaxMoments || cutoff_id < 0 || cutoff_id > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GrapSpec<T> spec;
  if (!make_spec(spec, algorithm, n_filters, c0, c1, c2, n_mono, codes,
                 n_moments, moments)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  Shape sh;
  const int max_filters = kMaxTilesPerLane * 32 / kTilesD * kTileK;
  sh.kg = n_filters < max_filters ? n_filters : max_filters;
  sh.kgp = kTileK;
  while (sh.kgp < sh.kg) sh.kgp *= 2;
  const bool one_tile = sh.kgp / kTileK * kTilesD <= 32;
  const size_t smem = smem_bytes<T>(sh, n_filters, n_moments);
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T rc2 = T(rc * rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  auto launch = [&](auto kernel) {
    // as many blocks as fit on the card at once, or fewer for few rows:
    // each block stages its tables once for all the rows it takes
    int resident = 0;
    const cudaError_t e = resident_blocks(
        reinterpret_cast<const void*>(kernel), kThreads, smem, &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int needed = (rows + kWarps - 1) / kWarps;
    const int blocks = needed < resident ? needed : resident;
    kernel<<<blocks, kThreads, smem, st>>>(rij, ux, uy, uz, slot, mask, w,
                                           out, rows, n, n_slots, sh, spec,
                                           cut, rc2);
    return static_cast<int>(cudaGetLastError());
  };
  return one_tile ? launch(grap_kernel<T, 1>) : launch(grap_kernel<T, 2>);
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). `w` is a device array
// [n_mono, n_moments] of the input type; the parameter tables and the
// monomial codes are host arrays copied into the launch.
extern "C" {

int grap_f32(const float* rij, const float* ux, const float* uy,
             const float* uz, const float* slot, const float* mask,
             const float* w, float* out, int rows, int n, int n_slots,
             int algorithm, int n_filters, const double* c0,
             const double* c1, const double* c2, int n_mono,
             const unsigned short* codes, int n_moments, const int* moments,
             double rc, int cutoff_id, void* stream) {
  return launch_grap<float>(rij, ux, uy, uz, slot, mask, w, out, rows, n,
                            n_slots, algorithm, n_filters, c0, c1, c2,
                            n_mono, codes, n_moments, moments, rc,
                            cutoff_id, stream);
}

int grap_f64(const double* rij, const double* ux, const double* uy,
             const double* uz, const double* slot, const double* mask,
             const double* w, double* out, int rows, int n, int n_slots,
             int algorithm, int n_filters, const double* c0,
             const double* c1, const double* c2, int n_mono,
             const unsigned short* codes, int n_moments, const int* moments,
             double rc, int cutoff_id, void* stream) {
  return launch_grap<double>(rij, ux, uy, uz, slot, mask, w, out, rows, n,
                             n_slots, algorithm, n_filters, c0, c1, c2,
                             n_mono, codes, n_moments, moments, rc,
                             cutoff_id, stream);
}

}  // extern "C"
