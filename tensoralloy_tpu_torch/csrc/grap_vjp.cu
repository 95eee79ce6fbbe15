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
// slot s, H [p, K] the filter values h_k = filter_k fc mask of its p
// pairs, H' their slopes and M [p, D] their monomials:
//   P = H^T M, recomputed as the forward forms it;
//   Pbar[k, d] = P[k, d] sum_m c[k, m] w[d, m],   c = 2 gbar[s, k, m] for
//     a moment above 0, gbar[s, k, m] sign(P0) / sqrt(Q0 + 1e-16) for
//     moment 0 (Q0 = sum_d w[d, m] P[k, d]^2, P0 = P[k, 0]);
//   E = H' Pbar and dM = H Pbar, both [p, D];
//   d/d r_j = sum_d E[j, d] m_d(u_j),
//   d/d u_j = sum_d (d m_d / d u) dM[j, d],
// each times the entry's mask. The unit-vector part runs the monomial
// recurrence backwards (`monomials_adjoint`), the chain rule of how
// `monomials` builds each monomial from its prefix. Inputs are the
// forward's [rows, n] rows and gbar [batch, rows, n_slots * K * M]
// (batch > 1: a committee's members or a linear model's coefficients,
// one launch); outputs four [batch, rows, n]. An entry's derivative is
// written once to its own place (no atomics); a masked entry, or one of
// no slot, gets exactly 0 and its geometry is not read.
//
// What binds it on an H100: FP32 FMAs, three products a pair of the
// forward's size (2 K D to recompute P, 2 K D each for E and dM; K = 16,
// D = 56 at the serving shape). What the design does about it:
//   * one warp per atom row, up to kWarps rows a block, persistent warps;
//     one block barrier stages the small tables, after it a warp meets
//     only __syncwarp;
//   * warp ballots compact the slot's real pairs (mask > 0, any place in
//     the row: holes and interleaved slots are fine) with their index
//     into a per-warp stage, 64 entries a step, in batches of 16;
//   * pass 1 recomputes P as the forward does: one lane a pair builds
//     the monomials into a tile of 16-byte chunks padded by one chunk a
//     row, the lanes compute each (pair, filter) value once, and each
//     lane adds a 4 filter x 8 monomial register tile (one 16-byte h
//     load and two m loads for 32 FMAs; the lane's monomials are the
//     two chunks 4 db and 32 + 4 db, so the 8 lanes of a filter block
//     read 128 contiguous bytes). More than 32 filters run in passes
//     over the row. Q0 comes from the tiles by xor shuffles over the 8
//     lanes of a filter block; P goes to a per-warp tile;
//   * per batch member, Pbar [K, 64] is formed in a per-warp tile (over
//     P itself where the batch is one);
//   * pass 2 walks the compacted pairs again: the monomial tile, then h
//     and h' of each (filter, pair) in filter-major tiles (pexp: one
//     exp2 and one exp for both); then each lane holds 4 pairs x 8
//     monomials of E and of dM in registers and runs over the filters,
//     4 loads (h, h', two of Pbar) for 64 FMAs; d/dr is reduced over the
//     8 lanes of a pair group by shuffles, dM rows overwrite the
//     monomial tile, and one lane a pair runs the adjoint recurrence
//     and writes its four outputs. Recomputing m, h and h' in pass 2
//     costs about a tenth of its FMAs and keeps the per-warp tiles
//     small enough for 16 warps an SM; keeping them from pass 1 would
//     need the row's ~78 pairs in shared memory.
// Entries of no slot are written as zeros before the slots run; the
// stores of a batch go to ascending entries of one row. float64 runs the
// same template. Recomputing P costs about one forward; saving it would
// cost [rows, S, K, D] of device memory (115 MB at 32769 rows, S = 1,
// K = 16, D = 56, float) and a change to the forward kernel.
// Full-precision exp/exp2/log2/sqrt (common.cuh): float64 parity with
// the closed form depends on them.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "grap_common.cuh"

namespace {

constexpr int kWarps = 4;                 // atom rows a block, at most
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;                // compacted pairs a tile
constexpr int kSpan = 64;                 // entries compacted a step
constexpr int kList = kSpan + kBatch;     // stage: a step + carry
constexpr int kTileK = 4;                 // pass 1: a lane's tile of 4
constexpr int kTileD = 8;                 //   filters x 8 monomials
constexpr int kPairs = 4;                 // pass 2: 4 pairs x 8 monomials
constexpr int kDp = 64;                   // monomials padded: 8 blocks of 8
constexpr int kTilesD = kDp / kTileD;     // lanes of one filter block
constexpr int kAlpha = 8;                 // row stride of the coefficients
constexpr int kMaxFiltersPerPass = 32;    // pass 1: 2 tiles a lane
constexpr size_t kMaxSmem = 232448;       // an H100 block's shared memory

// Row stride of the monomial tile: kDp and one chunk more, so that a
// lane per row (one pair a lane) and 8 lanes on one row both meet no
// bank conflicts.
template <typename T>
constexpr int kMs = kDp + kChunk<T>;

// Resident blocks an SM the compiler plans registers for: 4 of 128
// threads (at most 128 registers a thread) for float, 2 for double.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;

// Launch shape, fixed on the host from (K, batch).
struct Shape {
  int kg;      // pass 1: filters a pass over the row (<= 32)
  int kgp;     // kg padded to a power of two >= kTileK
  int kp;      // K padded to 4: rows of P and Pbar
  int hsz;     // elements of the h tiles: [kBatch, kgp] or 2 [kp, kBatch]
  int pbar;    // 1: Pbar has a tile of its own (batch > 1)
};

// Bytes of one warp's tiles, in this order: P [kp, kDp] and Pbar, the
// monomial tile [kBatch, kMs], the h tiles, the stage (r, mask, ux, uy,
// uz [5, kList] and the entries [kList] int), per-pair fc, fc', 1/r and
// d/dr [4, kBatch], log2 r [kBatch] double, the moment-0 scale [kp] and
// the coefficients [kp, kAlpha]. Each piece is a multiple of 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ size_t warp_bytes(const Shape& sh) {
  return sizeof(T) * (static_cast<size_t>(sh.kp) * kDp * (1 + sh.pbar) +
                      kBatch * kMs<T> + sh.hsz + 5 * kList + 4 * kBatch +
                      sh.kp * (1 + kAlpha)) +
         sizeof(int) * kList + sizeof(double) * kBatch;
}

// The block's tables after the warps' tiles: the invariant weights
// [M, kDp] of T, log2 of the pexp lengths [K] in double, the filter grid
// [3, K] of T and the moments [M].
template <typename T>
size_t table_bytes(int n_filters, int n_moments) {
  return sizeof(T) * (kDp * n_moments + 3 * n_filters) +
         sizeof(double) * n_filters + sizeof(int) * n_moments;
}

template <typename T, int TPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
grap_vjp_kernel(const T* __restrict__ gbar, const T* __restrict__ rij,
                const T* __restrict__ ux, const T* __restrict__ uy,
                const T* __restrict__ uz, const T* __restrict__ slot,
                const T* __restrict__ mask, const T* __restrict__ w,
                T* __restrict__ out_r, T* __restrict__ out_x,
                T* __restrict__ out_y, T* __restrict__ out_z, int batch,
                int rows, int n, int n_slots, Shape sh,
                const __grid_constant__ GrapSpec<T> spec,
                const __grid_constant__ Cutoff<T> cut, T rc2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = kChunk<T>;
  const int K = spec.n_filters, D = spec.n_mono, M = spec.n_moments;
  const int warps = blockDim.x >> 5;
  const size_t wb = warp_bytes<T>(sh);
  T* w_s = reinterpret_cast<T*>(smem_raw + warps * wb);   // [M, kDp]
  double* lrl_s = reinterpret_cast<double*>(w_s + kDp * M);   // [K]
  T* f_s = reinterpret_cast<T*>(lrl_s + K);   // [3, K] filter grid
  int* mom_s = reinterpret_cast<int*>(f_s + 3 * K);   // [M] moments

  const int tid = threadIdx.x;
  for (int i = tid; i < kDp * M; i += blockDim.x) {
    const int mi = i / kDp, d = i - mi * kDp;
    w_s[i] = d < D ? w[d * M + mi] : T(0);
  }
  for (int mi = tid; mi < M; mi += blockDim.x) mom_s[mi] = spec.moment[mi];
  for (int k = tid; k < K; k += blockDim.x) {
    f_s[k] = spec.c0[k];
    f_s[K + k] = spec.c1[k];
    f_s[2 * K + k] = spec.c2[k];
    lrl_s[k] = log2(double(spec.c0[k]));   // pexp: log2 rl
  }
  __syncthreads();   // the only block-wide barrier

  const int lane = tid & 31, warp = tid >> 5;
  T* p_s = reinterpret_cast<T*>(smem_raw + warp * wb);   // [kp, kDp] P
  T* pbar_s = sh.pbar ? p_s + sh.kp * kDp : p_s;         // [kp, kDp]
  T* m_s = p_s + sh.kp * kDp * (1 + sh.pbar);            // [kBatch, kMs]
  T* h_s = m_s + kBatch * kMs<T>;
  const Stage<T> st{h_s + sh.hsz, reinterpret_cast<int*>(h_s + sh.hsz +
                                                        5 * kList)};
  T* fc_s = reinterpret_cast<T*>(st.entry + kList);      // [kBatch]
  T* dfc_s = fc_s + kBatch;                              // fc'
  T* ir_s = dfc_s + kBatch;                              // 1 / r
  T* dr_s = ir_s + kBatch;                               // d/dr
  double* lr_s = reinterpret_cast<double*>(dr_s + kBatch);   // log2 r
  T* sc_s = reinterpret_cast<T*>(lr_s + kBatch);   // [kp] moment-0 scale
  T* al_s = sc_s + sh.kp;                          // [kp, kAlpha]
  const T* st_r = st.v;
  const T* st_mk = st.v + kList;
  const bool pexp = spec.algorithm == kPexp;
  int m0 = -1;   // the column of moment 0, if requested
  for (int mi = 0; mi < M; ++mi) {
    if (mom_s[mi] == 0) m0 = mi;
  }
  const int db = lane & (kTilesD - 1);   // the lane's monomial block
  // pass 1: the lane's filter blocks kb[t]
  int kb[TPL];
#pragma unroll
  for (int t = 0; t < TPL; ++t) kb[t] = (lane + 32 * t) / kTilesD;
  const int pq = lane >> 3;   // pass 2: the lane's pairs 4 pq .. 4 pq + 3
  const size_t plane = static_cast<size_t>(rows) * n;
  const size_t width = static_cast<size_t>(n_slots) * K * M;

  // Pair prep of a batch: one lane a pair stores its monomials to row
  // `lane` of the tile (zeros past D), its cutoff (and slope) times the
  // mask, 1/r and, for pexp, log2 r.
  auto prep = [&](int first, int nb, bool slope) {
    if (lane >= nb) return;
    const int q = first + lane;
    const T r = st_r[q], mk = st_mk[q];
    if (slope) {
      T f, df;
      cutoff_value_and_slope(cut, r, f, df);
      fc_s[lane] = f * mk;
      dfc_s[lane] = df * mk;
      ir_s[lane] = T(1) / r;
    } else {
      fc_s[lane] = cutoff_value(cut, r) * mk;
    }
    if (pexp) lr_s[lane] = log2(double(r));
    T m[kMaxMonomials];
    monomials(st.v[2 * kList + q], st.v[3 * kList + q], st.v[4 * kList + q],
              m);
    T* m_row = m_s + lane * kMs<T>;
#pragma unroll
    for (int c = 0; c < kDp / V; ++c) {
      T v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = c * V + e;   // d < 64; monomials end at 56
        v[e] = d < kMaxMonomials && d < D ? m[d < kMaxMonomials ? d : 0]
                                          : T(0);
      }
      store_chunk(m_row + c * V, v);
    }
  };

  // persistent warps: a warp takes every (gridDim.x * warps)-th row
  for (int row = blockIdx.x * warps + warp; row < rows;
       row += gridDim.x * warps) {
    const size_t base = static_cast<size_t>(row) * n;
    // entries of no slot: 0 in every output
    for (int j = lane; j < n; j += 32) {
      if (entry_slot(mask[base + j], slot[base + j], n_slots) >= 0) continue;
      for (int b = 0; b < batch; ++b) {
        const size_t o = b * plane + base + j;
        out_r[o] = T(0);
        out_x[o] = T(0);
        out_y[o] = T(0);
        out_z[o] = T(0);
      }
    }
    for (int s = 0; s < n_slots; ++s) {
      const T slot_value = T(s);
      // ---- pass 1: P = H^T M of filters [k0, k0 + kg) a walk
      int pairs = 0;
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
        // kgp divides 32: a lane computes h of filter kk_h for every
        // (32 / kgp)-th pair of a batch
        const int kk_h = lane & (kgp - 1);
        const bool k_on = kk_h < kg;
        const int k_h = k0 + (k_on ? kk_h : 0);
        const T c0 = f_s[k_h], c1 = f_s[K + k_h], c2 = f_s[2 * K + k_h];
        const double lrl = lrl_s[k_h];
        T acc[TPL][kTileK][kTileD];
#pragma unroll
        for (int t = 0; t < TPL; ++t) {
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
#pragma unroll
            for (int b = 0; b < kTileD; ++b) acc[t][a][b] = T(0);
          }
        }
        pairs = for_each_batch<kBatch, kSpan>(
            rij, ux, uy, uz, slot, mask, base, n, slot_value, st,
            [&](int first, int nb) {
              prep(first, nb, false);
              __syncwarp();
#pragma unroll 2
              for (int p = lane >> k_shift; p < nb; p += 32 >> k_shift) {
                h_s[(p << k_shift) + kk_h] =
                    k_on ? filter_value(spec.algorithm, c0, c1, c2, lrl,
                                        st_r[first + p], lr_s[p], rc2) *
                               fc_s[p]
                         : T(0);
              }
              __syncwarp();
#pragma unroll 2
              for (int p = 0; p < nb; ++p) {
                T mv[kTileD];
                load4(m_s + p * kMs<T> + 4 * db, mv);
                load4(m_s + p * kMs<T> + 32 + 4 * db, mv + 4);
#pragma unroll
                for (int t = 0; t < TPL; ++t) {
                  if (!on[t]) continue;
                  T hv[kTileK];
                  load4(h_s + p * kgp + kb[t] * kTileK, hv);
#pragma unroll
                  for (int a = 0; a < kTileK; ++a) {
#pragma unroll
                    for (int b = 0; b < kTileD; ++b) {
                      acc[t][a][b] = fma(hv[a], mv[b], acc[t][a][b]);
                    }
                  }
                }
              }
            });
        if (pairs == 0) break;   // no pair of slot s: nothing to add
        // the moment-0 scale sign(P0) / sqrt(Q0 + 1e-16) of each filter:
        // Q0 of the lane's 8 monomials, then over the 8 lanes of the block
#pragma unroll
        for (int t = 0; t < TPL; ++t) {
          if (m0 < 0) break;
          T q0[kTileK];
          T wv[kTileD];
          load4(w_s + m0 * kDp + 4 * db, wv);
          load4(w_s + m0 * kDp + 32 + 4 * db, wv + 4);
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
            q0[a] = T(0);
#pragma unroll
            for (int b = 0; b < kTileD; ++b) {
              q0[a] += wv[b] * (acc[t][a][b] * acc[t][a][b]);
            }
          }
#pragma unroll
          for (int off = 1; off < kTilesD; off <<= 1) {
#pragma unroll
            for (int a = 0; a < kTileK; ++a) {
              q0[a] += __shfl_xor_sync(kFull, q0[a], off);
            }
          }
          if (on[t] && db == 0) {   // monomial 0 is column 0 of block 0
#pragma unroll
            for (int a = 0; a < kTileK; ++a) {
              const int k = k0 + kb[t] * kTileK + a;
              if (k >= K) continue;
              const T p0 = acc[t][a][0];
              // sign(0) is 0, as in both frameworks (no copysign)
              const T sgn = p0 > T(0) ? T(1) : (p0 < T(0) ? T(-1) : T(0));
              sc_s[k] = sgn / d_sqrt(q0[a] + T(1e-16));
            }
          }
        }
#pragma unroll
        for (int t = 0; t < TPL; ++t) {
          if (!on[t]) continue;
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
            const int k = k0 + kb[t] * kTileK + a;
            if (k >= sh.kp) continue;
            store4(p_s + k * kDp + 4 * db, acc[t][a]);
            store4(p_s + k * kDp + 32 + 4 * db, acc[t][a] + 4);
          }
        }
      }
      if (pairs == 0) continue;
      __syncwarp();   // P and the scale are written

      for (int b = 0; b < batch; ++b) {
        // ---- the coefficients c[k, m], then Pbar = P (c w^T)
        const T* g = gbar + (static_cast<size_t>(b) * rows + row) * width +
                     static_cast<size_t>(s) * K * M;
        for (int i = lane; i < sh.kp * kAlpha; i += 32) {
          const int k = i / kAlpha, mi = i - k * kAlpha;
          T a = T(0);
          if (k < K && mi < M) {
            a = g[k * M + mi] * (mom_s[mi] == 0 ? sc_s[k] : T(2));
          }
          al_s[i] = a;
        }
        __syncwarp();
        {
          T wc[2][kMaxMoments];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int mi = 0; mi < kMaxMoments; ++mi) {
              wc[c][mi] = mi < M ? w_s[mi * kDp + lane + 32 * c] : T(0);
            }
          }
          for (int k = 0; k < sh.kp; ++k) {
            T al[kAlpha];
            load4(al_s + k * kAlpha, al);
            load4(al_s + k * kAlpha + 4, al + 4);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              T coef = T(0);
#pragma unroll
              for (int mi = 0; mi < kMaxMoments; ++mi) {
                coef = fma(al[mi], wc[c][mi], coef);
              }
              const int i = k * kDp + lane + 32 * c;
              pbar_s[i] = p_s[i] * coef;
            }
          }
        }
        // ---- pass 2: E = H' Pbar and dM = H Pbar a batch of pairs
        T* out_rb = out_r + b * plane + base;
        T* out_xb = out_x + b * plane + base;
        T* out_yb = out_y + b * plane + base;
        T* out_zb = out_z + b * plane + base;
        for_each_batch<kBatch, kSpan>(
            rij, ux, uy, uz, slot, mask, base, n, slot_value, st,
            [&](int first, int nb) {
              prep(first, nb, true);
              __syncwarp();
              // h and h' of each (filter, pair), filter-major
              T* ht = h_s;
              T* dht = h_s + sh.kp * kBatch;
              for (int i = lane; i < sh.kp * kBatch; i += 32) {
                const int k = i / kBatch, p = i - k * kBatch;
                T hv = T(0), dv = T(0);
                if (k < K && p < nb) {
                  T f, df;
                  filter_value_and_slope(spec.algorithm, f_s[k], f_s[K + k],
                                         f_s[2 * K + k], lrl_s[k],
                                         st_r[first + p], lr_s[p], ir_s[p],
                                         rc2, f, df);
                  hv = f * fc_s[p];
                  dv = df * fc_s[p] + f * dfc_s[p];
                }
                ht[i] = hv;
                dht[i] = dv;
              }
              __syncwarp();
              const int p0 = kPairs * pq;
              T e[kPairs][kTileD], dm[kPairs][kTileD];
#pragma unroll
              for (int i = 0; i < kPairs; ++i) {
#pragma unroll
                for (int c = 0; c < kTileD; ++c) {
                  e[i][c] = T(0);
                  dm[i][c] = T(0);
                }
              }
              if (p0 < nb) {
#pragma unroll 2
                for (int k = 0; k < K; ++k) {
                  T hv[kPairs], dv[kPairs], pb[kTileD];
                  load4(ht + k * kBatch + p0, hv);
                  load4(dht + k * kBatch + p0, dv);
                  load4(pbar_s + k * kDp + 4 * db, pb);
                  load4(pbar_s + k * kDp + 32 + 4 * db, pb + 4);
#pragma unroll
                  for (int i = 0; i < kPairs; ++i) {
#pragma unroll
                    for (int c = 0; c < kTileD; ++c) {
                      dm[i][c] = fma(hv[i], pb[c], dm[i][c]);
                      e[i][c] = fma(dv[i], pb[c], e[i][c]);
                    }
                  }
                }
              }
              // d/dr: sum_d E m over the lane's monomials, then over the
              // 8 lanes of the pair group; dM over the monomial tile
              T part[kPairs];
#pragma unroll
              for (int i = 0; i < kPairs; ++i) {
                part[i] = T(0);
                if (p0 + i < nb) {
                  T* m_row = m_s + (p0 + i) * kMs<T>;
                  T mv[kTileD];
                  load4(m_row + 4 * db, mv);
                  load4(m_row + 32 + 4 * db, mv + 4);
#pragma unroll
                  for (int c = 0; c < kTileD; ++c) {
                    part[i] = fma(mv[c], e[i][c], part[i]);
                  }
                  store4(m_row + 4 * db, dm[i]);
                  store4(m_row + 32 + 4 * db, dm[i] + 4);
                }
              }
#pragma unroll
              for (int off = 1; off < kTilesD; off <<= 1) {
#pragma unroll
                for (int i = 0; i < kPairs; ++i) {
                  part[i] += __shfl_xor_sync(kFull, part[i], off);
                }
              }
              if (db == 0) {
#pragma unroll
                for (int i = 0; i < kPairs; ++i) {
                  if (p0 + i < nb) dr_s[p0 + i] = part[i];
                }
              }
              __syncwarp();
              // one lane a pair: d/du by the adjoint recurrence
              if (lane < nb) {
                const int q = first + lane;
                const T x = st.v[2 * kList + q], y = st.v[3 * kList + q],
                        z = st.v[4 * kList + q];
                T m[kMaxMonomials], dmr[kMaxMonomials];
                monomials(x, y, z, m);
                const T* dm_row = m_s + lane * kMs<T>;
#pragma unroll
                for (int c = 0; c < kMaxMonomials / V; ++c) {
                  load_chunk(dm_row + c * V, dmr + c * V);
                }
                T gx = T(0), gy = T(0), gz = T(0);
                monomials_adjoint(x, y, z, m, dmr, gx, gy, gz);
                const T mk = st_mk[q];
                const int j = st.entry[q];
                out_rb[j] = dr_s[lane] * mk;
                out_xb[j] = gx * mk;
                out_yb[j] = gy * mk;
                out_zb[j] = gz * mk;
              }
            });
        __syncwarp();   // the next member rewrites the coefficients
      }
    }
  }
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
  GrapSpec<T> spec;
  if (!make_spec(spec, algorithm, n_filters, c0, c1, c2, n_mono, codes,
                 n_moments, moments)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  sh.kg = n_filters < kMaxFiltersPerPass ? n_filters : kMaxFiltersPerPass;
  sh.kgp = kTileK;
  while (sh.kgp < sh.kg) sh.kgp *= 2;
  sh.kp = (n_filters + 3) / 4 * 4;
  sh.hsz = kBatch * (sh.kgp > 2 * sh.kp ? sh.kgp : 2 * sh.kp);
  sh.pbar = batch > 1 ? 1 : 0;
  // as many rows a block as its tiles fit in shared memory, up to kWarps
  const size_t tables = table_bytes<T>(n_filters, n_moments);
  int warps = kWarps;
  while (warps > 1 && warps * warp_bytes<T>(sh) + tables > kMaxSmem) {
    --warps;
  }
  const size_t smem = warps * warp_bytes<T>(sh) + tables;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool one_tile = sh.kgp / kTileK * kTilesD <= 32;
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T rc2 = T(rc * rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  auto launch = [&](auto kernel) {
    // as many blocks as fit on the card at once, or fewer for few rows:
    // each block stages its tables once for all the rows it takes
    int resident = 0;
    const cudaError_t e = resident_blocks(
        reinterpret_cast<const void*>(kernel), 32 * warps, smem, &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int needed = (rows + warps - 1) / warps;
    const int blocks = needed < resident ? needed : resident;
    kernel<<<blocks, 32 * warps, smem, st>>>(
        gbar, rij, ux, uy, uz, slot, mask, w, out_r, out_x, out_y, out_z,
        batch, rows, n, n_slots, sh, spec, cut, rc2);
    return static_cast<int>(cudaGetLastError());
  };
  return one_tile ? launch(grap_vjp_kernel<T, 1>)
                  : launch(grap_vjp_kernel<T, 2>);
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
