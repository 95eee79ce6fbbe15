// Second-order kernel of the GRAP moment-tensor descriptors for NVIDIA
// Hopper (sm_90a), with a plain C interface for ctypes: the VJP of the
// VJP kernel of grap_vjp.cu.
//
// A force loss differentiates the forces, which the first backward took
// through `grap_vjp_kernel`; so does a Hessian row. JAX takes this
// derivative by `jax.grad` through `jax.vjp` of the XLA reference
// `_grap_ref_dense` of tensoralloy_tpu/ops/fused.py (the backward of the
// Pallas TPU kernel `_grap_kernel` is `jax.vjp` of it); there is no Pallas
// kernel of it. The Python wrapper `grap_vjp_bwd_kernel`, its closed-form
// plain version `grap_vjp_bwd_reference` (whose docstring writes the
// formulas out) and the autograd Function of the VJP `GrapVjpFunction`
// are in tensoralloy_tpu_torch/ops/fused.py.
//
// With grap_vjp.cu's notation, for an atom row and its slot s: H [p, K]
// the filter values times the cutoff and the mask of its p pairs, H' and
// H'' their derivatives in r, M [p, D] the monomials, Mdot_j = a_j .
// grad_u M_j their derivative along the pair's cotangent a_j = (a_x, a_y,
// a_z), v_j the pair's cotangent of d/dr, P = H^T M, C[k, d] = sum_m
// c[k, m] w[d, m] (c = kappa gbar, kappa = 2 above moment 0 and
// sign(P0) / sqrt(Q0 + 1e-16) at it) and Pbar = P o C:
//   Z = (v H')^T M + H^T Mdot, the forward's product twice more;
//   gbar_bar[s, k, m] = kappa[k, m] sum_d Z[k, d] P[k, d] w[d, m];
// and with the geometry term,
//   Pb2 = Z o C - [moment 0] gbar[k, 0] sign(P0) (Q0 + 1e-16)^(-3/2)
//         (sum_d Z P w[., 0])[k] w[d, 0] P[k, d],
//   d/d r_j  = (H' Pb2 + v_j H'' Pbar)_j . M_j + (H' Pbar)_j . Mdot_j,
//   d/d u_j  = (dM_j)^T (H Pb2 + v_j H' Pbar)_j + (d^2 M_j : a_j)^T
//              (H Pbar)_j,
// each times the entry's mask. The last term is the adjoint of the
// monomial recurrence run on the dual numbers (M, Mdot)
// (`monomials_dual_adjoint`, grap_common.cuh). Inputs: the cotangents
// v, a_x, a_y, a_z [rows, n] of the VJP's outputs, gbar [rows, n_slots *
// K * M] and the forward's [rows, n] rows; outputs gbar_bar [rows,
// n_slots * K * M] and the four geometry terms [rows, n]. A null geometry
// pointer launches the build without the geometry term (gbar is then not
// read): the loss backward of a train step asks for the parameters only.
// A masked entry, or one of no slot, gets exactly 0 and its geometry is
// not read.
//
// What binds it on an H100: FP32 FMAs in principle, as grap_vjp: without
// the geometry term three products a pair of the forward's size (P and
// Z's two); with it five more (H' Pbar, v H'' Pbar, H' Pb2, H Pbar,
// H Pb2) and the dual adjoint. In practice latency: at one warp a row the
// compaction's two dependent reads a span, the gathers of v and a a
// batch and the filters' transcendentals stall the warp, and the
// products are a third of the launch without the geometry term. So each
// mode is a build of its own (`kGeometry`) with its own batch and launch
// bounds:
//   * one warp per atom row, up to kWarps rows a block, persistent warps;
//     one block barrier stages the small tables;
//   * `for_each_batch_staging` (grap_common.cuh) compacts the slot's real
//     pairs by ballots, 16 a batch with the geometry term, 8 without; one
//     lane a pair builds its monomials and their derivative along a into
//     two tiles of 16-byte chunks, its cutoff's value, slope (and
//     curvature) times the mask;
//   * pass 1 takes up to 16 filters a walk (one 4 filter x 8 monomial
//     tile a lane, so P and Z's tiles are 64 registers): the lanes
//     compute each (pair, filter) h and v h' once, and each lane adds
//     h m, v h' m and h mdot to its two tiles (96 FMAs for 6 16-byte
//     loads). The moment-0 scale comes from the P tiles by xor shuffles
//     over the 8 lanes of a filter block, and each moment's sum of
//     Z P w likewise: gbar_bar is finished in registers and written once;
//   * the build without the geometry term (a train step's loss backward)
//     is pass 1 alone, at 168 registers and 8 pairs a batch: 3 blocks of
//     4 warps an SM. v and a are staged with the pairs' geometry, read in
//     the same round as r and u (no gather a batch), and a lane's four
//     filter items are computed in registers before they are stored, so
//     that their latencies overlap;
//   * the build with the geometry term (2 blocks of 4 warps an SM: its
//     tiles are 23 KB a warp at K = 16 in float32, and it takes 242
//     registers) gathers v and a a batch and computes its filter items
//     one at a time, which measured faster there. P and Z go to per-warp
//     tiles, which become Pbar and Pb2; pass 3 walks the pairs again, the
//     filters' values and two derivatives filter-major, and each lane
//     holds 4 pairs x 8 monomials of two products at a time over the
//     filters (H' Pbar and v H'' Pbar + H' Pb2, whose sums with M and
//     Mdot give d/dr; then H Pbar and H Pb2 + v H' Pbar into the monomial
//     tiles); one lane a pair runs the dual adjoint and writes its four
//     outputs. A d/du from H Pbar lowered one degree through a table of
//     each monomial's neighbours, on all 32 lanes, measured slower: its
//     gathers from the monomial tile load shared memory more than the
//     products do.
// No atomics: each output is written once, so a second launch gives the
// same bits. Entries of no slot are written as zeros before the slots
// run. float64 runs the same template. Full-precision exp/exp2/log2/sqrt
// (common.cuh): float64 parity with the closed form depends on them.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "grap_common.cuh"

namespace {

constexpr int kWarps = 4;                 // atom rows a block, at most
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 64;                 // entries compacted a step
constexpr int kTileK = 4;                 // pass 1: a lane's tile of 4
constexpr int kTileD = 8;                 //   filters x 8 monomials
constexpr int kPairs = 4;                 // pass 3: 4 pairs x 8 monomials
constexpr int kDp = 64;                   // monomials padded: 8 blocks of 8
constexpr int kTilesD = kDp / kTileD;     // lanes of one filter block
constexpr int kAlpha = 8;                 // row stride of the coefficients
constexpr int kFiltersPerWalk = 16;       // pass 1: one tile a lane
constexpr size_t kMaxSmem = 232448;       // an H100 block's shared memory

// Compacted pairs a batch: pass 3's layout of 4 pairs x 8 monomials a
// lane takes 16; the build without the geometry term takes 8, whose
// smaller tiles fit 3 blocks an SM.
template <bool kGeometry>
constexpr int kBatchOf = kGeometry ? 16 : 8;
template <bool kGeometry>
constexpr int kListOf = kSpan + kBatchOf<kGeometry>;   // a step + carry
// Cotangents staged with a pair's geometry (r, mask, ux, uy, uz): v, a_x,
// a_y, a_z without the geometry term; with it the parent's gathers a
// batch measured faster.
template <bool kGeometry>
constexpr int kCotangentsOf = kGeometry ? 0 : 4;

// Row stride of the monomial tiles: kDp and one chunk more (no bank
// conflicts for a lane a row nor for 8 lanes on one row).
template <typename T>
constexpr int kMs = kDp + kChunk<T>;

// Resident blocks an SM the compiler plans registers for. With the
// geometry term the tiles fit 2 blocks of 4 warps (23 KB a warp at K = 16
// in float32), and the dual adjoint and pass 1's prep may take the
// registers of 2; without it 3 (168 registers a thread).
template <typename T, bool kGeometry>
constexpr int kMinBlocks = sizeof(T) == 4 ? (kGeometry ? 2 : 3) : 1;

// Launch shape, fixed on the host from K and the build.
struct Shape {
  int kp;      // K padded to 4: rows of the P and Z tiles
  int hsz;     // elements of the h tiles: 2 [kBatch, 16] or 3 [kp, kBatch]
};

// Bytes of one warp's tiles, in this order: P and Z [kp, kDp] each (with
// the geometry term), the monomial tiles M and Mdot [kBatch, kMs] each,
// the h tiles, the stage (r, mask, ux, uy, uz and, without the geometry
// term, v, a_x, a_y, a_z [kStaged, kList]; the entries [kList] int),
// per-pair fc, fc', fc'',
// 1/r, v and d/dr [6, kBatch], log2 r [kBatch] double, the moment-0 scale
// and sum_d Z P w[., 0] [2, kp] and the coefficients [kp, kAlpha]. Each
// piece is a multiple of 16 bytes.
template <typename T, bool kGeometry>
__host__ __device__ __forceinline__ size_t warp_bytes(const Shape& sh) {
  constexpr int B = kBatchOf<kGeometry>, L = kListOf<kGeometry>;
  constexpr int kStaged = 5 + kCotangentsOf<kGeometry>;
  return sizeof(T) * (static_cast<size_t>(sh.kp) * kDp * 2 * kGeometry +
                      2 * B * kMs<T> + sh.hsz + kStaged * L + 6 * B +
                      sh.kp * (2 + kAlpha)) +
         sizeof(int) * L + sizeof(double) * B;
}

// The block's tables after the warps' tiles: the invariant weights
// [M, kDp] of T, log2 of the pexp lengths [K] in double, the filter grid
// [3, K] of T and the moments [M].
template <typename T>
size_t table_bytes(int n_filters, int n_moments) {
  return sizeof(T) * (kDp * n_moments + 3 * n_filters) +
         sizeof(double) * n_filters + sizeof(int) * n_moments;
}

// A [kTileD] register row to the lane's two chunks of a tile row, and back.
template <typename T>
__device__ __forceinline__ void load_row8(const T* row, int db, T* v) {
  load4(row + 4 * db, v);
  load4(row + 32 + 4 * db, v + 4);
}

template <typename T>
__device__ __forceinline__ void store_row8(T* row, int db, const T* v) {
  store4(row + 4 * db, v);
  store4(row + 32 + 4 * db, v + 4);
}

template <typename T, bool kGeometry>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, kGeometry>))
grap_vjp_bwd_kernel(const T* __restrict__ vr, const T* __restrict__ vx,
                    const T* __restrict__ vy, const T* __restrict__ vz,
                    const T* __restrict__ gbar, const T* __restrict__ rij,
                    const T* __restrict__ ux, const T* __restrict__ uy,
                    const T* __restrict__ uz, const T* __restrict__ slot,
                    const T* __restrict__ mask, const T* __restrict__ w,
                    T* __restrict__ gbar_bar, T* __restrict__ out_r,
                    T* __restrict__ out_x, T* __restrict__ out_y,
                    T* __restrict__ out_z, int rows, int n, int n_slots,
                    Shape sh, const __grid_constant__ GrapSpec<T> spec,
                    const __grid_constant__ Cutoff<T> cut, T rc2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = kChunk<T>;
  constexpr int kBatch = kBatchOf<kGeometry>;
  constexpr int kList = kListOf<kGeometry>;
  constexpr int kCotangents = kCotangentsOf<kGeometry>;
  constexpr int kStaged = 5 + kCotangents;
  const int K = spec.n_filters, D = spec.n_mono, M = spec.n_moments;
  const int warps = blockDim.x >> 5;
  const size_t wb = warp_bytes<T, kGeometry>(sh);
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
  T* z_s = p_s + kGeometry * sh.kp * kDp;                // [kp, kDp] Z
  T* m_s = z_s + kGeometry * sh.kp * kDp;                // [kBatch, kMs] M
  T* md_s = m_s + kBatch * kMs<T>;                       // Mdot
  T* h_s = md_s + kBatch * kMs<T>;
  const Stage<T> st{h_s + sh.hsz, reinterpret_cast<int*>(
                                       h_s + sh.hsz + kStaged * kList)};
  T* fc_s = reinterpret_cast<T*>(st.entry + kList);      // [kBatch]
  T* dfc_s = fc_s + kBatch;                              // fc'
  T* d2fc_s = dfc_s + kBatch;                            // fc''
  T* ir_s = d2fc_s + kBatch;                             // 1 / r
  T* v_s = ir_s + kBatch;                                // v (d/dr's)
  T* dr_s = v_s + kBatch;                                // d/dr
  double* lr_s = reinterpret_cast<double*>(dr_s + kBatch);   // log2 r
  T* sc_s = reinterpret_cast<T*>(lr_s + kBatch);   // [kp] moment-0 scale
  T* zw_s = sc_s + sh.kp;                          // [kp] sum_d Z P w0
  T* al_s = zw_s + sh.kp;                          // [kp, kAlpha]
  const T* st_r = st.v;
  const T* st_mk = st.v + kList;
  const bool pexp = spec.algorithm == kPexp;
  int m0 = -1;   // the column of moment 0, if requested
  for (int mi = 0; mi < M; ++mi) {
    if (mom_s[mi] == 0) m0 = mi;
  }
  const int db = lane & (kTilesD - 1);   // the lane's monomial block
  const int kb = lane / kTilesD;   // pass 1: the lane's filter block
  const int pq = lane >> 3;        // pass 3: the lane's pairs 4 pq + i
  const size_t width = static_cast<size_t>(n_slots) * K * M;
  // the cotangents v, a_x, a_y, a_z, staged without the geometry term
  const T* const cotangents[4] = {vr, vx, vy, vz};

  // Pair prep of a batch: one lane a pair stores its monomials and their
  // derivative along a to row `lane` of the tiles (zeros past D), its
  // cutoff, slope (and curvature) times the mask, 1/r, v and, for pexp,
  // log2 r.
  auto prep = [&](int first, int nb, bool curvature, size_t base) {
    if (lane >= nb) return;
    const int q = first + lane;
    const T r = st_r[q], mk = st_mk[q];
    T f, df, d2f = T(0);
    if (kGeometry && curvature) {
      cutoff_value_slope_curvature(cut, r, f, df, d2f);
    } else {
      cutoff_value_and_slope(cut, r, f, df);
    }
    fc_s[lane] = f * mk;
    dfc_s[lane] = df * mk;
    d2fc_s[lane] = d2f * mk;
    ir_s[lane] = T(1) / r;
    if (pexp) lr_s[lane] = log2(double(r));
    // v and a: gathered with the geometry term, staged without
    T a[4];
    if (kGeometry) {
      const size_t j = base + st.entry[q];
      a[0] = vr[j];
      a[1] = vx[j];
      a[2] = vy[j];
      a[3] = vz[j];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = st.v[(5 + i) * kList + q];
    }
    v_s[lane] = a[0];
    T m[kMaxMonomials], md[kMaxMonomials];
    monomials_dual(st.v[2 * kList + q], st.v[3 * kList + q],
                   st.v[4 * kList + q], a[1], a[2], a[3], m, md);
    T* m_row = m_s + lane * kMs<T>;
    T* md_row = md_s + lane * kMs<T>;
#pragma unroll
    for (int c = 0; c < kDp / V; ++c) {
      T a[V], b[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = c * V + e;   // d < 64; monomials end at 56
        const bool in = d < kMaxMonomials && d < D;
        a[e] = in ? m[d < kMaxMonomials ? d : 0] : T(0);
        b[e] = in ? md[d < kMaxMonomials ? d : 0] : T(0);
      }
      store_chunk(m_row + c * V, a);
      store_chunk(md_row + c * V, b);
    }
  };

  // persistent warps: a warp takes every (gridDim.x * warps)-th row
  for (int row = blockIdx.x * warps + warp; row < rows;
       row += gridDim.x * warps) {
    const size_t base = static_cast<size_t>(row) * n;
    if (kGeometry) {   // entries of no slot: 0 in every output
      for (int j = lane; j < n; j += 32) {
        if (entry_slot(mask[base + j], slot[base + j], n_slots) >= 0) {
          continue;
        }
        out_r[base + j] = T(0);
        out_x[base + j] = T(0);
        out_y[base + j] = T(0);
        out_z[base + j] = T(0);
      }
    }
    for (int s = 0; s < n_slots; ++s) {
      const T slot_value = T(s);
      T* gb_row = gbar_bar + static_cast<size_t>(row) * width +
                  static_cast<size_t>(s) * K * M;
      // ---- pass 1: P = H^T M and Z = (v H')^T M + H^T Mdot of filters
      // [k0, k0 + kg) a walk, then gbar_bar's columns of those filters
      int pairs = 0;
      for (int k0 = 0; k0 < K; k0 += kFiltersPerWalk) {
        const int kg = min(kFiltersPerWalk, K - k0);
        int kgp = kTileK, k_shift = 2;   // kg padded to a power of two
        while (kgp < kg) {
          kgp <<= 1;
          ++k_shift;
        }
        const bool on = kb * kTileK < kgp;
        // kgp divides 32: a lane computes h and v h' of filter kk_h for
        // every (32 / kgp)-th pair of a batch
        const int kk_h = lane & (kgp - 1);
        const bool k_on = kk_h < kg;
        const int k_h = k0 + (k_on ? kk_h : 0);
        const T c0 = f_s[k_h], c1 = f_s[K + k_h], c2 = f_s[2 * K + k_h];
        const double lrl = lrl_s[k_h];
        T* hv_s = h_s;                  // [nb, kgp] h, pair-major
        T* hd_s = h_s + kBatch * kgp;   // [nb, kgp] v h'
        T acc_p[kTileK][kTileD], acc_z[kTileK][kTileD];
#pragma unroll
        for (int a = 0; a < kTileK; ++a) {
#pragma unroll
          for (int b = 0; b < kTileD; ++b) {
            acc_p[a][b] = T(0);
            acc_z[a][b] = T(0);
          }
        }
        pairs = for_each_batch_staging<kBatch, kSpan, kCotangents>(
            rij, ux, uy, uz, slot, mask, cotangents, base, n, slot_value,
            st, [&](int first, int nb) {
              prep(first, nb, false, base);
              __syncwarp();
              // a lane's (pair, filter) items: without the geometry term
              // in registers first, so that their latencies overlap; with
              // it one at a time, which measured faster there
              constexpr int kItems =
                  kGeometry ? 1 : kBatch * kFiltersPerWalk / 32;
              for (int p0 = lane >> k_shift; p0 < nb;
                   p0 += kItems * (32 >> k_shift)) {
                T hvi[kItems], hdi[kItems];
#pragma unroll
                for (int t = 0; t < kItems; ++t) {
                  const int p = p0 + t * (32 >> k_shift);
                  hvi[t] = T(0);
                  hdi[t] = T(0);
                  if (k_on && p < nb) {
                    T f, df;
                    filter_value_and_slope(spec.algorithm, c0, c1, c2, lrl,
                                           st_r[first + p], lr_s[p],
                                           ir_s[p], rc2, f, df);
                    hvi[t] = f * fc_s[p];
                    hdi[t] = v_s[p] * (df * fc_s[p] + f * dfc_s[p]);
                  }
                }
#pragma unroll
                for (int t = 0; t < kItems; ++t) {
                  const int p = p0 + t * (32 >> k_shift);
                  if (p < nb) {
                    hv_s[(p << k_shift) + kk_h] = hvi[t];
                    hd_s[(p << k_shift) + kk_h] = hdi[t];
                  }
                }
              }
              __syncwarp();
              if (!on) return;
#pragma unroll 2
              for (int p = 0; p < nb; ++p) {
                T mv[kTileD], mdv[kTileD], hv[kTileK], hd[kTileK];
                load_row8(m_s + p * kMs<T>, db, mv);
                load_row8(md_s + p * kMs<T>, db, mdv);
                load4(hv_s + p * kgp + kb * kTileK, hv);
                load4(hd_s + p * kgp + kb * kTileK, hd);
#pragma unroll
                for (int a = 0; a < kTileK; ++a) {
#pragma unroll
                  for (int b = 0; b < kTileD; ++b) {
                    acc_p[a][b] = fma(hv[a], mv[b], acc_p[a][b]);
                    acc_z[a][b] =
                        fma(hd[a], mv[b], fma(hv[a], mdv[b], acc_z[a][b]));
                  }
                }
              }
            });
        if (pairs == 0) break;   // no pair of slot s
        // the moment-0 scale sign(P0) / sqrt(Q0 + 1e-16) of the lane's
        // filters: Q0 of its 8 monomials, then over the 8 lanes of the
        // block; P0 from the block's first lane
        T sc[kTileK];
#pragma unroll
        for (int a = 0; a < kTileK; ++a) sc[a] = T(0);
        if (m0 >= 0) {
          T wv[kTileD];
          load_row8(w_s + m0 * kDp, db, wv);
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
            T q0 = T(0);
#pragma unroll
            for (int b = 0; b < kTileD; ++b) {
              q0 += wv[b] * (acc_p[a][b] * acc_p[a][b]);
            }
#pragma unroll
            for (int off = 1; off < kTilesD; off <<= 1) {
              q0 += __shfl_xor_sync(kFull, q0, off);
            }
            const T p0 =
                __shfl_sync(kFull, acc_p[a][0], lane & ~(kTilesD - 1));
            // sign(0) is 0, as in both frameworks (no copysign)
            const T sgn = p0 > T(0) ? T(1) : (p0 < T(0) ? T(-1) : T(0));
            sc[a] = sgn / d_sqrt(q0 + T(1e-16));
          }
        }
        // gbar_bar[k, m] = kappa sum_d Z P w[d, m], over the lane's
        // monomials, then over the 8 lanes of the block
        for (int mi = 0; mi < M; ++mi) {
          T wv[kTileD];
          load_row8(w_s + mi * kDp, db, wv);
          const bool zero = mom_s[mi] == 0;
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
            T part = T(0);
#pragma unroll
            for (int b = 0; b < kTileD; ++b) {
              part = fma(acc_z[a][b] * acc_p[a][b], wv[b], part);
            }
#pragma unroll
            for (int off = 1; off < kTilesD; off <<= 1) {
              part += __shfl_xor_sync(kFull, part, off);
            }
            const int k = k0 + kb * kTileK + a;
            if (on && db == 0 && k < K) {
              gb_row[k * M + mi] = (zero ? sc[a] : T(2)) * part;
              if (zero && kGeometry) zw_s[k] = part;
            }
          }
        }
        if (kGeometry && on) {
#pragma unroll
          for (int a = 0; a < kTileK; ++a) {
            const int k = k0 + kb * kTileK + a;
            if (k >= sh.kp) continue;
            store_row8(p_s + k * kDp, db, acc_p[a]);
            store_row8(z_s + k * kDp, db, acc_z[a]);
            if (db == 0) sc_s[k] = sc[a];
          }
        }
      }
      if (pairs == 0) {   // no pair of slot s: its gbar_bar is 0
        for (int i = lane; i < K * M; i += 32) gb_row[i] = T(0);
        continue;
      }
      if (!kGeometry) continue;
      __syncwarp();   // P, Z, the scale and sum_d Z P w0 are written

      // ---- the coefficients c[k, m], then Pbar = P o C and Pb2 = Z o C
      // less moment 0's term through Q0
      const T* g = gbar + static_cast<size_t>(row) * width +
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
        T wc[2][kMaxMoments], w0[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int mi = 0; mi < kMaxMoments; ++mi) {
            wc[c][mi] = mi < M ? w_s[mi * kDp + lane + 32 * c] : T(0);
          }
          w0[c] = m0 >= 0 ? w_s[m0 * kDp + lane + 32 * c] : T(0);
        }
        for (int k = 0; k < sh.kp; ++k) {
          T al[kAlpha];
          load4(al_s + k * kAlpha, al);
          load4(al_s + k * kAlpha + 4, al + 4);
          // gbar[k, 0] sign(P0) (Q0 + 1e-16)^(-3/2) sum_d Z P w0: the
          // scale cubed is sign(P0) (Q0 + 1e-16)^(-3/2)
          T corr = T(0);
          if (m0 >= 0 && k < K) {
            const T sck = sc_s[k];
            corr = g[k * M + m0] * (sck * sck * sck) * zw_s[k];
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            T coef = T(0);
#pragma unroll
            for (int mi = 0; mi < kMaxMoments; ++mi) {
              coef = fma(al[mi], wc[c][mi], coef);
            }
            const int i = k * kDp + lane + 32 * c;
            const T pv = p_s[i];
            p_s[i] = pv * coef;
            z_s[i] = z_s[i] * coef - corr * w0[c] * pv;
          }
        }
      }
      // ---- pass 3: the geometry term a batch of pairs
      T* ht = h_s;                        // [kp, kBatch] h, filter-major
      T* dht = h_s + sh.kp * kBatch;      // h'
      T* vt = dht + sh.kp * kBatch;       // v h''
      for_each_batch<kBatch, kSpan>(
          rij, ux, uy, uz, slot, mask, base, n, slot_value, st,
          [&](int first, int nb) {
            prep(first, nb, true, base);
            __syncwarp();
            for (int i = lane; i < sh.kp * kBatch; i += 32) {
              const int k = i / kBatch, p = i - k * kBatch;
              T hv = T(0), dv = T(0), vv = T(0);
              if (k < K && p < nb) {
                T f, df, d2f;
                filter_value_slope_curvature(
                    spec.algorithm, f_s[k], f_s[K + k], f_s[2 * K + k],
                    lrl_s[k], st_r[first + p], lr_s[p], ir_s[p], rc2, f, df,
                    d2f);
                const T fc = fc_s[p], dfc = dfc_s[p];
                hv = f * fc;
                dv = df * fc + f * dfc;
                vv = v_s[p] * (d2f * fc + T(2) * df * dfc + f * d2fc_s[p]);
              }
              ht[i] = hv;
              dht[i] = dv;
              vt[i] = vv;
            }
            __syncwarp();
            const int p0 = kPairs * pq;
            // H' Pbar and v H'' Pbar + H' Pb2 of the lane's 4 pairs x 8
            // monomials, over the filters
            T e1[kPairs][kTileD], e2[kPairs][kTileD];
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
#pragma unroll
              for (int c = 0; c < kTileD; ++c) {
                e1[i][c] = T(0);
                e2[i][c] = T(0);
              }
            }
            if (p0 < nb) {
#pragma unroll 2
              for (int k = 0; k < K; ++k) {
                T dv[kPairs], vv[kPairs], pb[kTileD], pb2[kTileD];
                load4(dht + k * kBatch + p0, dv);
                load4(vt + k * kBatch + p0, vv);
                load_row8(p_s + k * kDp, db, pb);
                load_row8(z_s + k * kDp, db, pb2);
#pragma unroll
                for (int i = 0; i < kPairs; ++i) {
#pragma unroll
                  for (int c = 0; c < kTileD; ++c) {
                    e1[i][c] = fma(dv[i], pb[c], e1[i][c]);
                    e2[i][c] =
                        fma(vv[i], pb[c], fma(dv[i], pb2[c], e2[i][c]));
                  }
                }
              }
            }
            // d/dr: sum_d (e2 M + e1 Mdot) over the lane's monomials, then
            // over the 8 lanes of the pair group; v e1 over the lane's M
            T part[kPairs];
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
              part[i] = T(0);
              if (p0 + i < nb) {
                T* m_row = m_s + (p0 + i) * kMs<T>;
                T mv[kTileD], mdv[kTileD], ve[kTileD];
                load_row8(m_row, db, mv);
                load_row8(md_s + (p0 + i) * kMs<T>, db, mdv);
                const T vi = v_s[p0 + i];
#pragma unroll
                for (int c = 0; c < kTileD; ++c) {
                  part[i] = fma(mv[c], e2[i][c],
                                fma(mdv[c], e1[i][c], part[i]));
                  ve[c] = vi * e1[i][c];
                }
                store_row8(m_row, db, ve);
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
            // H Pbar, and H Pb2 + v H' Pbar, into the monomial tiles
            // (the lane's own columns)
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
#pragma unroll
              for (int c = 0; c < kTileD; ++c) e1[i][c] = T(0);
              if (p0 + i < nb) {
                load_row8(m_s + (p0 + i) * kMs<T>, db, e2[i]);
              } else {
#pragma unroll
                for (int c = 0; c < kTileD; ++c) e2[i][c] = T(0);
              }
            }
            if (p0 < nb) {
#pragma unroll 2
              for (int k = 0; k < K; ++k) {
                T hv[kPairs], pb[kTileD], pb2[kTileD];
                load4(ht + k * kBatch + p0, hv);
                load_row8(p_s + k * kDp, db, pb);
                load_row8(z_s + k * kDp, db, pb2);
#pragma unroll
                for (int i = 0; i < kPairs; ++i) {
#pragma unroll
                  for (int c = 0; c < kTileD; ++c) {
                    e1[i][c] = fma(hv[i], pb[c], e1[i][c]);
                    e2[i][c] = fma(hv[i], pb2[c], e2[i][c]);
                  }
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
              if (p0 + i < nb) {
                store_row8(m_s + (p0 + i) * kMs<T>, db, e2[i]);
                store_row8(md_s + (p0 + i) * kMs<T>, db, e1[i]);
              }
            }
            __syncwarp();
            // one lane a pair: d/du by the dual adjoint, seeded with
            // H Pb2 + v H' Pbar (M's) and H Pbar (Mdot's)
            if (lane < nb) {
              const int q = first + lane;
              const int j = st.entry[q];
              const T x = st.v[2 * kList + q], y = st.v[3 * kList + q],
                      z = st.v[4 * kList + q];
              const T tx = vx[base + j], ty = vy[base + j],
                      tz = vz[base + j];
              T m[kMaxMonomials], md[kMaxMonomials];
              T dm[kMaxMonomials], dmd[kMaxMonomials];
              monomials_dual(x, y, z, tx, ty, tz, m, md);
              const T* dm_row = m_s + lane * kMs<T>;
              const T* dmd_row = md_s + lane * kMs<T>;
#pragma unroll
              for (int c = 0; c < kMaxMonomials / V; ++c) {
                load_chunk(dm_row + c * V, dm + c * V);
                load_chunk(dmd_row + c * V, dmd + c * V);
              }
              T gx = T(0), gy = T(0), gz = T(0);
              monomials_dual_adjoint(x, y, z, tx, ty, tz, m, md, dm, dmd,
                                     gx, gy, gz);
              const T mk = st_mk[q];
              out_r[base + j] = dr_s[lane] * mk;
              out_x[base + j] = gx * mk;
              out_y[base + j] = gy * mk;
              out_z[base + j] = gz * mk;
            }
          });
    }
  }
}

// The launch of one (type, build): the arguments checked, the launch
// specification filled, as many rows a block as its tiles fit in shared
// memory (up to kWarps), as many blocks as fit on the card at once or
// fewer for few rows (each block stages its tables once for all the rows
// it takes).
template <typename T, bool kGeometry>
[[maybe_unused]] int launch_grap_vjp_bwd(
    const T* vr, const T* vx, const T* vy, const T* vz, const T* gbar,
    const T* rij, const T* ux, const T* uy, const T* uz, const T* slot,
    const T* mask, const T* w, T* gbar_bar, T* out_r, T* out_x, T* out_y,
    T* out_z, int rows, int n, int n_slots, int algorithm, int n_filters,
    const double* c0, const double* c1, const double* c2, int n_mono,
    const unsigned short* codes, int n_moments, const int* moments,
    double rc, int cutoff_id, void* stream) {
  if (rows <= 0 || n <= 0 || n_slots <= 0 || algorithm < kSf ||
      algorithm > kPexp || n_filters <= 0 || n_filters > kMaxFilters ||
      n_mono <= 0 || n_mono > kMaxMonomials || n_moments <= 0 ||
      n_moments > kMaxMoments || cutoff_id < 0 || cutoff_id > 4 ||
      kGeometry != (out_r != nullptr) || kGeometry != (out_x != nullptr) ||
      kGeometry != (out_y != nullptr) || kGeometry != (out_z != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GrapSpec<T> spec;
  if (!make_spec(spec, algorithm, n_filters, c0, c1, c2, n_mono, codes,
                 n_moments, moments)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kBatch = kBatchOf<kGeometry>;
  Shape sh;
  sh.kp = (n_filters + 3) / 4 * 4;
  sh.hsz = 2 * kBatch * kFiltersPerWalk;
  if (kGeometry && 3 * sh.kp * kBatch > sh.hsz) sh.hsz = 3 * sh.kp * kBatch;
  const size_t tables = table_bytes<T>(n_filters, n_moments);
  const size_t wb = warp_bytes<T, kGeometry>(sh);
  int warps = kWarps;
  while (warps > 1 && warps * wb + tables > kMaxSmem) --warps;
  const size_t smem = warps * wb + tables;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T rc2 = T(rc * rc);
  const void* kernel =
      reinterpret_cast<const void*>(grap_vjp_bwd_kernel<T, kGeometry>);
  int resident = 0;
  const cudaError_t e = resident_blocks(kernel, 32 * warps, smem, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int needed = (rows + warps - 1) / warps;
  const int blocks = needed < resident ? needed : resident;
  grap_vjp_bwd_kernel<T, kGeometry>
      <<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
          vr, vx, vy, vz, gbar, rij, ux, uy, uz, slot, mask, w, gbar_bar,
          out_r, out_x, out_y, out_z, rows, n, n_slots, sh, spec, cut, rc2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). `w` is a device array
// [n_mono, n_moments] of the input type; the parameter tables and the
// monomial codes are host arrays copied into the launch. Null geometry
// outputs (all four) launch the build without the geometry term. Each
// (type, build) is a function of its own; a build that defines
// GRAP_VJP_BWD_ENTRY as 0-3 compiles one of them (0 float32 with the
// geometry term, 1 float32 without, 2 and 3 float64 likewise), and
// units 0 and 2 also the entry points, which pick the build.
#ifdef GRAP_VJP_BWD_ENTRY
#define GRAP_VJP_BWD_HAS_ENTRY(i) (GRAP_VJP_BWD_ENTRY == (i))
#else
#define GRAP_VJP_BWD_HAS_ENTRY(i) 1
#endif

#define GRAP_VJP_BWD_PARAMS(T)                                               \
  const T *vr, const T *vx, const T *vy, const T *vz, const T *gbar,        \
      const T *rij, const T *ux, const T *uy, const T *uz, const T *slot,   \
      const T *mask, const T *w, T *gbar_bar, T *out_r, T *out_x,           \
      T *out_y, T *out_z, int rows, int n, int n_slots, int algorithm,      \
      int n_filters, const double *c0, const double *c1, const double *c2, \
      int n_mono, const unsigned short *codes, int n_moments,               \
      const int *moments, double rc, int cutoff_id, void *stream
#define GRAP_VJP_BWD_ARGS                                                   \
  vr, vx, vy, vz, gbar, rij, ux, uy, uz, slot, mask, w, gbar_bar, out_r,    \
      out_x, out_y, out_z, rows, n, n_slots, algorithm, n_filters, c0, c1, \
      c2, n_mono, codes, n_moments, moments, rc, cutoff_id, stream

extern "C" {

int grap_vjp_bwd_f32_geometry(GRAP_VJP_BWD_PARAMS(float));
int grap_vjp_bwd_f32_flat(GRAP_VJP_BWD_PARAMS(float));
int grap_vjp_bwd_f64_geometry(GRAP_VJP_BWD_PARAMS(double));
int grap_vjp_bwd_f64_flat(GRAP_VJP_BWD_PARAMS(double));

#if GRAP_VJP_BWD_HAS_ENTRY(0)
int grap_vjp_bwd_f32_geometry(GRAP_VJP_BWD_PARAMS(float)) {
  return launch_grap_vjp_bwd<float, true>(GRAP_VJP_BWD_ARGS);
}

int grap_vjp_bwd_f32(GRAP_VJP_BWD_PARAMS(float)) {
  return out_r != nullptr ? grap_vjp_bwd_f32_geometry(GRAP_VJP_BWD_ARGS)
                          : grap_vjp_bwd_f32_flat(GRAP_VJP_BWD_ARGS);
}
#endif

#if GRAP_VJP_BWD_HAS_ENTRY(1)
int grap_vjp_bwd_f32_flat(GRAP_VJP_BWD_PARAMS(float)) {
  return launch_grap_vjp_bwd<float, false>(GRAP_VJP_BWD_ARGS);
}
#endif

#if GRAP_VJP_BWD_HAS_ENTRY(2)
int grap_vjp_bwd_f64_geometry(GRAP_VJP_BWD_PARAMS(double)) {
  return launch_grap_vjp_bwd<double, true>(GRAP_VJP_BWD_ARGS);
}

int grap_vjp_bwd_f64(GRAP_VJP_BWD_PARAMS(double)) {
  return out_r != nullptr ? grap_vjp_bwd_f64_geometry(GRAP_VJP_BWD_ARGS)
                          : grap_vjp_bwd_f64_flat(GRAP_VJP_BWD_ARGS);
}
#endif

#if GRAP_VJP_BWD_HAS_ENTRY(3)
int grap_vjp_bwd_f64_flat(GRAP_VJP_BWD_PARAMS(double)) {
  return launch_grap_vjp_bwd<double, false>(GRAP_VJP_BWD_ARGS);
}
#endif

}  // extern "C"
