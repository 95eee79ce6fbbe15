// Second-order kernels of the Behler symmetry-function descriptors (G2
// radial, G4 angular) for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes: the VJP of the VJP kernels of sf_vjp.cu.
//
// A force loss differentiates the forces, which the first backward took
// through `g2_vjp_kernel` / `g4_vjp_kernel`; so does a Hessian row. JAX
// takes this derivative by `jax.grad` through `jax.vjp` of the XLA
// references `_g2_ref_dense` / `_g4_ref_dense` of
// tensoralloy_tpu/ops/fused.py (the backward of the Pallas TPU kernels
// `_g2_kernel` and `_g4_kernel` is `jax.vjp` of them); there is no Pallas
// kernel of it. The Python wrappers (`g2_vjp_bwd_kernel`,
// `g4_vjp_bwd_kernel`), their closed-form plain versions
// (`g2_vjp_bwd_reference`, `g4_vjp_bwd_reference`, whose docstrings write
// the formulas out) and the autograd Functions of the VJP
// (`G2VjpFunction`, `G4VjpFunction`) are in
// tensoralloy_tpu_torch/ops/fused.py.
//
// Inputs: the cotangent v of the VJP's outputs ([rows, n], three for
// G4), the first-order cotangent gbar [rows, n_slots * n_params] and the
// forward's dense rows (distances, the slot as a float, a 0/1 mask).
// Outputs: gbar_bar [rows, n_slots * n_params], which has the forward's
// shape, and the geometry term(s) [rows, n] (G2 d/d rij; G4 d/d rij,
// d/d rik, d/d rjk), which have the VJP's. A null geometry pointer skips
// the geometry term (and gbar is then not read): the loss backward of a
// train step asks for the parameters only. A masked entry, or one whose
// slot is outside [0, n_slots), gets exactly 0 and its geometry is not
// used (G4 does not read it).
//
// What binds them on an H100: the bytes, as in the forwards, beside
// more math an entry. A pass reads the slot and mask rows, the real
// entries' distances and cotangents once, and writes the geometry rows
// and one gbar_bar row. One warp per atom row, 4 rows a block, the
// shapes of the VJP kernels (sf_common.cuh): G2 walks its row by quads
// of 4 neighbouring entries (`walk_quads`: 16-byte loads of mask, slot,
// distance and v, all issued before any math, one 16-byte store of the
// geometry term; a quad of padding stores zeros); G4 compacts each
// 256-entry span's real triples in row order (`stage_span`: 16-byte
// loads of mask and slot, a warp prefix sum, a per-warp stage) and takes
// one lane a triple, its entries of no slot set to 0 as they are found.
// Each entry's geometry is computed once: its geometry term goes to its
// own place, and its share of gbar_bar[s, t] to per-slot registers (up
// to 4 slots a pass over the row, a template bound; more slots take the
// row again), summed over the warp at the row's end by the forward's
// reduce-scatter of xor shuffles. No atomic: each output is written
// once, in an order that does not change, so a second launch gives the
// same bits. The row's gbar (S * T values) is copied once into the
// warp's stage in shared memory.
//   * G2, per entry: the cutoff, its slope and curvature (one sincospi
//     for the cosine cutoff) and per grid row one exp2 (-eta log2(e) /
//     rc^2 and 2 eta / rc^2 folded on the host in double), then g_t' and
//     g_t'' by a few FMAs.
//   * G4, per triple: the gradients and Hessians of cos(theta), z and
//     F = fc(a) fc(b) fc(c) in (a, b, c) once (one reciprocal of a b),
//     the three dot products with v, then per grid row P_t, P_t', P_t''
//     (integer zeta by multiplies) and E_t (one exp2), gbar_bar's three
//     FMAs and six sums; the sums meet the geometry once a triple by the
//     product rule.
// Full-precision exp2/pow/sincospi (common.cuh): float64 parity with the
// closed form depends on them.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "common.cuh"
#include "sf_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParams = kMaxGridRows;

template <typename T>
struct G4BwdGrid {
  T beta[kMaxParams];
  T gamma[kMaxParams];
  T zeta[kMaxParams];
  T scale[kMaxParams];    // 2^(1 - zeta)
  T szg[kMaxParams];      // 2^(1 - zeta) zeta gamma
  T szzg[kMaxParams];     // 2^(1 - zeta) zeta (zeta - 1) gamma^2
  int izeta[kMaxParams];  // zeta where it is an integer in 1..16, else 0
};

// gbar_bar[row, s, t] = sum_j [slot_j = s] mask_j^2 g_t'(r_j) v_j,
// r_bar[row, j] = mask_j^2 v_j sum_t gbar[row, s_j, t] g_t''(r_j), with
// g_t = e_t fc, k_t = 2 eta_t (r - omega_t) / rc^2,
//   g_t' = e_t (fc' - fc k_t),
//   g_t'' = e_t (fc'' - 2 fc' k_t + fc (k_t^2 - 2 eta_t / rc^2)).
// P bounds the grid rows, SB the slots a pass.
template <typename T, int P, int SB>
__global__ void __launch_bounds__(kThreads)
g2_vjp_bwd_kernel(const T* __restrict__ v, const T* __restrict__ gbar,
                  const T* __restrict__ rij, const T* __restrict__ slot,
                  const T* __restrict__ mask, T* __restrict__ gbar_bar,
                  T* __restrict__ r_bar, int rows, int n, int n_slots,
                  int n_params, G2VjpGrid<T> grid, Cutoff<T> cut, bool vec) {
  extern __shared__ __align__(16) unsigned char gbar_stages[];
  const int warp = threadIdx.x >> 5;
  const int width = n_slots * n_params;
  const bool geometry = r_bar != nullptr;
  T* gs = reinterpret_cast<T*>(gbar_stages) + warp * width;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;   // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * n;
  if (geometry) {
    warp_copy(gs, gbar + static_cast<size_t>(row) * width, width);
    __syncwarp();
  }
  for (int s0 = 0; s0 < n_slots; s0 += SB) {
    const int ns = min(SB, n_slots - s0);
    T acc[SB][P];
#pragma unroll
    for (int ss = 0; ss < SB; ++ss) {
#pragma unroll
      for (int t = 0; t < P; ++t) acc[ss][t] = T(0);
    }
    walk_quads(mask + base, slot + base, rij + base, v + base, n, n_slots,
               vec, [&](int j, const T (&mk)[4], const int (&sv)[4],
                        bool any, const T (&r)[4], const T (&vq)[4]) {
      // this pass's entries; the others are written in their own pass,
      // the entries of no slot in the first
      bool in[4], mine = false, whole = true;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        in[i] = sv[i] >= s0 && sv[i] < s0 + ns;
        mine |= in[i];
        whole &= in[i] || (sv[i] < 0 && s0 == 0);
      }
      T rb[4] = {T(0), T(0), T(0), T(0)};
      if (!mine) {
        if (!geometry || s0 != 0) return;
        if (!any) {
          store_quad(r_bar + base, j, n, vec, rb);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (j + i < n && sv[i] < 0) r_bar[base + j + i] = T(0);
          }
        }
        return;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!in[i]) continue;
        const T w = mk[i] * mk[i] * vq[i];
        T fc, dfc, d2fc = T(0);
        if (geometry) {
          cutoff_value_slope_curvature(cut, r[i], fc, dfc, d2fc);
        } else {
          cutoff_value_and_slope(cut, r[i], fc, dfc);
        }
        const T* g = gs + sv[i] * n_params;
#pragma unroll
        for (int t = 0; t < P; ++t) {
          if (t >= n_params) continue;
          const T d = r[i] - grid.omega[t];
          const T e = d_exp2(grid.scale[t] * (d * d));
          const T k = grid.slope[t] * d;
          add_to_slot<T, P, SB>(acc, t, sv[i] - s0,
                                w * e * (dfc - fc * k));
          if (geometry) {
            const T d2g = e * (d2fc - T(2) * dfc * k +
                               fc * (k * k - grid.slope[t]));
            rb[i] = fma(g[t], d2g, rb[i]);
          }
        }
        rb[i] *= w;
      }
      if (!geometry) return;
      if (whole) {
        store_quad(r_bar + base, j, n, vec, rb);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j + i < n && (in[i] || (sv[i] < 0 && s0 == 0))) {
            r_bar[base + j + i] = rb[i];
          }
        }
      }
    });
    reduce_store<T, P, SB>(acc, ns, n_params,
                           gbar_bar + static_cast<size_t>(row) * width +
                               s0 * n_params);
  }
}

// x^k by multiplies, k >= 0.
template <typename T>
__device__ __forceinline__ T int_pow(T x, int k) {
  T r = T(1);
  for (int i = 0; i < k; ++i) r *= x;
  return r;
}

// Resident blocks an SM the compiler plans registers for: the served
// float grid of 4 rows fits 7 blocks (72 registers), where the cutoffs'
// curvature at their knots would otherwise leave it 80 and 6 blocks.
template <typename T, int P>
constexpr int kG4BwdBlocks = sizeof(T) == 4 && P <= 4 ? 7 : 1;

// Per triple of distances x = (a, b, c), T_t = P_t(cos) E_t(z) F (ops/
// fused.py `g4_vjp_bwd_reference`):
//   gbar_bar[row, s, t] = sum_triples [slot = s] mask^2 E_t
//       (P_t' F gc.v + P_t (gF.v - beta_t F gz.v)),
//   x_bar = S2 F gc (gc.v) + S1 (F Hc v + gc (gF.v) + gF (gc.v))
//           - B1 F (gc (gz.v) + gz (gc.v)) + B2 F gz (gz.v)
//           - B0 (F Hz v + gz (gF.v) + gF (gz.v)) + S0 HF v,
// gc, gz, gF the gradients of cos, z, F and Hc, Hz, HF their Hessians;
// with w_t = gbar[row, s, t] mask^2: S_k = sum_t w_t P_t^(k) E_t, B0 =
// sum_t w_t beta_t P_t E_t, B1 = sum_t w_t beta_t P_t' E_t, B2 =
// sum_t w_t beta_t^2 P_t E_t. P bounds the grid rows, SB the slots a
// pass. `exp2_scale` is -log2(e) / rc^2.
template <typename T, int P, int SB>
__global__ void __launch_bounds__(kThreads, (kG4BwdBlocks<T, P>))
g4_vjp_bwd_kernel(const T* __restrict__ va, const T* __restrict__ vb,
                  const T* __restrict__ vc, const T* __restrict__ gbar,
                  const T* __restrict__ rij, const T* __restrict__ rik,
                  const T* __restrict__ rjk, const T* __restrict__ slot,
                  const T* __restrict__ mask, T* __restrict__ gbar_bar,
                  T* __restrict__ out_a, T* __restrict__ out_b,
                  T* __restrict__ out_c, int rows, int n, int n_slots,
                  int n_params, G4BwdGrid<T> grid, Cutoff<T> cut,
                  T inv_rc2, T exp2_scale, bool vec) {
  __shared__ SpanStage<T> stages[kWarps];
  extern __shared__ __align__(16) unsigned char gbar_stages[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;   // the whole warp leaves together
  SpanStage<T>& st = stages[warp];
  const int width = n_slots * n_params;
  const bool geometry = out_a != nullptr;
  T* gs = reinterpret_cast<T*>(gbar_stages) + warp * width;
  const size_t base = static_cast<size_t>(row) * n;
  T* const outs[3] = {out_a, out_b, out_c};
  if (geometry) warp_copy(gs, gbar + static_cast<size_t>(row) * width, width);
  for (int s0 = 0; s0 < n_slots; s0 += SB) {
    const int ns = min(SB, n_slots - s0);
    T acc[SB][P];
#pragma unroll
    for (int ss = 0; ss < SB; ++ss) {
#pragma unroll
      for (int t = 0; t < P; ++t) acc[ss][t] = T(0);
    }
    for (int j0 = 0; j0 < n; j0 += kSpan) {
      int sv[kLaneEntries];
      const int count = stage_span(mask + base, slot + base, j0, n, n_slots,
                                   s0, ns, vec, st, sv);
      if (geometry && s0 == 0) {
        zero_unslotted<T, 3>(sv, j0, n, vec, outs, base, 0, 0, 1);
      }
      __syncwarp();
      for (int p = lane; p < count; p += 32) {
        const int j = st.j[p], s = st.s[p];
        const T mk = st.m[p];
        const T a = rij[base + j], b = rik[base + j], c = rjk[base + j];
        const T v0 = va[base + j], v1 = vb[base + j], v2 = vc[base + j];
        const T a2 = a * a, b2 = b * b, c2 = c * c;
        const T s2 = a2 + b2 + c2;
        const T r_ab = T(1) / (a * b);
        const T cos_theta = (a2 + b2 - c2) * T(0.5) * r_ab;
        const T half_r2 = T(0.5) * r_ab * r_ab;
        const T gc0 = (a2 - b2 + c2) * half_r2 * b;
        const T gc1 = (b2 - a2 + c2) * half_r2 * a;
        const T gc2 = -c * r_ab;
        const T two_rc2 = T(2) * inv_rc2;
        const T gz0 = two_rc2 * a, gz1 = two_rc2 * b, gz2 = two_rc2 * c;
        T fa, sa, ka = T(0), fb, sb, kb = T(0), fcc, sc, kc = T(0);
        if (geometry) {
          cutoff_value_slope_curvature(cut, a, fa, sa, ka);
          cutoff_value_slope_curvature(cut, b, fb, sb, kb);
          cutoff_value_slope_curvature(cut, c, fcc, sc, kc);
        } else {
          cutoff_value_and_slope(cut, a, fa, sa);
          cutoff_value_and_slope(cut, b, fb, sb);
          cutoff_value_and_slope(cut, c, fcc, sc);
        }
        const T f = fa * fb * fcc;
        const T gf0 = sa * fb * fcc, gf1 = fa * sb * fcc, gf2 = fa * fb * sc;
        const T gc_v = gc0 * v0 + gc1 * v1 + gc2 * v2;
        const T gz_v = gz0 * v0 + gz1 * v1 + gz2 * v2;
        const T gf_v = gf0 * v0 + gf1 * v1 + gf2 * v2;
        const T mm = mk * mk;
        const T fgc_m = f * gc_v * mm, fgz_m = f * gz_v * mm;
        const T gf_m = gf_v * mm;
        const T ze = s2 * exp2_scale;
        const T* g = gs + s * n_params;
        T sum0 = T(0), sum1 = T(0), sum2 = T(0);
        T bsum0 = T(0), bsum1 = T(0), bsum2 = T(0);
#pragma unroll
        for (int t = 0; t < P; ++t) {
          if (t >= n_params) continue;
          const T arg = T(1) + grid.gamma[t] * cos_theta;
          const T base_t = arg > T(0) ? arg : T(0);
          const int iz = grid.izeta[t];
          T pw, pw1, pw2 = T(0);
          if (iz > 0) {   // base^(iz - 2), then a multiply each
            if (iz >= 2) {
              pw2 = int_pow(base_t, iz - 2);
              pw1 = pw2 * base_t;
            } else {
              pw1 = T(1);
            }
            pw = pw1 * base_t;
          } else {
            pw = d_pow(base_t, grid.zeta[t]);
            pw1 = d_pow(base_t, grid.zeta[t] - T(1));
            if (geometry) pw2 = d_pow(base_t, grid.zeta[t] - T(2));
          }
          const T e = d_exp2(grid.beta[t] * ze);
          const T pe = grid.scale[t] * pw * e;
          const T p1e = arg > T(0) ? grid.szg[t] * pw1 * e : T(0);
          add_to_slot<T, P, SB>(acc, t, s - s0,
                                p1e * fgc_m + pe * (gf_m - grid.beta[t] *
                                                               fgz_m));
          if (geometry) {
            const T wt = g[t] * mm;
            const T p2e = arg > T(0) ? grid.szzg[t] * pw2 * e : T(0);
            const T wb = wt * grid.beta[t];
            sum0 = fma(wt, pe, sum0);
            sum1 = fma(wt, p1e, sum1);
            sum2 = fma(wt, p2e, sum2);
            bsum0 = fma(wb, pe, bsum0);
            bsum1 = fma(wb, p1e, bsum1);
            bsum2 = fma(wb * grid.beta[t], pe, bsum2);
          }
        }
        if (!geometry) continue;
        // the Hessians of cos and F in (a, b, c); 1/a = b r_ab
        const T ia = b * r_ab, ib = a * r_ab;
        const T hc00 = (b2 - c2) * ia * ia * r_ab;
        const T hc01 = -s2 * half_r2;
        const T hc02 = c * ia * r_ab;
        const T hc11 = (a2 - c2) * ib * ib * r_ab;
        const T hc12 = c * ib * r_ab;
        const T hc22 = -r_ab;
        const T hf00 = ka * fb * fcc, hf11 = fa * kb * fcc;
        const T hf22 = fa * fb * kc, hf01 = sa * sb * fcc;
        const T hf02 = sa * fb * sc, hf12 = fa * sb * sc;
        const T hcv[3] = {hc00 * v0 + hc01 * v1 + hc02 * v2,
                          hc01 * v0 + hc11 * v1 + hc12 * v2,
                          hc02 * v0 + hc12 * v1 + hc22 * v2};
        const T hfv[3] = {hf00 * v0 + hf01 * v1 + hf02 * v2,
                          hf01 * v0 + hf11 * v1 + hf12 * v2,
                          hf02 * v0 + hf12 * v1 + hf22 * v2};
        const T gc[3] = {gc0, gc1, gc2}, gz[3] = {gz0, gz1, gz2};
        const T gf[3] = {gf0, gf1, gf2}, vv[3] = {v0, v1, v2};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          outs[i][base + j] =
              sum2 * f * gc[i] * gc_v +
              sum1 * (f * hcv[i] + gc[i] * gf_v + gf[i] * gc_v) -
              bsum1 * f * (gc[i] * gz_v + gz[i] * gc_v) +
              bsum2 * f * gz[i] * gz_v -
              bsum0 * (f * two_rc2 * vv[i] + gz[i] * gf_v + gf[i] * gz_v) +
              sum0 * hfv[i];
        }
      }
    }
    reduce_store<T, P, SB>(acc, ns, n_params,
                           gbar_bar + static_cast<size_t>(row) * width +
                               s0 * n_params);
  }
}

bool bad_args(int rows, int n, int n_slots, int n_params, int cutoff_id,
              bool geometry, size_t value_bytes) {
  return rows <= 0 || n <= 0 || n_slots <= 0 || n_params <= 0 ||
         n_params > kMaxParams || cutoff_id < 0 || cutoff_id > 4 ||
         (geometry && static_cast<size_t>(n_slots) * n_params * value_bytes >
                          kGbarStageBytes);
}

[[maybe_unused]] int blocks_for(int rows) {
  return (rows + kWarps - 1) / kWarps;
}

template <typename T>
[[maybe_unused]] int launch_g2_vjp_bwd(const T* v, const T* gbar,
                                       const T* rij, const T* slot,
                                       const T* mask, T* gbar_bar, T* r_bar,
                                       int rows, int n, int n_slots,
                                       int n_params, const double* eta,
                                       const double* omega, double rc,
                                       int cutoff_id, void* stream) {
  const bool geometry = r_bar != nullptr;
  if (bad_args(rows, n, n_slots, n_params, cutoff_id, geometry,
               sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const G2VjpGrid<T> grid = make_g2_vjp_grid<T>(eta, omega, rc, n_params);
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const bool vec = n * sizeof(T) % 16 == 0 && aligned16(slot) &&
                   aligned16(mask) && (!geometry || aligned16(r_bar));
  const size_t shared =
      geometry ? static_cast<size_t>(kWarps) * n_slots * n_params * sizeof(T)
               : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_params(n_params, [&](auto p) {
    constexpr int P = decltype(p)::value;
    // slots a pass: SB * P <= 32 accumulators, as the forward
    constexpr int SB = P <= 8 ? 4 : (P <= 16 ? 2 : 1);
    auto kernel = n_slots == 1 ? g2_vjp_bwd_kernel<T, P, 1>
                               : g2_vjp_bwd_kernel<T, P, SB>;
    kernel<<<blocks_for(rows), kThreads, shared, st>>>(
        v, gbar, rij, slot, mask, gbar_bar, r_bar, rows, n, n_slots,
        n_params, grid, cut, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
[[maybe_unused]] int launch_g4_vjp_bwd(
    const T* va, const T* vb, const T* vc, const T* gbar, const T* rij,
    const T* rik, const T* rjk, const T* slot, const T* mask, T* gbar_bar,
    T* out_a, T* out_b, T* out_c, int rows, int n, int n_slots,
    int n_params, const double* beta, const double* gamma,
    const double* zeta, double rc, int cutoff_id, void* stream) {
  const bool geometry = out_a != nullptr;
  if (bad_args(rows, n, n_slots, n_params, cutoff_id, geometry,
               sizeof(T)) ||
      geometry != (out_b != nullptr) || geometry != (out_c != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  G4BwdGrid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    const double scale = std::pow(2.0, 1.0 - zeta[t]);
    grid.beta[t] = T(beta[t]);
    grid.gamma[t] = T(gamma[t]);
    grid.zeta[t] = T(zeta[t]);
    grid.scale[t] = T(scale);
    grid.szg[t] = T(scale * zeta[t] * gamma[t]);
    grid.szzg[t] = T(scale * zeta[t] * (zeta[t] - 1.0) * gamma[t] *
                     gamma[t]);
    const bool whole = zeta[t] >= 1.0 && zeta[t] <= 16.0 &&
                       zeta[t] == std::floor(zeta[t]);
    grid.izeta[t] = whole ? static_cast<int>(zeta[t]) : 0;
  }
  constexpr double kLog2E = 1.4426950408889634074;
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T inv_rc2 = T(1.0 / (rc * rc));
  const T exp2_scale = T(-kLog2E / (rc * rc));
  const bool vec = n * sizeof(T) % 16 == 0 && aligned16(slot) &&
                   aligned16(mask) &&
                   (!geometry || (aligned16(out_a) && aligned16(out_b) &&
                                  aligned16(out_c)));
  const size_t shared =
      geometry ? static_cast<size_t>(kWarps) * n_slots * n_params * sizeof(T)
               : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_params(n_params, [&](auto p) {
    constexpr int P = decltype(p)::value;
    // slots a pass: SB * P = 16 accumulators up to P = 16, as the forward
    constexpr int SB = P <= 4 ? 4 : (P <= 8 ? 2 : 1);
    auto kernel = n_slots == 1 ? g4_vjp_bwd_kernel<T, P, 1>
                               : g4_vjp_bwd_kernel<T, P, SB>;
    kernel<<<blocks_for(rows), kThreads, shared, st>>>(
        va, vb, vc, gbar, rij, rik, rjk, slot, mask, gbar_bar, out_a, out_b,
        out_c, rows, n, n_slots, n_params, grid, cut, inv_rc2, exp2_scale,
        vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). A null geometry output
// skips the geometry term. A build that defines SF_VJP_BWD_ENTRY as
// 0..3 compiles that one entry point only (four compilers share the
// file); without it, all four.
#ifdef SF_VJP_BWD_ENTRY
#define SF_VJP_BWD_HAS_ENTRY(i) (SF_VJP_BWD_ENTRY == (i))
#else
#define SF_VJP_BWD_HAS_ENTRY(i) 1
#endif

extern "C" {

#if SF_VJP_BWD_HAS_ENTRY(0)
int sf_g2_vjp_bwd_f32(const float* v, const float* gbar, const float* rij,
                      const float* slot, const float* mask, float* gbar_bar,
                      float* r_bar, int rows, int n, int n_slots,
                      int n_params, const double* eta, const double* omega,
                      double rc, int cutoff_id, void* stream) {
  return launch_g2_vjp_bwd<float>(v, gbar, rij, slot, mask, gbar_bar, r_bar,
                                  rows, n, n_slots, n_params, eta, omega, rc,
                                  cutoff_id, stream);
}
#endif

#if SF_VJP_BWD_HAS_ENTRY(1)
int sf_g2_vjp_bwd_f64(const double* v, const double* gbar, const double* rij,
                      const double* slot, const double* mask,
                      double* gbar_bar, double* r_bar, int rows, int n,
                      int n_slots, int n_params, const double* eta,
                      const double* omega, double rc, int cutoff_id,
                      void* stream) {
  return launch_g2_vjp_bwd<double>(v, gbar, rij, slot, mask, gbar_bar,
                                   r_bar, rows, n, n_slots, n_params, eta,
                                   omega, rc, cutoff_id, stream);
}
#endif

#if SF_VJP_BWD_HAS_ENTRY(2)
int sf_g4_vjp_bwd_f32(const float* va, const float* vb, const float* vc,
                      const float* gbar, const float* rij, const float* rik,
                      const float* rjk, const float* slot, const float* mask,
                      float* gbar_bar, float* out_a, float* out_b,
                      float* out_c, int rows, int n, int n_slots,
                      int n_params, const double* beta, const double* gamma,
                      const double* zeta, double rc, int cutoff_id,
                      void* stream) {
  return launch_g4_vjp_bwd<float>(va, vb, vc, gbar, rij, rik, rjk, slot, mask,
                                  gbar_bar, out_a, out_b, out_c, rows, n,
                                  n_slots, n_params, beta, gamma, zeta, rc,
                                  cutoff_id, stream);
}
#endif

#if SF_VJP_BWD_HAS_ENTRY(3)
int sf_g4_vjp_bwd_f64(const double* va, const double* vb, const double* vc,
                      const double* gbar, const double* rij,
                      const double* rik, const double* rjk,
                      const double* slot, const double* mask,
                      double* gbar_bar, double* out_a, double* out_b,
                      double* out_c, int rows, int n, int n_slots,
                      int n_params, const double* beta, const double* gamma,
                      const double* zeta, double rc, int cutoff_id,
                      void* stream) {
  return launch_g4_vjp_bwd<double>(va, vb, vc, gbar, rij, rik, rjk, slot,
                                   mask, gbar_bar, out_a, out_b, out_c, rows,
                                   n, n_slots, n_params, beta, gamma, zeta,
                                   rc, cutoff_id, stream);
}
#endif

}  // extern "C"
