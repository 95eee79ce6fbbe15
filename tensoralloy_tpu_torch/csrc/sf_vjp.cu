// Vector-Jacobian products of the Behler symmetry-function descriptors
// (G2 radial, G4 angular) for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// The backward of the Pallas TPU kernels `_g2_kernel` and `_g4_kernel`
// of tensoralloy_tpu/ops/fused.py, whose custom VJP is `jax.vjp` of the
// XLA references `_g2_ref_dense` / `_g4_ref_dense`. The Python wrappers
// (`g2_vjp_kernel`, `g4_vjp_kernel`), their closed-form plain versions
// (`g2_vjp_reference`, `g4_vjp_reference`) and the autograd Functions
// that call them are in tensoralloy_tpu_torch/ops/fused.py; the formulas
// are written out in those references' docstrings.
//
// Inputs are the forward's dense [rows, n] rows (distances, the slot as
// a float, a 0/1 mask) and a cotangent gbar [batch, rows, n_slots *
// n_params] (batch > 1: a committee's members, each its own cotangent,
// one launch). Outputs are [batch, rows, n]: G2 d/d rij, G4 d/d rij,
// d/d rik, d/d rjk. Every entry's derivative depends on its own geometry
// and on its slot's row of gbar only, so each is written once to its own
// place: no scatter, no atomic, the same bits at every run. A masked
// entry, or one whose slot is outside [0, n_slots), gets exactly 0 and
// its geometry is not used (G4 does not read it).
//
// What binds them on an H100: the bytes, as in the forwards. A pass
// reads the slot and mask rows and the real entries' three (G2: one)
// distances once, and writes one (G2) or three (G4) output rows per
// batch member; the gbar row of an atom (S * T values) is read from a
// stage in shared memory (G2) or by the warp's lanes from L1 (G4). Per
// entry G2 costs a cutoff and its slope and per grid row one exp2; G4
// three cutoffs and slopes and per grid row an exp2 and a power or two
// (integer zeta by multiplies).
//   * G2 (redesigned with the second-order kernels, whose row walk it
//     shares: `walk_quads` in sf_common.cuh): one warp per atom row, 4
//     rows a block (the forward's persistent warps made no difference
//     here, and the second-order kernel slower; PERF.md). The row's
//     cotangent (S * T values a member) is copied once into the warp's
//     stage in shared memory, for as many members as 8 KB hold (more
//     members take the row again). A lane takes quads of 4 neighbouring entries, 128 entries
//     a warp pass, and issues the 16-byte loads of mask, slot and
//     distance of a quad before any math, as the forward does; its four
//     outputs go out as one 16-byte store a member, a quad of padding as
//     zeros. Each real entry's cutoff and
//     slope and, per grid row, one exp2 (the constants folded on the
//     host in double) are computed once: one member takes each term into
//     its sum as it is made; more members keep the terms in registers
//     and cost an FMA a grid row each, the gbar row read from the stage.
//     No compaction and no load that waits on the mask: on an H100 both
//     cost G2, whose work an entry is small, more than they saved
//     (PERF.md).
//   * G4 (the forward's shape): one warp per atom row, 4 rows a block.
//     A lane reads 8 entries of a 256-entry span as two 16-byte loads of
//     mask and of slot (each warp load 512 contiguous bytes), all issued
//     before any math. A warp prefix sum of each lane's count places the
//     span's real entries (mask > 0, a slot in range: holes and
//     interleaved slots are fine) in row order in a per-warp stage with
//     their index, slot and mask; entries of no slot get 0 as they are
//     found, a quad with none as one 16-byte store a member. Then one
//     lane per real triple gathers its three distances (neighbouring
//     lanes, neighbouring entries), so no lane works on padding, and
//     computes the geometry once for all members: one reciprocal of
//     a b for the cosine and its three slopes, each cosine cutoff's
//     value and slope from one sincospi, and per grid row P_t E_t and
//     P_t' E_t with E_t one exp2 (-beta log2(e) / rc^2 and 2^(1-zeta)
//     zeta gamma folded on the host in double). A member then costs three
//     FMAs a grid row and the three stores, which go to the triple's own
//     entries: neighbouring lanes write neighbouring entries of the row.
// Full-precision exp/exp2/pow/sincospi (common.cuh): float64 parity with
// the closed form depends on them.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>

#include "common.cuh"
#include "sf_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParams = 64;

template <typename T>
struct G4VjpGrid {
  T scale_e[kMaxParams];  // -beta log2(e) / rc^2
  T beta[kMaxParams];
  T gamma[kMaxParams];
  T zeta[kMaxParams];
  T scale[kMaxParams];    // 2^(1 - zeta)
  T szg[kMaxParams];      // 2^(1 - zeta) zeta gamma
  int izeta[kMaxParams];  // zeta where it is an integer in 1..16, else 0
};

// d<gbar, G2>/d rij[b, row, j] = mask^2 sum_t gbar[b, row, s, t]
//   e_t (fc'(r) - fc(r) 2 eta_t (r - omega_t) / rc^2),
//   e_t = exp(-eta_t (r - omega_t)^2 / rc^2), s the entry's slot; the
// members in chunks of `members`. P bounds the grid rows; MULTI (more
// than one member) keeps each entry's g_t' in registers for the members,
// one member takes each term into its sum as it is made.
template <typename T, int P, bool MULTI>
__global__ void __launch_bounds__(kThreads)
g2_vjp_kernel(const T* __restrict__ gbar, const T* __restrict__ rij,
              const T* __restrict__ slot, const T* __restrict__ mask,
              T* __restrict__ out, int batch, int rows, int n, int n_slots,
              int n_params, G2VjpGrid<T> grid, Cutoff<T> cut, int members,
              bool vec) {
  extern __shared__ __align__(16) unsigned char gbar_stages[];
  const int warp = threadIdx.x >> 5;
  const int width = n_slots * n_params;
  T* gs = reinterpret_cast<T*>(gbar_stages) + warp * members * width;
  const size_t plane = static_cast<size_t>(rows) * n;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;   // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * n;
  for (int b0 = 0; b0 < batch; b0 += members) {
    const int b1 = min(batch, b0 + members);
    __syncwarp();   // the last chunk's readers are done with the stage
    for (int b = b0; b < b1; ++b) {
      warp_copy(gs + (b - b0) * width,
                gbar + (static_cast<size_t>(b) * rows + row) * width, width);
    }
    __syncwarp();
    walk_quads(mask + base, slot + base, rij + base,
               static_cast<const T*>(nullptr), n, n_slots, vec,
               [&](int j, const T (&mk)[4], const int (&sv)[4], bool any,
                   const T (&r)[4], const T (&)[4]) {
      T o[4] = {T(0), T(0), T(0), T(0)};
      if (!any) {
        for (int b = b0; b < b1; ++b) {
          store_quad(out + b * plane + base, j, n, vec, o);
        }
        return;
      }
      if (!MULTI) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (sv[i] < 0) continue;
          T fc, dfc;
          cutoff_value_and_slope(cut, r[i], fc, dfc);
          const T* g = gs + sv[i] * n_params;
          T acc = T(0);
#pragma unroll
          for (int t = 0; t < P; ++t) {
            if (t >= n_params) continue;
            const T d = r[i] - grid.omega[t];
            const T e = d_exp2(grid.scale[t] * (d * d));
            acc = fma(g[t], e * (dfc - fc * grid.slope[t] * d), acc);
          }
          o[i] = acc * (mk[i] * mk[i]);
        }
        store_quad(out + b0 * plane + base, j, n, vec, o);
        return;
      }
      // each real entry's geometry once for all members
      T dg[4][P];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T fc = T(0), dfc = T(0);
        if (sv[i] >= 0) cutoff_value_and_slope(cut, r[i], fc, dfc);
        const T mm = mk[i] * mk[i];
#pragma unroll
        for (int t = 0; t < P; ++t) {
          dg[i][t] = T(0);
          if (t >= n_params || sv[i] < 0) continue;
          const T d = r[i] - grid.omega[t];
          const T e = d_exp2(grid.scale[t] * (d * d));
          dg[i][t] = mm * e * (dfc - fc * grid.slope[t] * d);
        }
      }
      for (int b = b0; b < b1; ++b) {
        const T* g = gs + (b - b0) * width;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (sv[i] < 0) continue;
          const T* gr = g + sv[i] * n_params;
          T acc = T(0);
#pragma unroll
          for (int t = 0; t < P; ++t) {
            if (t < n_params) acc = fma(gr[t], dg[i][t], acc);
          }
          o[i] = acc;
        }
        store_quad(out + b * plane + base, j, n, vec, o);
      }
    });
  }
}

// d<gbar, G4>/d(rij, rik, rjk) of each triple (ops/fused.py
// `g4_vjp_reference`): with a, b, c the three distances,
//   d/da = fc3 (C dcos/da + Z 2a / rc^2) + V fc'(a) fc(b) fc(c), ...
// C = sum_t w_t P_t' E_t, Z = -sum_t w_t beta_t P_t E_t, V = sum_t w_t
// P_t E_t, w_t = gbar[b, row, s, t] mask^2. P bounds the grid rows.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
g4_vjp_kernel(const T* __restrict__ gbar, const T* __restrict__ rij,
              const T* __restrict__ rik, const T* __restrict__ rjk,
              const T* __restrict__ slot, const T* __restrict__ mask,
              T* __restrict__ out_a, T* __restrict__ out_b,
              T* __restrict__ out_c, int batch, int rows, int n,
              int n_slots, int n_params, G4VjpGrid<T> grid, Cutoff<T> cut,
              T inv_rc2, bool vec) {
  __shared__ SpanStage<T> stages[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;   // the whole warp leaves together
  SpanStage<T>& st = stages[warp];
  const size_t base = static_cast<size_t>(row) * n;
  const size_t width = static_cast<size_t>(n_slots) * n_params;
  const size_t plane = static_cast<size_t>(rows) * n;
  T* const outs[3] = {out_a, out_b, out_c};
  for (int j0 = 0; j0 < n; j0 += kSpan) {
    int sv[kLaneEntries];
    const int count = stage_span(mask + base, slot + base, j0, n, n_slots,
                                 0, n_slots, vec, st, sv);
    zero_unslotted<T, 3>(sv, j0, n, vec, outs, base, plane, 0, batch);
    __syncwarp();
    // one lane a real triple; its geometry once for all members
    for (int p = lane; p < count; p += 32) {
      const int j = st.j[p], s = st.s[p];
      const T mk = st.m[p];
      const T a = rij[base + j], b_ = rik[base + j], c = rjk[base + j];
      const T a2 = a * a, b2 = b_ * b_, c2 = c * c;
      const T s2 = a2 + b2 + c2;
      const T r_ab = T(1) / (a * b_);
      const T cos_theta = (a2 + b2 - c2) * T(0.5) * r_ab;
      const T half_r2 = T(0.5) * r_ab * r_ab;
      const T dcos_a = (a2 - b2 + c2) * half_r2 * b_;
      const T dcos_b = (b2 - a2 + c2) * half_r2 * a;
      const T dcos_c = -c * r_ab;
      T fa, sa, fb, sb, fcc, sc;
      cutoff_value_and_slope(cut, a, fa, sa);
      cutoff_value_and_slope(cut, b_, fb, sb);
      cutoff_value_and_slope(cut, c, fcc, sc);
      const T fc3 = fa * fb * fcc;
      const T mm = mk * mk;
      // each grid row's P_t E_t and P_t' E_t (the clamp's slope is 0
      // where 1 + gamma cos <= 0)
      T pe[P], dpe[P];
#pragma unroll
      for (int t = 0; t < P; ++t) {
        pe[t] = T(0);
        dpe[t] = T(0);
        if (t >= n_params) continue;
        const T arg = T(1) + grid.gamma[t] * cos_theta;
        const T base_t = arg > T(0) ? arg : T(0);
        const int iz = grid.izeta[t];
        T pw, pw1;
        if (iz > 0) {   // base^(iz - 1) by multiplies, then one more
          pw1 = T(1);
          for (int i = 1; i < iz; ++i) pw1 *= base_t;
          pw = pw1 * base_t;
        } else {
          pw = d_pow(base_t, grid.zeta[t]);
          pw1 = d_pow(base_t, grid.zeta[t] - T(1));
        }
        const T e = d_exp2(grid.scale_e[t] * s2);
        pe[t] = grid.scale[t] * pw * e;
        dpe[t] = arg > T(0) ? grid.szg[t] * pw1 * e : T(0);
      }
      for (int bb = 0; bb < batch; ++bb) {
        const T* g = gbar + (static_cast<size_t>(bb) * rows + row) * width +
                     static_cast<size_t>(s) * n_params;
        T coef_c = T(0), coef_z = T(0), coef_v = T(0);
#pragma unroll
        for (int t = 0; t < P; ++t) {
          if (t >= n_params) continue;
          const T gt = g[t];
          coef_v = fma(gt, pe[t], coef_v);
          coef_z = fma(-gt * grid.beta[t], pe[t], coef_z);
          coef_c = fma(gt, dpe[t], coef_c);
        }
        coef_c *= mm;
        coef_z *= mm;
        coef_v *= mm;
        const T z2 = T(2) * coef_z * inv_rc2;
        const size_t o = bb * plane + base + j;
        out_a[o] = fc3 * (coef_c * dcos_a + z2 * a) + coef_v * sa * fb * fcc;
        out_b[o] = fc3 * (coef_c * dcos_b + z2 * b_) + coef_v * fa * sb * fcc;
        out_c[o] = fc3 * (coef_c * dcos_c + z2 * c) + coef_v * fa * fb * sc;
      }
    }
  }
}

bool bad_args(int batch, int rows, int n, int n_slots, int n_params,
              int cutoff_id) {
  return batch <= 0 || rows <= 0 || n <= 0 || n_slots <= 0 ||
         n_params <= 0 || n_params > kMaxParams || cutoff_id < 0 ||
         cutoff_id > 4;
}

[[maybe_unused]] int blocks_for(int rows) {
  return (rows + kWarps - 1) / kWarps;
}

template <typename T>
[[maybe_unused]] int launch_g2_vjp(const T* gbar, const T* rij,
                                   const T* slot, const T* mask, T* out,
                                   int batch, int rows, int n, int n_slots,
                                   int n_params, const double* eta,
                                   const double* omega, double rc,
                                   int cutoff_id, void* stream) {
  if (bad_args(batch, rows, n, n_slots, n_params, cutoff_id)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = n_slots * n_params;
  const int members = std::min(
      batch, kGbarStageBytes / (width * static_cast<int>(sizeof(T))));
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  const G2VjpGrid<T> grid = make_g2_vjp_grid<T>(eta, omega, rc, n_params);
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const bool vec = n * sizeof(T) % 16 == 0 && aligned16(slot) &&
                   aligned16(mask) && aligned16(out);
  const size_t shared = static_cast<size_t>(kWarps) * members * width *
                        sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_params(n_params, [&](auto p) {
    constexpr int P = decltype(p)::value;
    auto kernel = batch == 1 ? g2_vjp_kernel<T, P, false>
                             : g2_vjp_kernel<T, P, true>;
    kernel<<<blocks_for(rows), kThreads, shared, st>>>(
        gbar, rij, slot, mask, out, batch, rows, n, n_slots, n_params, grid,
        cut, members, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
[[maybe_unused]] int launch_g4_vjp(const T* gbar, const T* rij,
                                   const T* rik, const T* rjk,
                                   const T* slot, const T* mask, T* out_a,
                                   T* out_b, T* out_c, int batch, int rows,
                                   int n, int n_slots, int n_params,
                                   const double* beta, const double* gamma,
                                   const double* zeta, double rc,
                                   int cutoff_id, void* stream) {
  if (bad_args(batch, rows, n, n_slots, n_params, cutoff_id)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr double kLog2E = 1.4426950408889634074;
  G4VjpGrid<T> grid;
  for (int t = 0; t < n_params; ++t) {
    const double scale = std::pow(2.0, 1.0 - zeta[t]);
    grid.scale_e[t] = T(-beta[t] * kLog2E / (rc * rc));
    grid.beta[t] = T(beta[t]);
    grid.gamma[t] = T(gamma[t]);
    grid.zeta[t] = T(zeta[t]);
    grid.scale[t] = T(scale);
    grid.szg[t] = T(scale * zeta[t] * gamma[t]);
    const bool whole = zeta[t] >= 1.0 && zeta[t] <= 16.0 &&
                       zeta[t] == std::floor(zeta[t]);
    grid.izeta[t] = whole ? static_cast<int>(zeta[t]) : 0;
  }
  const Cutoff<T> cut = make_cutoff<T>(cutoff_id, rc);
  const T inv_rc2 = T(1.0 / (rc * rc));
  const bool vec = n * sizeof(T) % 16 == 0 && aligned16(rij) &&
                   aligned16(rik) && aligned16(rjk) && aligned16(slot) &&
                   aligned16(mask) && aligned16(out_a) && aligned16(out_b) &&
                   aligned16(out_c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_params(n_params, [&](auto p) {
    constexpr int P = decltype(p)::value;
    g4_vjp_kernel<T, P><<<blocks_for(rows), kThreads, 0, st>>>(
        gbar, rij, rik, rjk, slot, mask, out_a, out_b, out_c, batch, rows,
        n, n_slots, n_params, grid, cut, inv_rc2, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). A build that defines
// SF_VJP_ENTRY as 0..3 compiles that one entry point only (four
// compilers share the file); without it, all four.
#ifdef SF_VJP_ENTRY
#define SF_VJP_HAS_ENTRY(i) (SF_VJP_ENTRY == (i))
#else
#define SF_VJP_HAS_ENTRY(i) 1
#endif

extern "C" {

#if SF_VJP_HAS_ENTRY(0)
int sf_g2_vjp_f32(const float* gbar, const float* rij, const float* slot,
                  const float* mask, float* out, int batch, int rows, int n,
                  int n_slots, int n_params, const double* eta,
                  const double* omega, double rc, int cutoff_id,
                  void* stream) {
  return launch_g2_vjp<float>(gbar, rij, slot, mask, out, batch, rows, n,
                              n_slots, n_params, eta, omega, rc, cutoff_id,
                              stream);
}
#endif

#if SF_VJP_HAS_ENTRY(1)
int sf_g2_vjp_f64(const double* gbar, const double* rij, const double* slot,
                  const double* mask, double* out, int batch, int rows,
                  int n, int n_slots, int n_params, const double* eta,
                  const double* omega, double rc, int cutoff_id,
                  void* stream) {
  return launch_g2_vjp<double>(gbar, rij, slot, mask, out, batch, rows, n,
                               n_slots, n_params, eta, omega, rc, cutoff_id,
                               stream);
}
#endif

#if SF_VJP_HAS_ENTRY(2)
int sf_g4_vjp_f32(const float* gbar, const float* rij, const float* rik,
                  const float* rjk, const float* slot, const float* mask,
                  float* out_a, float* out_b, float* out_c, int batch,
                  int rows, int n, int n_slots, int n_params,
                  const double* beta, const double* gamma,
                  const double* zeta, double rc, int cutoff_id,
                  void* stream) {
  return launch_g4_vjp<float>(gbar, rij, rik, rjk, slot, mask, out_a, out_b,
                              out_c, batch, rows, n, n_slots, n_params,
                              beta, gamma, zeta, rc, cutoff_id, stream);
}
#endif

#if SF_VJP_HAS_ENTRY(3)
int sf_g4_vjp_f64(const double* gbar, const double* rij, const double* rik,
                  const double* rjk, const double* slot, const double* mask,
                  double* out_a, double* out_b, double* out_c, int batch,
                  int rows, int n, int n_slots, int n_params,
                  const double* beta, const double* gamma,
                  const double* zeta, double rc, int cutoff_id,
                  void* stream) {
  return launch_g4_vjp<double>(gbar, rij, rik, rjk, slot, mask, out_a,
                               out_b, out_c, batch, rows, n, n_slots,
                               n_params, beta, gamma, zeta, rc, cutoff_id,
                               stream);
}
#endif

}  // extern "C"
