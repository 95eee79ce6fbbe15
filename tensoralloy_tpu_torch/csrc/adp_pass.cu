// The analytic ADP pass of a one-element model for NVIDIA Hopper
// (sm_90a), as two kernels over the dense neighbour rows, with a plain C
// interface for ctypes.
//
// Replaces no Pallas kernel: the JAX package leaves its analytic EAM
// pass (tensoralloy_tpu/nn/eam/fast_efs.py) to XLA. The port's plain
// route (`_make_pass` in tensoralloy_tpu_torch/nn/eam/fast_efs.py, its
// twin here) builds the ADP moments and the per-pair adjoints with
// einsums that PyTorch lowers to matrix-vector products batched over the
// rows, around about a hundred elementwise kernels over [rows, slots]
// and [rows, slots, 3, 3] arrays. These kernels take its pair work, the
// embedding (zjw04xc's blend) F(rho) and its slope, and the angular
// energy (a closed form of each atom's moments); a model with another
// embedding keeps the plain route (`fused_route`).
//
//   adp_accumulate  per row i: rho_i = sum rho(r), phi_i = 1/2 sum phi(r),
//                   mu_i = sum u(r) v, lam_i = sum w(r) v (x) v, and from
//                   them F(rho_i), the angular energy and their
//                   adjoints -> the adjoint records rec [rows, 12]
//                   (g_rho, am, g_mu[3], g_lam xx yy zz xy xz yz, 0) and
//                   dens [2, rows] (rho_i; F(rho_i) plus phi_i plus the
//                   angular energy)
//   adp_forces      per row k, from the records of k and of each
//                   neighbour j:
//                   forces[k] = sum (w_self + w_rev) v/r + ct_self - ct_rev
//                   and the virial's nine sums of ct_self (x) v, one set
//                   per block -> forces [rows, 3], vpart [blocks, 9]
// rho and phi are Zhou, Johnson & Wadley's elemental forms
// (a e^{-b (x - 1)} / (1 + (x - c)^20), x = r / r_e), u and w Mishin's
// ((p1 e^{-p2 r} + p3) psi((r - rc) / h)), their slopes in closed form.
// The coefficients come as one small device vector (`kCoef` below) so a
// pass reads nothing back to the host.
//
// What binds it on an H100: bytes. A row's 152 slots of neighbour index,
// image code and mask (12 B each) are read once by each kernel, 0.79 GB
// a kernel at 432,000 rows, 0.24 ms at 3.35 TB/s; the positions (5 MB)
// and the adjoint records (21 MB) that the slots gather stay in the
// 50 MB L2. The arithmetic is about 90 FLOP a pair within the cutoff
// (64 of 152 slots in bcc Mo) and 170 a pair within u and w's cutoff
// (14 of 152): under a tenth of the byte time at 67 TFLOP/s, if it is
// not spread over the masked and out-of-range slots. What the design
// does about it:
//   * one warp per row, kWarps rows per block; the warp reads a span of
//     160 slots as 5 coalesced loads a lane: the masks first, then the
//     index and image of the real slots only (a padding sector is never
//     fetched), then the neighbours' positions;
//   * each lane decodes its slots' images and forms v and r exactly as
//     ops.dense.shift_dot_cell and safe_norm_components do (no fused
//     multiply-adds there; a slot with no image skips the shift, which
//     is then 0), so the r < rcut test keeps the same slots as the plain
//     route;
//   * warp ballots compact the slots within rcut, and among them those
//     within u and w's cutoff (a sign test, no division), into a
//     per-warp stage in shared memory; the radial functions then run on
//     32 in-range pairs a trip, and the angular terms on 32 near pairs a
//     trip, instead of on every slot;
//   * a row's instructions rival its bytes, so the arithmetic is kept
//     small: the slopes' reciprocal lengths once a block, and rho and
//     phi's second term from one exponential where they share beta,
//     lamda and r_eq (one element's parameters: `share`);
//   * every sum is a lane's sum in slot order, then a fixed xor-shuffle
//     tree, and for the virial a fixed sum over the block's warps: no
//     atomics, so two passes from one state are bitwise equal;
//   * the per-atom records are written once and gathered by the
//     neighbours from L2 (two values for a pair within rcut, twelve for
//     a near pair);
//   * the per-atom work stays in the kernels: on an H100 host PyTorch
//     spends 15-25 us an op, and the embedding's autograd adjoint alone
//     (about 70 ops) took 2 ms of host time a pass against the kernels'
//     1.5 ms of device time, so MD's steps waited on the host; with the
//     blend in adp_accumulate a pass is four launches and two sums.
// float64 runs the same template (for the tests). Full-precision exp and
// division (common.cuh).

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                 // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kIters = 5;                 // slots a lane reads a span
constexpr int kSpan = 32 * kIters;        // slots staged per span
constexpr int kSimgBase = 31;             // transform/featurizer.py
constexpr int kSimgOff = 15;
constexpr int kSimgZero = kSimgOff * (1 + kSimgBase + kSimgBase * kSimgBase);
constexpr int kRec = 12;                  // adp_forces' adjoint record

// The coefficient vector (fast_efs.py `_coefficient_leaves`' order).
enum {
  kRhoA, kRhoB, kRhoC, kRhoRe,            // rho: f_eq, beta, lamda, r_eq
  kPhiA1, kPhiB1, kPhiC1, kPhiRe1,        // phi = zhou(A, alpha, kappa)
  kPhiA2, kPhiB2, kPhiC2, kPhiRe2,        //     - zhou(B, beta, lamda)
  kU1, kU2, kU3, kURc, kUH,               // u: d1, d2, d3, rc, h
  kW1, kW2, kW3, kWRc, kWH,               // w: q1, q2, q3, rc, h
  kRhoE, kRhoS, kFn0, kFn1, kFn2, kFn3,   // F: zjw04xc's blend
  kF0, kF1, kF2, kF3, kFe, kEta,
  kCoef
};
// A block's constants in shared memory: the coefficients, the cell, then
// reciprocals of the lengths that scale the slopes.
enum {
  kCell = kCoef,
  kInvRhoRe = kCell + 9, kInvPhiRe1, kInvPhiRe2, kInvUH, kInvWH,
  kConst
};

__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// Zhou's e^{-b (x - 1)} / (1 + (x - c)^20), x = r / re (ops/generic.py
// zhou_exp without its factor a), and its slope when `slope` is given;
// `inv_re` is 1 / re. x is a true quotient: r times a rounded 1 / re
// would evaluate every pair at distances scaled by one common factor, a
// uniform strain of up to an ulp whose virial adds up over the pairs
// (3e-5 of it at 432,000 atoms in float32); the slope's factor inv_re
// only scales the result by that ulp.
template <typename T>
__device__ __forceinline__ T zhou(T r, T re, T b, T c, T inv_re, T* slope) {
  const T x = r / re;
  const T t = x - c;
  const T t2 = t * t;
  const T t4 = t2 * t2;
  const T t8 = t4 * t4;
  const T t16 = t8 * t8;
  const T inv_den = T(1) / (T(1) + t16 * t4);
  const T f = d_exp(-b * (x - T(1))) * inv_den;
  if (slope) *slope = f * (-b - T(20) * (t16 * t2 * t) * inv_den) * inv_re;
  return f;
}

// rho and phi = zhou(A, alpha, kappa) - zhou(B, beta, lamda) at r, and
// their slopes when `drho` is given. Where rho's (beta, lamda, r_eq) are
// phi's second term's (`share`: one element's Zhou parameters), that
// term costs no second exponential.
template <typename T>
__device__ __forceinline__ void rho_phi(T r, const T* c, int share, T& rho,
                                        T& phi, T* drho, T* dphi) {
  T d0 = T(0), d1 = T(0), d2 = T(0);
  const bool slopes = drho != nullptr;
  const T g0 = zhou(r, c[kRhoRe], c[kRhoB], c[kRhoC], c[kInvRhoRe],
                    slopes ? &d0 : nullptr);
  const T g1 = zhou(r, c[kPhiRe1], c[kPhiB1], c[kPhiC1], c[kInvPhiRe1],
                    slopes ? &d1 : nullptr);
  T g2 = g0;
  d2 = d0;
  if (!share) {
    g2 = zhou(r, c[kPhiRe2], c[kPhiB2], c[kPhiC2], c[kInvPhiRe2],
              slopes ? &d2 : nullptr);
  }
  rho = c[kRhoA] * g0;
  phi = c[kPhiA1] * g1 - c[kPhiA2] * g2;
  if (slopes) {
    *drho = c[kRhoA] * d0;
    *dphi = c[kPhiA1] * d1 - c[kPhiA2] * d2;
  }
}

// Mishin's (p1 e^{-p2 r} + p3) psi((r - rc) / h), psi(s) = z^4 / (1 + z^4)
// with z = max(-s, 0) (ops/generic.py mishin_polar), and its slope;
// `inv_h` is 1 / h (s, like zhou's x, a true quotient).
template <typename T>
__device__ __forceinline__ T polar(T r, const T* p, T inv_h, T* slope) {
  const T s = (r - p[3]) / p[4];
  const T z = s < T(0) ? -s : T(0);
  const T z2 = z * z;
  const T z4 = z2 * z2;
  const T inv_q = T(1) / (T(1) + z4);
  const T psi = z4 * inv_q;
  const T e = p[0] * d_exp(-p[1] * r);
  const T g = e + p[2];
  if (slope) {
    *slope = -p[1] * e * psi - T(4) * z2 * z * (inv_q * inv_q) * inv_h * g;
  }
  return g * psi;
}

// zjw04xc's embedding F(rho) (nn/eam/potentials.py Zjw04xc.embed): two
// cubics about rho_n = 0.85 rho_e and rho_e and Fe (1 - eta ln z) z^eta
// with z = rho / rho_s, blended by sigmoid(2 (rho_n - rho)) and
// sigmoid(2 (rho - 1.15 rho_e)); and its slope dF/drho.
template <typename T>
__device__ __forceinline__ T blended_embed(T rho, const T* c, T& slope) {
  const T rho_e = c[kRhoE];
  const T rho_n = T(0.85) * rho_e;
  const T rho_0 = T(1.15) * rho_e;
  const T x1 = rho / rho_n - T(1);
  const T e1 = c[kFn0] + x1 * (c[kFn1] + x1 * (c[kFn2] + x1 * c[kFn3]));
  const T d1 =
      (c[kFn1] + x1 * (T(2) * c[kFn2] + T(3) * x1 * c[kFn3])) / rho_n;
  const T x2 = rho / rho_e - T(1);
  const T e2 = c[kF0] + x2 * (c[kF1] + x2 * (c[kF2] + x2 * c[kF3]));
  const T d2 = (c[kF1] + x2 * (T(2) * c[kF2] + T(3) * x2 * c[kF3])) / rho_e;
  const T z = rho / c[kRhoS] + T(1e-8);
  const T eta = c[kEta];
  const T ln_z = d_log(z);
  const T z_eta = d_pow(z, eta);
  const T e3 = c[kFe] * (T(1) - eta * ln_z) * z_eta;
  // d/dz (1 - eta ln z) z^eta = -eta^2 ln z z^eta / z
  const T d3 = -c[kFe] * eta * eta * ln_z * z_eta / z / c[kRhoS];
  const T s1 = T(1) / (T(1) + d_exp(-T(2) * (rho_n - rho)));
  const T s3 = T(1) / (T(1) + d_exp(-T(2) * (rho - rho_0)));
  const T s2 = T(1) - s1 - s3;
  const T ds1 = -T(2) * s1 * (T(1) - s1);
  const T ds3 = T(2) * s3 * (T(1) - s3);
  slope = ds1 * e1 + s1 * d1 - (ds1 + ds3) * e2 + s2 * d2 + ds3 * e3 +
          s3 * d3;
  return s1 * e1 + s2 * e2 + s3 * e3;
}

// Whether psi((r - rc) / h) can be nonzero: the quotient's sign without
// the division (a quotient that underflows to -0 is let through, and
// its psi is 0).
template <typename T>
__device__ __forceinline__ bool within_polar(T r, T rc, T h) {
  const T d = r - rc;
  return h > T(0) ? d < T(0) : (h < T(0) ? d > T(0) : d / h < T(0));
}

// The block's constants (the enum above) into shared memory.
template <typename T>
__device__ __forceinline__ void load_constants(T* c, const T* coef,
                                               const T* cell) {
  const int t = threadIdx.x;
  if (t < kCoef) c[t] = coef[t];
  if (t < 9) c[kCell + t] = cell[t];
  if (t == 32) {
    c[kInvRhoRe] = T(1) / coef[kRhoRe];
    c[kInvPhiRe1] = T(1) / coef[kPhiRe1];
    c[kInvPhiRe2] = T(1) / coef[kPhiRe2];
    c[kInvUH] = T(1) / coef[kUH];
    c[kInvWH] = T(1) / coef[kWH];
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// A warp's stage: the slots of one span within rcut, compacted, and the
// indices among them of those within u's or w's cutoff.
template <typename T>
struct Stage {
  T x[kSpan], y[kSpan], z[kSpan], r[kSpan];
  int j[kSpan];
  unsigned char near[kSpan];
};

// Read the slots [base, base + kSpan) of `row` and stage those within
// rcut (ops.dense.gather_vec's geometry, rounded op by op as PyTorch's
// elementwise kernels round it). -> the counts within rcut and near.
template <typename T>
__device__ __forceinline__ void stage_span(
    Stage<T>& st, const T* __restrict__ pos, const T* __restrict__ cell,
    const int* __restrict__ jd, const int* __restrict__ simg,
    const T* __restrict__ mask, const T* __restrict__ coef, int row, int n,
    int base, T rcut, const T pk[3], int lane, int& n_in, int& n_near) {
  const size_t off = static_cast<size_t>(row) * n;
  T mk[kIters];
  int jv[kIters], sv[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = base + it * 32 + lane;
    mk[it] = c < n ? mask[off + c] : T(0);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = base + it * 32 + lane;
    const bool real = mk[it] != T(0);
    jv[it] = real ? jd[off + c] : 0;
    sv[it] = real ? simg[off + c] : 0;
  }
  T px[kIters], py[kIters], pz[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const bool real = mk[it] != T(0);
    const T* p = pos + 3 * static_cast<size_t>(jv[it]);
    px[it] = real ? p[0] : T(0);
    py[it] = real ? p[1] : T(0);
    pz[it] = real ? p[2] : T(0);
  }
  const unsigned lower = (1u << lane) - 1u;
  n_in = 0;
  n_near = 0;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    T vx = T(0), vy = T(0), vz = T(0), r = T(1);
    bool in = false, near = false;
    if (mk[it] != T(0)) {
      const int code = sv[it];
      T v[3];
      const T pj[3] = {px[it], py[it], pz[it]};
      if (code == kSimgZero) {   // no image: the shift is 0 (or -0)
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = add_rn(pj[a], -pk[a]);
      } else {
        const T sx = T(code % kSimgBase - kSimgOff);
        const T sy = T((code / kSimgBase) % kSimgBase - kSimgOff);
        const T sz = T(code / (kSimgBase * kSimgBase) - kSimgOff);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T shift = add_rn(add_rn(mul_rn(sx, cell[a]),
                                        mul_rn(sy, cell[3 + a])),
                                 mul_rn(sz, cell[6 + a]));
          v[a] = add_rn(add_rn(pj[a], shift), -pk[a]);
        }
      }
      vx = v[0];
      vy = v[1];
      vz = v[2];
      const T r2 = add_rn(add_rn(add_rn(mul_rn(vx, vx), mul_rn(vy, vy)),
                                 mul_rn(vz, vz)),
                          T(1e-14));
      r = d_sqrt(r2);
      in = r < rcut;
      near = in && (within_polar(r, coef[kURc], coef[kUH]) ||
                    within_polar(r, coef[kWRc], coef[kWH]));
    }
    const unsigned b_in = __ballot_sync(kFull, in);
    const unsigned b_near = __ballot_sync(kFull, near);
    if (in) {
      const int k = n_in + __popc(b_in & lower);
      st.x[k] = vx;
      st.y[k] = vy;
      st.z[k] = vz;
      st.r[k] = r;
      st.j[k] = jv[it];
      if (near) {
        st.near[n_near + __popc(b_near & lower)] =
            static_cast<unsigned char>(k);
      }
    }
    n_in += __popc(b_in);
    n_near += __popc(b_near);
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adp_accumulate_kernel(
    const T* __restrict__ pos, const T* __restrict__ cell,
    const int* __restrict__ jd, const int* __restrict__ simg,
    const T* __restrict__ mask, const T* __restrict__ coef,
    const T* __restrict__ am, T* __restrict__ rec, T* __restrict__ dens,
    int rows, int n, T rcut, int share) {
  __shared__ Stage<T> stages[kWarps];
  __shared__ T c[kConst];
  load_constants(c, coef, cell);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  Stage<T>& st = stages[warp];
  const T pk[3] = {pos[3 * static_cast<size_t>(row)],
                   pos[3 * static_cast<size_t>(row) + 1],
                   pos[3 * static_cast<size_t>(row) + 2]};
  T rho = T(0), phi = T(0);
  T mu[3] = {T(0), T(0), T(0)};
  T lam[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};   // xx yy zz xy xz yz
  for (int base = 0; base < n; base += kSpan) {
    int n_in, n_near;
    stage_span(st, pos, c + kCell, jd, simg, mask, c, row, n, base, rcut, pk,
               lane, n_in, n_near);
    for (int i = lane; i < n_in; i += 32) {
      T rho_p, phi_p;
      rho_phi(st.r[i], c, share, rho_p, phi_p, static_cast<T*>(nullptr),
              static_cast<T*>(nullptr));
      rho += rho_p;
      phi += phi_p;
    }
    for (int i = lane; i < n_near; i += 32) {
      const int k = st.near[i];
      const T r = st.r[k], v[3] = {st.x[k], st.y[k], st.z[k]};
      const T u = polar(r, c + kU1, c[kInvUH], static_cast<T*>(nullptr));
      const T w = polar(r, c + kW1, c[kInvWH], static_cast<T*>(nullptr));
#pragma unroll
      for (int a = 0; a < 3; ++a) mu[a] += u * v[a];
      lam[0] += w * (v[0] * v[0]);
      lam[1] += w * (v[1] * v[1]);
      lam[2] += w * (v[2] * v[2]);
      lam[3] += w * (v[0] * v[1]);
      lam[4] += w * (v[0] * v[2]);
      lam[5] += w * (v[1] * v[2]);
    }
    __syncwarp();
  }
  rho = warp_sum(rho);
  phi = warp_sum(phi);
#pragma unroll
  for (int a = 0; a < 3; ++a) mu[a] = warp_sum(mu[a]);
#pragma unroll
  for (int a = 0; a < 6; ++a) lam[a] = warp_sum(lam[a]);
  if (lane == 0) {
    // F(rho) and its adjoint am F'(rho); the angular energy 1/2 |mu|^2 +
    // 1/2 |lam|^2 - nu^2 / 6 (nu the trace; fast_efs._adp_terms'
    // quad_energy) and its adjoints am mu and am (lam - nu / 3 I); in
    // the record that adp_forces gathers
    const T a = am[row];
    const T nu = lam[0] + lam[1] + lam[2];
    const T e_quad =
        T(0.5) * (mu[0] * mu[0] + mu[1] * mu[1] + mu[2] * mu[2]) +
        T(0.5) * (lam[0] * lam[0] + lam[1] * lam[1] + lam[2] * lam[2]) +
        (lam[3] * lam[3] + lam[4] * lam[4] + lam[5] * lam[5]) -
        nu * nu / T(6);
    const T third = nu / T(3);
    T slope;
    const T e_rest = (T(0.5) * phi + e_quad) + blended_embed(rho, c, slope);
    T* out = rec + static_cast<size_t>(row) * kRec;
    out[0] = a * slope;
    out[1] = a;
#pragma unroll
    for (int k = 0; k < 3; ++k) out[2 + k] = a * mu[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[5 + k] = a * (lam[k] - third);
#pragma unroll
    for (int k = 3; k < 6; ++k) out[5 + k] = a * lam[k];
    out[11] = T(0);
    dens[row] = rho;
    dens[static_cast<size_t>(rows) + row] = e_rest;
  }
}

// L v for a symmetric L given as (xx, yy, zz, xy, xz, yz).
template <typename T>
__device__ __forceinline__ void sym_apply(const T* L, const T v[3], T out[3]) {
  out[0] = L[0] * v[0] + L[3] * v[1] + L[4] * v[2];
  out[1] = L[3] * v[0] + L[1] * v[1] + L[5] * v[2];
  out[2] = L[4] * v[0] + L[5] * v[1] + L[2] * v[2];
}

// ct_mu(m) + sign ct_lam(L) of fast_efs._adp_terms:
//   ct_mu(m)  = u' (m . v) v/r + u m
//   ct_lam(L) = w' (v L v) v/r + 2 w L v
template <typename T>
__device__ __forceinline__ void angular_ct(const T v[3], const T e[3], T u,
                                           T du, T w, T dw, const T* m,
                                           const T* L, T sign, T out[3]) {
  T lv[3];
  sym_apply(L, v, lv);
  const T mv = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  const T vlv = v[0] * lv[0] + v[1] * lv[1] + v[2] * lv[2];
  const T radial = du * mv + sign * (dw * vlv);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[a] = radial * e[a] + u * m[a] + sign * (T(2) * w * lv[a]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adp_forces_kernel(
    const T* __restrict__ pos, const T* __restrict__ cell,
    const int* __restrict__ jd, const int* __restrict__ simg,
    const T* __restrict__ mask, const T* __restrict__ coef,
    const T* __restrict__ rec, T* __restrict__ forces,
    T* __restrict__ vpart, int rows, int n, T rcut, int share) {
  __shared__ Stage<T> stages[kWarps];
  __shared__ T c[kConst];
  __shared__ T wvir[kWarps][9];
  load_constants(c, coef, cell);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  T f[3] = {T(0), T(0), T(0)};
  T vir[9];
#pragma unroll
  for (int a = 0; a < 9; ++a) vir[a] = T(0);
  if (row < rows) {
    Stage<T>& st = stages[warp];
    const T pk[3] = {pos[3 * static_cast<size_t>(row)],
                     pos[3 * static_cast<size_t>(row) + 1],
                     pos[3 * static_cast<size_t>(row) + 2]};
    const T* own = rec + static_cast<size_t>(row) * kRec;
    const T g_rho = own[0], half_am = T(0.5) * own[1];
    for (int base = 0; base < n; base += kSpan) {
      int n_in, n_near;
      stage_span(st, pos, c + kCell, jd, simg, mask, c, row, n, base, rcut,
                 pk, lane, n_in, n_near);
      // w_self = g_rho_k rho' + am_k phi' / 2, w_rev with j's; the force
      // takes both along v/r, ct_self the first
      for (int i = lane; i < n_in; i += 32) {
        const T r = st.r[i], v[3] = {st.x[i], st.y[i], st.z[i]};
        const T* other = rec + static_cast<size_t>(st.j[i]) * kRec;
        T rho_p, phi_p, drho, dphi;
        rho_phi(r, c, share, rho_p, phi_p, &drho, &dphi);
        const T w_self = g_rho * drho + half_am * dphi;
        const T w_rev = other[0] * drho + T(0.5) * other[1] * dphi;
        const T w_tot = w_self + w_rev;
        const T inv_r = T(1) / r;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T e = v[a] * inv_r;
          f[a] += w_tot * e;
          const T cs = w_self * e;
#pragma unroll
          for (int b = 0; b < 3; ++b) vir[3 * a + b] += cs * v[b];
        }
      }
      // the angular cotangents through k's moments (self) and j's (rev)
      for (int i = lane; i < n_near; i += 32) {
        const int k = st.near[i];
        const T r = st.r[k], v[3] = {st.x[k], st.y[k], st.z[k]};
        const T inv_r = T(1) / r;
        const T e[3] = {v[0] * inv_r, v[1] * inv_r, v[2] * inv_r};
        const T* other = rec + static_cast<size_t>(st.j[k]) * kRec;
        T du, dw;
        const T u = polar(r, c + kU1, c[kInvUH], &du);
        const T w = polar(r, c + kW1, c[kInvWH], &dw);
        T cs[3], cr[3];
        angular_ct(v, e, u, du, w, dw, own + 2, own + 5, T(1), cs);
        angular_ct(v, e, u, du, w, dw, other + 2, other + 5, T(-1), cr);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          f[a] += cs[a] - cr[a];
#pragma unroll
          for (int b = 0; b < 3; ++b) vir[3 * a + b] += cs[a] * v[b];
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) f[a] = warp_sum(f[a]);
#pragma unroll
    for (int a = 0; a < 9; ++a) vir[a] = warp_sum(vir[a]);
    if (lane == 0) {
      T* out = forces + 3 * static_cast<size_t>(row);
#pragma unroll
      for (int a = 0; a < 3; ++a) out[a] = f[a];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 9; ++a) wvir[warp][a] = vir[a];
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wvir[w][threadIdx.x];
    vpart[static_cast<size_t>(blockIdx.x) * 9 + threadIdx.x] = s;
  }
}

template <typename T>
int launch_accumulate(const T* pos, const T* cell, const int* jd,
                      const int* simg, const T* mask, const T* coef,
                      const T* am, T* rec, T* dens, int rows, int n,
                      double rcut, int share, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  adp_accumulate_kernel<T><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      pos, cell, jd, simg, mask, coef, am, rec, dens, rows, n, T(rcut),
      share);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_forces(const T* pos, const T* cell, const int* jd,
                  const int* simg, const T* mask, const T* coef, const T* rec,
                  T* forces, T* vpart, int rows, int n, double rcut,
                  int share, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  adp_forces_kernel<T><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pos, cell, jd, simg, mask, coef, rec, forces, vpart, rows, n, T(rcut),
      share);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each function launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). Every pointer is a
// contiguous device array: pos [rows, 3], cell [3, 3], jd, simg (int32)
// and mask [rows, n], coef [34], am [rows], rec [rows, 12], dens [2,
// rows], forces [rows, 3], vpart [ceil(rows / 4), 9]. A slot's mask is 0
// or 1 and its index a row below `rows`. `share` (0 or 1) says that
// coef's rho beta, lamda and r_eq are phi's second term's.
extern "C" {

int adp_accumulate_f32(const float* pos, const float* cell, const int* jd,
                       const int* simg, const float* mask, const float* coef,
                       const float* am, float* rec, float* dens, int rows,
                       int n, double rcut, int share, void* stream) {
  return launch_accumulate<float>(pos, cell, jd, simg, mask, coef, am, rec,
                                  dens, rows, n, rcut, share, stream);
}

int adp_accumulate_f64(const double* pos, const double* cell, const int* jd,
                       const int* simg, const double* mask,
                       const double* coef, const double* am, double* rec,
                       double* dens, int rows, int n, double rcut, int share,
                       void* stream) {
  return launch_accumulate<double>(pos, cell, jd, simg, mask, coef, am, rec,
                                   dens, rows, n, rcut, share, stream);
}

int adp_forces_f32(const float* pos, const float* cell, const int* jd,
                   const int* simg, const float* mask, const float* coef,
                   const float* rec, float* forces, float* vpart, int rows,
                   int n, double rcut, int share, void* stream) {
  return launch_forces<float>(pos, cell, jd, simg, mask, coef, rec, forces,
                              vpart, rows, n, rcut, share, stream);
}

int adp_forces_f64(const double* pos, const double* cell, const int* jd,
                   const int* simg, const double* mask, const double* coef,
                   const double* rec, double* forces, double* vpart,
                   int rows, int n, double rcut, int share, void* stream) {
  return launch_forces<double>(pos, cell, jd, simg, mask, coef, rec, forces,
                               vpart, rows, n, rcut, share, stream);
}

}  // extern "C"
