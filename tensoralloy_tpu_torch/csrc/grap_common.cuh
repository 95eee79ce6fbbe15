// What the GRAP kernels (grap_kernel.cu, grap_vjp.cu) share: the
// compressed monomial basis up to moment 5, its host codes and its
// recurrence.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxMonomials = 56;         // max_moment 5

// The monomials in `moment_monomials` order, the code of each as the
// host builds it (ops/fused.py `monomial_codes`: bits 0-2 the degree,
// then 2 bits per sorted axis). The launcher holds the host's codes to
// this table, so the kernel's fixed recurrence below is the host's
// basis.
constexpr unsigned short kCodes[kMaxMonomials] = {
    0,    1,    9,    17,   2,    34,   66,   42,   74,   82,   3,    131,
    259,  163,  291,  323,  171,  299,  331,  339,  4,    516,  1028, 644,
    1156, 1284, 676,  1188, 1316, 1348, 684,  1196, 1324, 1356, 1364, 5,
    2053, 4101, 2565, 4613, 5125, 2693, 4741, 5253, 5381, 2725, 4773, 5285,
    5413, 5445, 2733, 4781, 5293, 5421, 5453, 5461};

// The 56 monomials of (x, y, z) up to degree 5, each the product of its
// prefix monomial and its last axis (the twin's `moment_basis_c`).
template <typename T>
__device__ __forceinline__ void monomials(T x, T y, T z,
                                          T (&m)[kMaxMonomials]) {
  m[0] = T(1); m[1] = x; m[2] = y; m[3] = z; m[4] = m[1] * x;
  m[5] = m[1] * y; m[6] = m[1] * z; m[7] = m[2] * y; m[8] = m[2] * z;
  m[9] = m[3] * z; m[10] = m[4] * x; m[11] = m[4] * y; m[12] = m[4] * z;
  m[13] = m[5] * y; m[14] = m[5] * z; m[15] = m[6] * z; m[16] = m[7] * y;
  m[17] = m[7] * z; m[18] = m[8] * z; m[19] = m[9] * z; m[20] = m[10] * x;
  m[21] = m[10] * y; m[22] = m[10] * z; m[23] = m[11] * y;
  m[24] = m[11] * z; m[25] = m[12] * z; m[26] = m[13] * y;
  m[27] = m[13] * z; m[28] = m[14] * z; m[29] = m[15] * z;
  m[30] = m[16] * y; m[31] = m[16] * z; m[32] = m[17] * z;
  m[33] = m[18] * z; m[34] = m[19] * z; m[35] = m[20] * x;
  m[36] = m[20] * y; m[37] = m[20] * z; m[38] = m[21] * y;
  m[39] = m[21] * z; m[40] = m[22] * z; m[41] = m[23] * y;
  m[42] = m[23] * z; m[43] = m[24] * z; m[44] = m[25] * z;
  m[45] = m[26] * y; m[46] = m[26] * z; m[47] = m[27] * z;
  m[48] = m[28] * z; m[49] = m[29] * z; m[50] = m[30] * y;
  m[51] = m[30] * z; m[52] = m[31] * z; m[53] = m[32] * z;
  m[54] = m[33] * z; m[55] = m[34] * z;
}

}  // namespace
