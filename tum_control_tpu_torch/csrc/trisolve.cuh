// Forward and backward substitution L L^T x = b for one system, by one warp.
//
// Shared by the triangular-solve kernel (chol.cu, K5) and the fused Mehrotra
// iteration (ipm_iter.cu, K4): both replace the blocked substitution of the
// Pallas kernels (chol.py::_solve_kernel_blocked, inlined in
// ipm_iter.py::_make_kernel). The TPU kernels run 128 systems side by side in
// the lanes; on the GPU one warp owns one system and keeps x in registers,
// lane l holding rows l, l+32, l+64, ... The substitution is a chain of n
// dependent steps, so it is bound by latency, not by bytes or FLOPs: each
// step is one shuffle (broadcast of the finished x_j), one division and at
// most MAXR fused multiply-adds per lane, with no block-wide barrier.
//
// L is row-major with leading dimension `ld`, normally in shared memory with
// ld = n + 1 (odd), so that the column reads of the forward pass
// (lanes on rows i, fixed column j) fall in distinct banks.
//
// RECIP selects the unblocked TPU kernel's arithmetic (chol.py::_solve_kernel,
// K7): each step multiplies by the reciprocal of the pivot, x_j (1 / L_jj),
// where the blocked kernels divide, x_j / L_jj. The two differ by one rounding
// per step, below every tolerance of the repo (see chol.cu).
#pragma once

#include "common.cuh"

template <bool RECIP>
__device__ __forceinline__ float pivot_div(float x, float d) {
  return RECIP ? x * (1.0f / d) : x / d;
}

template <int MAXR, bool RECIP = false>
__device__ __forceinline__ void warp_chol_solve(const float* L, int ld, int n, float (&x)[MAXR]) {
  const int lane = threadIdx.x & 31;
  // forward: L y = b
#pragma unroll
  for (int s = 0; s < MAXR; ++s) {
    for (int o = 0; o < 32; ++o) {
      const int j = s * 32 + o;
      if (j >= n) break;
      const float yj = pivot_div<RECIP>(__shfl_sync(FULL_MASK, x[s], o), L[j * ld + j]);
#pragma unroll
      for (int r = s; r < MAXR; ++r) {
        const int i = r * 32 + lane;
        if (i > j && i < n) x[r] -= L[i * ld + j] * yj;
        else if (i == j) x[r] = yj;
      }
    }
  }
  // backward: L^T x = y
#pragma unroll
  for (int s = MAXR - 1; s >= 0; --s) {
    for (int o = 31; o >= 0; --o) {
      const int j = s * 32 + o;
      if (j >= n) continue;
      const float xj = pivot_div<RECIP>(__shfl_sync(FULL_MASK, x[s], o), L[j * ld + j]);
#pragma unroll
      for (int r = 0; r <= s; ++r) {
        const int i = r * 32 + lane;
        if (i < j) x[r] -= L[j * ld + i] * xj;
        else if (i == j) x[r] = xj;
      }
    }
  }
}
