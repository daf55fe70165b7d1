// Forward and backward substitution L L^T x = b for one system, by one warp,
// in blocks of NB = 16 rows.
//
// Shared by the triangular-solve kernel (chol.cu: K5 and the K7 solve) and
// the fused Mehrotra iteration (ipm_iter.cu, K4): both replace the blocked
// substitution of the Pallas kernels (chol.py::_solve_kernel_blocked,
// inlined in ipm_iter.py::_make_kernel; the K7 solve chol.py::_solve_kernel).
// The TPU kernels run 128 systems side by side in the lanes; on the GPU one
// warp owns one system. The substitution is a chain of 2n dependent steps,
// so it is bound by latency, not by bytes or FLOPs. Per block of 16 rows
// every lane solves the 16 x 16 diagonal block redundantly in registers (no
// shuffle and no barrier on the chain; the block's columns are broadcast
// float4 reads issued a step ahead, from a transposed copy made once per
// launch), then the lanes update the rows outside the block, one row per
// lane, from 16 products. The pivots' reciprocals are taken once per launch;
// each quotient is a / b within an ulp (div_rn), with no IEEE division and
// its slow-path branch on the chain. FP32 FMAs only, no tensor cores.
//
// RECIP selects the unblocked TPU kernel's arithmetic (the K7 solve): each
// step multiplies by the reciprocal of the pivot, x_j (1 / L_jj), where the
// blocked kernels divide, x_j / L_jj. The two differ by one rounding per
// step, below every tolerance of the repo.
#pragma once

#include "common.cuh"

constexpr int NB = 16;  // rows per substitution block (and K3's panel width)

// 16 consecutive floats of shared memory (16-byte aligned) to registers and back
__device__ __forceinline__ void load16(const float* p, float (&r)[NB]) {
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&r)[NB]) {
#pragma unroll
  for (int q = 0; q < NB / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

// What the substitution reads besides L, made once per launch by all THREADS
// threads of the block (the caller orders it before the substitution with a
// barrier): inv[j] = 1 / L_jj, and each 16 x 16 diagonal block of L
// transposed, lower triangle only (block k's column j at dt + 256 k + 16 j).
template <int THREADS>
__device__ __forceinline__ void solve_prep(const float* __restrict__ L, int ld, int npad,
                                           float* __restrict__ dt, float* __restrict__ inv,
                                           int tid) {
  for (int j = tid; j < npad; j += THREADS) inv[j] = 1.0f / L[j * ld + j];
  for (int idx = tid; idx < npad * NB; idx += THREADS) {
    const int k0 = idx / (NB * NB) * NB, j = idx / NB % NB, i = idx % NB;
    dt[idx] = (i >= j) ? L[(k0 + i) * ld + k0 + j] : 0.0f;
  }
}

template <bool RECIP>
__device__ __forceinline__ float pivot_quotient(float v, float d, float iv) {
  return RECIP ? v * iv : div_rn(v, d, iv);
}

// L L^T x = b by one warp; b in x (shared memory, npad entries) on entry, the
// solution on exit. L row-major with leading dimension ld, npad rows (a
// multiple of 16, an identity tail past n); only its lower triangle is read.
// dt and inv as solve_prep leaves them. Per block of 16 rows every lane runs
// the block's chain in registers (the same values in all lanes), each step's
// column (forward) or row (backward) loaded as four float4s while the step
// before it computes; lane 0 stores the block; then each lane updates the
// rows it owns outside the block.
template <bool RECIP = false>
__device__ __forceinline__ void warp_solve_blocked(const float* __restrict__ L, int ld, int npad,
                                                   const float* __restrict__ dt,
                                                   const float* __restrict__ inv, float* x,
                                                   int lane) {
  // forward: L y = b
  for (int k0 = 0; k0 < npad; k0 += NB) {
    const float* Dk = dt + k0 * NB;
    float v[NB], iv[NB], c[NB];
    load16(x + k0, v);
    load16(inv + k0, iv);
    load16(Dk, c);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float cn[NB];
      if (j + 1 < NB) load16(Dk + (j + 1) * NB, cn);
      v[j] = pivot_quotient<RECIP>(v[j], c[j], iv[j]);
#pragma unroll
      for (int i = j + 1; i < NB; ++i) v[i] = fmaf(-c[i], v[j], v[i]);
      if (j + 1 < NB) {
#pragma unroll
        for (int i = 0; i < NB; ++i) c[i] = cn[i];
      }
    }
    if (lane == 0) store16(x + k0, v);
    for (int i = k0 + NB + lane; i < npad; i += 32) {
      float l[NB];
      load16(L + i * ld + k0, l);
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        a0 = fmaf(l[j], v[j], a0);
        a1 = fmaf(l[j + 1], v[j + 1], a1);
      }
      x[i] -= a0 + a1;
    }
    __syncwarp();
  }
  // backward: L^T x = y
  for (int k0 = npad - NB; k0 >= 0; k0 -= NB) {
    const float* Lk = L + k0 * ld + k0;
    float v[NB], iv[NB], r[NB];
    load16(x + k0, v);
    load16(inv + k0, iv);
    load16(Lk + (NB - 1) * ld, r);
#pragma unroll
    for (int j = NB - 1; j >= 0; --j) {
      float rn[NB];
      if (j > 0) load16(Lk + (j - 1) * ld, rn);
      v[j] = pivot_quotient<RECIP>(v[j], r[j], iv[j]);
#pragma unroll
      for (int i = 0; i < j; ++i) v[i] = fmaf(-r[i], v[j], v[i]);
      if (j > 0) {
#pragma unroll
        for (int i = 0; i < NB; ++i) r[i] = rn[i];
      }
    }
    if (lane == 0) store16(x + k0, v);
    for (int i = lane; i < k0; i += 32) {
      const float* Lc = L + k0 * ld + i;  // column i of the block's rows
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        a0 = fmaf(Lc[j * ld], v[j], a0);
        a1 = fmaf(Lc[(j + 1) * ld], v[j + 1], a1);
      }
      x[i] -= a0 + a1;
    }
    __syncwarp();
  }
}
