// K3 and K7: batched Cholesky factorization, one kernel body for both; K5
// and the K7 solve: L L^T x = b.
//
// chol_factor_kernel replaces ops/pallas_kernels/chol.py::_chol_kernel_blocked
// (chol.py:90, launched by _cholesky_tpu_packed and _cholesky_tpu; here K3,
// cholesky_f32) and chol.py::_chol_kernel (chol.py:33, the unblocked TPU
// kernel that no pallas_call of the JAX package passes; here K7,
// cholesky_unblocked_f32). The two compute one function with two pivot
// arithmetics, selected by the template flag RSQRT:
//   K3 (RSQRT = false): L_jj = sqrt(a_jj) and the column below is divided by
//     it, the arithmetic of cholesky_ref (held to jnp.linalg.cholesky);
//   K7 (RSQRT = true): the column from the diagonal down is multiplied by
//     rsqrt(a_jj), so L_jj = a_jj rsqrt(a_jj), the arithmetic of
//     cholesky_unblocked_ref and of both TPU kernels (chol.py:42, :108).
// The TPU kernels put 128 matrices in the lanes and run one pivot loop over
// all of them; here one block of CHOL_THREADS threads owns one matrix.
//
// What bounds it: neither bytes (H's lower triangle in, L out, ~46 KB per
// matrix at n = 76) nor FLOPs (~n^3 / 6 FMAs) but latency: the chain of
// ceil(n / NB) dependent panels, each a chain of NB dependent pivots, with
// block barriers between the steps of a panel. The design keeps that chain
// short and barrier-poor:
//   * the matrix lives in shared memory, padded to npad = NB ceil(n / NB)
//     with an identity tail (as _cholesky_tpu_packed pads it), so no inner
//     loop masks a ragged edge; row-major with ld = npad + 4 (ld = 4 mod 8:
//     8 lanes reading 16 bytes each from 8 consecutive rows hit 32 distinct
//     banks). H's lower triangle arrives by cp.async, 16 bytes per lane,
//     lanes over a row, when n % 4 == 0 and both pointers are 16-byte
//     aligned (4 bytes per lane otherwise), all copies in flight at once;
//   * per panel of NB = 16 columns: (1) warp 0 factors the 16 x 16 diagonal
//     block in registers, one row per lane, shuffles only; (2) every thread
//     solves one sub-diagonal row of the panel against it (the rows are
//     independent); (3) the trailing lower trapezoid takes the rank-16
//     update in 16 x 16 blocks, each lane accumulating a 4 x 2 register tile
//     over the 16 panel columns before it subtracts (chol.py:119-134). Warp
//     0 updates the next diagonal block first and factors it at once (step
//     1 of the next panel), while warps 1.. update the other blocks. Tile
//     coordinates are fixed per lane; no inner loop divides an index;
//   * two block barriers per panel (after steps 2 and 3): 2 ceil(n / 16) in
//     all, 10 at n = 76;
//   * FP32 FMAs only: no tensor cores (the work is latency-bound, and the
//     JAX package records ~2e-2 relative error from reduced-precision
//     products);
//   * a pivot that is not positive gives NaN (sqrt or rsqrt of a negative
//     number, 0 / 0, 0 * inf), which flows into every later column of that
//     matrix and of no other; no loop bound depends on the data.
// Limits: 1 <= n <= CHOL_MAX_N = 128 (the solve's limit), CHOL_THREADS = 256,
// shared memory (npad ld + NB) floats: 26,944 bytes at n = 76, 67,648 at
// n = 128 (above the default 48 KB only for npad >= 112, opted in by a
// cudaFuncSetAttribute per launch there and no host call below).
// ops/kernels/chol.py::chol_plan computes the same
// sizes and refuses n outside the range before any launch.
//
// K5 replaces chol.py::_solve_kernel_blocked (launched by _solve_tpu_packed
// and _solve_tpu), the K7 solve chol.py::_solve_kernel. What bounds them: the
// 2n dependent substitution steps (latency); L's lower triangle (~23 KB at
// n = 76) is read once. Design, one block of SOLVE_THREADS per system:
//   * L's lower triangle and b arrive in shared memory by cp.async, as the
//     factorization stages H (16 bytes per lane where n % 4 == 0 and the
//     pointers are 16-byte aligned, else 4), all copies in flight; padded
//     to npad = NB ceil(n / NB) rows with an identity tail and
//     ld = npad + 4. Entries above the diagonal are never read;
//   * all threads then take the pivots' reciprocals and transpose the
//     diagonal blocks once (trisolve.cuh::solve_prep), and warp 0 runs the
//     blocked substitution of trisolve.cuh (shared with K4): per 16-row
//     block the diagonal block's chain in registers, then the other rows;
//   * the K7 solve multiplies by 1 / L_jj (trisolve.cuh, RECIP), only to
//     keep the TPU kernel's arithmetic: x (1 / d) and x / d differ by one
//     rounding, which no tolerance of the repo can see (2e-5 relative on the
//     card, 1e-12 in float64 on the CPU).
// Limits: 1 <= n <= CHOL_MAX_N; shared memory (solve_layout) 32,640 bytes at
// n = 76, 76,800 at n = 128 (above 48 KB for npad >= 112, opted in there).
// ops/kernels/chol.py::chol_solve_plan computes the same and refuses n
// outside the range before any launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "trisolve.cuh"

constexpr int CHOL_THREADS = 256;
constexpr int CHOL_WARPS = CHOL_THREADS / 32;
constexpr int CHOL_MAX_N = 128;
constexpr int SOLVE_THREADS = 128;
constexpr int SOLVE_WARPS = SOLVE_THREADS / 32;

// the factorization's shared-memory layout (chol.py::chol_plan)
__host__ __device__ inline int chol_npad(int n) { return (n + NB - 1) / NB * NB; }
__host__ __device__ inline int chol_ld(int n) { return chol_npad(n) + 4; }
static size_t chol_smem(int n) { return sizeof(float) * ((size_t)chol_npad(n) * chol_ld(n) + NB); }

// the solve's shared-memory layout (chol.py::chol_solve_plan), offsets in
// floats, each a multiple of 4: L (npad x ld), its transposed diagonal
// blocks (npad x NB), 1 / L_jj (npad), x (npad)
struct SolveLayout {
  int npad, ld, odt, oinv, ox, floats;
};

__host__ __device__ inline SolveLayout solve_layout(int n) {
  SolveLayout s;
  s.npad = chol_npad(n);
  s.ld = chol_ld(n);
  s.odt = s.npad * s.ld;
  s.oinv = s.odt + s.npad * NB;
  s.ox = s.oinv + s.npad;
  s.floats = s.ox + s.npad;
  return s;
}

// Step 1: warp 0 factors the diagonal block at (k0, k0) in place and leaves
// each pivot's divisor (K3: L_jj) or multiplier (K7: rsqrt(a_jj)) in piv.
// Lane l holds row k0 + (l & 15); lanes 16-31 repeat rows 0-15 so that every
// shuffle is full-warp, and only lanes 0-15 write back. A lane reads only the
// lower triangle of its row: entries right of the diagonal are never used.
template <bool RSQRT>
__device__ __forceinline__ void factor_diag(float* a, int ld, int k0, float* piv, int lane) {
  const int row = lane & (NB - 1);
  float* src = a + (k0 + row) * ld + k0;
  float r[NB];
  load16(src, r);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float d = __shfl_sync(FULL_MASK, r[j], j);
    if (RSQRT) {
      const float s = rsqrtf(d);
      if (row >= j) r[j] *= s;
      if (lane == j) piv[j] = s;
    } else {
      const float s = sqrtf(d);
      const float q = div_rn(r[j], s, 1.0f / s);
      if (row > j) r[j] = q;
      if (row == j) r[j] = s;
      if (lane == j) piv[j] = s;
    }
#pragma unroll
    for (int k = j + 1; k < NB; ++k) {
      const float lkj = __shfl_sync(FULL_MASK, r[j], k);
      if (row >= k) r[k] -= r[j] * lkj;
    }
  }
  if (lane < NB) store16(src, r);
}

// Step 2: the panel's rows below the diagonal block, one row per thread:
// x L_dd^T = a, column by column in the order of the unblocked elimination.
// K3's reciprocals of the pivots come first, off the chain of each row.
template <bool RSQRT>
__device__ __forceinline__ void solve_panel_rows(float* a, int ld, int k0, int npad,
                                                 const float* piv, int tid) {
  float inv[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) inv[k] = RSQRT ? piv[k] : 1.0f / piv[k];
  for (int i = k0 + NB + tid; i < npad; i += CHOL_THREADS) {
    float* ri = a + i * ld + k0;
    float x[NB];
    load16(ri, x);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float4* lk = reinterpret_cast<const float4*>(a + (k0 + k) * ld + k0);
      float s = x[k];
#pragma unroll
      for (int q = 0; 4 * q < k; ++q) {
        const float4 l = lk[q];
        const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < k) s -= x[4 * q + e] * lq[e];
      }
      x[k] = RSQRT ? s * inv[k] : div_rn(s, piv[k], inv[k]);
    }
    store16(ri, x);
  }
}

// Step 3, one 16 x 16 block at (r0, c0) of the trailing matrix, by one warp:
// a[r][c] -= sum_t L[r][k0 + t] L[c][k0 + t]. Lane l owns rows
// r0 + 4 (l >> 3) + 0..3 and columns c0 + (l & 7), c0 + (l & 7) + 8.
__device__ __forceinline__ void update_block(float* a, int ld, int k0, int r0, int c0, int lane) {
  const int rr = r0 + 4 * (lane >> 3), cc = c0 + (lane & 7);
  float acc[4][2] = {};
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    float4 li[4], lc[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      li[i] = *reinterpret_cast<const float4*>(a + (rr + i) * ld + k0 + 4 * q);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      lc[c] = *reinterpret_cast<const float4*>(a + (cc + 8 * c) * ld + k0 + 4 * q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        acc[i][c] += li[i].x * lc[c].x + li[i].y * lc[c].y + li[i].z * lc[c].z + li[i].w * lc[c].w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) a[(rr + i) * ld + cc + 8 * c] -= acc[i][c];
}

// vec: n % 4 == 0 and H, L 16-byte aligned (16-byte copies and stores)
template <bool RSQRT>
__global__ void __launch_bounds__(CHOL_THREADS)
    chol_factor_kernel(const float* __restrict__ H, float* __restrict__ L, int n, int vec) {
  extern __shared__ __align__(16) float a[];
  const int npad = chol_npad(n), ld = chol_ld(n);
  float* piv = a + npad * ld;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Hb = H + (size_t)blockIdx.x * n * n;
  float* Lb = L + (size_t)blockIdx.x * n * n;

  // H's lower triangle, each row up to the chunk that holds its diagonal
  // (n <= 128: one chunk per lane per row), and the identity tail
  if (vec) {
    for (int i = warp; i < n; i += CHOL_WARPS)
      if (4 * lane <= i) cp_async16(a + i * ld + 4 * lane, Hb + (size_t)i * n + 4 * lane);
  } else {
    for (int i = warp; i < n; i += CHOL_WARPS)
      for (int c = lane; c <= i; c += 32) cp_async4(a + i * ld + c, Hb + (size_t)i * n + c);
  }
  for (int i = n + warp; i < npad; i += CHOL_WARPS)
    for (int c = lane; c <= i; c += 32) a[i * ld + c] = (c == i) ? 1.0f : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  if (warp == 0) factor_diag<RSQRT>(a, ld, 0, piv, lane);
  __syncthreads();
  for (int k0 = 0; k0 + NB < npad; k0 += NB) {
    const int k1 = k0 + NB;
    solve_panel_rows<RSQRT>(a, ld, k0, npad, piv, tid);
    __syncthreads();
    if (warp == 0) {
      update_block(a, ld, k0, k1, k1, lane);
      __syncwarp();
      factor_diag<RSQRT>(a, ld, k1, piv, lane);
    } else {
      // the other blocks of the trailing lower triangle, dealt to warps
      // 1 .. CHOL_WARPS - 1 in turn
      int turn = 1;
      for (int c0 = k1; c0 < npad; c0 += NB)
        for (int r0 = (c0 == k1) ? c0 + NB : c0; r0 < npad; r0 += NB) {
          if (turn == warp) update_block(a, ld, k0, r0, c0, lane);
          turn = (turn == CHOL_WARPS - 1) ? 1 : turn + 1;
        }
    }
    __syncthreads();
  }

  // L: the lower triangle, zeros above it
  if (vec) {
    for (int i = warp; i < n; i += CHOL_WARPS) {
      const int c = 4 * lane;
      if (c < n) {
        const float4 v = *reinterpret_cast<const float4*>(a + i * ld + c);
        *reinterpret_cast<float4*>(Lb + (size_t)i * n + c) =
            make_float4(c <= i ? v.x : 0.0f, c + 1 <= i ? v.y : 0.0f, c + 2 <= i ? v.z : 0.0f,
                        c + 3 <= i ? v.w : 0.0f);
      }
    }
  } else {
    for (int i = warp; i < n; i += CHOL_WARPS)
      for (int c = lane; c < n; c += 32) Lb[(size_t)i * n + c] = (c <= i) ? a[i * ld + c] : 0.0f;
  }
}

// vec: n % 4 == 0 and L 16-byte aligned (16-byte copies)
template <bool RECIP>
__global__ void __launch_bounds__(SOLVE_THREADS)
    chol_solve_kernel(const float* __restrict__ L, const float* __restrict__ b,
                      float* __restrict__ x, int n, int vec) {
  extern __shared__ __align__(16) float sm[];
  const SolveLayout s = solve_layout(n);
  const int npad = s.npad, ld = s.ld;
  float* sL = sm;
  float* sdt = sm + s.odt;
  float* sinv = sm + s.oinv;
  float* sx = sm + s.ox;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Lb = L + (size_t)blockIdx.x * n * n;

  // L's lower triangle, each row up to the chunk that holds its diagonal
  // (n <= 128: one chunk per lane per row), b, the identity tail
  if (vec) {
    for (int i = warp; i < n; i += SOLVE_WARPS)
      if (4 * lane <= i) cp_async16(sL + i * ld + 4 * lane, Lb + (size_t)i * n + 4 * lane);
  } else {
    for (int i = warp; i < n; i += SOLVE_WARPS)
      for (int c = lane; c <= i; c += 32) cp_async4(sL + i * ld + c, Lb + (size_t)i * n + c);
  }
  stage_async(sx, b + (size_t)blockIdx.x * n, n, tid, SOLVE_THREADS);
  for (int i = n + warp; i < npad; i += SOLVE_WARPS)
    for (int c = lane; c <= i; c += 32) sL[i * ld + c] = (c == i) ? 1.0f : 0.0f;
  for (int i = n + tid; i < npad; i += SOLVE_THREADS) sx[i] = 0.0f;
  cp_async_wait_all();
  __syncthreads();
  solve_prep<SOLVE_THREADS>(sL, ld, npad, sdt, sinv, tid);
  __syncthreads();
  if (warp != 0) return;
  warp_solve_blocked<RECIP>(sL, ld, npad, sdt, sinv, sx, lane);
  for (int i = lane; i < n; i += 32) x[(size_t)blockIdx.x * n + i] = sx[i];
}

template <bool RSQRT>
static int launch_factor(const float* H, float* L, int batch, int n, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > CHOL_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t smem = chol_smem(n);
  cudaError_t err = reserve_smem((const void*)chol_factor_kernel<RSQRT>, smem);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(H) | reinterpret_cast<uintptr_t>(L);
  const int vec = (n % 4 == 0) && (ptrs % 16 == 0);
  chol_factor_kernel<RSQRT>
      <<<batch, CHOL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(H, L, n, vec);
  return (int)cudaGetLastError();
}

extern "C" int cholesky_f32(const float* H, float* L, int batch, int n, void* stream) {
  return launch_factor<false>(H, L, batch, n, stream);
}

extern "C" int cholesky_unblocked_f32(const float* H, float* L, int batch, int n, void* stream) {
  return launch_factor<true>(H, L, batch, n, stream);
}

// the factorization's shared memory in bytes at n, or -1 outside 1..CHOL_MAX_N
extern "C" int cholesky_smem_bytes(int n) {
  return (n >= 1 && n <= CHOL_MAX_N) ? (int)chol_smem(n) : -1;
}

template <bool RECIP>
static int launch_solve(const float* L, const float* b, float* x, int batch, int n,
                        void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > CHOL_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)solve_layout(n).floats;
  cudaError_t err = reserve_smem((const void*)chol_solve_kernel<RECIP>, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(L) % 16 == 0);
  chol_solve_kernel<RECIP>
      <<<batch, SOLVE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(L, b, x, n, vec);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve_f32(const float* L, const float* b, float* x, int batch, int n,
                              void* stream) {
  return launch_solve<false>(L, b, x, batch, n, stream);
}

extern "C" int chol_solve_unblocked_f32(const float* L, const float* b, float* x, int batch,
                                        int n, void* stream) {
  return launch_solve<true>(L, b, x, batch, n, stream);
}

// The solve's launch shape at n, as ops/kernels/chol.py::chol_solve_plan
// gives it: plan = {npad, ld, threads, shared bytes}; returns 0, or -1 (plan
// untouched) outside 1..CHOL_MAX_N.
extern "C" int chol_solve_plan(int n, int* plan) {
  if (n < 1 || n > CHOL_MAX_N) return -1;
  const SolveLayout s = solve_layout(n);
  const int vals[4] = {s.npad, s.ld, SOLVE_THREADS, (int)(sizeof(float) * s.floats)};
  for (int i = 0; i < 4; ++i) plan[i] = vals[i];
  return 0;
}
