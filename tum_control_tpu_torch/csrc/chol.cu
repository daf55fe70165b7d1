// K3: batched Cholesky factorization, K5: the solve L L^T x = b, and K7:
// the unblocked versions of both.
//
// K3 replaces ops/pallas_kernels/chol.py::_chol_kernel_blocked (launched by
// _cholesky_tpu_packed and _cholesky_tpu); K5 replaces
// chol.py::_solve_kernel_blocked (launched by _solve_tpu_packed and
// _solve_tpu). The TPU kernels put 128 matrices in the lanes and run one
// pivot loop over all of them; here one block owns one matrix.
//
// K3 -- what bounds it: latency of the n sequential pivots, each followed by
// a trailing update of (n-j)^2/2 entries; bytes (2 n^2 floats per matrix)
// and FLOPs (n^3/3) are both small. Design: the matrix lives in shared
// memory (n x (n+1) floats, 23 KB at n = 76; the odd leading dimension
// keeps column accesses conflict-free), right-looking unblocked elimination
// with two barriers per pivot, the trailing update spread over all threads.
// Only the lower triangle of H is read; the strict upper triangle of L is 0.
//
// K5 -- what bounds it: the 2n dependent substitution steps (latency). Design:
// the block stages L in shared memory with coalesced loads, then one warp
// runs the substitution with x in registers (trisolve.cuh, shared with K4).
//
// K7 replaces chol.py::_chol_kernel and chol.py::_solve_kernel, the
// unblocked TPU kernels that no pallas_call of the JAX package passes. They
// take n as it is (no pad to a multiple of 16) and keep the TPU kernels'
// arithmetic: each pivot multiplies its column by rsqrt(a_jj) (so
// L_jj = a_jj rsqrt(a_jj)), one rank-1 update of the trailing lower
// triangle follows; the solve multiplies by 1 / L_jj (trisolve.cuh, RECIP).
// RECIP is kept only to match the TPU kernel's arithmetic: x (1 / d) and x / d
// differ by one rounding, which no tolerance of the repo can see (2e-5
// relative on the card, 1e-12 in float64 on the CPU), so no test tells the
// K7 solve from K5's kernel.
// Bound, as K3 and K5, by the latency of the n sequential pivots. Design of
// the factorization: one warp per matrix, lanes over rows, the matrix in
// shared memory (ld = n + 1); per pivot the lanes scale their rows of
// column j, then sweep the trailing columns k > j, lane l updating rows
// k + l, k + l + 32, ... of column k. Warp barriers only, no block barrier.
#include <cuda_runtime.h>

#include "common.cuh"
#include "trisolve.cuh"

constexpr int MAXR = 4;  // substitution rows per lane: n <= 128

__global__ void chol_kernel(const float* __restrict__ H, float* __restrict__ L, int n) {
  extern __shared__ float a[];
  const int ld = n + 1;
  const int tid = threadIdx.x, bs = blockDim.x;
  const float* Hb = H + (long)blockIdx.x * n * n;
  float* Lb = L + (long)blockIdx.x * n * n;
  for (int idx = tid; idx < n * n; idx += bs) {
    const int i = idx / n, k = idx - i * n;
    a[i * ld + k] = Hb[idx];
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float d = sqrtf(a[j * ld + j]);
    for (int i = j + 1 + tid; i < n; i += bs) a[i * ld + j] = a[i * ld + j] / d;
    __syncthreads();
    if (tid == 0) a[j * ld + j] = d;
    // trailing update of the lower triangle: a[i][k] -= l_ij l_kj, j < k <= i
    const int m = n - j - 1;
    for (int idx = tid; idx < m * m; idx += bs) {
      const int r = idx / m, c = idx - r * m;
      if (c <= r) {
        const int i = j + 1 + r, k = j + 1 + c;
        a[i * ld + k] -= a[i * ld + j] * a[k * ld + j];
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < n * n; idx += bs) {
    const int i = idx / n, k = idx - i * n;
    Lb[idx] = (k <= i) ? a[i * ld + k] : 0.0f;
  }
}

__global__ void chol_unblocked_kernel(const float* __restrict__ H, float* __restrict__ L, int n) {
  extern __shared__ float a[];
  const int ld = n + 1;
  const int lane = threadIdx.x;   // one warp per block
  const float* Hb = H + (long)blockIdx.x * n * n;
  float* Lb = L + (long)blockIdx.x * n * n;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, k = idx - i * n;
    if (k <= i) a[i * ld + k] = Hb[idx];
  }
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const float inv = rsqrtf(a[j * ld + j]);
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) a[i * ld + j] *= inv;
    __syncwarp();
    for (int k = j + 1; k < n; ++k) {
      const float lk = a[k * ld + j];
      for (int i = k + lane; i < n; i += 32) a[i * ld + k] -= a[i * ld + j] * lk;
    }
    __syncwarp();
  }
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, k = idx - i * n;
    Lb[idx] = (k <= i) ? a[i * ld + k] : 0.0f;
  }
}

template <bool RECIP>
__global__ void chol_solve_kernel(const float* __restrict__ L, const float* __restrict__ b,
                                  float* __restrict__ x, int n) {
  extern __shared__ float sl[];
  const int ld = n + 1;
  const int tid = threadIdx.x;
  const float* Lb = L + (long)blockIdx.x * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, k = idx - i * n;
    sl[i * ld + k] = Lb[idx];
  }
  __syncthreads();
  if (tid >= 32) return;
  float xr[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int i = r * 32 + tid;
    xr[r] = (i < n) ? b[(long)blockIdx.x * n + i] : 0.0f;
  }
  warp_chol_solve<MAXR, RECIP>(sl, ld, n, xr);
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int i = r * 32 + tid;
    if (i < n) x[(long)blockIdx.x * n + i] = xr[r];
  }
}

static cudaError_t set_smem(const void* fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" int cholesky_f32(const float* H, float* L, int batch, int n, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)n * (n + 1);
  cudaError_t err = set_smem((const void*)chol_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  chol_kernel<<<batch, 256, smem, static_cast<cudaStream_t>(stream)>>>(H, L, n);
  return (int)cudaGetLastError();
}

template <bool RECIP>
static int launch_solve(const float* L, const float* b, float* x, int batch, int n,
                        void* stream) {
  if (batch <= 0) return 0;
  if (n > 32 * MAXR) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)n * (n + 1);
  cudaError_t err = set_smem((const void*)chol_solve_kernel<RECIP>, smem);
  if (err != cudaSuccess) return (int)err;
  chol_solve_kernel<RECIP><<<batch, 128, smem, static_cast<cudaStream_t>(stream)>>>(L, b, x, n);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve_f32(const float* L, const float* b, float* x, int batch, int n,
                              void* stream) {
  return launch_solve<false>(L, b, x, batch, n, stream);
}

// K7: the caller ensures n (n + 1) floats fit in shared memory.
extern "C" int cholesky_unblocked_f32(const float* H, float* L, int batch, int n, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)n * (n + 1);
  cudaError_t err = set_smem((const void*)chol_unblocked_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  chol_unblocked_kernel<<<batch, 32, smem, static_cast<cudaStream_t>(stream)>>>(H, L, n);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve_unblocked_f32(const float* L, const float* b, float* x, int batch,
                                        int n, void* stream) {
  return launch_solve<true>(L, b, x, batch, n, stream);
}
