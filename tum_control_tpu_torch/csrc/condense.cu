// K2, K6 and K8: condensing of the stage sensitivities.
//
// K2 replaces ops/pallas_kernels/condense.py::_make_kernel (launched by
// _condense_tpu) of the JAX package. Per scenario:
//   e_0 = d0,  Gam_0 = 0,
//   e_{k+1} = A_k e_k + xi_k,  Gam_{k+1} = A_k Gam_k + B_k E_k,
// where E_k selects the columns k*nu .. (k+1)*nu of Gam. Outputs every stage
// 0..N, including stage 0 and the zero columns past k*nu.
//
// K6 replaces ops/pallas_kernels/condense.py::_make_kernel_from (launched by
// _condense_tpu_from): the same recurrence over a stage sub-range t = 0..N2-1
// from a carry (e0, Gam0), with B_t placed in the columns col0 + t*nu ..
// col0 + (t+1)*nu of a Gam that is nz wide. SNMPC condenses its nominal tail
// beyond the uncertainty horizon with it; Gam0 is the head's carry and is
// nonzero in its first col0 columns, so no column may be assumed zero.
//
// What bounds K2 and K6: bytes. Per scenario they write (N+1) nx nz floats of
// Gam (95 KB at N=38, nx=8, nu=2; K6 at N2=33, nz=76: 83 KB), against
// nx^2 (nz+1) FMAs per stage; the recurrence is sequential in the stage.
// Design: the columns of Gam are independent, Gam_{k+1}[:, z] =
// A_k Gam_k[:, z] (+ B_k's column where z lies in stage k's block), and e is
// one more column of the same recurrence with xi_k added. So one thread owns
// one column and keeps its nx values in registers: no stage needs a barrier
// or a shuffle, and no thread runs a second chain. COND_THREADS = 32
// columns (one warp) per block, ceil((nz + 1) / 32) blocks per scenario (3
// at nz = 76: 384 one-warp blocks, at most one warp per scheduler of the
// 132 SMs); each block stages its scenario's A, B and xi in shared memory
// by cp.async, all copies in flight while the threads load their carry
// (13.4 KB at the nominal shape, read again from L2 by each block of the
// scenario). A_k's rows are broadcast float4 reads, the next stage's issued
// before this stage's products; nx is a template parameter (8, the shipped
// width; a generic body takes 1 <= nx <= 16), so the nx x nx products
// unroll into two accumulators per row and no index is divided. e adds
// xi_k and the column of stage k's block its B (a column takes B once: that
// column of B is read ahead into registers) by selects, not branches. Each
// stage's rows go out as one predicated store per row, the same path in
// every lane, the warp's 32 columns side by side. A stage is ~125
// instructions of one warp's serial issue. Measured slower (PERF.md,
// tools/kernel_breakdown.py): a per-row branch between Gam and e (2x), a
// shared-memory tile written out as float4s, two lanes per column with a
// shuffle exchange (640 warps: two share a scheduler on some SMs), two
// columns per lane sharing A_k's reads. No column is skipped: K6's carry
// may be dense in every column. FROM selects the initial carry (loaded for
// K6, (d0, 0) for K2 and K8), col0 is 0 for K2. cond_layout / condense_launch_plan
// give the launch shape (ops/kernels/condense.py::condense_plan computes
// the same); shared memory above the default 48 KB is opted in only where a
// shape needs it.
//
// K8 replaces ops/pallas_kernels/condense.py::_make_mxu_kernel (launched by
// _condense_tpu_mxu), which no caller of the JAX package reaches: the same
// recurrence on an augmented carry G = [Gam | e] of nx x (nz+1), stage 0 =
// [0 | d0], then per stage G <- A_k G, the columns k nu .. (k+1) nu of G
// *assigned* B_k, and xi_k added to the e column. It writes one
// (N+1, nx, nz+1) tensor per scenario. K8 is K2's kernel with another store
// layout (ldg, lde: the row strides of Gam and e; K8's e is column nz of the
// same rows): assignment and K2's addition agree bit for bit here, since a
// column of Gam holds only +-0 before its own stage (the carry starts at
// zero) and A_k (+-0) + b = b for finite inputs, so K8's outputs equal K2's
// bitwise. Bound by bytes, as K2. The TPU kernel packs 128/nx scenarios
// block-diagonally into one 128x128 MXU product per stage, wasting 15/16 of
// the work; that packing is not carried over, and no tensor-core mode is
// used: the recurrence is bound by bytes, not operations, and TF32
// per-stage products cost ~2e-2 relative error in it.
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int COND_MAX_NX = 16;       // a column's nx values in one thread's registers
constexpr int COND_THREADS = 32;      // columns (threads) per block
constexpr int COND_FAST_NX = 8;       // the nx of the unrolled body
constexpr size_t SMEM_MAX = 232448;   // shared memory a block may have on Hopper

// K2 / K6 / K8 launch shape at (N, nx, nu, nz): blocks per scenario (nz + 1
// columns), and the shared-memory offsets of B and xi after A (floats,
// multiples of 4)
struct CondLayout {
  int blocks, oB, oxi, floats;
};

__host__ __device__ inline CondLayout cond_layout(int N, int nx, int nu, int nz) {
  CondLayout s;
  s.blocks = (nz + COND_THREADS) / COND_THREADS;
  s.oB = (N * nx * nx + 3) / 4 * 4;
  s.oxi = s.oB + (N * nx * nu + 3) / 4 * 4;
  s.floats = s.oxi + (N * nx + 3) / 4 * 4;
  return s;
}

static bool cond_supported(int N, int nx, int nu, int nz) {
  return N >= 1 && nx >= 1 && nx <= COND_MAX_NX && nu >= 1 && nz >= 0 &&
         sizeof(float) * (size_t)cond_layout(N, nx, nu, nz).floats <= SMEM_MAX;
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// gn = A_k g for one column: NX > 0 from A_k's rows as float4s (a, NX^2 / 4
// of them, in registers), NX == 0 (any nx <= COND_MAX_NX) from shared memory
template <int NX>
__device__ __forceinline__ void stage_product(const float4* a, const float* Ak, int nx,
                                              const float* g, float* gn) {
  if constexpr (NX > 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int q = 0; q < NX / 4; ++q) {
        const float4 v = a[i * (NX / 4) + q];
        a0 = fmaf(v.x, g[4 * q], a0);
        a1 = fmaf(v.y, g[4 * q + 1], a1);
        a0 = fmaf(v.z, g[4 * q + 2], a0);
        a1 = fmaf(v.w, g[4 * q + 3], a1);
      }
      gn[i] = a0 + a1;
    }
  } else {
#pragma unroll
    for (int i = 0; i < COND_MAX_NX; ++i) {
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int m = 0; m < COND_MAX_NX; m += 2) {
        if (i < nx && m < nx) a0 = fmaf(Ak[i * nx + m], g[m], a0);
        if (i < nx && m + 1 < nx) a1 = fmaf(Ak[i * nx + m + 1], g[m + 1], a1);
      }
      gn[i] = a0 + a1;
    }
  }
}

// NX: nx as a template parameter (8), or 0 for any nx <= 16
template <int NX, bool FROM>
__global__ void __launch_bounds__(COND_THREADS)
    condense_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ xi, const float* __restrict__ e0,
                    const float* __restrict__ G0, float* __restrict__ e_out,
                    float* __restrict__ gam_out, int N, int nx_, int nu, int nz, int col0,
                    int ldg, int lde) {
  constexpr int R = NX > 0 ? NX : COND_MAX_NX;   // registers per column
  constexpr int NQ = NX > 0 ? NX * NX / 4 : 1;   // float4s of one A_k
  constexpr int NV = NX > 0 ? NX / 4 : 1;        // float4s of one xi_k
  const int nx = NX > 0 ? NX : nx_;
  extern __shared__ __align__(16) float sm[];
  const CondLayout s = cond_layout(N, nx, nu, nz);
  const float* sA = sm;
  const float* sB = sm + s.oB;
  const float* sxi = sm + s.oxi;
  const int b = blockIdx.x / s.blocks, t = threadIdx.x;
  const int z = (blockIdx.x - b * s.blocks) * COND_THREADS + t;

  // the scenario's A, B, xi in flight, while the thread loads its column:
  // Gam's column z < nz, e at z = nz, nothing past it
  stage_async(sm, A + (size_t)b * N * nx * nx, N * nx * nx, t, COND_THREADS);
  stage_async(sm + s.oB, Bm + (size_t)b * N * nx * nu, N * nx * nu, t, COND_THREADS);
  stage_async(sm + s.oxi, xi + (size_t)b * N * nx, N * nx, t, COND_THREADS);
  const bool is_g = z < nz, is_e = z == nz, out = is_g || is_e;
  // the one stage whose B lands in this column (kz, B's column qz), or none
  int kz = -1, qz = 0;
  if (is_g && z >= col0 && z < col0 + N * nu) {
    kz = (z - col0) / nu;
    qz = z - col0 - kz * nu;
  }
  float g[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float v = 0.0f;
    if (i < nx) {
      if (is_e) v = e0[(size_t)b * nx + i];
      else if (FROM && is_g) v = G0[((size_t)b * nx + i) * nz + z];
    }
    g[i] = v;
  }
  // stage k of the column: Gam's column z (rows ldg apart, the warp's 32
  // columns side by side) or e (rows lde apart); one predicated store per
  // row, the same path in every lane
  const int stride = is_e ? lde : ldg;
  float* col = is_e ? e_out + (size_t)b * (N + 1) * nx * lde
                    : gam_out + (size_t)b * (N + 1) * nx * ldg + (is_g ? z : 0);
  auto store = [&](int k) {
    float* p = col + (size_t)k * nx * stride;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < nx && out) p[i * stride] = g[i];
  };
  store(0);
  cp_async_wait_all();
  __syncthreads();
  float bz[R];
#pragma unroll
  for (int i = 0; i < R; ++i) bz[i] = (kz >= 0 && i < nx) ? sB[(kz * nx + i) * nu + qz] : 0.0f;

  // stage k from A_k, xi_k in cur / xc, with A_{k+1}, xi_{k+1} loaded into
  // nxt / xn meanwhile (broadcast reads); the stages alternate the two
  // register sets, so none is copied
  auto step = [&](int k, const float4 (&cur)[NQ], float4 (&nxt)[NQ], const float4 (&xc)[NV],
                  float4 (&xn)[NV]) {
    if constexpr (NX > 0) {
      const int kn = min(k + 1, N - 1);
      const float4* An = reinterpret_cast<const float4*>(sA + kn * NX * NX);
#pragma unroll
      for (int q = 0; q < NQ; ++q) nxt[q] = An[q];
#pragma unroll
      for (int q = 0; q < NV; ++q) xn[q] = reinterpret_cast<const float4*>(sxi + kn * NX)[q];
    }
    float gn[R];
    stage_product<NX>(cur, sA + k * nx * nx, nx, g, gn);
    const bool take = is_e || k == kz;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < nx) {
        float xk;
        if constexpr (NX > 0) xk = lane_of(xc[i / 4], i % 4);
        else xk = sxi[k * nx + i];
        const float add = is_e ? xk : bz[i];
        if (take) gn[i] += add;
      }
      g[i] = gn[i];
    }
    store(k + 1);
  };
  float4 a0[NQ], a1[NQ], x0[NV], x1[NV];
  if constexpr (NX > 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) a0[q] = reinterpret_cast<const float4*>(sA)[q];
#pragma unroll
    for (int q = 0; q < NV; ++q) x0[q] = reinterpret_cast<const float4*>(sxi)[q];
  }
  for (int k = 0; k < N; k += 2) {
    step(k, a0, a1, x0, x1);
    if (k + 1 < N) step(k + 1, a1, a0, x1, x0);
  }
}

template <int NX, bool FROM>
static int launch_nx(const CondLayout& s, size_t smem, const float* A, const float* Bm,
                     const float* xi, const float* e0, const float* G0, float* e_out,
                     float* gam_out, int batch, int N, int nx, int nu, int nz, int col0,
                     int ldg, int lde, void* stream) {
  const cudaError_t err = reserve_smem((const void*)condense_kernel<NX, FROM>, smem);
  if (err != cudaSuccess) return (int)err;
  condense_kernel<NX, FROM>
      <<<batch * s.blocks, COND_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          A, Bm, xi, e0, G0, e_out, gam_out, N, nx, nu, nz, col0, ldg, lde);
  return (int)cudaGetLastError();
}

template <bool FROM>
static int launch(const float* A, const float* Bm, const float* xi, const float* e0,
                  const float* G0, float* e_out, float* gam_out, int batch, int N, int nx,
                  int nu, int nz, int col0, int ldg, int lde, void* stream) {
  if (batch <= 0) return 0;
  if (!cond_supported(N, nx, nu, nz)) return (int)cudaErrorInvalidValue;
  const CondLayout s = cond_layout(N, nx, nu, nz);
  if ((long long)batch * s.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)s.floats;
  return nx == COND_FAST_NX ? launch_nx<COND_FAST_NX, FROM>(s, smem, A, Bm, xi, e0, G0, e_out,
                                                            gam_out, batch, N, nx, nu, nz,
                                                            col0, ldg, lde, stream)
                            : launch_nx<0, FROM>(s, smem, A, Bm, xi, e0, G0, e_out, gam_out,
                                                 batch, N, nx, nu, nz, col0, ldg, lde, stream);
}

// K2: (e_0, Gam_0) = (d0, 0), nz = N nu.
extern "C" int condense_f32(const float* A, const float* Bm, const float* xi, const float* d0,
                            float* e_out, float* gam_out, int batch, int N, int nx, int nu,
                            void* stream) {
  return launch<false>(A, Bm, xi, d0, nullptr, e_out, gam_out, batch, N, nx, nu, N * nu, 0,
                       N * nu, 1, stream);
}

// K6: (e_0, Gam_0) = (e0, G0) with G0 (batch, nx, nz), stage t's B in the
// columns col0 + t nu .. col0 + (t+1) nu; the caller ensures col0 + N2 nu <= nz.
extern "C" int condense_from_f32(const float* A, const float* Bm, const float* xi,
                                 const float* e0, const float* G0, float* e_out, float* gam_out,
                                 int batch, int N2, int nx, int nu, int nz, int col0,
                                 void* stream) {
  return launch<true>(A, Bm, xi, e0, G0, e_out, gam_out, batch, N2, nx, nu, nz, col0, nz, 1,
                      stream);
}

// K2 / K6 / K8's launch shape at (N, nx, nu, nz), as
// ops/kernels/condense.py::condense_plan gives it: plan = {threads per block,
// blocks per scenario, nx of the unrolled body (8) or 0 (the generic one),
// shared bytes}; returns 0, or -1 (plan untouched) where the kernel refuses
// the shape.
extern "C" int condense_launch_plan(int N, int nx, int nu, int nz, int* plan) {
  if (!cond_supported(N, nx, nu, nz)) return -1;
  const CondLayout s = cond_layout(N, nx, nu, nz);
  const int vals[4] = {COND_THREADS, s.blocks, nx == COND_FAST_NX ? nx : 0,
                       (int)(sizeof(float) * s.floats)};
  for (int i = 0; i < 4; ++i) plan[i] = vals[i];
  return 0;
}

// K8: out (batch, N+1, nx, nz+1) = the augmented carries [Gam_k | e_k], nz =
// N nu: K2's kernel, Gam's rows and e's at the row stride nz + 1 of one
// tensor, e in its last column.
extern "C" int condense_aug_f32(const float* A, const float* Bm, const float* xi, const float* d0,
                                float* out, int batch, int N, int nx, int nu, void* stream) {
  const int nz = N * nu;
  return launch<false>(A, Bm, xi, d0, nullptr, out + nz, out, batch, N, nx, nu, nz, 0, nz + 1,
                       nz + 1, stream);
}
