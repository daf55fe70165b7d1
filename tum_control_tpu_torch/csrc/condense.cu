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
// What bounds K2 and K6: bytes. Per scenario they write (N+1) nx nz floats of Gam
// (95 KB at N=38, nx=8, nu=2; K6 at N2=33, nz=76: 83 KB), against
// nx^2 nz FMAs per stage; the recurrence is sequential in the stage. Design:
// one block per scenario; A, B, xi of the scenario and a double-buffered
// Gam_k (nx x nz, 2.4 KB) stay in shared memory across all stages, one thread
// per Gam entry, and each stage's Gam goes to device memory once, in
// coalesced rows. One kernel body serves both: FROM selects the initial carry
// (loaded for K6, (d0, 0) for K2), col0 is 0 for K2.
//
// K8 replaces ops/pallas_kernels/condense.py::_make_mxu_kernel (launched by
// _condense_tpu_mxu), which no caller of the JAX package reaches: the same
// recurrence on an augmented carry G = [Gam | e] of nx x (nz+1), stage 0 =
// [0 | d0], then per stage G <- A_k G, the columns k nu .. (k+1) nu of G
// *assigned* B_k, and xi_k added to the e column. It writes one
// (N+1, nx, nz+1) tensor per scenario. The TPU kernel packs 128/nx scenarios
// block-diagonally into one 128x128 MXU product per stage, wasting 15/16 of
// the work; that packing is not carried over, and no tensor-core mode is
// used (TF32 per-stage products cost ~2e-2 relative error in this
// recurrence). Design: one block per scenario, A, B, xi in shared memory,
// one thread per augmented column holding that column (nx <= 16 values) in
// registers, so a stage needs no barrier; each stage's rows go to device
// memory coalesced across the threads. Bound by bytes too: (N+1) nx (nz+1)
// floats written per scenario.
#include <cuda_runtime.h>

template <bool FROM>
__global__ void condense_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                                const float* __restrict__ xi, const float* __restrict__ e0,
                                const float* __restrict__ G0, float* __restrict__ e_out,
                                float* __restrict__ gam_out, int N, int nx, int nu, int nz,
                                int col0) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, bs = blockDim.x;
  float* sA = sm;                    // N nx nx
  float* sB = sA + N * nx * nx;      // N nx nu
  float* sxi = sB + N * nx * nu;     // N nx
  float* g[2] = {sxi + N * nx, sxi + N * nx + nx * nz};
  float* e[2] = {g[1] + nx * nz, g[1] + nx * nz + nx};

  const float* Ab = A + (long)b * N * nx * nx;
  const float* Bb = Bm + (long)b * N * nx * nu;
  const float* xib = xi + (long)b * N * nx;
  for (int i = tid; i < N * nx * nx; i += bs) sA[i] = Ab[i];
  for (int i = tid; i < N * nx * nu; i += bs) sB[i] = Bb[i];
  for (int i = tid; i < N * nx; i += bs) sxi[i] = xib[i];
  for (int i = tid; i < nx * nz; i += bs) g[0][i] = FROM ? G0[(long)b * nx * nz + i] : 0.0f;
  for (int i = tid; i < nx; i += bs) e[0][i] = e0[(long)b * nx + i];
  __syncthreads();

  float* eo = e_out + (long)b * (N + 1) * nx;
  float* go = gam_out + (long)b * (N + 1) * nx * nz;
  for (int k = 0; k <= N; ++k) {
    const float* gc = g[k & 1];
    const float* ec = e[k & 1];
    for (int i = tid; i < nx * nz; i += bs) go[(long)k * nx * nz + i] = gc[i];
    for (int i = tid; i < nx; i += bs) eo[k * nx + i] = ec[i];
    if (k == N) break;
    float* gn = g[(k + 1) & 1];
    float* en = e[(k + 1) & 1];
    const float* Ak = sA + k * nx * nx;
    const float* Bk = sB + k * nx * nu;
    for (int idx = tid; idx < nx * nz; idx += bs) {
      const int i = idx / nz, z = idx - i * nz;
      float acc = 0.0f;
      for (int m = 0; m < nx; ++m) acc += Ak[i * nx + m] * gc[m * nz + z];
      const int q = z - col0 - k * nu;
      if (q >= 0 && q < nu) acc += Bk[i * nu + q];
      gn[idx] = acc;
    }
    for (int i = tid; i < nx; i += bs) {
      float acc = 0.0f;
      for (int m = 0; m < nx; ++m) acc += Ak[i * nx + m] * ec[m];
      en[i] = acc + sxi[k * nx + i];
    }
    __syncthreads();
  }
}

template <bool FROM>
static int launch(const float* A, const float* Bm, const float* xi, const float* e0,
                  const float* G0, float* e_out, float* gam_out, int batch, int N, int nx,
                  int nu, int nz, int col0, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem =
      sizeof(float) * ((size_t)N * nx * nx + (size_t)N * nx * nu + (size_t)N * nx +
                       2 * (size_t)nx * nz + 2 * (size_t)nx);
  cudaError_t err = cudaFuncSetAttribute(condense_kernel<FROM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((nx * nz + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  condense_kernel<FROM><<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, xi, e0, G0, e_out, gam_out, N, nx, nu, nz, col0);
  return (int)cudaGetLastError();
}

// K2: (e_0, Gam_0) = (d0, 0), nz = N nu.
extern "C" int condense_f32(const float* A, const float* Bm, const float* xi, const float* d0,
                            float* e_out, float* gam_out, int batch, int N, int nx, int nu,
                            void* stream) {
  return launch<false>(A, Bm, xi, d0, nullptr, e_out, gam_out, batch, N, nx, nu, N * nu, 0,
                       stream);
}

// K6: (e_0, Gam_0) = (e0, G0) with G0 (batch, nx, nz), stage t's B in the
// columns col0 + t nu .. col0 + (t+1) nu; the caller ensures col0 + N2 nu <= nz.
extern "C" int condense_from_f32(const float* A, const float* Bm, const float* xi,
                                 const float* e0, const float* G0, float* e_out, float* gam_out,
                                 int batch, int N2, int nx, int nu, int nz, int col0,
                                 void* stream) {
  return launch<true>(A, Bm, xi, e0, G0, e_out, gam_out, batch, N2, nx, nu, nz, col0, stream);
}

constexpr int AUG_MAX_NX = 16;  // register carry per column thread

__global__ void condense_aug_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                                    const float* __restrict__ xi, const float* __restrict__ d0,
                                    float* __restrict__ out, int N, int nx, int nu) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int z = threadIdx.x, bs = blockDim.x;
  const int nz = N * nu, w = nz + 1;
  float* sA = sm;                    // N nx nx
  float* sB = sA + N * nx * nx;      // N nx nu
  float* sxi = sB + N * nx * nu;     // N nx
  const float* Ab = A + (long)b * N * nx * nx;
  const float* Bb = Bm + (long)b * N * nx * nu;
  const float* xib = xi + (long)b * N * nx;
  for (int i = z; i < N * nx * nx; i += bs) sA[i] = Ab[i];
  for (int i = z; i < N * nx * nu; i += bs) sB[i] = Bb[i];
  for (int i = z; i < N * nx; i += bs) sxi[i] = xib[i];
  __syncthreads();
  if (z >= w) return;

  // thread z owns column z of the carry: Gam's columns, then e at z = nz
  float g[AUG_MAX_NX];
#pragma unroll
  for (int i = 0; i < AUG_MAX_NX; ++i) g[i] = (i < nx && z == nz) ? d0[(long)b * nx + i] : 0.0f;
  float* ob = out + (long)b * (N + 1) * nx * w;
#pragma unroll
  for (int i = 0; i < AUG_MAX_NX; ++i)
    if (i < nx) ob[i * w + z] = g[i];
  for (int k = 0; k < N; ++k) {
    const float* Ak = sA + k * nx * nx;
    float gn[AUG_MAX_NX];
#pragma unroll
    for (int i = 0; i < AUG_MAX_NX; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < AUG_MAX_NX; ++m)
        if (i < nx && m < nx) acc += Ak[i * nx + m] * g[m];
      gn[i] = acc;
    }
    const int q = z - k * nu;
    float* o = ob + (long)(k + 1) * nx * w;
#pragma unroll
    for (int i = 0; i < AUG_MAX_NX; ++i) {
      if (i < nx) {
        if (q >= 0 && q < nu) gn[i] = sB[(k * nx + i) * nu + q];   // assigned, not added
        if (z == nz) gn[i] += sxi[k * nx + i];
        g[i] = gn[i];
        o[i * w + z] = g[i];
      }
    }
  }
}

// K8: out (batch, N+1, nx, nz+1) = the augmented carries [Gam_k | e_k]. The
// caller ensures nx <= 16, N nu + 1 <= 1024 and that the shared memory fits.
extern "C" int condense_aug_f32(const float* A, const float* Bm, const float* xi, const float* d0,
                                float* out, int batch, int N, int nx, int nu, void* stream) {
  if (batch <= 0) return 0;
  if (nx > AUG_MAX_NX || N * nu + 1 > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)N * nx * nx + (size_t)N * nx * nu + (size_t)N * nx);
  cudaError_t err = cudaFuncSetAttribute(condense_aug_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((N * nu + 1 + 31) / 32) * 32;
  condense_aug_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, xi, d0, out, N, nx, nu);
  return (int)cudaGetLastError();
}
