// K2: full condensing of the stage sensitivities.
//
// Replaces ops/pallas_kernels/condense.py::_make_kernel (launched by
// _condense_tpu) of the JAX package. Per scenario:
//   e_0 = d0,  Gam_0 = 0,
//   e_{k+1} = A_k e_k + xi_k,  Gam_{k+1} = A_k Gam_k + B_k E_k,
// where E_k selects the columns k*nu .. (k+1)*nu of Gam. Outputs every stage
// 0..N, including stage 0 and the zero columns past k*nu.
//
// What bounds it: bytes. Per scenario it writes (N+1) nx nz floats of Gam
// (0.47 MB at N=38, nx=8, nu=2), against nx^2 nz FMAs per stage; the
// recurrence is sequential in k. Design: one block per scenario; A, B, xi of
// the scenario and a double-buffered Gam_k (nx x nz, 2.4 KB) stay in shared
// memory across all stages, one thread per Gam entry, and each stage's Gam
// goes to device memory once, in coalesced rows.
#include <cuda_runtime.h>

__global__ void condense_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                                const float* __restrict__ xi, const float* __restrict__ d0,
                                float* __restrict__ e_out, float* __restrict__ gam_out,
                                int N, int nx, int nu) {
  extern __shared__ float sm[];
  const int nz = N * nu;
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
  for (int i = tid; i < nx * nz; i += bs) g[0][i] = 0.0f;
  for (int i = tid; i < nx; i += bs) e[0][i] = d0[(long)b * nx + i];
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
      const int q = z - k * nu;
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

extern "C" int condense_f32(const float* A, const float* Bm, const float* xi, const float* d0,
                            float* e_out, float* gam_out, int batch, int N, int nx, int nu,
                            void* stream) {
  if (batch <= 0) return 0;
  const int nz = N * nu;
  const size_t smem =
      sizeof(float) * ((size_t)N * nx * nx + (size_t)N * nx * nu + (size_t)N * nx +
                       2 * (size_t)nx * nz + 2 * (size_t)nx);
  cudaError_t err = cudaFuncSetAttribute(condense_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((nx * nz + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  condense_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, xi, d0, e_out, gam_out, N, nx, nu);
  return (int)cudaGetLastError();
}
