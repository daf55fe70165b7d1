// K1: fused shooting rollout + exact forward sensitivities.
//
// Replaces ops/pallas_kernels/linearize.py::_make_kernel (launched by
// _kernel_path) of the JAX package: for every (scenario, stage) element,
// F = step(x, u) (RK4 of the 8-state prediction model over one shooting
// interval in n_sub substeps) and J = dF/d(x, u), 8 x 10. The TPU kernel gets
// J by tracing jax.linearize inside the kernel; here the model is templated
// on a dual-number type (model.cuh) and J comes out of forward-mode tangents.
//
// What bounds it: arithmetic latency, not bytes. Each element reads 40 B and
// writes 352 B, while each of its 12 model evaluations is a chain of ~110
// dependent operations including 6 transcendental calls, pushed through
// the tangents. Design: one thread per (element, input direction), ND = 1
// tangent per thread, so the 10 directions of an element run in 10 threads
// and a thread needs 80 registers with no spills (one thread carrying all
// 10 tangents needs 255 registers and spills). The primal is recomputed by
// each direction's thread; that costs arithmetic the card has in excess and
// buys 48,640 threads at the main path's 4,864 elements to hide the latency.
#include <cuda_runtime.h>

#include "model.cuh"

constexpr int NX = 8;
constexpr int NU = 2;
constexpr int NV = NX + NU;
constexpr int ND = 1;  // tangents per thread

__global__ void linearize_kernel(const float* __restrict__ xu, float* __restrict__ F,
                                 float* __restrict__ J, int n_el, ModelParams p, int n_sub,
                                 float h, float h2, float h6) {
  constexpr int NG = NV / ND;  // direction groups per element
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)n_el * NG) return;
  const int e = (int)(t / NG);
  const int g = (int)(t % NG);
  const float* in = xu + (long)e * NV;

  Dual<ND> x[NX], u[NU];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    Dual<ND> d = dconst<ND>(in[v]);
#pragma unroll
    for (int q = 0; q < ND; ++q) d.d[q] = (v == g * ND + q) ? 1.0f : 0.0f;
    if (v < NX) x[v] = d; else u[v - NX] = d;
  }
  rk4_pred(x, u, n_sub, h, h2, h6, p);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) F[(long)e * NX + i] = x[i].v;
  }
  float* out = J + (long)e * NX * NV;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int q = 0; q < ND; ++q) out[i * NV + g * ND + q] = x[i].d[q];
  }
}

// params (host, double): lf, lr, m, Iz, c_aero, Fbank_x, Fbank_y, fr0, fr1, fr4,
// Fz_f, Fz_r, Fmax_f, Fmax_r, Bf, Cf, Df, Ef, Br, Cr, Dr, Er, h, h2, h6
extern "C" int linearize_f32(const float* xu, float* F, float* J, int n_el, const double* prm,
                             int n_sub, void* stream) {
  if (n_el <= 0) return 0;
  ModelParams p;
  float* dst = reinterpret_cast<float*>(&p);
  const int np = sizeof(ModelParams) / sizeof(float);
  for (int i = 0; i < np; ++i) dst[i] = (float)prm[i];
  const float h = (float)prm[np], h2 = (float)prm[np + 1], h6 = (float)prm[np + 2];
  constexpr int threads = 128;
  const long total = (long)n_el * (NV / ND);
  const int blocks = (int)((total + threads - 1) / threads);
  linearize_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      xu, F, J, n_el, p, n_sub, h, h2, h6);
  return (int)cudaGetLastError();
}
