// K1: fused shooting rollout + exact forward sensitivities.
//
// Replaces ops/pallas_kernels/linearize.py::_make_kernel (launched by
// _kernel_path) of the JAX package: for every (scenario, stage) element,
// F = step(x, u) (RK4 of the 8-state prediction model over one shooting
// interval in n_sub substeps) and J = dF/d(x, u), 8 x 10. The TPU kernel gets
// J by tracing jax.linearize inside the kernel; here the model is templated
// on a dual-number type (model.cuh) and J comes out of forward-mode tangents.
//
// What bounds it: the latency of one thread's chain of model evaluations
// (12 at 3 substeps, 4 at one), not bytes (40 B in, 352 B out per element):
// the primal alone, one thread per element, takes ~1,450 cycles per
// evaluation (H100 80GB HBM3, 700 W; tools/kernel_breakdown.py). Design:
//   * the model's arithmetic without IEEE division and with one sincosf per
//     angle (model.cuh): with the old arithmetic, every tangent divided by
//     IEEE `/`, the kernel took 2.6-4.1 times its primal alone;
//   * one thread per (element, input direction), LIN_ND = 1 tangent each,
//     the primal recomputed by each: more threads hide more of the chain's
//     latency, which outweighs issuing the primal fewer times (measured: 2
//     tangents a thread 7 % slower at the nominal shape, 3 % faster at
//     SNMPC's; 5 or 10 slower at both);
//   * 7 blocks per SM (at most 72 registers, no spills) keep all 880 blocks
//     of the SNMPC shape (11,264 elements) resident in one wave.
#include <cuda_runtime.h>

#include "model.cuh"

constexpr int NX = 8;
constexpr int NU = 2;
constexpr int NV = NX + NU;
constexpr int LIN_ND = 1;                   // tangents per thread
constexpr int LIN_NG = NV / LIN_ND;         // threads per element
constexpr int LIN_THREADS = 128;
constexpr int LIN_MIN_BLOCKS = 7;           // per SM: at most 72 registers a thread
static_assert(NV % LIN_ND == 0, "LIN_ND must divide the 10 input directions");

__global__ void __launch_bounds__(LIN_THREADS, LIN_MIN_BLOCKS)
    linearize_kernel(const float* __restrict__ xu, float* __restrict__ F, float* __restrict__ J,
                     int n_el, ModelParams p, int n_sub, float h, float h2, float h6) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)n_el * LIN_NG) return;
  const int e = (int)(t / LIN_NG);
  const int g = (int)(t % LIN_NG);
  const float* in = xu + (long)e * NV;

  Dual<LIN_ND> x[NX], u[NU];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    Dual<LIN_ND> d = dconst<LIN_ND>(in[v]);
#pragma unroll
    for (int q = 0; q < LIN_ND; ++q) d.d[q] = (v == g * LIN_ND + q) ? 1.0f : 0.0f;
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
    for (int q = 0; q < LIN_ND; ++q) out[i * NV + g * LIN_ND + q] = x[i].d[q];
  }
}

static int lin_blocks(int n_el) {
  return (int)(((long)n_el * LIN_NG + LIN_THREADS - 1) / LIN_THREADS);
}

// params (host, double): lf, lr, m, Iz, c_aero, Fbank_x, Fbank_y, fr0, fr1, fr4,
// Fz_f, Fz_r, Fmax_f, Fmax_r, Bf, Cf, Df, Ef, Br, Cr, Dr, Er, 1/m, 1/Iz,
// 1/Fmax_f, 1/Fmax_r, h, h2, h6
extern "C" int linearize_f32(const float* xu, float* F, float* J, int n_el, const double* prm,
                             int n_sub, void* stream) {
  if (n_el <= 0) return 0;
  ModelParams p;
  float* dst = reinterpret_cast<float*>(&p);
  const int np = sizeof(ModelParams) / sizeof(float);
  for (int i = 0; i < np; ++i) dst[i] = (float)prm[i];
  const float h = (float)prm[np], h2 = (float)prm[np + 1], h6 = (float)prm[np + 2];
  linearize_kernel<<<lin_blocks(n_el), LIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xu, F, J, n_el, p, n_sub, h, h2, h6);
  return (int)cudaGetLastError();
}

// The launch's shape at n_el elements, as ops/kernels/linearize.py::
// linearize_plan gives it: plan = {threads per block, blocks, tangents per
// thread, threads per element}; returns 0, or -1 for n_el < 1.
extern "C" int linearize_launch_plan(int n_el, int* plan) {
  if (n_el < 1) return -1;
  plan[0] = LIN_THREADS;
  plan[1] = lin_blocks(n_el);
  plan[2] = LIN_ND;
  plan[3] = LIN_NG;
  return 0;
}
