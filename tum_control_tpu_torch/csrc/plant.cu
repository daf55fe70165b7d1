// The plant's RK4: the closed loop's 7-state vehicle integrated over one
// simulation step, for every scenario, in one launch.
//
// Replaces no TPU kernel: the JAX package integrates the plant in plain JAX
// (tum_control_tpu/sim/closed_loop.py, rk4_multistep over sim_ode), where XLA
// fuses it. Eager PyTorch launches each elementwise op of its 4 substeps x 4
// model evaluations on its own: ~1,716 launches a step (~1,732 with a
// derivative disturbance), each ~1.2 us of the card's time whatever it
// computes.
//
// One thread integrates one scenario through n_sub classical RK4 substeps of
// models/vehicle_stm.py::sim_ode (sim_ode_disturbed with w), in the order of
// models/integrators.py::rk4_step. The plant is model.cuh's pred_ode on the
// 8-vector [x_sim, a] with u = [0, ddelta]: out[6] = u[1] is the steering
// rate, out[7] = u[0] = 0 holds a over the step (the plain path's zero-order
// hold), and w adds to the first seven derivatives. The arithmetic is K1's
// primal (model.cuh: sincosf, atanf, sqrtf, rcp_nr, the constants in double
// on the host), so it meets K1's tolerance against the plain version.
//
// What bounds it: the latency of one thread's chain of 4 n_sub model
// evaluations (16 at the plant's 4 substeps). K1's primal takes ~1,450 cycles
// an evaluation (csrc/linearize.cu's note), so ~10-15 us a launch. Bytes
// (at most 64 a scenario) and operations (~4.5 kFLOP a scenario) bound it at
// ~0.01 us at B = 128: the chain sets the time, not the card's rates. The
// design keeps every scenario's chain in flight at once, 32 threads a block
// (one warp at B = 1), so a batch spreads over B / 32 SMs.
#include <cuda_runtime.h>

#include "model.cuh"

constexpr int NXS = 7;          // plant state: posx, posy, yaw, vlong, vlat, yawrate, delta_f
constexpr int NUS = 2;          // plant input: a, steering rate
constexpr int NXP = NXS + 1;    // pred_ode's state: the plant's and the held a
constexpr int PLANT_THREADS = 32;
// per-scenario tires, ops/kernels/linearize.py::tire_table's row: Bf, Cf, Df, Ef, Br, Cr, Dr,
// Er, Fmax_f, Fmax_r, 1/Fmax_f, 1/Fmax_r
constexpr int TIRE_COLS = 12;

template <bool DIST>
__device__ __forceinline__ void plant_ode(const float* x, const float* u, const float* w, float* k,
                                          const ModelParams& p) {
  pred_ode(x, u, k, p);
  if (DIST) {
#pragma unroll
    for (int i = 0; i < NXS; ++i) k[i] = k[i] + w[i];
  }
}

template <bool TABLE, bool DIST>
__global__ void __launch_bounds__(PLANT_THREADS)
    plant_kernel(const float* __restrict__ x_in, const float* __restrict__ u_in,
                 const float* __restrict__ w_in, float* __restrict__ x_out, int batch,
                 ModelParams p, int n_sub, float h, float h2, float h6,
                 const float* __restrict__ tires, int tire_rows) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  if (TABLE) {
    const float* row = tires + (long)(tire_rows == 1 ? 0 : b) * TIRE_COLS;
    p.Bf = row[0]; p.Cf = row[1]; p.Df = row[2]; p.Ef = row[3];
    p.Br = row[4]; p.Cr = row[5]; p.Dr = row[6]; p.Er = row[7];
    p.Fmax_f = row[8]; p.Fmax_r = row[9]; p.inv_Fmax_f = row[10]; p.inv_Fmax_r = row[11];
  }
  float x[NXP], u[2], w[NXS];
#pragma unroll
  for (int i = 0; i < NXS; ++i) x[i] = x_in[(long)b * NXS + i];
  x[NXS] = u_in[(long)b * NUS];
  u[0] = 0.0f;
  u[1] = u_in[(long)b * NUS + 1];
  if (DIST) {
#pragma unroll
    for (int i = 0; i < NXS; ++i) w[i] = w_in[(long)b * NXS + i];
  }
  for (int s = 0; s < n_sub; ++s) {
    float k[NXP], xt[NXP], acc[NXP];
    plant_ode<DIST>(x, u, w, k, p);
#pragma unroll
    for (int i = 0; i < NXP; ++i) { acc[i] = k[i]; xt[i] = x[i] + h2 * k[i]; }
    plant_ode<DIST>(xt, u, w, k, p);
#pragma unroll
    for (int i = 0; i < NXP; ++i) { acc[i] = acc[i] + 2.0f * k[i]; xt[i] = x[i] + h2 * k[i]; }
    plant_ode<DIST>(xt, u, w, k, p);
#pragma unroll
    for (int i = 0; i < NXP; ++i) { acc[i] = acc[i] + 2.0f * k[i]; xt[i] = x[i] + h * k[i]; }
    plant_ode<DIST>(xt, u, w, k, p);
#pragma unroll
    for (int i = 0; i < NXP; ++i) x[i] = x[i] + h6 * (acc[i] + k[i]);
  }
#pragma unroll
  for (int i = 0; i < NXS; ++i) x_out[(long)b * NXS + i] = x[i];
}

template <bool TABLE, bool DIST>
static void launch(const float* x, const float* u, const float* w, float* out, int batch,
                   const ModelParams& p, int n_sub, float h, float h2, float h6,
                   const float* tires, int tire_rows, cudaStream_t stream) {
  const int blocks = (batch + PLANT_THREADS - 1) / PLANT_THREADS;
  plant_kernel<TABLE, DIST><<<blocks, PLANT_THREADS, 0, stream>>>(
      x, u, w, out, batch, p, n_sub, h, h2, h6, tires, tire_rows);
}

// x (batch, 7), u (batch, 2) = [a, steering rate], w (batch, 7) or null (no
// derivative disturbance), out (batch, 7); prm (host, double): the model
// constants in ModelParams order, then h, h / 2, h / 6
// (ops/kernels/linearize.py::kernel_params); tires null (prm's tires) or a
// device table of 1 or `batch` rows of TIRE_COLS floats (row b for scenario
// b), whose tire slots of prm are not read.
extern "C" int plant_f32(const float* x, const float* u, const float* w, float* out, int batch,
                         const double* prm, const float* tires, int tire_rows, int n_sub,
                         void* stream) {
  if (batch <= 0) return 0;
  if (n_sub < 0 || (tires != nullptr && tire_rows != 1 && tire_rows != batch))
    return (int)cudaErrorInvalidValue;
  ModelParams p;
  float* dst = reinterpret_cast<float*>(&p);
  const int np = sizeof(ModelParams) / sizeof(float);
  for (int i = 0; i < np; ++i) dst[i] = (float)prm[i];
  const float h = (float)prm[np], h2 = (float)prm[np + 1], h6 = (float)prm[np + 2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = tires != nullptr ? tire_rows : 1;
  if (tires != nullptr && w != nullptr)
    launch<true, true>(x, u, w, out, batch, p, n_sub, h, h2, h6, tires, rows, s);
  else if (tires != nullptr)
    launch<true, false>(x, u, w, out, batch, p, n_sub, h, h2, h6, tires, rows, s);
  else if (w != nullptr)
    launch<false, true>(x, u, w, out, batch, p, n_sub, h, h2, h6, tires, rows, s);
  else
    launch<false, false>(x, u, w, out, batch, p, n_sub, h, h2, h6, tires, rows, s);
  return (int)cudaGetLastError();
}
