// The 8-state Pacejka single-track prediction model, written once as a
// template over its scalar type: `float` for values, `Dual<ND>` for values
// with ND forward-mode tangents. Computes models/vehicle_stm.py::pred_ode,
// including the NaN-safe low-speed guard and the 1e-24 inside the speed
// sqrt, to K1's tolerance (2e-5 of each output's max against the plain
// version) rather than operation by operation: every quotient is a product
// with a reciprocal (the model's constant divisors precomputed on the host
// in double, one reciprocal per divisor otherwise, from rcp.approx and one
// Newton step: within ~1 ulp, no IEEE division and its slow-path branch),
// and sine and cosine of one argument come from one sincosf. arctan is the
// native atanf: the TPU kernel's polynomial (fastmath.atan_poly) only existed
// because Mosaic cannot lower arctan.
#pragma once

#include <math.h>

// 1 / x from the hardware's approximate reciprocal and one Newton step
__device__ __forceinline__ float rcp_nr(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

template <int ND>
struct Dual {
  float v;
  float d[ND];
};

struct ModelParams {
  float lf, lr, m, Iz;
  float c_aero;            // 0.5 * ro * S * Cd
  float Fbank_x, Fbank_y;
  float fr0, fr1, fr4;
  float Fz_f, Fz_r, Fmax_f, Fmax_r;
  float Bf, Cf, Df, Ef, Br, Cr, Dr, Er;
  float inv_m, inv_Iz, inv_Fmax_f, inv_Fmax_r;  // 1 / m, 1 / Iz, 1 / Fmax_f, 1 / Fmax_r
};

// ---- scalar layer: float ---------------------------------------------------
__device__ __forceinline__ float s_val(float x) { return x; }
__device__ __forceinline__ float s_sin(float x) { return sinf(x); }
__device__ __forceinline__ void s_sincos(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ float s_atan(float x) { return atanf(x); }
__device__ __forceinline__ float s_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float s_where(bool c, float a, float b) { return c ? a : b; }
__device__ __forceinline__ float s_clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---- scalar layer: Dual<ND> ------------------------------------------------
#define DUAL_LOOP for (int q = 0; q < ND; ++q)

template <int ND> __device__ __forceinline__ Dual<ND> dconst(float v) {
  Dual<ND> r; r.v = v;
#pragma unroll
  DUAL_LOOP r.d[q] = 0.0f;
  return r;
}
template <int ND> __device__ __forceinline__ float s_val(const Dual<ND>& x) { return x.v; }

template <int ND> __device__ __forceinline__ Dual<ND> operator+(const Dual<ND>& a, const Dual<ND>& b) {
  Dual<ND> r; r.v = a.v + b.v;
#pragma unroll
  DUAL_LOOP r.d[q] = a.d[q] + b.d[q];
  return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator+(const Dual<ND>& a, float b) {
  Dual<ND> r = a; r.v = a.v + b; return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator+(float a, const Dual<ND>& b) {
  Dual<ND> r = b; r.v = a + b.v; return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator-(const Dual<ND>& a, const Dual<ND>& b) {
  Dual<ND> r; r.v = a.v - b.v;
#pragma unroll
  DUAL_LOOP r.d[q] = a.d[q] - b.d[q];
  return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator-(const Dual<ND>& a, float b) {
  Dual<ND> r = a; r.v = a.v - b; return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator-(float a, const Dual<ND>& b) {
  Dual<ND> r; r.v = a - b.v;
#pragma unroll
  DUAL_LOOP r.d[q] = -b.d[q];
  return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator-(const Dual<ND>& a) {
  Dual<ND> r; r.v = -a.v;
#pragma unroll
  DUAL_LOOP r.d[q] = -a.d[q];
  return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator*(const Dual<ND>& a, const Dual<ND>& b) {
  Dual<ND> r; r.v = a.v * b.v;
#pragma unroll
  DUAL_LOOP r.d[q] = a.d[q] * b.v + a.v * b.d[q];
  return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator*(const Dual<ND>& a, float b) {
  Dual<ND> r; r.v = a.v * b;
#pragma unroll
  DUAL_LOOP r.d[q] = a.d[q] * b;
  return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator*(float a, const Dual<ND>& b) {
  return b * a;
}
template <int ND> __device__ __forceinline__ Dual<ND> operator/(const Dual<ND>& a, const Dual<ND>& b) {
  const float ib = rcp_nr(b.v);
  Dual<ND> r; r.v = a.v * ib;
#pragma unroll
  DUAL_LOOP r.d[q] = (a.d[q] - r.v * b.d[q]) * ib;
  return r;
}
// chain rule through a scalar function with value fv and derivative dfv
template <int ND> __device__ __forceinline__ Dual<ND> dchain(const Dual<ND>& x, float fv, float dfv) {
  Dual<ND> r; r.v = fv;
#pragma unroll
  DUAL_LOOP r.d[q] = dfv * x.d[q];
  return r;
}
template <int ND> __device__ __forceinline__ Dual<ND> s_sin(const Dual<ND>& x) {
  float s, c;
  sincosf(x.v, &s, &c);
  return dchain(x, s, c);
}
template <int ND> __device__ __forceinline__ void s_sincos(const Dual<ND>& x, Dual<ND>& s, Dual<ND>& c) {
  float sv, cv;
  sincosf(x.v, &sv, &cv);
  s = dchain(x, sv, cv);
  c = dchain(x, cv, -sv);
}
template <int ND> __device__ __forceinline__ Dual<ND> s_atan(const Dual<ND>& x) {
  return dchain(x, atanf(x.v), rcp_nr(1.0f + x.v * x.v));
}
template <int ND> __device__ __forceinline__ Dual<ND> s_sqrt(const Dual<ND>& x) {
  const float s = sqrtf(x.v);
  return dchain(x, s, 0.5f * rcp_nr(s));
}
template <int ND> __device__ __forceinline__ Dual<ND> s_where(bool c, const Dual<ND>& a, const Dual<ND>& b) {
  return c ? a : b;
}
template <int ND> __device__ __forceinline__ Dual<ND> s_clamp(const Dual<ND>& x, float lo, float hi) {
  return x.v < lo ? dconst<ND>(lo) : (x.v > hi ? dconst<ND>(hi) : x);
}
// a constant of the same type as x (zero tangents)
__device__ __forceinline__ float s_like(float, float v) { return v; }
template <int ND> __device__ __forceinline__ Dual<ND> s_like(const Dual<ND>&, float v) {
  return dconst<ND>(v);
}

// ---- the model --------------------------------------------------------------
constexpr float VLONG_EPS = 1e-3f;

template <class T>
__device__ __forceinline__ T pacejka(const T& alpha, float B, float C, float D, float E) {
  const T Ba = B * alpha;
  return D * s_sin(C * s_atan(Ba - E * (Ba - s_atan(Ba))));
}

// xdot = f(x, u) for x = [posx, posy, yaw, vlong, vlat, yawrate, delta_f, a],
// u = [jerk, steering_rate]
template <class T>
__device__ __forceinline__ void pred_ode(const T* x, const T* u, T* out, const ModelParams& p) {
  const T& yaw = x[2];
  const T& vlong = x[3];
  const T& vlat = x[4];
  const T& yawrate = x[5];
  const T& delta_f = x[6];
  const T& a = x[7];

  const T v_kmh = s_sqrt(vlong * vlong + vlat * vlat + 1e-24f) * 3.6f;
  const T t = v_kmh * 0.01f;
  const T t2 = t * t;
  const T fr = p.fr0 + p.fr1 * t + p.fr4 * (t2 * t2);
  const T Fr_f = fr * p.Fz_f;
  const T Fr_r = fr * p.Fz_r;
  const T Faero = p.c_aero * (vlong * vlong);
  const T Fx_f = -Fr_f;
  const T Fx_r = p.m * a - Fr_r;

  const bool moving = s_val(vlong) > VLONG_EPS;
  const T zero = s_like(vlong, 0.0f);
  const T vl_safe = s_where(moving, vlong, s_like(vlong, 1.0f));
  const T alpha_f = s_where(moving, delta_f - s_atan((vlat + p.lf * yawrate) / vl_safe), zero);
  const T alpha_r = s_where(moving, s_atan((p.lr * yawrate - vlat) / vl_safe), zero);

  const T Gy_f = s_clamp(Fx_f * p.inv_Fmax_f, -0.98f, 0.98f);
  const T Gy_r = s_clamp(Fx_r * p.inv_Fmax_r, -0.98f, 0.98f);
  const T Fy_f = pacejka(alpha_f, p.Bf, p.Cf, p.Df, p.Ef) * s_sqrt(1.0f - Gy_f * Gy_f);
  const T Fy_r = pacejka(alpha_r, p.Br, p.Cr, p.Dr, p.Er) * s_sqrt(1.0f - Gy_r * Gy_r);

  T cd, sd, cy, sy;
  s_sincos(delta_f, sd, cd);
  s_sincos(yaw, sy, cy);
  out[0] = vlong * cy - vlat * sy;
  out[1] = vlong * sy + vlat * cy;
  out[2] = yawrate;
  out[3] = (Fx_r - Faero - Fy_f * sd + Fx_f * cd - p.Fbank_x + p.m * vlat * yawrate) * p.inv_m;
  out[4] = (Fy_r + Fy_f * cd + Fx_f * sd - p.Fbank_y - p.m * vlong * yawrate) * p.inv_m;
  out[5] = (p.lf * (Fy_f * cd + Fx_f * sd) - p.lr * Fy_r) * p.inv_Iz;
  out[6] = u[1];
  out[7] = u[0];
}

// n_sub classical RK4 substeps of pred_ode over one shooting interval;
// h = interval / n_sub, h2 = 0.5 h, h6 = h / 6 (as models/integrators.py)
template <class T>
__device__ __forceinline__ void rk4_pred(T* x, const T* u, int n_sub, float h, float h2, float h6,
                                         const ModelParams& p) {
  for (int s = 0; s < n_sub; ++s) {
    T k[8], xt[8], acc[8];
    pred_ode(x, u, k, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) { acc[i] = k[i]; xt[i] = x[i] + h2 * k[i]; }
    pred_ode(xt, u, k, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) { acc[i] = acc[i] + 2.0f * k[i]; xt[i] = x[i] + h2 * k[i]; }
    pred_ode(xt, u, k, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) { acc[i] = acc[i] + 2.0f * k[i]; xt[i] = x[i] + h * k[i]; }
    pred_ode(xt, u, k, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = x[i] + h6 * (acc[i] + k[i]);
  }
}
