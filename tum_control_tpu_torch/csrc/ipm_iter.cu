// K4: one fused Mehrotra interior-point iteration of the soft-constrained
// condensed QP, per scenario.
//
// Replaces ops/pallas_kernels/ipm_iter.py::_make_kernel (launched by
// fused_iteration_batched) of the JAX package; the same math as that file's
// iteration_ref: residuals, barrier terms, the affine and the centred
// directions (each a con_tmul, a forward/backward substitution against the
// Cholesky factor L of the current normal matrix, and a con_mul), the
// fraction-to-boundary step (gamma_ftb), the Mehrotra centring
// sigma = clip((gap_aff/gap)^3, 1e-4, 0.99), the guarded update, sigma for the
// next normal matrix and the `unconverged` flag. The constraint system is
// the ncg general rows G followed by nz identity rows over w (n_id = nz).
//
// What bounds it: latency. Per scenario it reads ~56 KB (L, G and 14
// vectors) once and does ~4 (nz^2 + ncg nz) FMAs, but the two substitutions
// are 4 nz dependent steps and the iteration has ~12 block-wide reductions
// and barriers. Design: one block per scenario, one thread per constraint
// row (row values live in registers), L and G staged once in shared memory
// (padded to an odd leading dimension: 47 KB at nz = 76, ncg = 78, so the
// launch raises the dynamic shared-memory limit), one warp runs both
// substitutions with x in registers (trisolve.cuh, shared with K5), and the
// gap sums, the step minimum and the isfinite check are block reductions.
#include <cuda_runtime.h>

#include "common.cuh"
#include "trisolve.cuh"

constexpr int MAXR = 4;  // substitution rows per lane: nz <= 128

struct Dirs {
  float dsu, dsl, dpu, dpl, dlu, dll, dmu, dml, gdw, dw, alpha;
};

__global__ void ipm_iter_kernel(
    const float* __restrict__ L, const float* __restrict__ G, const float* __restrict__ rw,
    const float* __restrict__ c0, const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ z1, const float* __restrict__ z2, const float* __restrict__ nt_in,
    const float* __restrict__ w_in, const float* __restrict__ gw_in,
    const float* __restrict__ su_in, const float* __restrict__ sl_in,
    const float* __restrict__ pu_in, const float* __restrict__ pl_in,
    const float* __restrict__ lu_in, const float* __restrict__ ll_in,
    const float* __restrict__ mu_in, const float* __restrict__ ml_in,
    float* __restrict__ w_out, float* __restrict__ gw_out, float* __restrict__ su_out,
    float* __restrict__ sl_out, float* __restrict__ pu_out, float* __restrict__ pl_out,
    float* __restrict__ lu_out, float* __restrict__ ll_out, float* __restrict__ mu_out,
    float* __restrict__ ml_out, float* __restrict__ sig_out, unsigned char* __restrict__ unc_out,
    int nz, int ncg, float gamma_ftb) {
  extern __shared__ float sm[];
  const int nc = ncg + nz;
  const int ld = nz + 1;
  float* sL = sm;                 // nz x ld
  float* sG = sL + nz * ld;       // ncg x ld
  float* sy = sG + ncg * ld;      // nc
  float* sx = sy + nc;            // nz
  float* red = sx + nz;           // 32
  const int b = blockIdx.x;
  const int tid = threadIdx.x, bs = blockDim.x;

  const float* Lb = L + (long)b * nz * nz;
  const float* Gb = G + (long)b * ncg * nz;
  for (int idx = tid; idx < nz * nz; idx += bs) {
    const int i = idx / nz, k = idx - i * nz;
    sL[i * ld + k] = Lb[idx];
  }
  for (int idx = tid; idx < ncg * nz; idx += bs) {
    const int i = idx / nz, k = idx - i * nz;
    sG[i * ld + k] = Gb[idx];
  }

  // ---- this thread's constraint row (rows >= nc are inert) ----------------
  const bool row = tid < nc;
  const long ro = (long)b * nc + tid;
  const float c0i = row ? c0[ro] : 0.0f, lbi = row ? lb[ro] : 0.0f, ubi = row ? ub[ro] : 0.0f;
  const float z1i = row ? z1[ro] : 0.0f, z2i = row ? z2[ro] : 0.0f;
  const float gw = row ? gw_in[ro] : 0.0f;
  const float su = row ? su_in[ro] : 0.0f, sl = row ? sl_in[ro] : 0.0f;
  const float pu = row ? pu_in[ro] : 1.0f, pl = row ? pl_in[ro] : 1.0f;
  const float lam_u = row ? lu_in[ro] : 0.0f, lam_l = row ? ll_in[ro] : 0.0f;
  const float mu_u = row ? mu_in[ro] : 0.0f, mu_l = row ? ml_in[ro] : 0.0f;
  const bool act_u = row && ubi < 1e10f;
  const bool act_l = row && lbi > -1e10f;
  const bool soft = z2i < 1e6f;
  const bool s_u = act_u && soft, s_l = act_l && soft;
  // this thread's entry of the nz-vectors
  const bool vz = tid < nz;
  const float w = vz ? w_in[(long)b * nz + tid] : 0.0f;
  const float rwz = vz ? rw[(long)b * nz + tid] : 0.0f;
  const float nt = nt_in[b];

  const float v = gw + c0i;
  const float r_pu = act_u ? v + pu - su - ubi : 0.0f;
  const float r_pl = act_l ? pl - v - sl + lbi : 0.0f;

  auto gap_terms = [&](float lu, float pu_, float ll, float pl_, float mu, float su_, float ml,
                       float sl_) {
    return (act_u ? lu * pu_ : 0.0f) + (act_l ? ll * pl_ : 0.0f) + (s_u ? mu * su_ : 0.0f) +
           (s_l ? ml * sl_ : 0.0f);
  };
  const float gap = block_sum(gap_terms(lam_u, pu, lam_l, pl, mu_u, su, mu_l, sl), red);

  // barrier terms (ipm_iter.py::_barrier_terms)
  auto barrier = [&](float su_, float sl_, float pu_, float pl_, float lu, float ll, float mu,
                     float ml, float& su_s, float& sl_s, float& rs_u, float& rs_l, float& b_u,
                     float& b_l, float& ipb_u, float& ipb_l, float& D_u, float& D_l,
                     float& sig_u, float& sig_l) {
    su_s = s_u ? su_ : 1.0f;
    sl_s = s_l ? sl_ : 1.0f;
    rs_u = z1i + z2i * su_ - lu - mu;
    rs_l = z1i + z2i * sl_ - ll - ml;
    b_u = z2i + mu / su_s;
    b_l = z2i + ml / sl_s;
    ipb_u = s_u ? lu / (pu_ * b_u) : 0.0f;
    ipb_l = s_l ? ll / (pl_ * b_l) : 0.0f;
    D_u = 1.0f + ipb_u;
    D_l = 1.0f + ipb_l;
    sig_u = act_u ? lu / (pu_ * D_u) : 0.0f;
    sig_l = act_l ? ll / (pl_ * D_l) : 0.0f;
  };
  float su_s, sl_s, rs_u, rs_l, b_u, b_l, ipb_u, ipb_l, D_u, D_l, sig_u, sig_l;
  barrier(su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, su_s, sl_s, rs_u, rs_l, b_u, b_l, ipb_u,
          ipb_l, D_u, D_l, sig_u, sig_l);
  __syncthreads();  // sL, sG staged

  auto directions = [&](float tau) {
    Dirs d;
    const float a_u = s_u ? -rs_u + tau / su_s - mu_u : 0.0f;
    const float a_l = s_l ? -rs_l + tau / sl_s - mu_l : 0.0f;
    const float chat_u =
        act_u ? (tau / pu - lam_u + lam_u * r_pu / pu - ipb_u * a_u) / D_u : 0.0f;
    const float chat_l =
        act_l ? (tau / pl - lam_l + lam_l * r_pl / pl - ipb_l * a_l) / D_l : 0.0f;
    if (row) sy[tid] = chat_u - chat_l;
    __syncthreads();
    // rhs = rw + [G; I]' y
    if (vz) {
      float t = 0.0f;
      for (int r = 0; r < ncg; ++r) t += sG[r * ld + tid] * sy[r];
      sx[tid] = rwz + (t + sy[ncg + tid]);
    }
    __syncthreads();
    if (tid < 32) {
      float xr[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        const int i = r * 32 + tid;
        xr[r] = (i < nz) ? sx[i] : 0.0f;
      }
      warp_chol_solve<MAXR>(sL, ld, nz, xr);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        const int i = r * 32 + tid;
        if (i < nz) sx[i] = -xr[r];
      }
    }
    __syncthreads();
    d.dw = vz ? sx[tid] : 0.0f;
    // Gdw = [G; I] dw
    float gdw = 0.0f;
    if (tid < ncg) {
      for (int z = 0; z < nz; ++z) gdw += sG[tid * ld + z] * sx[z];
    } else if (row) {
      gdw = sx[tid - ncg];
    }
    d.gdw = gdw;
    d.dlu = act_u ? chat_u + sig_u * gdw : 0.0f;
    d.dll = act_l ? chat_l - sig_l * gdw : 0.0f;
    d.dsu = s_u ? (d.dlu + a_u) / b_u : 0.0f;
    d.dsl = s_l ? (d.dll + a_l) / b_l : 0.0f;
    d.dmu = s_u ? (tau - mu_u * su - mu_u * d.dsu) / su_s : 0.0f;
    d.dml = s_l ? (tau - mu_l * sl - mu_l * d.dsl) / sl_s : 0.0f;
    d.dpu = act_u ? d.dsu - gdw - r_pu : 0.0f;
    d.dpl = act_l ? d.dsl + gdw - r_pl : 0.0f;
    // fraction to the boundary
    auto ratio = [](bool m, float x, float dx) { return (m && dx < 0.0f) ? -x / dx : INFINITY; };
    float step = ratio(act_u, lam_u, d.dlu);
    step = pmin(step, ratio(act_l, lam_l, d.dll));
    step = pmin(step, ratio(s_u, mu_u, d.dmu));
    step = pmin(step, ratio(s_l, mu_l, d.dml));
    step = pmin(step, ratio(act_u, pu, d.dpu));
    step = pmin(step, ratio(act_l, pl, d.dpl));
    step = pmin(step, ratio(s_u, su, d.dsu));
    step = pmin(step, ratio(s_l, sl, d.dsl));
    d.alpha = pmin(1.0f, gamma_ftb * block_min(step, red));
    return d;
  };

  // predictor (affine) direction and the Mehrotra centring
  const Dirs a = directions(0.0f);
  const float aa = a.alpha;
  const float gap_aff = block_sum(
      gap_terms(lam_u + aa * a.dlu, pu + aa * a.dpu, lam_l + aa * a.dll, pl + aa * a.dpl,
                mu_u + aa * a.dmu, su + aa * a.dsu, mu_l + aa * a.dml, sl + aa * a.dsl),
      red);
  const float ratio_gap = gap_aff / pmax(gap, 1e-30f);
  const float sig_c = pmin(pmax(ratio_gap * ratio_gap * ratio_gap, 1e-4f), 0.99f);
  const float tau = sig_c * gap / nt;

  // corrector (centred) direction and the guarded update
  const Dirs d = directions(tau);
  const bool unconverged = gap > 1e-11f * nt;
  const bool finite_dw = block_all(!vz || isfinite(d.dw));
  const bool ok = unconverged && finite_dw && isfinite(d.alpha);
  const float al = d.alpha;
  auto upd = [&](float x, float dx, bool m) { return (ok && m) ? x + al * dx : x; };
  if (vz) w_out[(long)b * nz + tid] = ok ? w + al * d.dw : w;
  if (row) {
    const float su_n = upd(su, d.dsu, s_u), sl_n = upd(sl, d.dsl, s_l);
    const float pu_n = upd(pu, d.dpu, act_u), pl_n = upd(pl, d.dpl, act_l);
    const float lu_n = upd(lam_u, d.dlu, act_u), ll_n = upd(lam_l, d.dll, act_l);
    const float mu_n = upd(mu_u, d.dmu, s_u), ml_n = upd(mu_l, d.dml, s_l);
    gw_out[ro] = ok ? gw + al * d.gdw : gw;
    su_out[ro] = su_n;
    sl_out[ro] = sl_n;
    pu_out[ro] = pu_n;
    pl_out[ro] = pl_n;
    lu_out[ro] = lu_n;
    ll_out[ro] = ll_n;
    mu_out[ro] = mu_n;
    ml_out[ro] = ml_n;
    float t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, sgu, sgl;
    barrier(su_n, sl_n, pu_n, pl_n, lu_n, ll_n, mu_n, ml_n, t0, t1, t2, t3, t4, t5, t6, t7, t8,
            t9, sgu, sgl);
    sig_out[ro] = sgu + sgl;
  }
  if (tid == 0) unc_out[b] = unconverged ? 1 : 0;
}

// in: L, G, rw, c0, lb, ub, z1, z2, nt, w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l (19)
// out: w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, sigma (11 float) + unconverged (u8)
extern "C" int ipm_iteration_f32(const float* const* in, float* const* out,
                                 unsigned char* unconverged, int batch, int nz, int ncg,
                                 float gamma_ftb, void* stream) {
  if (batch <= 0) return 0;
  const int nc = ncg + nz;
  if (nz > 32 * MAXR || nc > 1024) return (int)cudaErrorInvalidValue;
  const int ld = nz + 1;
  const size_t smem = sizeof(float) * ((size_t)nz * ld + (size_t)ncg * ld + nc + nz + 32);
  cudaError_t err = cudaFuncSetAttribute(ipm_iter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((nc + 31) / 32) * 32;
  ipm_iter_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10], in[11],
      in[12], in[13], in[14], in[15], in[16], in[17], in[18], out[0], out[1], out[2], out[3],
      out[4], out[5], out[6], out[7], out[8], out[9], out[10], unconverged, nz, ncg, gamma_ftb);
  return (int)cudaGetLastError();
}
