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
// What bounds it: latency. Per scenario it reads ~35 KB (L's lower
// triangle, G and 14 vectors) once and does ~4 (nz^2 + ncg nz) FMAs, but
// the four triangular substitutions are 4 nz dependent steps, and the
// iteration needs block-wide reductions and barriers. The design, one block
// per scenario, one thread per constraint row (its values in registers):
//   * L's lower triangle and G arrive in shared memory by cp.async (16 bytes
//     per lane where nz % 4 == 0 and the pointers are 16-byte aligned, else
//     4), all in flight while the threads load their rows and compute the
//     barrier terms. Row-major with ld = npad + 4 (= 4 mod 8: 16-byte reads
//     of 8 consecutive rows hit distinct banks); L padded to npad = 16
//     ceil(nz / 16) rows with an identity tail, G's columns nz..npad-1 zero,
//     so no inner loop masks a ragged edge;
//   * the substitution (trisolve.cuh, shared with K5 and the K7 solve) is
//     blocked in 16-row blocks and run by warp 0 with x in shared memory: every
//     lane solves the 16 x 16 diagonal block redundantly in registers (no
//     shuffle on the chain; the block's columns are broadcast float4 reads
//     issued a step ahead, from a transposed copy made once per launch),
//     then the lanes update the remaining rows, one row per lane, from 16
//     products. The pivots' reciprocals are taken once per launch; each
//     quotient is a / b within an ulp (div_rn), with no IEEE division and
//     its slow-path branch on the chain. FP32 FMAs only, no tensor cores.
//     (x in registers, gathered by shuffles with the block loops unrolled,
//     was slower: 0.0265 against 0.0227 ms on an H100 80GB HBM3 at 700 W,
//     tools/kernel_breakdown.py, with seven times the substitution's code);
//   * con_tmul G^T y is spread over all threads (each a float4 of columns
//     over a slice of rows, partial sums summed by warp 0 as it assembles
//     the right-hand side); con_mul G dw is one row per thread over float4
//     reads, in two accumulators;
//   * three block reductions (gap with the affine step's minimum; gap_aff;
//     the centred step's minimum with the non-finite count of dw), one
//     barrier each. Both directions run one loop body.
// Limits (ops/kernels/ipm_iter.py::ipm_plan computes the same): 1 <= nz <=
// 128, nc = ncg + nz <= 256 rows (one block of 256 threads, so each thread
// may hold up to 255 registers: warp 0's substitution keeps its block's
// columns in flight beside the row state); shared memory (k4_layout) is
// 64,080 bytes at nz = 76, ncg = 78, so the launch opts in above the
// default 48 KB, once per device and size.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "trisolve.cuh"

constexpr int K4_MAX_NZ = 128;
constexpr int K4_THREADS = 256;      // one per row of the constraint system: nc <= 256
constexpr int MAXR = K4_MAX_NZ / 32;  // rows of rw per lane in warp 0

// Shared-memory layout and thread shape at (nz, ncg); offsets in floats,
// each a multiple of 4 (16-byte aligned).
struct K4Layout {
  int npad, ld, nq, parts, rows_per_part;
  int oG, oinv, odt, oy, ox, opart, ored, floats;
};

__host__ __device__ inline K4Layout k4_layout(int nz, int ncg) {
  K4Layout s;
  const int nc = ncg + nz;
  s.npad = (nz + NB - 1) / NB * NB;
  s.ld = s.npad + 4;
  s.nq = s.npad / 4;                               // float4 columns
  const int p = K4_THREADS / s.nq;                 // row slices of G^T y,
  s.parts = p < ncg ? p : (ncg > 0 ? ncg : 1);     // none of them empty
  s.rows_per_part = (ncg + s.parts - 1) / s.parts;
  s.oG = s.npad * s.ld;                            // L: npad x ld
  s.oinv = s.oG + ncg * s.ld;                      // G: ncg x ld
  s.odt = s.oinv + s.npad;                         // 1 / L_jj
  s.oy = s.odt + s.npad * NB;                      // L's diagonal blocks, transposed
  s.ox = s.oy + (nc + 3) / 4 * 4;                  // y (nc)
  s.opart = s.ox + s.npad;                         // x (npad)
  s.ored = s.opart + s.parts * s.npad;             // G^T y partial sums
  s.floats = s.ored + 3 * 64;                      // 3 reductions' scratch
  return s;
}

// Shared memory stays within a block's 227 KB: 150,272 bytes at nz = 128, nc = 256.
static bool k4_supported(int nz, int ncg) {
  return nz >= 1 && nz <= K4_MAX_NZ && ncg >= 0 && ncg + nz <= K4_THREADS;
}

// (sum of a, NaN-propagating min of m) over the block, one barrier; every
// thread gets both. `scratch`: 64 floats used by this reduction alone.
__device__ __forceinline__ float2 block_sum_min(float a, float m, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = K4_THREADS / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, o);
    m = pmin(m, __shfl_xor_sync(FULL_MASK, m, o));
  }
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = m;
  }
  __syncthreads();
  float sa = 0.0f, sm = scratch[32];
  for (int w = 0; w < nwarps; ++w) sa += scratch[w];
  for (int w = 1; w < nwarps; ++w) sm = pmin(sm, scratch[32 + w]);
  return make_float2(sa, sm);
}

__global__ void __launch_bounds__(K4_THREADS, 1) ipm_iter_kernel(
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
    int nz, int ncg, float gamma_ftb, int vec) {
  extern __shared__ __align__(16) float sm[];
  const K4Layout s = k4_layout(nz, ncg);
  const int nc = ncg + nz, npad = s.npad, ld = s.ld;
  float* sL = sm;
  float* sG = sm + s.oG;
  float* sinv = sm + s.oinv;
  float* sdt = sm + s.odt;
  float* sy = sm + s.oy;
  float* sx = sm + s.ox;
  float* spart = sm + s.opart;
  float* red = sm + s.ored;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = K4_THREADS / 32;

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
  // this thread's entry of w; warp 0 keeps rw for the rows it assembles
  const bool vz = tid < nz;
  const float w = vz ? w_in[(long)b * nz + tid] : 0.0f;
  float rwr[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int z = lane + 32 * r;
    rwr[r] = (warp == 0 && z < nz) ? rw[(long)b * nz + z] : 0.0f;
  }
  const float nt = nt_in[b];

  // ---- L's lower triangle and G into shared memory, asynchronously, behind
  // the row loads above; the barrier terms below compute while they land ----
  const float* Lb = L + (size_t)b * nz * nz;
  const float* Gb = G + (size_t)b * ncg * nz;
  if (vec) {
    for (int i = warp; i < nz; i += nwarps)
      if (4 * lane <= i) cp_async16(sL + i * ld + 4 * lane, Lb + (size_t)i * nz + 4 * lane);
    for (int r = warp; r < ncg; r += nwarps)
      if (4 * lane < nz) cp_async16(sG + r * ld + 4 * lane, Gb + (size_t)r * nz + 4 * lane);
  } else {
    for (int i = warp; i < nz; i += nwarps)
      for (int c = lane; c <= i; c += 32) cp_async4(sL + i * ld + c, Lb + (size_t)i * nz + c);
    for (int r = warp; r < ncg; r += nwarps)
      for (int c = lane; c < nz; c += 32) cp_async4(sG + r * ld + c, Gb + (size_t)r * nz + c);
  }
  for (int i = nz + warp; i < npad; i += nwarps)  // L's identity tail
    for (int c = lane; c <= i; c += 32) sL[i * ld + c] = (c == i) ? 1.0f : 0.0f;
  for (int r = warp; r < ncg; r += nwarps)        // G's zero columns
    for (int c = nz + lane; c < npad; c += 32) sG[r * ld + c] = 0.0f;

  const float v = gw + c0i;
  const float r_pu = act_u ? v + pu - su - ubi : 0.0f;
  const float r_pl = act_l ? pl - v - sl + lbi : 0.0f;

  auto gap_terms = [&](float lu, float pu_, float ll, float pl_, float mu, float su_, float ml,
                       float sl_) {
    return (act_u ? lu * pu_ : 0.0f) + (act_l ? ll * pl_ : 0.0f) + (s_u ? mu * su_ : 0.0f) +
           (s_l ? ml * sl_ : 0.0f);
  };

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
  const float gap_now = gap_terms(lam_u, pu, lam_l, pl, mu_u, su, mu_l, sl);

  cp_async_wait_all();
  __syncthreads();  // sL, sG staged
  // the pivots' reciprocals and the transposed diagonal blocks, for warp 0's
  // substitutions (ordered before them by the first barrier of the loop)
  solve_prep<K4_THREADS>(sL, ld, npad, sdt, sinv, tid);

  // this thread's share of G^T y: a float4 of columns q over one slice of rows
  const int q = tid % s.nq, part = tid / s.nq;
  const int r_lo = part * s.rows_per_part;
  const int r_hi = min(ncg, r_lo + s.rows_per_part);

  // the affine direction (pass 0, tau = 0), then the centred one (pass 1)
  float tau = 0.0f, gap = 0.0f;
  float dw = 0.0f, gdw = 0.0f, dsu = 0.0f, dsl = 0.0f, dpu = 0.0f, dpl = 0.0f;
  float dlu = 0.0f, dll = 0.0f, dmu = 0.0f, dml = 0.0f, alpha = 0.0f;
  bool finite_dw = true;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const float a_u = s_u ? -rs_u + tau / su_s - mu_u : 0.0f;
    const float a_l = s_l ? -rs_l + tau / sl_s - mu_l : 0.0f;
    const float chat_u =
        act_u ? (tau / pu - lam_u + lam_u * r_pu / pu - ipb_u * a_u) / D_u : 0.0f;
    const float chat_l =
        act_l ? (tau / pl - lam_l + lam_l * r_pl / pl - ipb_l * a_l) / D_l : 0.0f;
    if (row) sy[tid] = chat_u - chat_l;
    __syncthreads();
    // rhs = rw + [G; I]' y: partial sums over row slices, summed by warp 0
    if (part < s.parts) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r = r_lo; r < r_hi; ++r) {
        const float4 g = reinterpret_cast<const float4*>(sG + r * ld)[q];
        const float yr = sy[r];
        acc.x = fmaf(g.x, yr, acc.x);
        acc.y = fmaf(g.y, yr, acc.y);
        acc.z = fmaf(g.z, yr, acc.z);
        acc.w = fmaf(g.w, yr, acc.w);
      }
      reinterpret_cast<float4*>(spart + part * npad)[q] = acc;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        const int z = lane + 32 * r;
        if (z < npad) {
          float t = 0.0f;
          for (int p = 0; p < s.parts; ++p) t += spart[p * npad + z];
          sx[z] = (z < nz) ? rwr[r] + (t + sy[ncg + z]) : 0.0f;
        }
      }
      __syncwarp();
      warp_solve_blocked(sL, ld, npad, sdt, sinv, sx, lane);
    }
    __syncthreads();
    // dw = -x; Gdw = [G; I] dw
    dw = vz ? -sx[tid] : 0.0f;
    if (tid < ncg) {
      const float4* g = reinterpret_cast<const float4*>(sG + tid * ld);
      const float4* xv = reinterpret_cast<const float4*>(sx);
      float a0 = 0.0f, a1 = 0.0f;
      for (int c = 0; c < s.nq; ++c) {
        const float4 gc = g[c], xc = xv[c];
        a0 = fmaf(gc.x, xc.x, a0);
        a1 = fmaf(gc.y, xc.y, a1);
        a0 = fmaf(gc.z, xc.z, a0);
        a1 = fmaf(gc.w, xc.w, a1);
      }
      gdw = -(a0 + a1);
    } else {
      gdw = row ? -sx[tid - ncg] : 0.0f;
    }
    dlu = act_u ? chat_u + sig_u * gdw : 0.0f;
    dll = act_l ? chat_l - sig_l * gdw : 0.0f;
    dsu = s_u ? (dlu + a_u) / b_u : 0.0f;
    dsl = s_l ? (dll + a_l) / b_l : 0.0f;
    dmu = s_u ? (tau - mu_u * su - mu_u * dsu) / su_s : 0.0f;
    dml = s_l ? (tau - mu_l * sl - mu_l * dsl) / sl_s : 0.0f;
    dpu = act_u ? dsu - gdw - r_pu : 0.0f;
    dpl = act_l ? dsl + gdw - r_pl : 0.0f;
    // fraction to the boundary
    auto ratio = [](bool m, float x, float dx) { return (m && dx < 0.0f) ? -x / dx : INFINITY; };
    float step = ratio(act_u, lam_u, dlu);
    step = pmin(step, ratio(act_l, lam_l, dll));
    step = pmin(step, ratio(s_u, mu_u, dmu));
    step = pmin(step, ratio(s_l, mu_l, dml));
    step = pmin(step, ratio(act_u, pu, dpu));
    step = pmin(step, ratio(act_l, pl, dpl));
    step = pmin(step, ratio(s_u, su, dsu));
    step = pmin(step, ratio(s_l, sl, dsl));
    if (pass == 0) {
      // the gap and the affine step in one reduction; then the Mehrotra centring
      const float2 r0 = block_sum_min(gap_now, step, red);
      gap = r0.x;
      const float aa = pmin(1.0f, gamma_ftb * r0.y);
      const float gap_aff =
          block_sum_min(gap_terms(lam_u + aa * dlu, pu + aa * dpu, lam_l + aa * dll, pl + aa * dpl,
                                  mu_u + aa * dmu, su + aa * dsu, mu_l + aa * dml, sl + aa * dsl),
                        0.0f, red + 64).x;
      const float ratio_gap = gap_aff / pmax(gap, 1e-30f);
      const float sig_c = pmin(pmax(ratio_gap * ratio_gap * ratio_gap, 1e-4f), 0.99f);
      tau = sig_c * gap / nt;
    } else {
      // the centred step with the count of non-finite entries of dw
      const float2 r2 = block_sum_min((vz && !isfinite(dw)) ? 1.0f : 0.0f, step, red + 128);
      finite_dw = r2.x == 0.0f;
      alpha = pmin(1.0f, gamma_ftb * r2.y);
    }
  }

  // the guarded update
  const bool unconverged = gap > 1e-11f * nt;
  const bool ok = unconverged && finite_dw && isfinite(alpha);
  const float al = alpha;
  auto upd = [&](float x, float dx, bool m) { return (ok && m) ? x + al * dx : x; };
  if (vz) w_out[(long)b * nz + tid] = ok ? w + al * dw : w;
  if (row) {
    const float su_n = upd(su, dsu, s_u), sl_n = upd(sl, dsl, s_l);
    const float pu_n = upd(pu, dpu, act_u), pl_n = upd(pl, dpl, act_l);
    const float lu_n = upd(lam_u, dlu, act_u), ll_n = upd(lam_l, dll, act_l);
    const float mu_n = upd(mu_u, dmu, s_u), ml_n = upd(mu_l, dml, s_l);
    gw_out[ro] = ok ? gw + al * gdw : gw;
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

// Opts the kernel in to `smem` bytes of dynamic shared memory where that is
// above the default 48 KB: one cudaFuncSetAttribute per device and new
// largest size in the process, none at or below 48 KB.
constexpr int K4_MAX_DEVICES = 64;
static cudaError_t reserve_k4_smem(size_t smem) {
  static size_t reserved[K4_MAX_DEVICES] = {};
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < K4_MAX_DEVICES && smem <= reserved[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ipm_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < K4_MAX_DEVICES) reserved[dev] = smem;
  return err;
}

// in: L, G, rw, c0, lb, ub, z1, z2, nt, w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l (19)
// out: w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, sigma (11 float) + unconverged (u8)
extern "C" int ipm_iteration_f32(const float* const* in, float* const* out,
                                 unsigned char* unconverged, int batch, int nz, int ncg,
                                 float gamma_ftb, void* stream) {
  if (batch <= 0) return 0;
  if (!k4_supported(nz, ncg)) return (int)cudaErrorInvalidValue;
  const K4Layout s = k4_layout(nz, ncg);
  const size_t smem = sizeof(float) * (size_t)s.floats;
  const cudaError_t err = reserve_k4_smem(smem);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(in[0]) | reinterpret_cast<uintptr_t>(in[1]);
  const int vec = (nz % 4 == 0) && (ptrs % 16 == 0);
  ipm_iter_kernel<<<batch, K4_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10], in[11],
      in[12], in[13], in[14], in[15], in[16], in[17], in[18], out[0], out[1], out[2], out[3],
      out[4], out[5], out[6], out[7], out[8], out[9], out[10], unconverged, nz, ncg, gamma_ftb,
      vec);
  return (int)cudaGetLastError();
}

// The launch's shape at (nz, ncg), as ops/kernels/ipm_iter.py::ipm_plan gives
// it: plan = {npad, ld, threads, parts, rows_per_part, shared bytes}; returns
// 0, or -1 (plan untouched) where the kernel refuses the shape.
extern "C" int ipm_iteration_plan(int nz, int ncg, int* plan) {
  if (!k4_supported(nz, ncg)) return -1;
  const K4Layout s = k4_layout(nz, ncg);
  const int vals[6] = {s.npad, s.ld, K4_THREADS, s.parts, s.rows_per_part,
                       (int)(sizeof(float) * s.floats)};
  for (int i = 0; i < 6; ++i) plan[i] = vals[i];
  return 0;
}
