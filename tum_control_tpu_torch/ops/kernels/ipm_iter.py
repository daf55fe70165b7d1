"""K4: one fused Mehrotra IPM iteration, batched over scenarios.

Port of tum_control_tpu/ops/pallas_kernels/ipm_iter.py (`_make_kernel`,
launched by `fused_iteration_batched`). The constraint system is the ncg
general rows G followed by nz identity rows over w (n_id = nz), the only
layout the RTI engine builds.

  * `iteration_ref`: the plain PyTorch version, a batched `iteration_ref`
    of the JAX package (the same residuals, barrier algebra, affine and
    centred directions, fraction-to-boundary step, Mehrotra centring and
    guarded update);
  * `fused_iteration`: the wrapper. CPU tensors -> `iteration_ref`; CUDA
    float32 tensors -> csrc/ipm_iter.cu; anything else raises;
  * `ipm_plan`: the kernel's launch shape at (nz, ncg), and a raise for
    shapes it refuses, before any launch.

Carry order (10 tensors): w (B,nz), Gw, su, sl, pu, pl, lam_u, lam_l, mu_u,
mu_l (B,nc). Returns (carry', sigma (B,nc), unconverged (B,) bool).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tum_control_tpu_torch.ops.diffmode import kernel_with_plain_vjp
from tum_control_tpu_torch.ops.kernels import build
from tum_control_tpu_torch.ops.kernels.chol import chol_solve_ref

MAX_NZ = 128          # csrc/ipm_iter.cu::K4_MAX_NZ
THREADS = 256         # K4_THREADS: one thread per constraint row, nc <= 256
BLOCK = 16            # NB, the substitution's block


class IpmPlan(NamedTuple):
    """Launch shape of csrc/ipm_iter.cu at (nz, ncg) (its `k4_layout`): L
    padded to `npad` rows, L and G row-major in shared memory with leading
    dimension `ld`; `threads` per block (256, one per constraint row;
    rows past nc are inert); G^T y split into `parts` slices of
    `rows_per_part` rows; `smem_bytes` of shared memory (L, G, 1 / L_jj,
    L's diagonal blocks transposed, y, x, the partial sums, 3 x 64 floats
    of reduction scratch; at most 150,272 at nz = 128, nc = 256).
    `max_registers` per thread is the cap that `__launch_bounds__(256, 1)`
    leaves, the hardware's 255."""
    npad: int
    ld: int
    threads: int
    parts: int
    rows_per_part: int
    smem_bytes: int
    max_registers: int


def ipm_plan(nz: int, ncg: int) -> IpmPlan:
    """The K4 kernel's launch shape; raises for nz outside 1..MAX_NZ,
    ncg < 0 or nc = ncg + nz > THREADS."""
    nc = ncg + nz
    if not 1 <= nz <= MAX_NZ or ncg < 0 or nc > THREADS:
        raise ValueError(f"the ipm_iter kernel takes 1 <= nz <= {MAX_NZ}, ncg >= 0 and "
                         f"ncg + nz <= {THREADS}; got nz = {nz}, ncg = {ncg}")
    npad = -(-nz // BLOCK) * BLOCK
    ld = npad + 4   # = 4 mod 8: 16-byte reads of 8 consecutive rows hit distinct banks
    parts = max(1, min(THREADS // (npad // 4), ncg))
    rows_per_part = -(-ncg // parts)
    floats = (npad * ld + ncg * ld + npad + npad * BLOCK + -(-nc // 4) * 4 + npad
              + parts * npad + 3 * 64)
    return IpmPlan(npad, ld, THREADS, parts, rows_per_part, 4 * floats, 255)


def masks_of(lb, ub, z2):
    act_u = ub < 1e10
    act_l = lb > -1e10
    soft = z2 < 1e6
    return act_u, act_l, act_u & soft, act_l & soft


def _barrier_terms(su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l):
    one = torch.ones_like(su)
    zero = torch.zeros_like(su)
    su_s = torch.where(s_u, su, one)
    sl_s = torch.where(s_l, sl, one)
    rs_u = z1 + z2 * su - lam_u - mu_u
    rs_l = z1 + z2 * sl - lam_l - mu_l
    b_u = z2 + mu_u / su_s
    b_l = z2 + mu_l / sl_s
    ipb_u = torch.where(s_u, lam_u / (pu * b_u), zero)
    ipb_l = torch.where(s_l, lam_l / (pl * b_l), zero)
    D_u = 1.0 + ipb_u
    D_l = 1.0 + ipb_l
    sig_u = torch.where(act_u, lam_u / (pu * D_u), zero)
    sig_l = torch.where(act_l, lam_l / (pl * D_l), zero)
    return su_s, sl_s, rs_u, rs_l, b_u, b_l, ipb_u, ipb_l, D_u, D_l, sig_u, sig_l


def sigma_of(su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l):
    """sig_u + sig_l for the normal-matrix product H = H0 + G' diag(sig) G."""
    *_, sig_u, sig_l = _barrier_terms(
        su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l
    )
    return sig_u + sig_l


def iteration_ref(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb: float = 0.99):
    """One Mehrotra iteration from the Cholesky factor L (B,nz,nz) of the
    current normal matrix and the stationarity residual
    rw = H0 w + g0 + [G; I]'(lam_u - lam_l) (B,nz)."""
    w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l = carry
    ncg = G.shape[1]
    act_u, act_l, s_u, s_l = masks_of(lb, ub, z2)
    zero = torch.zeros_like(c0)
    inf = torch.full_like(c0, float("inf"))

    def con_mul(x):
        return torch.cat([torch.matmul(G, x[..., None])[..., 0], x], dim=1)

    def con_tmul(y):
        return torch.matmul(y[:, None, :ncg], G)[:, 0] + y[:, ncg:]

    def total_gap(lu, pu_, ll, pl_, mu, su_, ml, sl_):
        return torch.sum(
            torch.where(act_u, lu * pu_, zero) + torch.where(act_l, ll * pl_, zero)
            + torch.where(s_u, mu * su_, zero) + torch.where(s_l, ml * sl_, zero),
            dim=1,
        )

    v = Gw + c0
    r_pu = torch.where(act_u, v + pu - su - ub, zero)
    r_pl = torch.where(act_l, pl - v - sl + lb, zero)
    gap = total_gap(lam_u, pu, lam_l, pl, mu_u, su, mu_l, sl)
    (su_s, sl_s, rs_u, rs_l, b_u, b_l, ipb_u, ipb_l, D_u, D_l, sig_u, sig_l) = _barrier_terms(
        su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l
    )

    def directions(tau):
        t = tau[:, None]
        a_u = torch.where(s_u, -rs_u + t / su_s - mu_u, zero)
        a_l = torch.where(s_l, -rs_l + t / sl_s - mu_l, zero)
        chat_u = torch.where(act_u, (t / pu - lam_u + lam_u * r_pu / pu - ipb_u * a_u) / D_u, zero)
        chat_l = torch.where(act_l, (t / pl - lam_l + lam_l * r_pl / pl - ipb_l * a_l) / D_l, zero)
        dw = -chol_solve_ref(L, rw + con_tmul(chat_u - chat_l))
        Gdw = con_mul(dw)
        dlam_u = torch.where(act_u, chat_u + sig_u * Gdw, zero)
        dlam_l = torch.where(act_l, chat_l - sig_l * Gdw, zero)
        dsu = torch.where(s_u, (dlam_u + a_u) / b_u, zero)
        dsl = torch.where(s_l, (dlam_l + a_l) / b_l, zero)
        dmu_u = torch.where(s_u, (t - mu_u * su - mu_u * dsu) / su_s, zero)
        dmu_l = torch.where(s_l, (t - mu_l * sl - mu_l * dsl) / sl_s, zero)
        dpu = torch.where(act_u, dsu - Gdw - r_pu, zero)
        dpl = torch.where(act_l, dsl + Gdw - r_pl, zero)
        step = None
        for x, dx, m in ((lam_u, dlam_u, act_u), (lam_l, dlam_l, act_l), (mu_u, dmu_u, s_u),
                         (mu_l, dmu_l, s_l), (pu, dpu, act_u), (pl, dpl, act_l),
                         (su, dsu, s_u), (sl, dsl, s_l)):
            neg = dx < 0
            r = torch.where(m & neg, -x / torch.where(neg, dx, -torch.ones_like(dx)), inf)
            r = torch.amin(r, dim=1)
            step = r if step is None else torch.minimum(step, r)
        alpha = torch.minimum(gamma_ftb * step, torch.ones_like(step))  # NaN propagates
        return (dw, Gdw, dsu, dsl, dpu, dpl, dlam_u, dlam_l, dmu_u, dmu_l), alpha

    d_aff, alpha_aff = directions(torch.zeros_like(gap))
    _, _, dsu_a, dsl_a, dpu_a, dpl_a, dlu_a, dll_a, dmu_a, dml_a = d_aff
    aa = alpha_aff[:, None]
    gap_aff = total_gap(
        lam_u + aa * dlu_a, pu + aa * dpu_a, lam_l + aa * dll_a, pl + aa * dpl_a,
        mu_u + aa * dmu_a, su + aa * dsu_a, mu_l + aa * dml_a, sl + aa * dsl_a,
    )
    sig_c = torch.clamp((gap_aff / torch.clamp(gap, min=1e-30)) ** 3, 1e-4, 0.99)
    tau = sig_c * gap / nt

    (dw, Gdw, dsu, dsl, dpu, dpl, dlam_u, dlam_l, dmu_u, dmu_l), alpha = directions(tau)

    unconverged = gap > 1e-11 * nt
    ok = unconverged & torch.all(torch.isfinite(dw), dim=1) & torch.isfinite(alpha)
    okr = ok[:, None]
    al = alpha[:, None]

    def upd(x, dx, m):
        return torch.where(okr & m, x + al * dx, x)

    w = torch.where(okr, w + al * dw, w)
    Gw = torch.where(okr, Gw + al * Gdw, Gw)
    su, sl = upd(su, dsu, s_u), upd(sl, dsl, s_l)
    pu, pl = upd(pu, dpu, act_u), upd(pl, dpl, act_l)
    lam_u, lam_l = upd(lam_u, dlam_u, act_u), upd(lam_l, dlam_l, act_l)
    mu_u, mu_l = upd(mu_u, dmu_u, s_u), upd(mu_l, dmu_l, s_l)
    sig_next = sigma_of(su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l)
    return (w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l), sig_next, unconverged


def fused_iteration_cuda(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb: float = 0.99):
    """Launch csrc/ipm_iter.cu; all inputs contiguous CUDA float32."""
    B, ncg, nz = G.shape
    nc = ncg + nz
    ipm_plan(nz, ncg)
    shapes = [(B, nz, nz), (B, ncg, nz), (B, nz)] + [(B, nc)] * 5 + [(B,), (B, nz)] + [(B, nc)] * 9
    ins = (L, G, rw, c0, lb, ub, z1, z2, nt) + tuple(carry)
    for t, s in zip(ins, shapes):
        if tuple(t.shape) != s:
            raise ValueError(f"ipm_iter: expected shape {s}, got {tuple(t.shape)}")
    fn = build.library("ipm_iter").ipm_iteration_f32
    outs = [torch.empty_like(x) for x in carry] + [torch.empty_like(c0)]
    unc = torch.empty((B,), dtype=torch.bool, device=G.device)
    in_ptrs = (ctypes.c_void_p * 19)(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in outs])
    with torch.cuda.device(G.device):
        status = fn(ctypes.cast(in_ptrs, ctypes.c_void_p), ctypes.cast(out_ptrs, ctypes.c_void_p),
                    build.ptr(unc), B, nz, ncg, gamma_ftb, build.stream_of(G))
    build.check_status("ipm_iteration_f32", status)
    build.LAUNCHES["ipm_iteration"] += 1
    return tuple(outs[:10]), outs[10], unc


def fused_iteration(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb: float = 0.99):
    """One batched Mehrotra iteration; dispatches by device (module doc)."""
    if build.use_kernel(L, G, rw, c0, lb, ub, z1, z2, nt, *carry):
        def flat(fn):  # (19 tensors) -> carry' (10), sigma, unconverged
            def run(*a):
                out, sig, unc = fn(*a[:9], a[9:], gamma_ftb)
                return (*out, sig, unc)
            return run

        *out, sig, unc = kernel_with_plain_vjp(flat(fused_iteration_cuda), flat(iteration_ref),
                                               L, G, rw, c0, lb, ub, z1, z2, nt, *carry)
        return tuple(out), sig, unc
    return iteration_ref(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb)
