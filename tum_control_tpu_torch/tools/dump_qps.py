"""Condensed QPs of a real closed loop, the port's IPM solution of each and
an independent scipy solve beside it (port of tools/dump_qps.py):

    python -m tum_control_tpu_torch.tools.dump_qps [n_qps] [--out Logs/qp_anchor_torch.npz]
        [--device cuda|cpu]

Runs the nominal closed loop of one scenario on Monteblanco for 10 n_qps
steps (default n_qps = 100) and, every 10th step, captures the QP the RTI
engine builds there and the port's IPM solution of it (cold, the engine's
iteration count, one polish step). Each QP is then solved again by scipy's
trust-constr on the explicit-slack formulation of the JAX script (the
program HPIPM solves), in float64 on the host, and the tool prints
max |w_scipy - w_ipm| per QP. It writes the QPs, both solutions and the
scipy failures to --out, by default Logs/qp_anchor_torch.npz, in the layout
of tests/data/qp_anchor.npz, which the JAX package's tests read and this
tool never writes.
"""
import argparse
import os
import sys

import numpy as np
import torch

from tum_control_tpu_torch.tools import common

BIG_THRESH = 1e10
DEFAULT_OUT = os.path.join("Logs", "qp_anchor_torch.npz")
FIELDS = ["H0", "g0", "G", "c0", "lb", "ub", "z1", "z2"]


def solve_qp_scipy(H0, g0, G, c0, lb, ub, z1, z2, n_id):
    """The soft QP by scipy trust-constr with explicit slack variables
    (tools/dump_qps.py::solve_qp_scipy):

    min_{w,su,sl} 0.5 w'H0 w + g0'w + z1'(su+sl) + 0.5 z2'(su^2+sl^2)
    s.t. (soft rows)  v - ub <= su,  lb - v <= sl,  su, sl >= 0
         (hard rows)  lb <= v <= ub,          v = [G; I] w + c0
    Returns (w, scipy's result)."""
    import scipy.sparse as sp
    from scipy.optimize import LinearConstraint, minimize

    nz = H0.shape[0]
    Gfull = np.vstack([G, np.eye(nz)]) if n_id else G
    if Gfull.shape[0] != c0.shape[0]:
        raise ValueError(f"{Gfull.shape[0]} constraint rows against {c0.shape[0]} values of c0")

    act_u = ub < BIG_THRESH
    act_l = lb > -BIG_THRESH
    soft = z2 < 1e6
    iu = np.where(act_u & soft)[0]
    il = np.where(act_l & soft)[0]
    ihu = np.where(act_u & ~soft)[0]
    ihl = np.where(act_l & ~soft)[0]
    nu_, nl_ = len(iu), len(il)
    n = nz + nu_ + nl_

    def split(x):
        return x[:nz], x[nz:nz + nu_], x[nz + nu_:]

    def fun(x):
        w, su, sl = split(x)
        return (0.5 * w @ H0 @ w + g0 @ w + z1[iu] @ su + 0.5 * su @ (z2[iu] * su)
                + z1[il] @ sl + 0.5 * sl @ (z2[il] * sl))

    def jac(x):
        w, su, sl = split(x)
        return np.concatenate([H0 @ w + g0, z1[iu] + z2[iu] * su, z1[il] + z2[il] * sl])

    def hess(x):
        return sp.block_diag([H0, sp.diags(z2[iu]), sp.diags(z2[il])]).tocsr()

    rows, lo, hi = [], [], []
    Zu = np.zeros((nu_, nl_))
    rows.append(np.hstack([-Gfull[iu], np.eye(nu_), Zu]))     # soft upper: su + ub - v >= 0
    lo.append(c0[iu] - ub[iu])
    hi.append(np.full(nu_, np.inf))
    rows.append(np.hstack([Gfull[il], Zu.T, np.eye(nl_)]))    # soft lower: sl - lb + v >= 0
    lo.append(lb[il] - c0[il])
    hi.append(np.full(nl_, np.inf))
    if len(ihu):
        rows.append(np.hstack([-Gfull[ihu], np.zeros((len(ihu), nu_ + nl_))]))
        lo.append(c0[ihu] - ub[ihu])
        hi.append(np.full(len(ihu), np.inf))
    if len(ihl):
        rows.append(np.hstack([Gfull[ihl], np.zeros((len(ihl), nu_ + nl_))]))
        lo.append(lb[ihl] - c0[ihl])
        hi.append(np.full(len(ihl), np.inf))
    rows.append(np.hstack([np.zeros((nu_ + nl_, nz)), np.eye(nu_ + nl_)]))   # slacks >= 0
    lo.append(np.zeros(nu_ + nl_))
    hi.append(np.full(nu_ + nl_, np.inf))
    A = np.vstack(rows)

    res = minimize(fun, np.zeros(n), jac=jac, hess=hess, method="trust-constr",
                   constraints=[LinearConstraint(A, np.concatenate(lo), np.concatenate(hi))],
                   options={"gtol": 1e-12, "xtol": 1e-14, "maxiter": 3000})
    return res.x[:nz], res


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_qps", nargs="?", type=int, default=100)
    ap.add_argument("--out", default=DEFAULT_OUT)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def capture(n_qps, dtype, device, every=10):
    """The closed loop's QPs every `every` steps and the IPM's solutions:
    ([the 8 QP fields as float64 arrays], [w], n_id)."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.ipm import solve_soft_qp_ipm
    from tum_control_tpu_torch.track.planner import planner_emulator

    n_steps = n_qps * every
    sim, x0m, x0s, traj, _ = build_simulation(SimConfig(sim_mode=0, T=n_steps * 0.02),
                                              MPCConfig(), device=device, dtype=dtype)
    ctrl, eng = sim.controller, sim.controller.engine
    carry = sim.init_carry(x0m[None], x0s[None], 0)
    z7 = torch.zeros((1, 7), dtype=dtype, device=device)
    host = lambda t: t[0].double().cpu().numpy()
    qps, ours = [], []
    for i in range(n_steps):
        if i % every == 0:
            window = planner_emulator(traj, carry.pose, sim.Tp, sim.N + 1)[1]
            yref, yref_e = ctrl.make_yref(window)
            qp = eng._build_qp(carry.ctrl_state, carry.x_est, yref, yref_e)[0]
            w_ipm = solve_soft_qp_ipm(qp, n_iters=eng.newton_iters, n_polish=1, n_id=eng.nz)[0]
            qps.append([host(f) for f in qp])
            ours.append(host(w_ipm))
        carry = sim.step(carry, z7, z7)[0]
    return qps, ours, eng.nz


def main(argv=None, dtype=torch.float32):
    """Returns dict(out, qps, w_ipm, w_scipy, scipy_fails, max_diff)."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    qps, ours, n_id = capture(args.n_qps, dtype, device)
    print(f"captured {len(qps)} QPs from {10 * args.n_qps} steps")
    sols, fails = [], 0
    for j, q in enumerate(qps):
        w_sp, res = solve_qp_scipy(*q, n_id=n_id)
        if res.status not in (1, 2):   # gtol / xtol termination
            fails += 1
            print(f"  qp {j}: scipy status {res.status}: {res.message}")
        sols.append(w_sp)
        d = np.abs(w_sp - ours[j]).max()
        if j % 10 == 0 or d > 1e-4:
            print(f"  qp {j}: |w_scipy - w_ipm|_inf = {d:.2e}, "
                  f"u0 diff = {np.abs(w_sp[:2] - ours[j][:2]).max():.2e}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **{f: np.stack([q[k] for q in qps]) for k, f in enumerate(FIELDS)},
                        w_scipy=np.stack(sols), w_ipm_at_dump=np.stack(ours), n_id=n_id,
                        scipy_fails=fails)
    diffs = np.abs(np.stack(sols) - np.stack(ours))
    print(f"saved {args.out}; scipy fails: {fails}; max |w| diff {diffs.max():.3e}; "
          f"max u0 diff {diffs[:, :2].max():.3e}")
    return dict(out=args.out, qps=qps, w_ipm=ours, w_scipy=sols, scipy_fails=fails,
                max_diff=float(diffs.max()))


if __name__ == "__main__":
    main(sys.argv[1:])
