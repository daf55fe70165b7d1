"""SNMPC's QP assembly taken apart: which sub-stage costs what (port of
tools/snmpc_dissect.py):

    python -m tum_control_tpu_torch.tools.snmpc_dissect [batch] [repeats] [--device cuda|cpu]

Four stages, each chained through its carry as the JAX script chains them:
lin_condense (the engine's hook: K1, the head recurrence, K6 and the dense
(N+1, 88, nz) Gamma; 1e-9 of e fed back into U) | constraint rows (con_jac
and the rows' products with e and Gamma; 1e-12 of the first row fed back) |
cost blocks (y_jac, y_term's Jacobian and the Gauss-Newton assembly;
1e-12 of the sums of g0 and H0 fed back) | the full structured _build_qp.
Per iteration: the host's time to issue it and the device's between CUDA
events around the loop (stage_bench.py says how to read the two).
"""
import argparse
import sys

import torch

from tum_control_tpu_torch.tools import common
from tum_control_tpu_torch.tools.stage_bench import run_stages, setup


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("repeats", nargs="?", type=int, default=100)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def dissect_stages(s):
    """[(name, step, carry0)] of the four chained stages on setup's inputs."""
    from tum_control_tpu_torch.ops.rti import jacobian_fwd

    eng, f = s.eng, s.eng.funcs
    N, nu = eng.N, eng.nu
    X0, U0 = s.init.X, s.init.U

    def lc_step(st):
        e, _ = f.lin_condense(st.X, st.U, s.x0e - st.X[:, 0])
        return st._replace(U=st.U + 1e-9 * e[:, :N, :nu])

    def con_step(eG):
        e, Gam = eG
        C, Jc = f.con_jac(X0)
        c0_c = C + torch.matmul(Jc, e[..., None])[..., 0]
        G_c = torch.matmul(Jc, Gam)
        return e + 1e-12 * c0_c[:, :, :1], Gam + 1e-12 * G_c[:, :, :1, :]

    def cost_step(eG):
        e, Gam = eG
        Y, Jyx, Jyu = f.y_jac(X0[:, :-1], U0)
        r0 = Y - s.yref + torch.matmul(Jyx, e[:, :N, :, None])[..., 0]
        M = torch.matmul(Jyx, Gam[:, :N]) + torch.matmul(Jyu, eng.E)
        yt, Jye = jacobian_fwd(f.y_term, X0[:, N])
        re0 = yt - s.yref_e + torch.matmul(Jye, e[:, N, :, None])[..., 0]
        H0, g0 = eng._gn_assemble(r0, M, re0, torch.matmul(Jye, Gam[:, N]), eng.W, eng.We)
        s1 = g0.sum(-1)[:, None, None]
        s2 = H0.sum((-2, -1))[:, None, None, None]
        return e + 1e-12 * s1, Gam + 1e-12 * s2

    def build_step(st):
        qp = eng._build_qp(st, s.x0e, s.yref, s.yref_e)[0]
        return st._replace(U=st.U + 1e-9 * qp.g0.reshape(s.batch, N, nu))

    eG = f.lin_condense(X0, U0, s.x0e - X0[:, 0])
    return [("lin_condense", lc_step, s.init), ("con rows", con_step, eG),
            ("cost blocks", cost_step, eG), ("full build_qp", build_step, s.init)]


def main(argv=None, dtype=torch.float32):
    """Returns {stage: dict(host_ms, wall_ms, device_ms, launches, carry)}."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    s = setup("snmpc", args.batch, dtype, device)
    print(f"batch={args.batch} repeats={args.repeats} nx={s.eng.nx} nz={s.eng.nz}", flush=True)
    return run_stages(dissect_stages(s), args.repeats, device, args.batch)


if __name__ == "__main__":
    main(sys.argv[1:])
