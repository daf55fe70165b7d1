"""Per-stage timing and kernel counts of one batched closed-loop step (port
of tools/profile_step.py):

    python -m tum_control_tpu_torch.tools.profile_step [batch] [--controller nominal [snmpc ...]]
        [--repeats 20] [--device cuda|cpu]

Stages, each called on the same inputs: planner | build_qp (linearize,
condense, assemble) | ipm+polish | solve (all of the RTI step) |
plant+estimator (the loop's own plant integration, `ClosedLoopSim.
integrate_plant`, at a zero input, and the estimator) | full
step. Beside each stage's time per call on the host's clock
(synchronized), it prints what one torch.profiler window of one call
shows: the device kernels the stage launches, their device time and that
of the hand-written kernels among them; and the hand-written kernels'
launches by name (ops/kernels/build.py::LAUNCHES). Every stage of every
controller named is timed before the first profiler window: a profiler
session slows the host's launches for the rest of the process.
planner + solve + plant+estimator is
what the full step does besides re-initializing failed solves and logging;
the tool prints their kernel counts' sum beside the full step's. On the CPU
the device columns are not measured.
"""
import argparse
import sys

import torch

from tum_control_tpu_torch.tools import common
from tum_control_tpu_torch.tools.stage_bench import setup


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("--controller", nargs="+", default=["nominal"])
    ap.add_argument("--repeats", type=int, default=20, help="calls per timed stage")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def stages(s):
    """[(name, fn)]: each stage as a call on setup's inputs."""
    from tum_control_tpu_torch.ops.ipm import solve_soft_qp_ipm
    from tum_control_tpu_torch.sim.estimator import estimate

    sim, eng = s.sim, s.eng
    u_plant = torch.zeros_like(s.x0m[:, :2])   # [a, steering rate]

    def plant_est():
        x7 = sim.integrate_plant(s.carry.x_sim, u_plant)
        return estimate(s.carry.est_state, torch.cat([x7, u_plant[:, :1]], dim=1))[0]

    return [
        ("planner", lambda: s.window(s.x0m[:, :2])),
        ("build_qp", lambda: eng._build_qp(s.init, s.x0e, s.yref, s.yref_e)[0]),
        ("ipm+polish", lambda: solve_soft_qp_ipm(s.qp, n_iters=eng.newton_iters, n_polish=1,
                                                 warm=s.init.warm, n_id=eng.nz)[0]),
        ("solve (all)", lambda: eng.solve(s.init, s.x0e, s.yref, s.yref_e)[0]),
        ("plant+estimator", plant_est),
        ("full step", lambda: sim.step(s.carry, s.z7, s.z7)[0].x_sim),
    ]


def main(argv=None, dtype=torch.float32):
    """Returns {controller: {stage: dict(ms, kernels, device_ms, hand_ms,
    launches, out)}}: host ms per call, device kernels, their device ms and
    the hand-written kernels' device ms per call (None on the CPU),
    hand-written launches by kernel per call, and the stage's output."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    runs = {c: stages(setup(c, args.batch, dtype, device)) for c in args.controller}
    res = {c: {} for c in runs}
    for c, sts in runs.items():
        for name, fn in sts:
            with common.Launches() as n:
                out = fn()
            ms = common.host_ms(fn, args.repeats, device)
            res[c][name] = dict(ms=ms, launches=n.counts, out=out)
    for c, sts in runs.items():
        for name, fn in sts:
            prof = common.profile_call(fn, device)
            res[c][name].update(zip(("kernels", "device_ms", "hand_ms"),
                                    prof or (None, None, None)))
    for c, rc in res.items():
        print(f"batch={args.batch} controller={c} ({args.repeats} calls a stage)")
        for name, r in rc.items():
            kern = common.NOT_MEASURED if r["kernels"] is None else f"{r['kernels']:5.0f} kernels"
            print(f"{name:16s}: {r['ms']:8.3f} ms | device {common.fmt_ms(r['device_ms'])} in "
                  f"{kern} (hand-written {common.fmt_ms(r['hand_ms'])}) | launches "
                  f"{r['launches']}")
        full = rc["full step"]
        print(f"full step -> {args.batch / full['ms'] * 1e3:,.0f} solves/s")
        if full["kernels"] is not None:
            parts = sum(rc[k]["kernels"] for k in ("planner", "solve (all)", "plant+estimator"))
            print(f"kernels: planner + solve + plant+estimator {parts:.0f}, full step "
                  f"{full['kernels']:.0f} (the rest: re-initialization and the log)")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
