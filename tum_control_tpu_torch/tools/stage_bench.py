"""Per-stage timing of the closed-loop step, each stage chained through its
own carry (port of tools/stage_bench.py):

    python -m tum_control_tpu_torch.tools.stage_bench [batch] [repeats] [controller]
        [--device cuda|cpu]

Stages: planner | build_qp | ipm | full solve | full step, each run
`repeats` times eagerly with its output fed back into its carry as the JAX
script does (the planner's pose moved by 1e-6 of the window's first point,
1e-9 g0 added to U, the IPM's warm start, the RTI state, the closed-loop
carry), so no iteration repeats the last one's work. The JAX script ran the
R iterations inside one lax.scan, one dispatch, so its time was the
device's. Here each iteration issues its kernels one by one, and the tool
prints two times per iteration: the host's time to issue them and the
device's time between CUDA events around the loop. Equal times mean the
device waited for the host (a host-bound stage); a device time above the
host's means the host ran ahead. On the CPU the device time is not
measured.
"""
import argparse
import sys
from types import SimpleNamespace

import torch

from tum_control_tpu_torch.tools import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("repeats", nargs="?", type=int, default=200)
    ap.add_argument("controller", nargs="?", default="nominal")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def setup(controller, batch, dtype, device, x0=None):
    """The per-stage tools' shared inputs: the closed loop of `controller`
    (Monteblanco, sim_mode 0), `batch` starts (`x0`, else
    common.lap_starts), the controller's cold RTI state and IPM warm start,
    the planner window and references at the starts, the engine-level x0
    (SNMPC fans the measured state into its stacked copies), the cold
    closed-loop carry and the QP at the starts."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.track.planner import planner_emulator

    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=2.0),
                                          MPCConfig(controller=controller), device=device,
                                          dtype=dtype)
    ctrl = sim.controller
    eng = ctrl.engine
    x0m = common.lap_starts(traj, batch, dtype, device) if x0 is None else x0
    init = ctrl.init_state(x0m)
    x0e = ctrl._fan(x0m) if hasattr(ctrl, "_fan") else x0m
    window = lambda pose: planner_emulator(traj, pose, sim.Tp, sim.N + 1)[1]
    win = window(x0m[:, :2])
    yref, yref_e = ctrl.make_yref(win)
    z7 = torch.zeros((batch, 7), dtype=dtype, device=device)
    s = SimpleNamespace(sim=sim, ctrl=ctrl, eng=eng, traj=traj, batch=batch, x0m=x0m, x0e=x0e,
                        init=init, window=window, win=win, yref=yref, yref_e=yref_e, z7=z7,
                        carry=sim.init_carry(x0m, x0m[:, :7].contiguous(), 0))
    s.qp = eng._build_qp(init, x0e, yref, yref_e)[0]
    return s


def chained_stages(s):
    """[(name, step, carry0)] of the chained stages on setup's inputs."""
    from tum_control_tpu_torch.ops.ipm import solve_soft_qp_ipm

    eng, N, nu = s.eng, s.eng.N, s.eng.nu

    def plan_step(p):
        return p + 1e-6 * s.window(p).pos[:, 0, :]

    def build_step(st):
        qp = eng._build_qp(st, s.x0e, s.yref, s.yref_e)[0]
        return st._replace(U=st.U + 1e-9 * qp.g0.reshape(s.batch, N, nu))

    def ipm_step(wm):
        return solve_soft_qp_ipm(s.qp, n_iters=eng.newton_iters, n_polish=1, warm=wm,
                                 n_id=eng.nz)[2]

    def solve_step(st):
        return eng.solve(st, s.x0e, s.yref, s.yref_e)[1]

    def full_step(c):
        return s.sim.step(c, s.z7, s.z7)[0]

    return [("planner", plan_step, s.x0m[:, :2]), ("build_qp", build_step, s.init),
            ("ipm", ipm_step, s.init.warm), ("solve", solve_step, s.init),
            ("full step", full_step, s.carry)]


def run_stages(stages, R, device, batch):
    """Times each chained stage; returns {name: dict(host_ms, wall_ms,
    device_ms, launches, carry)}, launches per iteration."""
    out = {}
    for name, step, carry in stages:
        with common.Launches() as n:
            c, host, wall, dev = common.chained(step, carry, R, device)
        out[name] = dict(host_ms=host, wall_ms=wall, device_ms=dev, carry=c,
                         launches={k: v / (R + 1) for k, v in n.counts.items()})
        print(f"{name:14s}: host {host:9.3f} ms/iter, device {common.fmt_ms(dev)}/iter "
              f"(wall {wall:.3f} ms/iter); hand-written launches/iter "
              f"{out[name]['launches']}", flush=True)
    return out


def main(argv=None, dtype=torch.float32):
    """Returns {stage: dict(host_ms, wall_ms, device_ms, launches, carry)}
    and, under "solves_per_s", the batch over the full step's wall time."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    s = setup(args.controller, args.batch, dtype, device)
    print(f"batch={args.batch} repeats={args.repeats} controller={args.controller}", flush=True)
    out = run_stages(chained_stages(s), args.repeats, device, args.batch)
    out["solves_per_s"] = args.batch / out["full step"]["wall_ms"] * 1e3
    print(f"-> {out['solves_per_s']:,.0f} solves/s", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
