"""Roofline accounting of the batched nominal closed-loop step on the card
(port of tools/roofline.py):

    python -m tum_control_tpu_torch.tools.roofline [batches...] [--steps 200]
        [--device cuda|cpu]

Per batch (default 64 128 256 512 1024):
  1. `kernel_model`: the work of the hand-written kernels per scenario-step
     (K1's RK4 rollout and its tangents, K2's Gamma recurrence, the
     Cholesky and the two substitutions per IPM iteration and polish), the
     JAX script's `pallas_model` formulas, so that the roofline reads the
     same work whatever implements it;
  2. the wall time per step of `steps` closed-loop steps (synchronized,
     after as many untimed ones);
  3. the achieved FLOP/s and bytes/s of that work, and the roofline time
     max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s) (the H100 SXM's float32 rate
     outside the tensor cores and its HBM3 rate) against the step.
The JAX script added XLA's post-fusion cost analysis of everything outside
the Pallas kernels; PyTorch has no counterpart, so the ops outside the
hand-written kernels are reported by count and device time from one
torch.profiler window per batch (after every timed run: a profiler session
slows the host's later launches), not by their work. The per-stage chained
times (stage_bench.py) at the smallest and the largest batch localize how
the step scales. On the CPU the device columns are not measured.
"""
import argparse
import sys

import torch

from tum_control_tpu_torch.tools import common

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
PEAK_F32_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores


def kernel_model(N=38, nx=8, nu=2, qp_iters=4, n_polish=1, substeps=3):
    """(FLOPs, device-memory bytes) per scenario-step of the hand-written
    kernels, float32 (4 bytes), tools/roofline.py::pallas_model's formulas:

    linearize: RK4 x substeps of the 8-state ODE (~250 FLOPs an evaluation
      with the Pacejka trigonometry) x 4 stages, once for the value and once
      per (nx + nu) = 10 forward tangents, per stage element;
    condense: per stage (nx, nx) @ (nx, nz + 1) and (nx, nu) @ (nu, nz);
    Cholesky: one (nz, nz) factorization and two triangular solves per IPM
      iteration and polish;
    bytes: the kernels' operands and results only.
    """
    f32 = 4
    nz = N * nu
    ode = 250.0
    lin_flops = N * (ode * 4 * substeps) * (1 + nx + nu)
    lin_bytes = N * (10 + nx + nx * (nx + nu)) * f32
    cond_flops = N * (2 * nx * nx * (nz + 1) + 2 * nx * nu * nz)
    cond_bytes = N * (nx * nx + nx * nu + nx) * f32 + (N + 1) * (nx + nx * nz) * f32
    it = qp_iters + n_polish
    chol_flops = it * (nz**3 / 3 + 2 * 2 * nz * nz)
    chol_bytes = it * (2 * nz * nz) * f32
    return (lin_flops + cond_flops + chol_flops,
            lin_bytes + cond_bytes + chol_bytes)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batches", nargs="*", type=int, default=[64, 128, 256, 512, 1024])
    ap.add_argument("--steps", type=int, default=200, help="timed steps a batch")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns dict(model=(FLOPs, bytes) per scenario-step, rows=[dict(batch,
    ms, solves_per_s, gflops, gbs, roofline_ms, roofline_share, kernels,
    device_ms, hand_ms, other_ms)], stages={batch: {stage: us per
    scenario-step}})."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios
    from tum_control_tpu_torch.tools.stage_bench import chained_stages, setup

    args = parse_args(argv)
    device = common.start(args, dtype)
    R = args.steps
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=R * 0.02), MPCConfig(),
                                          device=device, dtype=dtype)
    p_flops, p_bytes = kernel_model(qp_iters=MPCConfig().qp_iters)
    print(f"hand-written kernels' work per scenario-step: {p_flops / 1e6:.2f} MFLOP, "
          f"{p_bytes / 1e3:.1f} KB")
    rows, starts = [], {}
    for batch in args.batches:
        starts[batch] = batched_scenarios(traj, batch, dtype=dtype, device=device)
        x0m, x0s = starts[batch]
        ms = common.host_ms(lambda: sim.run(x0m, x0s, R), 1, device) / R
        flops, byts = p_flops * batch, p_bytes * batch
        t_roof = max(flops / PEAK_F32_PER_S, byts / PEAK_BYTES_PER_S) * 1e3
        rows.append(dict(batch=batch, ms=ms, solves_per_s=batch / ms * 1e3,
                         gflops=flops / ms / 1e6, gbs=byts / ms / 1e6, roofline_ms=t_roof,
                         roofline_share=t_roof / ms))
    stages = {}
    for batch in sorted({args.batches[0], args.batches[-1]}):
        s = setup("nominal", batch, dtype, device, x0=starts[batch][0])
        stages[batch] = {}
        for name, step, carry in chained_stages(s):
            if name in ("build_qp", "ipm", "full step"):
                wall = common.chained(step, carry, R, device)[2]
                stages[batch][name] = wall / batch * 1e3
    for r in rows:
        x0m, x0s = starts[r["batch"]]
        prof = common.profile_call(lambda: sim.run(x0m, x0s, 2), device)
        kern, dev_ms, hand_ms = (None,) * 3 if prof is None else (v / 2 for v in prof)
        r.update(kernels=kern, device_ms=dev_ms, hand_ms=hand_ms,
                 other_ms=None if prof is None else dev_ms - hand_ms)

    print(f"card: {common.card(device)}; peaks {PEAK_F32_PER_S / 1e12:.0f} TFLOP/s float32, "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
    print(f"{'batch':>6} {'ms/step':>8} {'solves/s':>9} {'GFLOP/s':>8} {'GB/s':>7} "
          f"{'roof ms':>8} {'roofline%':>9}  device per step (profiler)")
    for r in rows:
        dev = (common.NOT_MEASURED if r["kernels"] is None else
               f"{r['kernels']:.0f} kernels, {r['device_ms']:.3f} ms: hand-written "
               f"{r['hand_ms']:.3f} ms, the other ops {r['other_ms']:.3f} ms")
        print(f"{r['batch']:>6} {r['ms']:8.3f} {r['solves_per_s']:9.1f} {r['gflops']:8.2f} "
              f"{r['gbs']:7.2f} {r['roofline_ms']:8.5f} {r['roofline_share'] * 100:8.3f}%  {dev}")
    lo, hi = min(stages), max(stages)
    print(f"per-stage wall time, batch {lo} vs {hi} (us per scenario-step):")
    for k in stages[lo]:
        a, b = stages[lo][k], stages[hi][k]
        print(f"  {k:10s}: {a:9.3f} -> {b:9.3f}  ({b / a:.2f}x)")
    return dict(model=(p_flops, p_bytes), rows=rows, stages=stages)


if __name__ == "__main__":
    main(sys.argv[1:])
