"""Multi-objective BO of the NMPC cost weights on the GPU (the port's
counterpart of the root bo_optimize.py):

    python -m tum_control_tpu_torch.bo_optimize [--initial 50] [--iterations 400]
        [--batch 5] [--out Logs/bo_trials_torch.csv] [--export F.csv]
        [--resume CSV] [--seed-params CSV] [--device cuda|cpu] [--smoke]

Each candidate weight set is evaluated by batched closed-loop rollouts over
curvature-segmented track pieces (high / low curvature groups, alternating
per iteration), every (candidate, segment) pair one scenario on its own lap;
the rollouts and the GP / acquisition math run on `--device` (cuda by
default: without a card the run raises unless `--device cpu` is given).
Writes the trials CSV (`--out`, the reference's layout) after every
iteration and, with `--export`, the reduced Pareto parameter sets.
"""
import argparse
import os

import numpy as np

from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.learn.bo.objective import ObjectiveEvaluator, make_segment_batch
from tum_control_tpu_torch.learn.bo.optimizer import BayesianOptimizer, BOConfig
from tum_control_tpu_torch.learn.bo.postprocess import export_parameter_sets
from tum_control_tpu_torch.learn.bo.segmentation import get_train_segments
from tum_control_tpu_torch.track.trajectory import load_ref_trajectory, stack_trajectories

TRACKS = ["modena", "monteblanco"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--initial", type=int, default=50)
    ap.add_argument("--iterations", type=int, default=400)
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--out", default="Logs/bo_trials_torch.csv")
    ap.add_argument("--export", default=None, help="export reduced Pareto sets to CSV")
    ap.add_argument("--resume", default=None, help="load trials CSV before optimizing")
    ap.add_argument("--seed-params", default=None,
                    help="CSV of known parameter sets to evaluate as initial trials")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--smoke", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    sim_cfg = SimConfig(sim_mode=0)
    sim, *_ = build_simulation(sim_cfg, MPCConfig(), device=device)
    dtype = sim.controller.engine.W.dtype
    stacked = stack_trajectories([
        load_ref_trajectory(os.path.join(sim_cfg.trajectory_path, f"reftraj_{t}_edgar.json"),
                            dtype=dtype, device=device)
        for t in TRACKS
    ])
    groups = get_train_segments(tracks=TRACKS)
    if args.smoke:
        groups = [g[:2] for g in groups]
    print(f"segments: high-curv {len(groups[0])}, low-curv {len(groups[1])}")

    evaluator = ObjectiveEvaluator(sim, stacked, max_steps=120 if args.smoke else 1500)
    evaluators = [lambda p, seg=make_segment_batch(g, TRACKS, device): evaluator.evaluate(p, seg)
                  for g in groups]
    cfg = BOConfig(
        n_initial=4 if args.smoke else args.initial,
        n_bayesian_optimization=2 if args.smoke else args.iterations,
        batch_size=2 if args.smoke else args.batch,
        n_mc=16 if args.smoke else 64,
    )
    bo = BayesianOptimizer(evaluators, cfg, device=device)
    if args.resume and os.path.exists(args.resume):
        bo.load_trials(args.resume)
    else:
        if args.seed_params:
            seeds = np.loadtxt(args.seed_params, delimiter=",")
            bo._evaluate(bo._norm(seeds), group=0)
            print(f"seeded {len(seeds)} known parameter sets")
        bo.generate_initial_data()
        n_feas = sum(bool(np.asarray(t.feasible).any()) for t in bo.trials)
        print(f"initial data: {len(bo.trials)} trials, any-group feasible {n_feas}")

    for it in range(cfg.n_bayesian_optimization):
        bo.step(it)
        hv = [bo.hypervolume(g) for g in range(2)]
        nf = [sum(bool(np.asarray(t.feasible).reshape(-1)[g]) for t in bo.trials)
              for g in range(2)]
        print(f"iter {it}: trials={len(bo.trials)} feasible/group={nf} hypervolume={hv}",
              flush=True)
        bo.store_trials(args.out)

    if args.export:
        table = export_parameter_sets(bo.trials, args.export)
        print(f"exported {len(table)} parameter sets to {args.export}")


if __name__ == "__main__":
    main()
