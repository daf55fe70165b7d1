"""Readings from which the limits of benchmark/limits/<cell>.json are set:
the program's numbers over many seeds, and the control's.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1,S2,... --seconds <s>
        [--control-seeds S1,S2,S3] [--fault <name>]

On the card. For each seed: the cell's run as the benchmark makes it
(warm-up, a window of `--seconds` at the cell's own load, the same seeded
sample of steps) and the float64 reference over the sample: the program's
numbers (compare.numbers, and compare.extremes beside them). For each
control seed, the control is the
reference itself put in the program's place and computed one precision
below the configuration's float32: float32 with TF32 matmuls, from the same
sampled carries; its numbers against the float64 reference must exceed the
limits. Besides the numbers compared, it prints the widest and the mean
gaps, and `dual_gap` (the interior-point warm start), and, at the three widest
control gaps, the plain float32 reference's own gap (a second float32
evaluation of the step), and the five largest pair scores (each pair's
widest gap over its number's limit: above compare.PAIR_FACTOR a pair is
off). With `--fault` the program runs with that fault of
benchmark/faults.py planted under its step, and its numbers are the
fault's readings. One JSON line per seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def dual_gap(samples, outs) -> float:
    """|warm (program) - (reference)| / max(1, |reference|), the widest over
    the interior-point warm start's entries."""
    import torch

    gap = 0.0
    for s, out in zip(samples, outs):
        for a, b in zip(s["after"]["warm"], out["warm"]):
            a = a.to(b.device, b.dtype)
            gap = max(gap, float(((a - b).abs() / torch.clamp(b.abs(), min=1.0)).amax()))
    return gap


def top_scores(g, limits, k=5) -> list:
    """The k largest pair scores (compare.pair_scores)."""
    from benchmark.compare import pair_scores

    s = pair_scores(g, limits)
    return [float(v) for v in s.topk(min(k, s.numel())).values]


def main(argv=None):
    import contextlib

    import torch

    from benchmark import run as R
    from benchmark.compare import extremes, gaps, in_place_of_program, numbers
    from benchmark.faults import FAULTS, planted
    from benchmark.reference.closed_loop import Reference, tf32

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args(argv)
    spec = R.load_spec()
    cell = R.cell_of(spec, args.workload)
    device = torch.device(args.device)
    import importlib
    from types import SimpleNamespace
    driver = importlib.import_module(f"benchmark.driver_{cell.traffic['driver']}")
    with tf32(False):
        ref64 = Reference(cell.cfg, ROOT, dtype=torch.float64, device=device)
    ctrl = Reference(cell.cfg, ROOT, dtype=torch.float32, device=device)
    torch.set_num_threads(2)
    control = set(int(s) for s in args.control_seeds.split(",") if s)
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = SimpleNamespace(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                              device=device, t_start=time.perf_counter(), peaks=None)
        with planted(args.fault) if args.fault else contextlib.nullcontext():
            out = driver.run(ctx)
        line = dict(seed=seed, cell=args.workload, samples=len(out.samples), fault=args.fault)
        lim = cell.limits
        with tf32(False):
            o64 = [ref64.step(s["before"]) for s in out.samples]
            g = gaps(out.samples, ref64, o64)
            line["program"] = dict(numbers(g, lim), **extremes(g), top_scores=top_scores(g, lim),
                                   dual_gap=dual_gap(out.samples, o64))
            # the widest pairs, and the plain float32 reference's own gap there
            # (TF32 off: a second float32 evaluation of the same step)
            o32 = [ctrl.step(s["before"]) for s in out.samples]
            g32 = gaps(in_place_of_program(out.samples, o32), ref64, o64)
            top = torch.topk(g["u"].flatten(), 3)
            line["worst_u"] = [dict(pair=int(i) // 2, input=int(i) % 2, program=float(v),
                                    float32_reference=float(g32["u"].flatten()[i]))
                               for v, i in zip(top.values, top.indices)]
            line["float32_reference"] = dict(numbers(g32, lim), **extremes(g32))
        if seed in control:
            with tf32(True):
                outs = [ctrl.step(s["before"]) for s in out.samples]
            fake = in_place_of_program(out.samples, outs)
            with tf32(False):
                g = gaps(fake, ref64, o64)
                line["control"] = dict(numbers(g, lim), **extremes(g), top_scores=top_scores(g, lim),
                                       dual_gap=dual_gap(fake, o64))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
