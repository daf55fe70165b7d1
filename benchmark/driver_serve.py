"""Served traffic: one scenario under the port's real-time executor, the
synchronous serving loop `deploy_rt.run_synchronous` over
`deploy_rt.packed_step` at the deployment's period, cycle after cycle until
the window closes (each cycle waits for its deadline on the executor's
grid, steps, and waits for the packed control on the host).

  cycle_ms_p95  95th percentile over every served cycle of the window of
                the time from the cycle's due time on the executor's grid
                (as the executor re-anchors it after a miss) to its packed
                control on the host; a cycle whose step failed (status != 0
                or a non-finite control) counts as the whole window
  setup_s       process start -> the first served cycle
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import program
from benchmark.compare import Sampler, carry_tensors, copy
from benchmark.tracing import WRAPPED, Spans, installed, profile_window
from benchmark.work import step_work


class WindowClosed(Exception):
    pass


class Clock:
    """The executor as run_synchronous sees it: each cycle's start and the
    moment its control is recorded, and the end of the window."""

    def __init__(self, ex, t_end_ns=None):
        self.ex, self.t_end_ns = ex, t_end_ns
        self.cycles = []  # (t_start_ns, t_recorded_ns, solve_ns, status, u0, u1)

    def begin_cycle(self):
        if self.t_end_ns is not None and time.monotonic_ns() >= self.t_end_ns:
            raise WindowClosed
        return self.ex.begin_cycle()

    def record(self, t_start_ns, solve_ns, status, cost, lat_dev, vel_dev, u0, u1):
        self.cycles.append((t_start_ns, time.monotonic_ns(), solve_ns, status, u0, u1))
        self.ex.record(t_start_ns, solve_ns, status, cost, lat_dev, vel_dev, u0, u1)


def run(ctx):
    from tum_control_tpu_torch import deploy_rt
    from tum_control_tpu_torch.utils.rt_runtime import RealtimeExecutor

    tr = ctx.cell.traffic
    sim, carry, lap_points = program.build(ctx, 1)
    if program.draws(sim):
        raise ValueError("the serve driver takes no configuration that draws disturbances: "
                         "its sample does not hold the generator's state that the reference "
                         "draws from, and the served step, one CUDA graph, replays its draws")
    zeros = torch.zeros_like(carry.x_sim)
    for _ in range(int(tr["warmup_steps"])):
        carry, packed = deploy_rt.packed_step(sim, carry, zeros)
        packed.cpu()
    period = float(tr["period_s"])
    ex = RealtimeExecutor(period_s=period)

    spans = Spans()
    sampler = Sampler(int(tr["sample_steps"]), ctx.seed)
    issue = []
    state = dict(carry=carry, n=0, sampling=True)
    orig = deploy_rt.packed_step

    def packed_step(sim_, carry_, zeros_):
        keep = state["sampling"] and sampler.admit()
        before = copy(carry_tensors(carry_)) if keep else None
        t = time.perf_counter()
        out, packed = orig(sim_, carry_, zeros_)
        issue.append(time.perf_counter() - t)
        if keep:
            sampler.keep(before, packed[0:2][None], packed[6:7], carry_tensors(out))
        state["carry"] = out
        state["n"] += state["sampling"]
        return out, packed

    deploy_rt.packed_step = packed_step
    try:
        with installed(spans, sim.controller) if ctx.trace else contextlib.nullcontext():
            setup_s = time.perf_counter() - ctx.t_start
            t0 = time.monotonic_ns()
            clock = Clock(ex, t0 + int(ctx.seconds * 1e9))
            try:
                deploy_rt.run_synchronous(sim, carry, clock, 1 << 62)
            except WindowClosed:
                pass
            window_s = (time.monotonic_ns() - t0) * 1e-9
            state["sampling"] = False
            stats = ex.stats()
            peak = program.memory_peak(ctx.device)
            record = None
            if ctx.trace:
                n = state["n"]
                spans_s, calls = dict(spans.seconds), dict(spans.calls)
                P = int(tr["profile_steps"])
                ex2 = RealtimeExecutor(period_s=period)
                try:
                    prof = profile_window(
                        lambda: deploy_rt.run_synchronous(sim, state["carry"], Clock(ex2), P),
                        list(WRAPPED) + ["solve"], ctx.device)
                finally:
                    ex2.close()
                cyc = clock.cycles
                record = dict(mode="serve", batch=1, steps=n, window_s=window_s,
                              issue_s=issue[:n], spans_s=spans_s, span_calls=calls,
                              profile=dict(prof, steps=P),
                              solve_s=[c[2] * 1e-9 for c in cyc],
                              misses=int(stats["deadline_misses"]), cycles=int(stats["cycles"]),
                              work=step_work(ctx.cell.cfg["shapes"], 1, lap_points,
                                             int(ctx.cell.cfg["mpc"]["qp_iters"])),
                              peaks=ctx.peaks)
    finally:
        deploy_rt.packed_step = orig
        ex.close()
    cyc = clock.cycles
    fail = np.array([c[3] != 0 or not (np.isfinite(c[4]) and np.isfinite(c[5])) for c in cyc])
    lat_ms = np.array([(c[1] - c[0]) * 1e-6 for c in cyc])
    lat_ms = np.where(fail, ctx.seconds * 1e3, lat_ms)
    p50, p95 = (float(np.percentile(lat_ms, q)) for q in (50, 95))
    program.say(f"setup_s {setup_s!r}; window {window_s!r} s, {len(cyc)} cycles at "
                f"{period * 1e3:g} ms; deadline misses {stats['deadline_misses']} of "
                f"{stats['cycles']}")
    program.say(f"cycle ms p50 {p50!r}, p95 {p95!r} ({int(np.sum(lat_ms > p95))} cycles beyond "
                f"the p95); host ms a cycle to issue the step: mean "
                f"{1e3 * float(np.mean(issue)):.4f}; failed cycles {int(fail.sum())}")
    samples = sampler.samples()
    del sim, carry, state
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return program.Result(e2e=dict(cycle_ms_p95=p95, setup_s=setup_s), attempted=len(cyc),
                          failed=int(fail.sum()), samples=samples, sample_rows=1, record=record,
                          memory_peak_bytes=peak)
