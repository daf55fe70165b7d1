"""Closed-loop batch traffic: B scenarios stepped together by
`ClosedLoopSim.step` for the whole window (a closed loop: a scenario's
next step waits for its previous one), after `warmup_steps` steps that
launch every kernel of the path once and let the allocator take its
blocks.

The window is a fixed count of closed-loop steps, the traffic's
`window_steps`, or `--seconds` of wall time, whichever ends it first. Any
two runs of one seed that reach `window_steps` attempt the same B x
`window_steps` solves from the same scenarios, and the seeded sample
(compare.Sampler) draws the same step indices, however fast the host
issues them. So a failed-solve share of two versions of the program is
taken over the same solves: a faster host path reaches no steps that the
slower one does not. A run that reaches `--seconds` first says so on
standard error and reports the steps it ran.

  attempted     B x the steps of the window
  failed        the window's solves with status != 0 or a non-finite
                control; each is listed on standard error after the window
                (its step, scenario, status and whether its control was
                finite), the first MAX_LISTED of them

  device_solves_per_s  B x the steps of the profiled stretch over the
                seconds in which the card ran an operation in it (the union
                of the device operations' intervals, from the profiler's
                trace): the solves the card completes per second of its own
                work. The stretch is `profile_steps` steps run under
                torch.profiler once the window has closed, in every run.
  setup_s       process start -> the first timed step

On the host's clock the window gives B x the steps completed over its wall
seconds (the window ends after a synchronisation, so every step counted has
finished on the device): the per-layer `wall_solves_per_s.batch`. The step
is issued by the host, which leaves the card idle ~95 % of the time, so
that rate follows the host's speed, which moves from run to run by more
than the largest bound allows (PERF.md section 2).
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

MAX_LISTED = 20   # failed solves listed one by one on standard error


def run(ctx):
    tr = ctx.cell.traffic
    B = int(tr["batch"])
    S = int(tr["window_steps"])
    sim, carry, lap_points = program.build(ctx, B)
    zeros = torch.zeros_like(carry.x_sim)
    step = sim.step
    draws = program.draws(sim)
    for _ in range(int(tr["warmup_steps"])):
        carry, _ = step(carry, zeros, zeros)
    program.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    spans = Spans()
    sampler = Sampler(int(tr["sample_steps"]), ctx.seed)
    kept, issue, ends = [], [], []
    launches0 = program.launches()
    with installed(spans, sim.controller) if ctx.trace else contextlib.nullcontext():
        t0 = time.perf_counter()
        n = 0
        while n < S:
            t = time.perf_counter()
            if t - t0 >= ctx.seconds:
                break
            keep = sampler.admit()
            before = copy(carry_tensors(carry, draws)) if keep else None
            carry, log = step(carry, zeros, zeros)
            ends.append(time.perf_counter() - t0)
            issue.append(ends[-1] - (t - t0))
            status = log.simSolverDebug[:, 4]
            kept.append((log.simU.clone(), status.clone(), log.lat_dev.clone()))
            if keep:
                sampler.keep(before, log.simU, status, carry_tensors(carry))
            n += 1
        program.sync(ctx.device)
        window_s = time.perf_counter() - t0
        peak = program.memory_peak(ctx.device)
        launched = {k: v - launches0[k] for k, v in program.launches().items()
                    if v != launches0[k]}
        P = int(tr["profile_steps"])

        def steps():
            c = carry
            for _ in range(P):
                c, _ = step(c, zeros, zeros)

        # the card's time for P steps; an untraced run on a machine without
        # a card has none (a traced one refuses there)
        prof = (profile_window(steps, list(WRAPPED) + ["solve"], ctx.device)
                if ctx.trace or ctx.device.type == "cuda" else None)
        record = None
        if ctx.trace:
            spans_s, calls = dict(spans.seconds), dict(spans.calls)
            record = dict(mode="batch", batch=B, steps=n, window_s=window_s, issue_s=issue,
                          spans_s=spans_s, span_calls=calls, profile=dict(prof, steps=P),
                          work=step_work(ctx.cell.cfg["shapes"], B, lap_points,
                                         int(ctx.cell.cfg["mpc"]["qp_iters"])),
                          peaks=ctx.peaks)
    u = torch.stack([k[0] for k in kept], dim=1)
    st = torch.stack([k[1] for k in kept], dim=1)
    lat = torch.stack([k[2] for k in kept], dim=1).abs().double().cpu().numpy()
    bad = (st != 0) | ~torch.isfinite(u).all(dim=-1)
    failed = int(bad.sum())
    program.say(f"the window reached --seconds {ctx.seconds!r} first: {n} steps of window_steps "
                f"{S}" if n < S else f"the window ended at window_steps {S}, {window_s!r} s "
                f"of --seconds {ctx.seconds!r}")
    program.say(f"setup_s {setup_s!r}; window {window_s!r} s, {n} steps x {B} scenarios, "
                f"{B * n / window_s!r} solves per wall second; host ms a step to issue: mean "
                f"{1e3 * float(np.mean(issue))!r}")
    e2e = dict(setup_s=setup_s)
    if prof is not None:
        e2e["device_solves_per_s"] = B * P / prof["busy_s"]
        program.say(f"profiled stretch: {P} steps, device busy {prof['busy_s']!r} s of "
                    f"{prof['window_s']!r} s, {prof['kernels']} kernels")
    per_step = ", ".join(f"{k} {v / n:g}" for k, v in sorted(launched.items())) if n else ""
    program.say(f"hand-written launches per step: {per_step or 'none'}")
    per_s = np.bincount(np.floor(np.asarray(ends)).astype(int)) if ends else []
    program.say(f"steps issued in each second of the window: {list(map(int, per_s))}")
    program.say(f"|lat_dev| p50 / p99 over the window: {float(np.percentile(lat, 50))!r} / "
                f"{float(np.percentile(lat, 99))!r} m; solves with status != 0 or a non-finite "
                f"control: {failed} of {B * n}")
    list_failed(bad, st, u, int(tr["warmup_steps"]))
    samples = sampler.samples()
    del sim, carry, kept
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return program.Result(e2e=e2e,
                          attempted=B * n, failed=failed, samples=samples, sample_rows=B,
                          record=record, memory_peak_bytes=peak)


def list_failed(bad, status, u, warmup: int):
    """One line on standard error for each of the first MAX_LISTED failed
    solves, in the order of the window's steps, then their count. `bad`
    and `status` are (B, steps), `u` (B, steps, nu)."""
    if not bool(bad.any()):
        return
    steps, rows = torch.nonzero(bad.T, as_tuple=True)
    for i, b in zip(steps[:MAX_LISTED].tolist(), rows[:MAX_LISTED].tolist()):
        program.say(f"failed solve: window step {i} (closed-loop step {warmup + i}), scenario "
                    f"{b}, status {float(status[b, i])!r}, control finite "
                    f"{bool(torch.isfinite(u[b, i]).all())}")
    program.say(f"failed solves: {steps.numel()}, the first {min(steps.numel(), MAX_LISTED)} "
                "listed")
