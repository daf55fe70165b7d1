"""Faults planted underneath a run's timed path, for the check that the
comparison fails them: the CPU tests (benchmark/tests/test_bench_faults.py)
and `calibrate.py --fault` on the card. `planted(name)` breaks the closed
loop as `program.build` hands it to the driver, so the drivers run the
broken step through their own window, sample and comparison.

  unchanged     the step returns its state unchanged
  half_batch    only the first half of the batch is stepped: the second
                half keeps its state, and its logged results are the first
                half's
  altered       the control altered where the controller produces it:
                +0.01 rad/s of steering rate (3 % of its bound), every
                scenario
  one_control   as `altered`, one scenario of the batch
  one_status    one scenario's solve reported failed (status 1), so the
                step re-initialises its iterate
  one_state     one scenario's state returned unchanged
  dropped_draws the plant gets a zero derivative disturbance: the step
                still draws it, so the estimation noise that follows is
                drawn as before (a configuration that draws)

The benchmark runs on one chip, so no exchange between chips can be left
out.
"""
from __future__ import annotations

import contextlib

import torch

from benchmark import program

STEERING_RATE = 0.01


def _row(B: int) -> int:
    """The scenario a one-scenario fault breaks: inside the batch, not its
    first or last row."""
    return B // 3


def _rows(x, y, keep):
    """x where `keep` (B,) holds, y elsewhere, in every (B, ...) tensor."""
    if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == keep.shape[0]:
        return torch.where(keep.view((-1,) + (1,) * (x.dim() - 1)), x, y)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_rows(a, b, keep) for a, b in zip(x, y)))
    return x


def _solve_with(sim, change):
    """The controller's output changed where the closed loop takes it: from
    `solve_with_extra` where the controller carries state (`init_extra`:
    R2NMPC, WMPC), else from `solve`."""
    ctrl = sim.controller
    name = "solve_with_extra" if hasattr(ctrl, "init_extra") else "solve"
    solve = getattr(ctrl, name)

    def broken(*args, **kwargs):
        out, *rest = solve(*args, **kwargs)
        return (change(out), *rest)

    setattr(ctrl, name, broken)
    return sim.step


def unchanged(sim):
    step = sim.step
    return lambda c, a, b: (c, step(c, a, b)[1])


def half_batch(sim):
    step = sim.step

    def broken(c, a, b):
        B = c.x_sim.shape[0]
        h = B // 2
        new, log = step(c, a, b)
        copied = type(log)(*(torch.cat([t[:h], t[:B - h]]) for t in log))
        return _rows(new, c, torch.arange(B, device=c.x_sim.device) < h), copied
    return broken


def _steer(out, rows):
    u0 = out.u0.clone()
    u0[rows, 1] += STEERING_RATE
    return out._replace(u0=u0)


def altered(sim):
    return _solve_with(sim, lambda out: _steer(out, slice(None)))


def one_control(sim):
    return _solve_with(sim, lambda out: _steer(out, _row(out.u0.shape[0])))


def one_status(sim):
    def change(out):
        stats = out.stats.clone()
        stats[_row(stats.shape[0]), 4] = 1
        return out._replace(stats=stats)
    return _solve_with(sim, change)


def one_state(sim):
    step = sim.step

    def broken(c, a, b):
        B = c.x_sim.shape[0]
        new, log = step(c, a, b)
        return _rows(new, c, torch.arange(B, device=c.x_sim.device) != _row(B)), log
    return broken


def dropped_draws(sim):
    d = sim.dist_deriv
    sim.dist_deriv = d._replace(magnitudes=torch.zeros_like(d.magnitudes))
    return sim.step


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered, one_control, one_status,
                                  one_state, dropped_draws)}


@contextlib.contextmanager
def planted(name: str):
    """Within the block, every closed loop that program.build makes steps
    through fault `name`."""
    build = program.build

    def broken(ctx, batch):
        sim, carry, lap_points = build(ctx, batch)
        sim.step = FAULTS[name](sim)
        return sim, carry, lap_points

    program.build = broken
    try:
        yield
    finally:
        program.build = build
