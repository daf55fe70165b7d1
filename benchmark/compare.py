"""Whether what the timed path produced is correct: a seeded sample of the
window's steps, each recomputed by the float64 reference from the
program's own carry before that step, and the numbers that judge the
program's outputs against the reference's. A pair is one scenario of one
sampled step.

  u_gap      the gap of the applied control u0 = [jerk, steering rate],
             each input over the reference's largest |u| of that input in
             the sample, at the 99th percentile over the sampled (pair,
             input) gaps; a pair whose solver status differs from the
             reference's reads 1 on both inputs
  state_gap  the gap of the next plant state (7) and the next estimate
             (8), each component over the reference's largest change of
             that component across the step in the sample, at the 99th
             percentile over the sampled (pair, component) gaps
  iterate_gap  the gap of the controller's carried iterate (X over every
             node and state, U over every stage and input) after the
             failed-solve re-initialisation, and of every float tensor of
             the controller's carried state (`extra`: R2NMPC's back-offs,
             WMPC's weights and observation), each component (the last
             axis) over the reference's largest change of it across the
             step, at the 99th percentile over the sampled gaps
  pairs_off  the number of pairs with any u, state or iterate gap above
             PAIR_FACTOR times that number's limit, or a status, or an
             integer of the carried state (WMPC's step count and action),
             that differs from the reference's (a gap that is not finite
             is above any limit)

The 99th percentiles bound the bulk of the pairs; pairs_off bounds how many
may lie far beyond those limits. In about one run in three a single
scenario of a batch holds a soft row within float32's rounding of its
bound, the polish's semismooth Newton step takes the other active set
there, and that pair reads up to 2.4e-2 where the others read 1e-4
(PERF.md section 2): one pair off is sound, two have been seen once, and
the next widest pair of a sound run reads at most 1.6 times a limit. A
scenario that the timed path gets wrong on every step is off in every
sampled step, while it is too small a share of a batch of 128 to move a
99th percentile. `extremes` and
`pair_scores` give the widest gaps beside the numbers.

`Sampler` keeps K steps drawn uniformly from the whole window (reservoir
sampling from the seed): the carry before the step and the program's
outputs, as copies taken when the step is issued. Where the configuration
draws disturbances, the carry before the step holds the state of the
program's generator, from which the reference draws for itself.
"""
from __future__ import annotations

import random

import torch

NUMBERS = ("u_gap", "state_gap", "iterate_gap", "pairs_off")
QUANTILE = 0.99
KINDS = dict(u="u_gap", state="state_gap", iterate="iterate_gap")
STATE, ITERATE = ("x_sim", "x_est"), ("X", "U")
PAIR_FACTOR = 2.0


def carry_tensors(carry, draws: bool = False) -> dict:
    """The program's SimCarry as the reference's plain tensors: `extra`, the
    tensors of the controller's carried state, where it has one, and with
    `draws` (the configuration draws disturbances) `gen_state`, the state of
    the draws' generator, which the step advances."""
    out = dict(X=carry.ctrl_state.X, U=carry.ctrl_state.U, warm=tuple(carry.ctrl_state.warm),
               x_sim=carry.x_sim, x_est=carry.x_est, est_buf=carry.est_state.buf,
               est_count=carry.est_state.count, pose=carry.pose)
    if carry.extra is not None:
        out["extra"] = extra_tensors(carry.extra)
    if draws:
        out["gen_state"] = carry.key.get_state()
    return out


def extra_tensors(extra) -> tuple:
    """The tensors of a controller's carried NamedTuple in field order, a
    nested one (WMPC's `base`, R2NMPC's back-offs) in its place."""
    out = []
    for v in extra:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(extra_tensors(v))
    return tuple(out)


def copy(d: dict) -> dict:
    return {k: (tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone())
            for k, v in d.items()}


class Sampler:
    """Reservoir of K sampled steps, decided before each step is issued."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(int(seed) ^ 0x5EED)
        self.slots = []
        self.seen = 0
        self._slot = None

    def admit(self) -> bool:
        """Whether the next step is kept; call once before each step."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self._slot = len(self.slots)
            self.slots.append(None)
            return True
        j = self.rng.randrange(i + 1)
        self._slot = j if j < self.k else None
        return self._slot is not None

    def keep(self, before: dict, u0, status, after: dict):
        self.slots[self._slot] = dict(before=before, u0=u0.clone(), status=status.clone(),
                                      after=copy(after))

    def samples(self) -> list:
        return [s for s in self.slots if s is not None]


def in_place_of_program(samples: list, outs: list) -> list:
    """The samples with another computation's outputs `outs` (reference.step
    dicts) in the program's place: how the control is judged."""
    return [dict(s, u0=o["u0"], status=o["status"], after=o) for s, o in zip(samples, outs)]


def _compared(s: dict, out: dict):
    """(name, before, program, reference) of each carried tensor compared:
    the plant state and estimate, the iterate, then the carried state."""
    for key in STATE + ITERATE:
        yield key, s["before"][key], s["after"][key], out[key]
    extra = [s["before"].get("extra", ()), s["after"].get("extra", ()), out.get("extra", ())]
    if len({len(e) for e in extra}) != 1:
        raise ValueError(f"the carried state holds {[len(e) for e in extra]} tensors before the "
                         "step, in the program and in the reference")
    for j, ts in enumerate(zip(*extra)):
        yield ("extra", j), *ts


def gaps(samples: list, reference, outs=None) -> dict:
    """The scaled gaps of every sampled pair: {"u": (pairs, 2), "state":
    (pairs, 15), "iterate": (pairs, the entries of X, U and the carried
    state's float tensors), "bad": (pairs,) a status or a carried integer
    unlike the reference's}, the reference run one sample at a time (or its
    outputs `outs`, given)."""
    du, ur, bad = [], [], []
    dx, ref_dx = {}, {}
    for i, s in enumerate(samples):
        out = reference.step(s["before"]) if outs is None else outs[i]
        dev = out["u0"]
        u_p = s["u0"].to(dev.device, dev.dtype)
        du.append((u_p - out["u0"]).abs())
        ur.append(out["u0"].abs())
        off = s["status"].to(dev.device).reshape(-1).to(torch.int32) != out["status"]
        for key, prev, prog, ref in _compared(s, out):
            if not prog.is_floating_point():
                off = off | (prog.to(dev.device) != ref).reshape(prog.shape[0], -1).any(dim=1)
                continue
            prev, prog = prev.to(dev.device, dev.dtype), prog.to(dev.device, dev.dtype)
            n = prog.shape[-1] if prog.dim() > 1 else 1
            dx.setdefault(key, []).append((prog - ref).abs().reshape(prog.shape[0], -1, n))
            ref_dx.setdefault(key, []).append((ref - prev).abs().reshape(-1, n))
        bad.append(off)
    scale_u = torch.clamp(torch.cat(ur).amax(dim=0), min=1e-12)
    bad = torch.cat(bad)
    u = torch.cat(du) / scale_u
    u = torch.where(bad[:, None], torch.ones_like(u), u)
    scaled = {k: (torch.cat(dx[k]) / torch.clamp(torch.cat(ref_dx[k]).amax(dim=0), min=1e-12))
              .flatten(1) for k in dx}
    return dict(u=u, state=torch.cat([scaled[k] for k in STATE], dim=1),
                iterate=torch.cat([v for k, v in scaled.items() if k not in STATE], dim=1),
                bad=bad)


def pair_scores(g: dict, limits: dict) -> torch.Tensor:
    """Each pair's widest gap over its number's limit, the largest of the
    three (inf where a status differs or a gap is not finite): a pair is
    off where its score exceeds PAIR_FACTOR."""
    score = torch.stack([torch.nan_to_num(g[k] / limits[n], nan=float("inf")).amax(dim=1)
                         for k, n in KINDS.items()]).amax(dim=0)
    return torch.where(g["bad"], torch.full_like(score, float("inf")), score)


def numbers(g: dict, limits: dict) -> dict:
    q = lambda t: float(torch.quantile(t.flatten().double().cpu(), QUANTILE))
    out = {n: q(g[k]) for k, n in KINDS.items()}
    out["pairs_off"] = int((pair_scores(g, limits) > PAIR_FACTOR).sum())
    return out


def extremes(g: dict) -> dict:
    """The widest and the mean gaps (PERF.md's readings beside the numbers)."""
    return {f"{k}_{f}": float(getattr(g[k], "amax" if f == "widest" else "mean")())
            for k in KINDS for f in ("widest", "mean")}


def judge(samples: list, reference, limits: dict) -> dict:
    """{number: {"value", "limit"}} over the samples."""
    values = numbers(gaps(samples, reference), limits)
    return {k: dict(value=values[k], limit=limits[k]) for k in NUMBERS}
