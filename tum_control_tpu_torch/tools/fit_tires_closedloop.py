"""Differentiable closed-loop tire fit against both ACC24 no-dist goldens
(port of tools/fit_tires_closedloop.py):

    python -m tum_control_tpu_torch.tools.fit_tires_closedloop [--steps 150]
        [--chunk-len 250] [--skip 50] [--lr 0.01] [--n-chunks 24] [--init YAML]
        [--ok-floor 0.995] [--golden NPZ] [--golden-snmpc NPZ] [--out YAML]
        [--log TXT] [--device cuda|cpu]

Fits the 8 Pacejka log-multipliers theta by gradient descent through the
closed loop (planner -> RTI solve -> IPM -> plant RK4 -> estimator), jointly
over the nominal and the SNMPC (10 samples, UPH 15) golden:

  * each golden is cut into --n-chunks windows of --chunk-len steps; each
    starts from the log's plant state plus its accel state, the controller
    cold-starts, the first --skip steps are masked out of the loss; all
    chunks of a golden roll out as one batch, the tires exp(base + theta)
    on plant and controller;
  * each step is checkpointed (torch.utils.checkpoint, non-reentrant): the
    reverse sweep recomputes a step from its carry; on the card the kernels
    run in the forward and the plain versions' VJP in the backward
    (ops/diffmode.py);
  * theta passes every step through `SanitizeCotangent`, as the JAX tool's
    carry does, so that every theta-gradient path is sanitized at every step;
  * the loss per golden: (mean|dev_lat| / golden's - 1)^2 + 0.3 trace
    mismatch + the per-chunk softplus divergence penalty; plus the 0.1
    proximal pull toward theta0 (the init file, by default the r4 blend);
  * Adam behind global-norm clipping at 5, with the JAX tool's
    revert-and-halve guard on the gate and on --ok-floor.

Writes --out (data/Config/EDGAR/pacejka_params_2023fit_cl.yaml) and the log
--log (Logs/attribution/closedloop_fit.txt). Without --device it runs on the
card in float32; `main(argv, dtype=torch.float64)` on the CPU is the float64
reference. The tire values are never read back inside a step: the kernel
takes them from a device table (ops/kernels/linearize.py::tire_table).
"""
import argparse
import math
import os
import sys
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tum_control_tpu_torch.config import MPCConfig
from tum_control_tpu_torch.learn.adam import adam_init, adam_update, clip_by_global_norm
from tum_control_tpu_torch.tools import common, tire_fit

HEADER = ("# Pacejka parameters fitted by gradient descent THROUGH the closed\n"
          "# loop (both ACC24 no-dist goldens jointly; chunked multiple\n"
          "# shooting). Generated by tools/fit_tires_closedloop.py — see\n"
          "# docs/PARITY.md round-5 section.\n")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--chunk-len", type=int, default=250)
    ap.add_argument("--skip", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--n-chunks", type=int, default=24)
    ap.add_argument("--init", default=None,
                    help="tire yaml to initialize theta from (default: the r4 blend)")
    ap.add_argument("--ok-floor", type=float, default=0.995,
                    help="revert when a run's masked solver-ok drops below this")
    tire_fit.golden_args(ap)
    ap.add_argument("--out", default=tire_fit.CL_YAML)
    ap.add_argument("--log", default=os.path.join(tire_fit.LOG_DIR, "closedloop_fit.txt"))
    common.add_device_arg(ap)
    return tire_fit.resolve_goldens(ap.parse_args(argv))


def _float_leaves(tree):
    """The floating-point tensors of a nest of NamedTuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in _float_leaves(v)]
    return []


def _replace_leaves(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        return type(tree)(*(_replace_leaves(v, it) for v in tree))
    return tree


class SanitizeCotangent(torch.autograd.Function):
    """Identity on (theta, *state); in the backward, the JAX tool's `_cc_bwd`:
    the state's cotangent, over all its float leaves of each scenario (a
    chunk: the JAX tool vmaps its rollout over chunks), is scaled to norm
    <= 1 with NaN and inf set to 0 (a non-finite norm scales by 0); theta's
    cotangent, the chunks' sum (theta is unbatched in the JAX scan's carry),
    is NaN-cleaned and clamped to +-1e3. `stats` (a dict, or None) keeps the
    smallest scale and the largest |theta cotangent| before the clamp as
    device tensors, read by the caller after the backward."""

    @staticmethod
    def forward(ctx, stats, theta, *leaves):
        ctx.stats = stats
        return (theta.view_as(theta), *(leaf.view_as(leaf) for leaf in leaves))

    @staticmethod
    def backward(ctx, g_theta, *g_leaves):
        n2 = sum(g.reshape(g.shape[0], -1).square().sum(1) for g in g_leaves)
        n2 = torch.where(torch.isfinite(n2), n2, torch.full_like(n2, math.inf))
        scale = torch.clamp(torch.rsqrt(torch.clamp(n2, min=1e-30)), max=1.0)
        scale = torch.where(torch.isfinite(scale), scale, torch.zeros_like(scale))
        clean = [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                 * scale.view((-1,) + (1,) * (g.dim() - 1)) for g in g_leaves]
        g_theta = torch.nan_to_num(g_theta, nan=0.0, posinf=0.0, neginf=0.0)
        stats = ctx.stats
        if stats is not None:
            stats["min_scale"] = torch.minimum(stats["min_scale"], scale.min())
            stats["max_g_theta"] = torch.maximum(stats["max_g_theta"], g_theta.abs().max())
        return (None, torch.clamp(g_theta, -1e3, 1e3), *clean)


def sanitize_cotangent(theta, carry, stats=None):
    """(theta, carry) through SanitizeCotangent, the carry's float leaves
    replaced by its outputs."""
    leaves = _float_leaves(carry)
    out = SanitizeCotangent.apply(stats, theta, *leaves)
    return out[0], _replace_leaves(carry, iter(out[1:]))


class FitProblem:
    """The closed-loop loss of both goldens as a function of theta, on one
    device and type: `value_and_grad(theta)` -> (loss, (rn, rs, tn, ts, okn,
    oks), gradient), each a tensor on the device."""

    def __init__(self, args, device, dtype):
        self.device, self.dtype = device, dtype
        tp0 = tire_fit.shipped_tires()
        self.mu = tp0.mu
        self.base = tire_fit.log_base(tp0, dtype, device)
        init = tire_fit.read_tire_values(args.init or tire_fit.BLEND_YAML)
        self.theta0 = torch.as_tensor(np.log(init) - np.log(np.array(tp0[:8])), dtype=dtype,
                                      device=device)
        tp = self.tires(self.theta0)
        self.runs = []
        for path, option, mpc_cfg in ((args.golden, "--golden", MPCConfig()),
                                      (args.golden_snmpc, "--golden-snmpc",
                                       MPCConfig(**tire_fit.SNMPC))):
            chunks = tire_fit.golden_chunks(tire_fit.load_golden(path, option), args.n_chunks,
                                            args.chunk_len, dtype, device)
            sim = tire_fit.fit_simulation(mpc_cfg, tp, device, dtype)[0]
            self.runs.append((sim, *chunks))
        self.mask = (torch.arange(args.chunk_len, device=device) >= args.skip).to(dtype)
        self.zeros = torch.zeros((args.n_chunks, 7), dtype=dtype, device=device)
        self.stats = None

    def tires(self, theta):
        return tire_fit.tires_at(theta, self.base, self.mu)

    def step(self, sim, theta, carry):
        """One closed-loop step of every chunk with the tires of theta;
        returns (theta, carry) through the sanitizer, |lat_dev| and the
        solver status."""
        sim.set_tires(self.tires(theta))
        carry, log = sim.step(carry, self.zeros, self.zeros)
        theta, carry = sanitize_cotangent(theta, carry, self.stats)
        return theta, carry, log.lat_dev.abs(), log.simSolverDebug[:, 4]

    def run_terms(self, sim, theta, x0m, x0s, g_dev):
        carry = sim.init_carry(x0m, x0s, key=0)
        devs, status = [], []
        for _ in range(self.mask.shape[0]):
            theta, carry, dev, st = checkpoint(self.step, sim, theta, carry, use_reentrant=False,
                                               preserve_rng_state=False)
            devs.append(dev)
            status.append(st)
        dev, status, mask = torch.stack(devs, 1), torch.stack(status, 1), self.mask[None, :]
        msum = self.mask.sum() * dev.shape[0]
        m_our = (dev * mask).sum() / msum
        m_g = (g_dev * mask).sum() / msum
        ratio = m_our / torch.clamp(m_g, min=1e-6)
        trace = (((dev - g_dev) * mask) ** 2).sum() / msum
        # per-chunk divergence penalty: a global max is hypersensitive to one
        # marginal chunk at the stability edge
        blow = torch.nn.functional.softplus(4.0 * (dev.amax(dim=1) - 1.5)).mean()
        ok = (status == 0).to(self.dtype)
        okfrac = (ok * mask).sum() / msum
        return ratio, trace, blow, okfrac

    def loss(self, theta):
        (rn, tn, bn, okn), (rs, ts, bs, oks) = (self.run_terms(sim, theta, *data)
                                                for sim, *data in self.runs)
        loss = ((rn - 1.0) ** 2 + (rs - 1.0) ** 2 + 0.3 * (tn + ts) + (bn + bs)
                + 0.1 * torch.sum((theta - self.theta0) ** 2))
        return loss, (rn, rs, tn, ts, okn, oks)

    def value_and_grad(self, theta):
        one = torch.ones((), dtype=self.dtype, device=self.device)
        self.stats = {"min_scale": one, "max_g_theta": 0 * one}
        theta = theta.detach().requires_grad_(True)
        loss, aux = self.loss(theta)
        (g,) = torch.autograd.grad(loss, theta)
        return loss.detach(), tuple(a.detach() for a in aux), g


def main(argv=None, dtype=torch.float32):
    """Returns dict(iterations: one dict per gradient (loss, the terms, the
    gradient, its norm, seconds, the sanitizer's smallest scale and largest
    theta cotangent), gate, theta (best), out)."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    prob = FitProblem(args, device, dtype)
    theta = prob.theta0
    lr_cur = args.lr
    state = adam_init([theta])
    best = (1e9, theta)
    iterations = []
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    with open(args.log, "w") as logf:
        for it in range(args.steps):
            t0 = time.perf_counter()
            lv, aux, g = prob.value_and_grad(theta)
            lv = float(lv)
            rn, rs, tn, ts, okn, oks = (float(a) for a in aux)
            gnorm = float(torch.linalg.norm(g))
            seconds = time.perf_counter() - t0
            iterations.append(dict(loss=lv, rn=rn, rs=rs, tn=tn, ts=ts, okn=okn, oks=oks,
                                   grad=g.double().cpu().numpy(), gnorm=gnorm, seconds=seconds,
                                   min_scale=float(prob.stats["min_scale"]),
                                   max_g_theta=float(prob.stats["max_g_theta"])))
            line = (f"it {it:3d} loss {lv:.5f} ratio_nom {rn:.3f} ratio_snmpc {rs:.3f} "
                    f"trace {tn:.4f}/{ts:.4f} ok {okn:.3f}/{oks:.3f} |g| {gnorm:.3e} "
                    f"({seconds:.1f}s)")
            print(line, flush=True)
            logf.write(line + "\n")
            logf.flush()
            # score on the gate (both ratios near 1), only if healthy; theta0
            # (the r4 blend, known lap-stable) seeds the fallback
            gate = max(abs(rn - 1.0), abs(rs - 1.0))
            if okn >= 0.998 and oks >= 0.998 and gate < best[0]:
                best = (gate, theta)
            # a step that crashed chunks or sharply worsened both ratios left
            # the stable basin: revert to the best theta and halve the rate
            healthy = okn >= args.ok_floor and oks >= args.ok_floor and math.isfinite(lv)
            if not healthy or gate > best[0] + 0.15:
                lr_cur *= 0.5
                if lr_cur < 2e-4:
                    print("learning rate floor reached; stopping at best-so-far")
                    break
                theta = best[1]
                state = adam_init([theta])
                print(f"  -> reverted to best theta, lr={lr_cur:.5f}")
                logf.write(f"  -> reverted, lr={lr_cur:.5f}\n")
                continue
            (upd,), state = adam_update(clip_by_global_norm([g], 5.0), state, lr_cur)
            theta = theta + upd
        gate, theta_best = best
        tp = prob.tires(theta_best)
        theta_np = theta_best.double().cpu().numpy()
        line = f"best gate (max |ratio-1|): {gate:.4f}; theta {theta_np}"
        print(line)
        logf.write(line + "\n")
    tire_fit.write_tires(args.out, tp, HEADER)
    print("wrote", args.out, flush=True)
    return dict(iterations=iterations, gate=gate, theta=theta_np, out=args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
