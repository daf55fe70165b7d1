"""Lap-scale tire calibration: a batched full-lap evolution strategy (port
of tools/fit_tires_es.py):

    python -m tum_control_tpu_torch.tools.fit_tires_es [--gens 60] [--pop 16]
        [--mu 4] [--sigma 0.008] [--init YAML] [--out YAML] [--golden NPZ]
        [--golden-snmpc NPZ] [--log TXT] [--device cuda|cpu]

Each generation draws `pop` members around the mean (numpy's
default_rng(0); member 0 is the mean itself), and runs every member's full
lap of n steps (n: the golden's length) from the lap's start, for the
nominal NMPC and the SNMPC (10 samples, UPH 15), each as ONE batch of `pop`
scenarios with one tire set per scenario on plant and controller (the K1
kernel reads each scenario's row of a tire table). Fitness per member:

    (mean|dev_lat| / golden's - 1)^2 + 1.5 (SNMPC's - 1)^2
    + softplus divergence penalties + 10 x (1 - solver-ok) of each run,

then the (mu, lambda) mean of the `mu` best, and the sigma adaptation by the
share of members better than the mean. The best member whose laps were all
solved (ok == 1.0 on both) is written to --out (data/Config/EDGAR/
pacejka_params_2023fit_cl.yaml); the log to --log
(Logs/attribution/closedloop_es.txt). The statistics are reduced on the
device and the fitness computed on the host in float64.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

from tum_control_tpu_torch.config import MPCConfig
from tum_control_tpu_torch.tools import common, tire_fit

TS = 0.02
HEADER = ("# Pacejka parameters calibrated on the FULL-LAP closed-loop parity\n"
          "# objective (both ACC24 no-dist goldens jointly): chunk-scale fit by\n"
          "# gradient descent through the sim scan + lap-scale batched-rollout\n"
          "# evolution strategy. Generated by tools/fit_tires_closedloop.py +\n"
          "# tools/fit_tires_es.py — see docs/PARITY.md round-5 section.\n")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gens", type=int, default=60)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--mu", type=int, default=4)
    ap.add_argument("--sigma", type=float, default=0.008)
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", default=tire_fit.CL_YAML)
    tire_fit.golden_args(ap)
    ap.add_argument("--log", default=os.path.join(tire_fit.LOG_DIR, "closedloop_es.txt"))
    common.add_device_arg(ap)
    return tire_fit.resolve_goldens(ap.parse_args(argv))


def softplus(x):
    return np.logaddexp(x, 0.0)


class Population:
    """Both controllers' closed loops, built once, evaluated on a batch of
    tire sets: `lap_stats(thetas (P, 8))` -> per controller (mean |lat_dev|,
    max |lat_dev|, solver-ok share), each (P,) float64 numpy."""

    def __init__(self, n_steps: int, device, dtype):
        from tum_control_tpu_torch.track.trajectory import initial_state

        self.n, self.device, self.dtype = n_steps, device, dtype
        tp0 = tire_fit.shipped_tires()
        self.mu = tp0.mu
        self.base = tire_fit.log_base(tp0, dtype, device)
        self.sims = []
        for mpc_cfg in (MPCConfig(), MPCConfig(**tire_fit.SNMPC)):
            sim, sim_cfg, traj_path = tire_fit.fit_simulation(mpc_cfg, tp0, device, dtype,
                                                              T=n_steps * TS)
            self.sims.append(sim)
        x0m, x0s = initial_state(traj_path, sim_cfg.idx_ref_start)
        self.x0m = torch.as_tensor(x0m, dtype=dtype, device=device)
        self.x0s = torch.as_tensor(x0s, dtype=dtype, device=device)

    def lap_stats(self, thetas: np.ndarray):
        P = thetas.shape[0]
        tp = tire_fit.tires_at(torch.as_tensor(thetas, dtype=self.dtype, device=self.device),
                               self.base, self.mu)
        out = []
        for sim in self.sims:
            sim.set_tires(tp)
            _, log = sim.run(self.x0m.expand(P, -1), self.x0s.expand(P, -1), self.n, key=0)
            dev = log.lat_dev.abs()
            ok = (log.simSolverDebug[..., 4] == 0).to(self.dtype).mean(dim=1)
            stats = torch.stack([dev.mean(dim=1), dev.amax(dim=1), ok])
            out.append(stats.double().cpu().numpy())
        return out


def fitness(stats_nom, stats_snm, g_nom: float, g_snm: float):
    """(fit, rn, rs, xn, xs, okn, oks), each (P,)."""
    (mn, xn, okn), (ms, xs, oks) = stats_nom, stats_snm
    rn, rs = mn / g_nom, ms / g_snm
    # the divergence penalty is ~0 in the healthy region (max ~0.8 m), or its
    # flat baseline would drown the ratio terms the gate checks
    blow = lambda x: 0.25 * softplus(8.0 * (x - 1.3))
    fit = ((rn - 1.0) ** 2 + 1.5 * (rs - 1.0) ** 2 + blow(xn) + blow(xs)
           + 10.0 * ((1.0 - okn) + (1.0 - oks)))
    return fit, rn, rs, xn, xs, okn, oks


def main(argv=None, dtype=torch.float32):
    """Returns dict(generations: one dict per generation (cand, fit, rn,
    rs, xn, xs, okn, oks, best index, gate, sigma, seconds), best_fit,
    gate, theta (best), out)."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    d_nom = tire_fit.load_golden(args.golden)
    d_snm = tire_fit.load_golden(args.golden_snmpc, "--golden-snmpc")
    n = d_nom["simU"].shape[0]
    g_nom = float(np.abs(d_nom["dev_lat"][:n]).mean())
    g_snm = float(np.abs(d_snm["dev_lat"][:n]).mean())
    pop = Population(n, device, dtype)
    base = np.log(np.array(tire_fit.shipped_tires()[:8]))
    theta0 = np.log(tire_fit.read_tire_values(args.init or tire_fit.BLEND_YAML)) - base

    rng = np.random.default_rng(0)
    mean = theta0.copy()
    sigma = args.sigma
    best = (np.inf, theta0, None)
    generations = []
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    with open(args.log, "w") as logf:
        for gen in range(args.gens):
            t0 = time.perf_counter()
            pert = rng.standard_normal((args.pop, 8)) * sigma
            pert[0] = 0.0  # elitist: always re-evaluate the current mean
            cand = mean[None, :] + pert
            fit, rn, rs, xn, xs, okn, oks = fitness(*pop.lap_stats(cand), g_nom, g_snm)
            order = np.argsort(fit)
            mean = cand[order[:args.mu]].mean(axis=0)
            gi = order[0]
            gate = max(abs(rn[gi] - 1), abs(rs[gi] - 1))
            if fit[gi] < best[0] and okn[gi] == 1.0 and oks[gi] == 1.0:
                best = (fit[gi], cand[gi].copy(), gate)
            seconds = time.perf_counter() - t0
            generations.append(dict(cand=cand, fit=fit, rn=rn, rs=rs, xn=xn, xs=xs, okn=okn,
                                    oks=oks, best=int(gi), gate=gate, sigma=sigma,
                                    seconds=seconds))
            line = (f"gen {gen:3d} best_fit {fit[gi]:.5f} ratios {rn[gi]:.3f}/{rs[gi]:.3f} "
                    f"max {xn[gi]:.2f}/{xs[gi]:.2f} ok {okn[gi]:.4f}/{oks[gi]:.4f} "
                    f"gate {gate:.3f} sigma {sigma:.4f} ({seconds:.1f}s)")
            print(line, flush=True)
            logf.write(line + "\n")
            logf.flush()
            # 1/5-success-style sigma adaptation, against the elitist mean member
            frac_better = float(np.mean(fit < fit[0]))
            sigma *= 1.15 if frac_better > 0.3 else 0.9
            sigma = float(np.clip(sigma, 0.001, 0.05))
        best_fit, th_best, gate = best
        print(f"final best gate {gate}; theta {th_best}")
        logf.write(f"final best gate {gate}; theta {th_best}\n")
    tp = tire_fit.tires_at(torch.as_tensor(th_best, dtype=dtype), tire_fit.log_base(
        tire_fit.shipped_tires(), dtype, "cpu"), pop.mu)
    tire_fit.write_tires(args.out, tp, HEADER)
    print("wrote", args.out, flush=True)
    return dict(generations=generations, best_fit=best_fit, gate=gate, theta=th_best,
                out=args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
