"""Golden-gap attribution (port of tools/golden_attribution.py):

    python -m tum_control_tpu_torch.tools.golden_attribution [--golden NPZ]
        [--golden-snmpc NPZ] [--out YAML] [--steps 3000] [--T 120]
        [--device cuda|cpu]

  1. re-fits the 8 Pacejka parameters to the golden run's own state
     transitions (one 4-substep RK4 plant step per logged sample, float64,
     Adam on log-multipliers of the default TireParams; residuals on vlong,
     vlat, yaw rate in acceleration units),
  2. writes the fitted set to --out (data/Config/EDGAR/
     pacejka_params_2023fit.yaml by default) and its log-space blend toward
     the shipped shape (alpha 0.35) beside it (`*_snmpc.yaml`),
  3. runs the nominal lap with the fitted and with the shipped tires, the
     SNMPC (10 samples, UPH 15) and the nominal lap with the blend, tires on
     plant and controller,
  4. prints dev_lat / dev_vel statistics and control envelopes beside the
     goldens' and the two verdict lines.

The fit runs in float64 on the tool's device, as the JAX tool runs it on the
CPU in float64; the laps run in the tool's type (float32 on the card)
through the hand-written kernels. T cuts the laps (the goldens cover 120 s).
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.learn.adam import adam_init, adam_update
from tum_control_tpu_torch.models.integrators import rk4_multistep
from tum_control_tpu_torch.models.vehicle_stm import sim_ode
from tum_control_tpu_torch.params import TireParams, VehicleParams
from tum_control_tpu_torch.tools import common, tire_fit

TS = 0.02
VP = VehicleParams()
TP0 = TireParams()
FIT_HEADER = ("# Pacejka parameters re-fitted to the ACC24 golden transitions\n"
              "# (2023 tire identification; generated by tools/golden_attribution.py)\n")
BLEND_HEADER = (
    "# SNMPC-consistent 2023 tire proxy: log-space blend (alpha=0.35 toward\n"
    "# the shipped shape) of pacejka_params_2023fit.yaml. The one-step-optimal\n"
    "# fit under-determines the saturation shape; under it the SNMPC sample\n"
    "# fan destabilizes at the Monteblanco hairpin. This blend reproduces BOTH\n"
    "# ACC24 goldens' full 120 s closed loops (tools/golden_attribution.py;\n"
    "# forensics in docs/PARITY.md).\n")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    tire_fit.golden_args(ap)
    ap.add_argument("--out", default=tire_fit.FIT_YAML,
                    help="fitted tire file; the blend goes beside it as *_snmpc.yaml")
    ap.add_argument("--steps", type=int, default=3000, help="Adam steps of the transition fit")
    ap.add_argument("--T", type=float, default=120.0, help="seconds of each lap")
    common.add_device_arg(ap)
    return tire_fit.resolve_goldens(ap.parse_args(argv))


def fit_tires(d: dict, n_steps: int = 3000, lr: float = 0.02, device=None):
    """Fit [Bf, Cf, Df, Ef, Br, Cr, Dr, Er] (log-multipliers theta on the
    default TireParams) to the golden's one-step transitions in float64 on
    `device` (device.resolve_device: cuda unless the caller names one);
    residuals on [vlong, vlat, yawrate] over Ts. Returns (TireParams of
    floats, rms0, rms1, theta (8,) numpy)."""
    device = resolve_device(device)
    f64 = torch.float64
    t = lambda a: torch.as_tensor(a, dtype=f64, device=device)
    n = d["simU"].shape[0]
    X, Xn = t(d["CiLX"][:n]), t(d["CiLX"][1:n + 1])
    U = torch.stack([t(d["MPC_SimX"][1:n + 1, 7]), t(d["simU"][:, 1])], dim=1)
    base = tire_fit.log_base(TP0, f64, device)

    def loss(theta):
        tp = tire_fit.tires_at(theta, base, TP0.mu)
        nxt = rk4_multistep(lambda x, u: sim_ode(x, u, VP, tp), X, U, TS, 4)
        return torch.mean(((nxt - Xn)[:, 3:6] / TS) ** 2)

    theta = torch.zeros(8, dtype=f64, device=device)
    with torch.no_grad():
        rms0 = float(torch.sqrt(loss(theta)))
    state = adam_init([theta])
    for _ in range(n_steps):
        theta.requires_grad_(True)
        (g,) = torch.autograd.grad(loss(theta), theta)
        (upd,), state = adam_update([g], state, lr)
        theta = theta.detach() + upd
    with torch.no_grad():
        rms1 = float(torch.sqrt(loss(theta)))
    tp = TireParams(**tire_fit.tire_floats(tire_fit.tires_at(theta, base, TP0.mu)))
    return tp, rms0, rms1, theta.cpu().numpy()


def write_yaml(tp: TireParams, path: str, header: str = None):
    tire_fit.write_tires(path, tp, FIT_HEADER if header is None else header)


def write_snmpc_blend(fit_yaml: str = tire_fit.FIT_YAML, alpha: float = 0.35) -> str:
    """Log-space blend of the one-step fit toward the shipped shape, the
    minimal correction under which the SNMPC sample fan stays stable at the
    hairpin; written beside `fit_yaml` as its name + `_snmpc`. Returns its
    path."""
    fit = tire_fit.read_tire_values(fit_yaml)
    shp = np.array(TP0[:8])
    v = np.exp((1 - alpha) * np.log(fit) + alpha * np.log(shp))
    root, ext = os.path.splitext(fit_yaml)
    path = root + "_snmpc" + ext
    write_yaml(TireParams(*v, mu=TP0.mu), path, header=BLEND_HEADER)
    return path


def run_lap(tire_file: str, T: float, device, dtype, controller="nominal", **mpc_kw):
    """One lap of T seconds from the lap's start with `tire_file` (relative
    to data/Config, or absolute) on plant and controller."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig

    sim_cfg = SimConfig(sim_mode=0, T=T, tire_params_file_MPC=tire_file,
                        tire_params_file_simulator=tire_file)
    sim, x0m, x0s, *_ = build_simulation(sim_cfg, MPCConfig(controller=controller, **mpc_kw),
                                         device=device, dtype=dtype)
    _, log = sim.run(x0m[None], x0s[None], sim_cfg.Nsim)
    return log


def stats(lat, vel, U, label):
    """Prints and returns |dev_lat| mean and max, |dev_vel| mean (and the
    control envelopes, printed)."""
    host = lambda a: a.detach().double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    lat, vel = np.abs(host(lat)).ravel(), np.abs(host(vel)).ravel()
    U = host(U).reshape(-1, 2)
    print(f"{label:24s} dev_lat mean/max {lat.mean():.3f}/{lat.max():.3f} m  "
          f"dev_vel mean {vel.mean():.3f} m/s  |jerk|max {np.abs(U[:, 0]).max():.2f}  "
          f"|dsteer|max {np.abs(U[:, 1]).max():.3f}", flush=True)
    return float(lat.mean()), float(lat.max()), float(vel.mean())


def main(argv=None, dtype=torch.float32):
    """Returns dict(tp, rms0, rms1, theta, the statistics of each run, the
    two gaps and verdicts, seconds of the fit and of each lap)."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    d = tire_fit.load_golden(args.golden)
    ds = tire_fit.load_golden(args.golden_snmpc, "--golden-snmpc")
    print("fitting 8 Pacejka parameters to golden transitions ...", flush=True)
    t0 = time.perf_counter()
    tp, rms0, rms1, theta = fit_tires(d, args.steps, device=device)
    common.sync(device)
    fit_s = time.perf_counter() - t0
    cs_f, cs_r = tp.Bf * tp.Cf * tp.Df, tp.Br * tp.Cr * tp.Dr
    cs_f0, cs_r0 = TP0.Bf * TP0.Cf * TP0.Df, TP0.Br * TP0.Cr * TP0.Dr
    print(f"one-step RMS [m/s^2]: shipped {rms0:.3f} -> fitted {rms1:.3f}")
    print(f"effective cornering stiffness BCD front/rear: {cs_f/1e3:.1f}k/{cs_r/1e3:.1f}k  "
          f"({cs_f/cs_f0:.2f}x/{cs_r/cs_r0:.2f}x shipped)")
    print(f"fitted: {tp}")
    print(f"fit: {args.steps} Adam steps in {fit_s:.3f} s", flush=True)
    write_yaml(tp, args.out)
    print(f"wrote {args.out}", flush=True)

    out = dict(tp=tp, rms0=rms0, rms1=rms1, theta=theta, fit_s=fit_s, laps_s={})
    n = d["simU"].shape[0]
    g_mean, _, _ = out["golden"] = stats(d["dev_lat"][:n], d["dev_vel"][:n], d["simU"],
                                         "golden ACC24")

    def lap(name, tire_file, label, **kw):
        t0 = time.perf_counter()
        log = run_lap(tire_file, args.T, device, dtype, **kw)
        common.sync(device)
        out["laps_s"][name] = time.perf_counter() - t0
        out[name] = stats(log.lat_dev, log.vel_dev, log.simU, label)
        out[name + "_ok"] = float((log.simSolverDebug[..., 4] == 0).double().mean())
        return out[name][0]

    f_mean = lap("fitted", args.out, "ours, fitted 2023 tires")
    s_mean = lap("shipped", tire_fit.SHIPPED, "ours, shipped tires")
    rel = abs(f_mean - g_mean) / g_mean
    print(f"\nmean dev_lat gap vs golden: fitted {rel*100:.1f}% "
          f"(shipped {abs(s_mean - g_mean) / g_mean * 100:.1f}%)")
    verdict = "CONFIRMED" if rel < 0.10 else "RESIDUAL GAP"
    print(f"attribution (nominal): {verdict} (threshold 10%)")

    blend = write_snmpc_blend(args.out)
    ns = ds["simU"].shape[0]
    gs_mean, _, _ = out["golden_snmpc"] = stats(ds["dev_lat"][:ns], ds["dev_vel"][:ns],
                                                ds["simU"], "golden ACC24 SNMPC")
    sn_mean = lap("snmpc_blend", blend, "ours SNMPC, blend tires", **tire_fit.SNMPC)
    nb_mean = lap("nominal_blend", blend, "ours nominal, blend tires")
    rel_s = abs(sn_mean - gs_mean) / gs_mean
    print(f"\nSNMPC mean dev_lat gap vs golden: blend {rel_s*100:.1f}% "
          f"(nominal with the same blend: {abs(nb_mean - g_mean) / g_mean * 100:.1f}%)")
    verdict_s = "CONFIRMED" if rel_s < 0.25 else "RESIDUAL GAP"
    print(f"attribution (SNMPC): {verdict_s} (threshold 25% — shape-proxy blend)", flush=True)
    out.update(gap=rel, verdict=verdict, gap_snmpc=rel_s, verdict_snmpc=verdict_s, blend=blend)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
