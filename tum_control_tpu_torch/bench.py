"""Headline benchmark of the port: aggregate closed-loop NMPC solve
throughput on one card (port of the root bench.py):

    python -m tum_control_tpu_torch.bench [batch] [steps] [--device cuda|cpu]

bench.py's protocol. The nominal NMPC on Monteblanco, SimConfig(sim_mode=0,
T = steps x 0.02 s), MPCConfig(qp_iters = $BENCH_QP_ITERS, else the
shipped value), B = `batch` scenarios spread along the lap
(parallel/mesh.py::batched_scenarios) in float32: `settle` closed-loop
steps (100; the controller and estimator settle before the metrics), two
untimed steps from the settled carry (the first launches build and load the
kernels, bench.py's compile call), then `steps` timed steps of `run_from`
from the settled carry, synchronized on both sides (tools/common.py::
settle_and_run). solves/s = B x steps / seconds (one step of every
scenario is B solves); the reference's single-stream solver is the
baseline, 1 / 1.026 ms = 974.7 solve/s.

On stderr: the card's name and power limit, the host's CPU model; the
throughput line, the solver-ok fraction (status 0) and |lat_dev| p50 / p99
over the timed window; the single-stream per-step latency (B = 1, `steps`
steps, the second call timed, from x0 + 1e-6); the SNMPC and the R2NMPC at
min(steps, 300) steps and B = `batch` (the second `run` timed), each with
its throughput against the reference's single-stream solve time (6.178 /
1.026 ms). On stdout, as its last line, bench.py's JSON:

    {"metric": "nmpc_solves_per_sec", "value": ..., "unit": "solve/s",
     "vs_baseline": ...}

One departure from bench.py: a failed SNMPC or R2NMPC run is not caught
and logged; its exception propagates and the process exits non-zero, since
a caught failure with exit 0 would hide a broken device or kernel.

`measure(batch, steps, settle, device, dtype)` runs the protocol and
returns its figures and logs; `main(argv)` prints and returns what it
printed. The kernels on this path: K1-K5 on the nominal NMPC and the
R2NMPC, K1, K6 and K3-K5 on the SNMPC.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.tools import common

BASELINE_SOLVES_PER_SEC = 1.0 / 1.026e-3  # ACC24 nominal NMPC mean solve time
SETTLE = 100
# the reference's single-stream mean solve times (BASELINE.md), ms
REF_SINGLE_STREAM_MS = {"snmpc": 6.178, "rnmpc": 1.026}
MAX_CONTROLLER_STEPS = 300


def cpu_model() -> str:
    """The host CPU's model name: /proc/cpuinfo's "model name", else lscpu's
    "Model name" (ARM hosts list no model in /proc/cpuinfo), else the
    machine type."""
    import platform
    import subprocess

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    for line in out.splitlines():
        if line.strip().startswith("Model name"):
            return line.split(":", 1)[1].strip()
    return platform.machine() or "unknown"


def _say(lines, msg):
    lines.append(msg)
    print(msg, file=sys.stderr, flush=True)


def _ok_fraction(log) -> float:
    return float((log.simSolverDebug[..., 4] == 0).double().mean())


def measure(batch: int = 128, steps: int = 1000, settle: int = SETTLE, device=None,
            dtype=torch.float32) -> dict:
    """bench.py's protocol on `device` (cuda unless named); returns the
    figures (solves_per_sec, seconds, ok, lat_p50, lat_p99, single_ms, and per
    controller in `controllers`: solves_per_sec, seconds, steps, ok,
    vs_ref_single_stream), `stderr` (the lines it printed there) and `logs`
    (SimLogs: settle, nominal (the timed window), single, snmpc, rnmpc)."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    device = resolve_device(device)
    lines = []
    _say(lines, f"device: {common.card(device)} ({dtype}); host CPU: {cpu_model()}")
    qp_iters = int(os.environ.get("BENCH_QP_ITERS", MPCConfig().qp_iters))
    sim, x0m, x0s, traj, _ = build_simulation(SimConfig(sim_mode=0, T=steps * 0.02),
                                              MPCConfig(qp_iters=qp_iters), device=device,
                                              dtype=dtype)
    x0m_b, x0s_b = batched_scenarios(traj, batch, dtype=dtype, device=device)
    _, slog, _, log, dt = common.settle_and_run(sim, x0m_b, x0s_b, settle, steps, device)
    sps = batch * steps / dt
    ok = _ok_fraction(log)
    lat = log.lat_dev.abs().double().cpu().numpy()
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    _say(lines, f"batch={batch} steps={steps}: {dt:.3f}s -> {sps:.0f} solves/s")
    _say(lines, f"solver ok fraction: {ok:.4f}; lat_dev p50/p99: {p50:.3f}/{p99:.3f} m")

    # single-stream latency: the first call builds, the second (from a moved
    # start) is timed to the host's read of its result
    _, l1 = sim.run(x0m[None], x0s[None], steps, key=0)
    float(l1.lat_dev.sum())
    t0 = time.perf_counter()
    _, l1 = sim.run(x0m[None] + 1e-6, x0s[None] + 1e-6, steps, key=0)
    float(l1.lat_dev.sum())
    single_ms = (time.perf_counter() - t0) / steps * 1e3
    _say(lines, f"single-stream per-step latency: {single_ms:.3f} ms")

    controllers, logs = {}, dict(settle=slog, nominal=log, single=l1)
    for name, base_ms in REF_SINGLE_STREAM_MS.items():
        steps_c = min(steps, MAX_CONTROLLER_STEPS)
        sim_c, *_ = build_simulation(SimConfig(sim_mode=0, T=steps_c * 0.02),
                                     MPCConfig(controller=name), device=device, dtype=dtype)
        sim_c.run(x0m_b, x0s_b, steps_c, key=0)   # builds the path's kernels
        common.sync(device)
        t0 = time.perf_counter()
        _, log_c = sim_c.run(x0m_b, x0s_b, steps_c, key=0)
        common.sync(device)
        dt_c = time.perf_counter() - t0
        sps_c = batch * steps_c / dt_c
        ok_c = _ok_fraction(log_c)
        vs = sps_c * base_ms / 1e3
        controllers[name] = dict(solves_per_sec=sps_c, seconds=dt_c, steps=steps_c, ok=ok_c,
                                 vs_ref_single_stream=vs)
        logs[name] = log_c
        _say(lines, f"{name}: {sps_c:.0f} solves/s (batch={batch}, steps={steps_c}), "
                    f"ok={ok_c:.4f}, vs_ref_single_stream={vs:.1f}x")
    return dict(batch=batch, steps=steps, settle=settle, qp_iters=qp_iters,
                solves_per_sec=sps, seconds=dt, ok=ok, lat_p50=p50, lat_p99=p99,
                single_ms=single_ms, controllers=controllers, stderr=lines, logs=logs)


def headline(sps: float) -> dict:
    """bench.py's JSON line."""
    return {"metric": "nmpc_solves_per_sec", "value": round(sps, 1), "unit": "solve/s",
            "vs_baseline": round(sps / BASELINE_SOLVES_PER_SEC, 2)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("steps", nargs="?", type=int, default=1000)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32) -> dict:
    """Runs the benchmark; returns what it printed, {"stderr": [lines],
    "json": the last stdout line's object}, and `measure`'s result."""
    args = parse_args(argv)
    res = measure(args.batch, args.steps, SETTLE, args.device, dtype)
    line = headline(res["solves_per_sec"])
    print(json.dumps(line), flush=True)
    return {"stderr": res["stderr"], "json": line, "measure": res}


if __name__ == "__main__":
    main(sys.argv[1:])
