"""Shared pieces of the measurement and diagnostic tools: the device and
float type of a run, the card's name and power limit, the scenario starts
of the per-stage tools, timing, and the kernels a call launches.

On the card a tool runs in float32 (`main(argv, dtype=...)` takes another
type for the CPU); every time named "device" comes from CUDA events or the
profiler, and a CPU run prints "not measured" in its place.
"""
from __future__ import annotations

import argparse
import math
import re
import subprocess
import time

import numpy as np
import torch

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.ops.kernels import build

NOT_MEASURED = "not measured"


def add_device_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    return out.splitlines()[0]


def start(args, dtype=torch.float32) -> torch.device:
    """Resolves --device and prints the device line of the run."""
    device = resolve_device(args.device)
    print(f"device: {card(device)} ({dtype})", flush=True)
    return device


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lap_starts(traj, batch: int, dtype, device):
    """(batch, 8) states at `batch` points spread evenly along the lap, at the
    reference speed with the lateral states zero (the per-stage tools'
    starts: tools/profile_step.py, stage_bench.py, snmpc_dissect.py)."""
    host = lambda t: t.detach().cpu().double().numpy()
    starts = np.linspace(0, traj.n_points - 1, batch).astype(np.int32)
    pos = host(traj.pos)[starts]
    yaw = np.mod(host(traj.yaw)[starts], 2 * np.pi)
    v = host(traj.v)[starts]
    x = np.stack([pos[:, 0], pos[:, 1], yaw, v, 0 * v, 0 * v, 0 * v, 0 * v], axis=1)
    return torch.as_tensor(x, dtype=dtype, device=device)


class Launches:
    """The hand-written kernels' launches (ops/kernels/build.py::LAUNCHES)
    made inside a `with` block, by kernel, zeros left out."""

    def __enter__(self):
        self.before = dict(build.LAUNCHES)
        return self

    def __exit__(self, *exc):
        self.counts = {k: v - self.before[k] for k, v in build.LAUNCHES.items()
                       if v != self.before[k]}
        return False


def host_ms(fn, n: int, device):
    """Milliseconds per call of `fn` on the host's clock, `n` calls after one
    warm-up, synchronized before and after (the JAX tools' `bench`)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def chained(step, carry, R: int, device):
    """`step` applied R times from `carry`, after one warm-up call from the
    same carry. Returns (the carry after R steps, host ms per iteration to
    issue them, wall ms per iteration until the device finished, device ms
    per iteration between CUDA events around the loop or None on the CPU).
    With the host ahead of the device the device time exceeds the host's;
    a host-bound loop shows both equal (the device waits for launches)."""
    step(carry)
    sync(device)
    ev = None
    if device.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    c = carry
    for _ in range(R):
        c = step(c)
    t1 = time.perf_counter()
    if ev is not None:
        ev[1].record()
    sync(device)
    t2 = time.perf_counter()
    dev_ms = ev[0].elapsed_time(ev[1]) / R if ev is not None else None
    return c, (t1 - t0) / R * 1e3, (t2 - t0) / R * 1e3, dev_ms


def profile_call(fn, device, n: int = 1):
    """One torch.profiler window of `n` calls of `fn` (after a warm-up call):
    (device kernels launched per call, device ms per call, device ms per call
    of the hand-written kernels), or None on the CPU, where no device runs."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        sync(device)
    rows = [r for r in prof.key_averages() if str(r.device_type).endswith("CUDA")]
    hand = [r for r in rows if HAND_KERNEL.search(r.key)]
    return (sum(r.count for r in rows) / n, sum(device_us(r) for r in rows) / n / 1e3,
            sum(device_us(r) for r in hand) / n / 1e3)


# the csrc kernels' symbols, as the profiler names them
HAND_KERNEL = re.compile(r"\b(linearize_kernel|condense_kernel|chol_factor_kernel|"
                         r"chol_solve_kernel|ipm_iter_kernel)\b")


def device_us(row) -> float:
    """Device microseconds of one torch.profiler `key_averages()` row."""
    return (getattr(row, "self_device_time_total", 0.0)
            or getattr(row, "self_cuda_time_total", 0.0))


def settle_and_run(sim, x0m, x0s, settle: int, steps: int, device):
    """bench.py's protocol: `settle` closed-loop steps (at least 1), two
    untimed steps from the settled carry (the first launches build and load
    the kernels), then `steps` timed steps from it, synchronized before and
    after. Returns (settled carry, settle log, carry, log, seconds)."""
    c0, slog = sim.run(x0m, x0s, settle, key=0)
    sim.run_from(c0, 2)
    sync(device)
    t0 = time.perf_counter()
    carry, log = sim.run_from(c0, steps)
    sync(device)
    return c0, slog, carry, log, time.perf_counter() - t0


def fmt_ms(v, digits: int = 3) -> str:
    return NOT_MEASURED if v is None else f"{v:.{digits}f} ms"


def all_finite(x) -> bool:
    """True when every number in a nest of dicts, lists, tuples, arrays and
    tensors is finite."""
    if isinstance(x, dict):
        return all(all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(all_finite(v) for v in x)
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point() or bool(torch.isfinite(x).all())
    if isinstance(x, np.ndarray):
        return not np.issubdtype(x.dtype, np.floating) or bool(np.isfinite(x).all())
    if isinstance(x, float):
        return math.isfinite(x)
    return True
