"""Spans around the port's layer entry points, and the profiler window.

Spans are the benchmark's own: in a traced run, `Spans.install` replaces
the entry points named in `WRAPPED` by wrappers that time each call on the
host's clock and open a `torch.profiler.record_function` of the same name;
`Spans.remove` puts the originals back. No file of the port changes. A
name the port no longer has is skipped, and the metrics that read it
report nothing.

`profile_window` runs a few steps under `torch.profiler` (CPU and CUDA
activity), exports the Chrome trace into a temporary directory (under
TMPDIR, deleted afterwards) and reduces it: device operations with their
intervals, each kernel attributed to the spans whose host interval holds
its launch, the union of device intervals, the window's length, and the
idle gaps between device operations by the span the host was in.
"""
from __future__ import annotations

import collections
import contextlib
import importlib
import json
import os
import tempfile
import time

import torch

# span name -> (module, attribute) of the entry point it wraps; the
# controller's `solve` is wrapped on the controller instance
WRAPPED = {
    "planner": ("tum_control_tpu_torch.sim.closed_loop", "planner_emulator"),
    "plant_rk4": ("tum_control_tpu_torch.sim.closed_loop", "rk4_multistep"),
    "estimate": ("tum_control_tpu_torch.sim.closed_loop", "estimate"),
    "ipm": ("tum_control_tpu_torch.ops.rti", "solve_soft_qp_ipm"),
    "polish": ("tum_control_tpu_torch.ops.ipm", "newton_polish"),
}
WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Host seconds and calls per span name, while installed."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._undo = []

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.seconds[name] += time.perf_counter() - t0
                    self.calls[name] += 1
        return wrapped

    def install(self, controller):
        for name, (mod_name, attr) in WRAPPED.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            setattr(mod, attr, self._wrap(name, fn))
            self._undo.append((mod, attr, fn))
        if hasattr(controller, "solve"):
            controller.solve = self._wrap("solve", controller.solve)
            self._undo.append((controller, "solve", None))

    def remove(self):
        for obj, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        self._undo.clear()

    def reset(self):
        self.seconds.clear()
        self.calls.clear()


def _union(intervals):
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    return total + (end - start if end is not None else 0.0)


def reduce_trace(events: list, span_names) -> dict:
    """The profiler window's numbers from Chrome-trace events (times in us)."""
    win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no '{WINDOW}' annotation")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") in span_names]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name = collections.defaultdict(float)
    span_dev = collections.defaultdict(float)
    unattributed = 0
    for e in kernels:
        by_name[e["name"]] += e["dur"] * 1e-6
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            unattributed += 1
            continue
        for s in spans:
            if s["ts"] <= ts <= s["ts"] + s["dur"]:
                span_dev[s["name"]] += e["dur"] * 1e-6
    ivals = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    ivals = [(a, b) for a, b in ivals if b > a]
    # idle gaps between device operations, by the innermost span the host was in
    gaps = collections.defaultdict(float)
    merged, end = [], w0
    for a, b in sorted(ivals):
        if a > end:
            merged.append((end, a))
        end = max(end, b)
    if w1 > end:
        merged.append((end, w1))
    for a, b in merged:
        mid = 0.5 * (a + b)
        inside = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
        name = min(inside, key=lambda s: s["dur"])["name"] if inside else "outside the spans"
        gaps[name] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=_union(ivals) * 1e-6, kernels=len(kernels),
                device_ops=len(dev), unattributed=unattributed, span_device_s=dict(span_dev),
                top_ops=top(by_name), idle_gaps=top(gaps))


def profile_window(fn, span_names, device) -> dict:
    """`fn()` (a few steps) under torch.profiler inside the WINDOW
    annotation, synchronised inside it; the reduced trace."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        raise RuntimeError("the profiler window measures the card: no CUDA device in this run")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)
        with open(path, "r") as fh:
            events = json.load(fh)["traceEvents"]
    return reduce_trace(events, set(span_names))


@contextlib.contextmanager
def installed(spans: Spans, controller):
    spans.install(controller)
    try:
        yield spans
    finally:
        spans.remove()
