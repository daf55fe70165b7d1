"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration (benchmark/configs/<config>.json) and a
traffic mix (benchmark/traffic/<traffic>.json); the mix names its driver
(benchmark/driver_<driver>.py), which builds the port's closed loop, warms
it up, runs the measured window and keeps a seeded sample of its steps.
`--trace 0` reports the cell's end-to-end metrics; `--trace 1` runs the
same window with the benchmark's spans around the port's layers, then a
short profiler window, and reports the cell's per-layer metrics, each read
by its reader benchmark/metrics/<metric>.py. After the window the float64
reference (benchmark/reference/) recomputes the sampled steps and
benchmark/limits/<cell>.json holds the limits of the numbers compared.

The last line on standard output is one JSON object: correct, attempted,
failed, metrics, device, (with --trace 1) breakdown, and last `compared`,
each number compared beside its limit. Notes go to standard error, the
numbers compared last. Without a CUDA device the run exits with code 2 and
prints no result; so it does if a JAX module is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "tum_control_tpu")
THREADS = 2   # CPU threads of torch's pool: the step's work is on the card


class Refused(Exception):
    """The run cannot measure here (no card, a forbidden module)."""


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), "r") as fh:
        return json.load(fh)


def _json(root, *parts):
    with open(os.path.join(root, "benchmark", *parts), "r") as fh:
        return json.load(fh)


def metric_reader(name: str, root: str = ROOT):
    """The module benchmark/metrics/<name>.py (UNIT, LAYER, MOVES, read)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(spec: dict, workload: str, root: str = ROOT) -> SimpleNamespace:
    """Everything a cell's run reads, found by the names in BENCHMARK.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload '{workload}'; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    applies = lambda m: workload in m.get("workloads", [workload])
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    per_layer = [m for m in spec["per_layer"] if applies(m)]
    return SimpleNamespace(name=workload, chips=int(w["chips"]),
                           cfg=_json(root, "configs", f"{w['config']}.json"),
                           traffic=_json(root, "traffic", f"{w['traffic']}.json"),
                           limits=_json(root, "limits", f"{workload}.json"), e2e=e2e,
                           per_layer=per_layer)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, power_limit="none")
    try:
        power = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                                "-i", str(device.index or 0)], capture_output=True, text=True,
                               check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        power = "not read"
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                power_limit=power)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             t_start: float = T_START, root: str = ROOT) -> dict:
    """One run of `workload`; returns the result line's object. `device`
    None takes the card and refuses to run without one (the benchmark's
    runs); the CPU tests pass a CPU device. `root` is the checkout that
    holds BENCHMARK.json and benchmark/."""
    import torch

    torch.set_num_threads(THREADS)
    spec = load_spec(root)
    cell = cell_of(spec, workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise Refused(f"this run needs {cell.chips} CUDA device(s); "
                          f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    info = card(device)
    driver = importlib.import_module(f"benchmark.driver_{cell.traffic['driver']}")
    ctx = SimpleNamespace(cell=cell, seed=int(seed), seconds=float(seconds), trace=trace,
                          device=device, t_start=t_start, peaks=None)
    if trace:
        from benchmark.peaks import PEAKS
        ctx.peaks = PEAKS.get(info["kind"])
        say(f"card: {info['kind']}, power limit {info['power_limit']}; peaks "
            + (f"{ctx.peaks['f32_flops_per_s']:.3e} FLOP/s float32, "
               f"{ctx.peaks['bytes_per_s']:.3e} B/s" if ctx.peaks else "not known for this card"))
    out = driver.run(ctx)
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded once the window closed: {', '.join(found)}")

    from benchmark.compare import judge
    from benchmark.reference.closed_loop import Reference, tf32

    t_ref = time.perf_counter()
    with tf32(False):
        ref = Reference(cell.cfg, root, dtype=torch.float64, device=device)
        compared = judge(out.samples, ref, cell.limits)
    say(f"reference: {len(out.samples)} sampled steps of {out.sample_rows} rows each, "
        f"{time.perf_counter() - t_ref:.3f} s")
    finite = all(math.isfinite(c["value"]) for c in compared.values())
    correct = bool(out.samples) and finite and all(c["value"] <= c["limit"]
                                                   for c in compared.values())

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"], root).read(out.record)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for m in cell.e2e:
            if m["name"] in out.e2e:
                metrics[m["name"]] = dict(value=out.e2e[m["name"]], unit=m["unit"])
    dev = dict(platform=info["platform"], kind=info["kind"], count=info["count"],
               memory_peak_bytes=out.memory_peak_bytes)
    result = dict(correct=correct, attempted=out.attempted, failed=out.failed, metrics=metrics,
                  device=dev)
    if trace:
        prof = out.record["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = dict(device_ops=prof["top_ops"], idle_gaps=prof["idle_gaps"])
    result["compared"] = {k: dict(value=c["value"] if math.isfinite(c["value"]) else None,
                                  limit=c["limit"]) for k, c in compared.items()}
    for k, c in compared.items():
        say(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as e:
        say(f"refused: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
