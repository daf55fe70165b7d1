"""The six readers of the port's host spans (benchmark/metrics/: planner,
QP build, QP iterations, polish and rest of a batch step; the served
cycle's wait for its control), on the CPU: their numbers from steps and
cycles recorded with the benchmark's own spans installed, as in a traced
run; the parts adding up to the step; None from a tracer that recorded
nothing, from the other mode, and from a port without the tracer; no
span name of the port equal to one of the benchmark's; and the six
entries in BENCHMARK.json against the contract.

    python -m pytest benchmark/tests/test_bench_trace.py -q
"""
import json
import os
import statistics
import sys
import time

import pytest
import torch

from benchmark import run as R
from benchmark.program import settings
from benchmark.tracing import WINDOW, WRAPPED, Spans, installed

READERS = ("planner_ms.batch", "qp_build_ms.batch", "qp_iterations_ms.batch", "polish_ms.batch",
           "step_rest_ms.batch", "control_wait_ms.serve")
BUILD = ("tc.rti.linearize", "tc.rti.condense", "tc.rti.assemble", "tc.rti.build_qp")
PARTS = ("tc.planner", "tc.qp.iteration", "tc.qp.polish", "tc.plant", "tc.estimator") + BUILD


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubExecutor:
    """run_synchronous's executor without the native library or its sleep."""

    def begin_cycle(self):
        return time.monotonic_ns()

    def record(self, *args):
        pass


@pytest.fixture(scope="module")
def snap():
    """Two nominal steps, one SNMPC step and two served cycles at B = 2 in
    float64, the benchmark's spans installed: the port's tracer's snapshot."""
    from tum_control_tpu_torch import deploy_rt
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios
    from tum_control_tpu_torch.utils import trace

    sims = {}
    for config in ("nominal", "snmpc"):
        cfg = json.load(open(os.path.join(R.ROOT, "benchmark", "configs", f"{config}.json")))
        sim, _, _, traj, _ = build_simulation(*settings(cfg), device="cpu", dtype=torch.float64)
        sims[config] = sim, sim.init_carry(*batched_scenarios(traj, 2))
    trace.set_enabled(True)
    trace.reset()
    for config, steps in (("nominal", 2), ("snmpc", 1)):
        sim, carry = sims[config]
        z = torch.zeros_like(carry.x_sim)
        with installed(Spans(), sim.controller):
            for _ in range(steps):
                carry, _ = sim.step(carry, z, z)
    sim, carry = sims["nominal"]
    with installed(Spans(), sim.controller):
        deploy_rt.run_synchronous(sim, carry, StubExecutor(), 2)
    return trace.snapshot()


def _expected_ms(snap, root, names, minus=()):
    """A reader's number recomputed from the raw spans."""
    vals = []
    for _, spans in snap["spans"]:
        if spans[0][0] != root or not any(s[0] in names for s in spans):
            continue
        dur = lambda ns: sum(t1 - t0 for n, t0, t1, _ in spans if n in ns)
        vals.append(1e-6 * (dur(names) - dur(minus)))
    return statistics.median(vals)


def _read_all(mode_of_batch="batch", mode_of_serve="serve"):
    return {name: R.metric_reader(name).read(
        dict(mode=mode_of_serve if name.endswith(".serve") else mode_of_batch))
        for name in READERS}


def test_readers_read_the_recorded_spans(snap, monkeypatch):
    from tum_control_tpu_torch.utils import trace

    assert [r[0] for r in snap["records"]] == ["tc.step"] * 3 + ["tc.cycle"] * 2
    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    want = {
        "planner_ms.batch": _expected_ms(snap, "tc.step", ("tc.planner",)),
        "qp_build_ms.batch": _expected_ms(snap, "tc.step", BUILD),
        "qp_iterations_ms.batch": _expected_ms(snap, "tc.step", ("tc.qp.iteration",)),
        "polish_ms.batch": _expected_ms(snap, "tc.step", ("tc.qp.polish",)),
        "step_rest_ms.batch": _expected_ms(snap, "tc.step", ("tc.step",), PARTS),
        "control_wait_ms.serve": _expected_ms(snap, "tc.cycle", ("tc.cycle.fetch",)),
    }
    got = _read_all()
    assert got == pytest.approx(want, rel=1e-12)
    assert all(v > 0 for v in got.values())
    # the wrong mode reads nothing
    assert all(v is None for v in _read_all("serve", "batch").values())


def test_the_parts_add_up_to_the_step(snap):
    """Per step: planner + QP build + QP iterations + polish + rest + plant
    + estimator is `tc.step`, each part read as its reader reads it."""
    from tum_control_tpu_torch.utils import trace

    for record in snap["records"][:3]:
        one = dict(records=[record], spans=[])
        parts = [trace.median_ms(one, "tc.step", names) for names in
                 (("tc.planner",), BUILD, ("tc.qp.iteration",), ("tc.qp.polish",),
                  ("tc.plant",), ("tc.estimator",))]
        rest = trace.median_ms(one, "tc.step", ("tc.step",), minus=PARTS)
        step = trace.median_ms(one, "tc.step", ("tc.step",))
        assert sum(parts) + rest == pytest.approx(step, rel=1e-12) and rest > 0


def test_readers_return_none_from_an_empty_tracer(monkeypatch):
    from tum_control_tpu_torch.utils import trace

    empty = trace.Tracer().snapshot()
    monkeypatch.setattr(trace, "snapshot", lambda: empty)
    assert all(v is None for v in _read_all().values())


def test_readers_return_none_without_the_tracer(monkeypatch):
    """As on a port that has no tracer (the module cannot be imported)."""
    import tum_control_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "tum_control_tpu_torch.utils.trace", None)
    assert all(v is None for v in _read_all().values())


def test_port_spans_differ_from_the_benchmarks(snap):
    names = set().union(*(totals for _, _, totals in snap["records"]))
    assert {"tc.step", "tc.cycle", "tc.rti.build_qp", "tc.qp.polish"} <= names
    assert all(n.startswith("tc.") for n in names)
    assert not names & (set(WRAPPED) | {"solve", WINDOW})


@pytest.mark.parametrize("name", READERS)
def test_entries_follow_the_contract(name):
    """Each of the six entries under `per_layer`, looked up by name, against
    the contract the other per-layer metrics are held to in
    test_bench_spec.py: its cells are cells of the end-to-end metric it
    moves, wherever it stands in the list and whichever cells come later."""
    spec = R.load_spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    (m,) = [m for m in spec["per_layer"] if m["name"] == name]
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "program_span")
    reader = R.metric_reader(name)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
    assert m["layer"] in {p["layer"] for p in spec["per_layer"] if p["name"] not in READERS}
    assert m["moves"] == ("cycle_ms_p95" if name.endswith(".serve") else "device_solves_per_s")
    cells = {w["name"] for w in spec["workloads"]}
    assert m["workloads"] and set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
