"""The port's host spans (utils/trace.py) on the CPU: the span tree of a
nominal, an SNMPC and an R2NMPC-under-WMPC closed-loop step and of a served
cycle, nested
intervals whose self times add up to the step, the spans as profiler
annotations with the same nesting (and no annotation without a profiler),
a step's outputs unchanged by the tracer, names apart from the benchmark's
own spans, bounded storage, a span that closes when its body raises, and
the tracer under threads. B = 2, one torch thread. The benchmark's readers
of the spans are tested in benchmark/tests/test_bench_trace.py; the
card-only case (a span around a region captured in a CUDA graph) is in
test_torch_cuda.py.
"""
import json
import sys
import threading
import time

import pytest
import torch

from tum_control_tpu_torch import deploy_rt
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.utils import trace

# every span of a step sits directly inside `tc.step`
CALLS = {
    "nominal": {"tc.step": 1, "tc.planner": 1, "tc.rti.linearize": 1, "tc.rti.condense": 1,
                "tc.rti.assemble": 1, "tc.qp.iteration": 3, "tc.qp.polish": 1, "tc.plant": 1,
                "tc.estimator": 1},
    "snmpc": {"tc.step": 1, "tc.planner": 1, "tc.rti.build_qp": 1, "tc.qp.iteration": 3,
              "tc.qp.polish": 1, "tc.plant": 1, "tc.estimator": 1},
}
# R2NMPC's tightening and the WMPC policy's update, every step
CALLS["rnmpc_wmpc"] = dict(CALLS["nominal"], **{"tc.rnmpc.tighten": 1, "tc.wmpc.policy": 1})
MPC = {"nominal": dict(controller="nominal"), "snmpc": dict(controller="snmpc"),
       "rnmpc_wmpc": dict(controller="rnmpc", enable_WMPC=True,
                          WMPC_model="data/wmpc_models/new_BO_F")}
# the span names of the benchmark (benchmark/tracing.py: WRAPPED, the
# controller's `solve` and the profiler window); a `tc.` name never equals one
BENCHMARK_SPANS = ("planner", "plant_rk4", "estimate", "ipm", "polish", "solve", "bench.window")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(path):
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(**MPC[path]),
                                          device="cpu", dtype=torch.float64)
    return sim, traj


@pytest.fixture(scope="module")
def sims():
    return {c: _sim(c) for c in MPC}


def _carry(sim, traj, batch):
    return sim.init_carry(*batched_scenarios(traj, batch))


class StubExecutor:
    """run_synchronous's executor without the native library or its sleep."""

    def __init__(self):
        self.records = []

    def begin_cycle(self):
        return time.monotonic_ns()

    def record(self, *args):
        self.records.append(args)


@pytest.fixture(scope="module")
def recorded(sims):
    """Two nominal steps, one SNMPC step, one R2NMPC-under-WMPC step and two
    served cycles, each a record of its own: (the snapshot, the stub
    executor)."""
    trace.set_enabled(True)
    trace.reset()
    sim, traj = sims["nominal"]
    carry = _carry(sim, traj, 2)
    z = torch.zeros_like(carry.x_sim)
    for _ in range(2):
        carry, _ = sim.step(carry, z, z)
    sim_s, traj_s = sims["snmpc"]
    carry_s = _carry(sim_s, traj_s, 2)
    sim_s.step(carry_s, z, z)
    sim_w, traj_w = sims["rnmpc_wmpc"]
    sim_w.step(_carry(sim_w, traj_w, 2), z, z)
    ex = StubExecutor()
    deploy_rt.run_synchronous(sim, _carry(sim, traj, 1), ex, 2)
    return trace.snapshot(), ex


def _tree(spans):
    """[(name, parent name or None)] of one record's raw spans."""
    return [(name, spans[p][0] if p >= 0 else None) for name, _, _, p in spans]


def _calls(spans):
    out = {}
    for name, *_ in spans:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("controller, records", [("nominal", (0, 1)), ("snmpc", (2,)),
                                                 ("rnmpc_wmpc", (3,))])
def test_steps_record_the_span_tree(recorded, controller, records):
    snap, _ = recorded
    assert [r[0] for r in snap["records"]] == ["tc.step"] * 4 + ["tc.cycle"] * 2
    for r in records:
        root, index, totals = snap["records"][r]
        _, spans = snap["spans"][r]
        assert index == -1 and _calls(spans) == CALLS[controller]
        tree = _tree(spans)
        assert tree[0] == ("tc.step", None)
        assert all(parent == "tc.step" for _, parent in tree[1:])
        # the record's totals are its raw spans summed by name
        assert totals == {name: (sum(t1 - t0 for m, t0, t1, _ in spans if m == name), n)
                          for name, n in _calls(spans).items()}


def test_spans_nest_and_self_times_add_up_to_the_record(recorded):
    snap, _ = recorded
    for _, spans in snap["spans"]:
        child = [0] * len(spans)
        for name, t0, t1, p in spans:
            assert t0 <= t1
            if p >= 0:
                assert spans[p][1] <= t0 and t1 <= spans[p][2]
                child[p] += t1 - t0
        own = [t1 - t0 - c for (_, t0, t1, _), c in zip(spans, child)]
        assert min(own) >= 0
        assert sum(own) == spans[0][2] - spans[0][1]


def test_served_cycles_record_their_spans(recorded):
    snap, ex = recorded
    assert len(ex.records) == 2
    for i, (index, spans) in enumerate(snap["spans"][4:]):
        assert index == i and snap["records"][4 + i][1] == i
        tree = _tree(spans)
        assert tree[0] == ("tc.cycle", None)
        assert [n for n, p in tree if p == "tc.cycle"] == ["tc.step", "tc.cycle.fetch"]


def test_names_differ_from_the_benchmarks_spans(recorded):
    snap, _ = recorded
    names = set().union(*(totals for _, _, totals in snap["records"]))
    assert names == set().union(*CALLS.values()) | {"tc.cycle", "tc.cycle.fetch"}
    assert all(n.startswith(trace.PREFIX) for n in names)
    assert not names & set(BENCHMARK_SPANS)
    with pytest.raises(ValueError, match="tc."):
        with trace.span("planner"):
            pass


def _annotations(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted(((e["ts"], -e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("tc.")))


def test_spans_are_profiler_annotations_with_the_same_nesting(sims, tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    sim, traj = sims["snmpc"]
    carry = _carry(sim, traj, 2)
    z = torch.zeros_like(carry.x_sim)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.step(carry, z, z)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ann = _annotations(tmp_path / "trace.json")
    # each annotation's parent: the innermost annotation around it
    parents, stack = [], []
    for ts, neg, name in ann:
        while stack and stack[-1][0] - stack[-1][1] < ts - neg:
            stack.pop()
        parents.append((name, stack[-1][2] if stack else None))
        stack.append((ts, neg, name))
    assert parents == _tree(trace.snapshot()["spans"][-1][1])

    # no profiler: no record_function is opened, on or off
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    for on in (True, False):
        trace.set_enabled(on)
        try:
            sim.step(carry, z, z)
        finally:
            trace.set_enabled(True)
    assert opened == []


def _outputs_equal_with_the_tracer_off(sim, traj):
    carry = _carry(sim, traj, 2)
    z = torch.zeros_like(carry.x_sim)
    outs = {}
    for on in (True, False):
        trace.set_enabled(on)
        try:
            trace.reset()
            outs[on] = sim.step(carry, z, z)
            assert len(trace.snapshot()["records"]) == int(on)
        finally:
            trace.set_enabled(True)
    flat = lambda t: [x for x in torch.utils._pytree.tree_leaves(t) if isinstance(x, torch.Tensor)]
    on, off = flat(outs[True]), flat(outs[False])
    assert len(on) == len(off) > 10
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_outputs_equal_with_the_tracer_off(sims):
    _outputs_equal_with_the_tracer_off(*sims["nominal"])


def test_wmpc_outputs_equal_with_the_tracer_off(sims):
    """R2NMPC under WMPC: its tightening and policy spans change no output."""
    _outputs_equal_with_the_tracer_off(*sims["rnmpc_wmpc"])


def test_storage_keeps_the_last_records():
    trace.reset()
    n = trace.RECORDS + 5
    for i in range(n):
        with trace.span("tc.test.root", index=i):
            with trace.span("tc.test.leaf"):
                pass
    snap = trace.snapshot()
    assert [r[1] for r in snap["records"]] == list(range(5, n))
    assert [index for index, _ in snap["spans"]] == list(range(n - trace.RAW_RECORDS, n))
    assert all(totals["tc.test.leaf"][1] == 1 for _, _, totals in snap["records"])
    trace.reset()
    assert trace.snapshot() == dict(records=[], spans=[])


def test_a_span_closes_when_its_body_raises():
    trace.reset()
    with pytest.raises(RuntimeError, match="inside"):
        with trace.span("tc.test.root"):
            with trace.span("tc.test.leaf"):
                raise RuntimeError("inside")
    with trace.span("tc.test.next"):
        pass
    snap = trace.snapshot()
    assert [r[0] for r in snap["records"]] == ["tc.test.root", "tc.test.next"]
    assert _tree(snap["spans"][0][1]) == [("tc.test.root", None), ("tc.test.leaf", "tc.test.root")]


def test_threads_keep_records_apart():
    """Threads that trace at once, each its own records: every record holds
    one root and its three leaves (a span put in another thread's record
    breaks one)."""
    n_threads, n_records = 8, 200

    def work():
        for _ in range(n_records):
            with trace.span("tc.test.a"):
                for _ in range(3):
                    with trace.span("tc.test.b"):
                        pass

    trace.reset()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    records = trace.snapshot()["records"]
    assert len(records) == n_threads * n_records
    for root, _, totals in records:
        assert root == "tc.test.a" and set(totals) == {"tc.test.a", "tc.test.b"}
        assert totals["tc.test.a"][1] == 1 and totals["tc.test.b"][1] == 3
        assert totals["tc.test.b"][0] <= totals["tc.test.a"][0]
