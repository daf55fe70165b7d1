"""The reader of the served step's graph counter (benchmark/metrics/
graph_replay_share.serve.py), on the CPU: its number from served cycles
counted by the port (on the CPU every call is eager, so 0; a card's count of
one eager call, one capture and replays after them), None from a batch
record, from a port without the counter and from a counter that counted
nothing; and its entry in BENCHMARK.json against the contract.

    python -m pytest benchmark/tests/test_bench_graph.py -q
"""
import json
import os
import time

import pytest
import torch

from benchmark import run as R
from benchmark.program import settings

NAME = "graph_replay_share.serve"


class StubExecutor:
    """run_synchronous's executor without the native library or its sleep."""

    def begin_cycle(self):
        return time.monotonic_ns()

    def record(self, *args):
        pass


def _read(mode="serve"):
    return R.metric_reader(NAME).read(dict(mode=mode))


def test_reads_the_served_cycles_count(monkeypatch):
    from tum_control_tpu_torch import deploy_rt
    from tum_control_tpu_torch.api import build_simulation

    monkeypatch.setattr(deploy_rt, "GRAPH_STEPS", dict(eager=0, capture=0, replay=0))
    assert _read() is None
    cfg = json.load(open(os.path.join(R.ROOT, "benchmark", "configs", "nominal.json")))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sim, x0m, x0s, _, _ = build_simulation(*settings(cfg), device="cpu", dtype=torch.float64)
        deploy_rt.run_synchronous(sim, sim.init_carry(x0m[None], x0s[None], key=1),
                                  StubExecutor(), 2)
    finally:
        torch.set_num_threads(n)
    assert deploy_rt.GRAPH_STEPS == dict(eager=2, capture=0, replay=0)
    assert _read() == 0.0
    # a card's run: the eager call and the capture in the warm-up, then replays
    deploy_rt.GRAPH_STEPS.update(eager=1, capture=1, replay=2548)
    assert _read() == pytest.approx(2548 / 2550, rel=1e-15)


def test_none_from_a_batch_record_and_without_the_counter(monkeypatch):
    from tum_control_tpu_torch import deploy_rt

    monkeypatch.setattr(deploy_rt, "GRAPH_STEPS", dict(eager=1, capture=1, replay=8))
    assert _read("batch") is None and _read() == 0.8
    monkeypatch.delattr(deploy_rt, "GRAPH_STEPS")
    assert _read() is None


def test_entry_follows_the_contract():
    """The entry under `per_layer` against the contract the other per-layer
    metrics are held to in test_bench_spec.py; found by its name, as later
    entries follow it."""
    spec = R.load_spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    m = next(p for p in spec["per_layer"] if p["name"] == NAME)
    assert m == dict(name=NAME, unit="share", better="higher", source="program_counter",
                     layer="serving (deploy_rt.py, utils/rt_runtime.py)", moves="cycle_ms_p95",
                     workloads=["nominal.serve"])
    reader = R.metric_reader(NAME)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
    assert m["layer"] in {p["layer"] for p in spec["per_layer"] if p["name"] != NAME}
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])
    assert [p["name"] for p in spec["per_layer"]].count(NAME) == 1
