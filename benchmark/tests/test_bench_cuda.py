"""On the card only (marked `cuda`; they skip without a CUDA device):

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_cuda.py -q

- the control: each cell's run at its own size (a short window), then the
  reference put in the program's place and computed one precision below
  the configuration's float32 (float32 with TF32 matmuls), from the same
  sampled carries, judged by the cell's own limits: it must come out not
  correct, where the program's own outputs come out correct;
- in each cell that draws disturbances, a run whose plant gets none
  (faults.py's `dropped_draws`) at the cell's own size is not correct;
- a traced run of the nominal batch cell reports every per-layer metric of
  the cell, with the device's busy and window seconds.
"""
import importlib
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as R
from benchmark.compare import in_place_of_program, judge
from benchmark.faults import planted
from benchmark.reference.closed_loop import Reference, tf32

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", [w["name"] for w in R.load_spec()["workloads"]])
def test_the_control_is_not_correct(card, workload):
    cell = R.cell_of(R.load_spec(), workload)
    driver = importlib.import_module(f"benchmark.driver_{cell.traffic['driver']}")
    ctx = SimpleNamespace(cell=cell, seed=2**31 + 55, seconds=2.0, trace=False, device=card,
                          t_start=time.perf_counter(), peaks=None)
    out = driver.run(ctx)
    with tf32(False):
        ref64 = Reference(cell.cfg, R.ROOT, dtype=torch.float64, device=card)
        program = judge(out.samples, ref64, cell.limits)
    ctrl = Reference(cell.cfg, R.ROOT, dtype=torch.float32, device=card)
    with tf32(True):
        outs = [ctrl.step(s["before"]) for s in out.samples]
    with tf32(False):
        control = judge(in_place_of_program(out.samples, outs), ref64, cell.limits)
    assert all(c["value"] <= c["limit"] for c in program.values()), program
    assert any(c["value"] > c["limit"] for c in control.values()), control


@pytest.mark.parametrize("workload", [w["name"] for w in R.load_spec()["workloads"]
                                      if R.cell_of(R.load_spec(), w["name"])
                                      .cfg["sim"].get("simulate_disturbances")])
def test_dropped_draws_are_not_correct(card, workload):
    with planted("dropped_draws"):
        res = R.run_cell(workload, 2**31 + 66, 2.0, False)
    assert res["correct"] is False, res["compared"]


def test_traced_run_reports_every_per_layer_metric(card):
    res = R.run_cell("nominal.b128", 2**31 + 77, 2.0, True)
    cell = R.cell_of(R.load_spec(), "nominal.b128")
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert res["correct"] is True
