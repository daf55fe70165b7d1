"""A CPU dry run of every cell (a batch of 2, a window of one second, the
port's plain versions): the result line has the contract's keys, the cell's
end-to-end metrics and the numbers compared last, and the process that ran
it loaded no module of JAX or of the JAX package. On the CPU nothing is
timed: the numbers only show that the path runs."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run as R
from benchmark.tracing import profile_window

DRY = r"""
import json, sys
sys.path.insert(0, ROOT)
import benchmark.run as R
cell_of = R.cell_of
def small(spec, w, root=R.ROOT):
    c = cell_of(spec, w, root)
    if "batch" in c.traffic:
        c.traffic["batch"] = 2
    return c
R.cell_of = small
res = R.run_cell(WORKLOAD, 2**31 + 977, 1.0, False, device="cpu")
print(json.dumps(dict(result=res, loaded=R.forbidden_modules())))
"""


@pytest.mark.parametrize("workload", [w["name"] for w in R.load_spec()["workloads"]])
def test_cpu_dry_run(workload):
    code = f"ROOT = {R.ROOT!r}\nWORKLOAD = {workload!r}\n" + DRY
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=R.ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res = got["result"]
    assert got["loaded"] == []
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    cell = R.cell_of(R.load_spec(), workload)
    # a device metric is never read off a CPU run
    assert set(res["metrics"]) == {m["name"] for m in cell.e2e if m["source"] != "device_trace"}
    assert res["device"]["platform"] == "cpu"
    assert set(res["compared"]) == set(cell.limits)
    last = out.stderr.strip().splitlines()[-len(cell.limits):]
    assert [line.split()[1] for line in last] == list(cell.limits)


def test_a_device_metric_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_window(lambda: None, ["solve"], torch.device("cpu"))


def test_the_run_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(R.Refused):
        R.run_cell("nominal.b128", 1, 1.0, False)
    assert R.main(["--workload", "nominal.b128", "--seed", "1", "--seconds", "1"]) == 2
