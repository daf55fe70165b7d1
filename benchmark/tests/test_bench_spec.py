"""BENCHMARK.json against the benchmark's contract, and the files each
cell, configuration, traffic mix and per-layer metric is found by.

    python -m pytest benchmark/tests -q
"""
import json
import os
import re
import shutil
from typing import NamedTuple

import pytest
import torch

from benchmark import run as R
from benchmark.compare import NUMBERS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = R.load_spec()


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs_name_their_files():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.load(open(os.path.join(R.ROOT, c["file"])))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_cells_find_their_files_and_report_the_metrics():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] == 1
        cell = R.cell_of(SPEC, w["name"])
        assert cell.traffic["driver"] in ("batch", "serve")
        assert set(cell.limits) == set(NUMBERS)
        e2e = {m["name"] for m in cell.e2e}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_metrics_follow_the_contract_and_their_readers():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"device_solves_per_s", "cycle_ms_p95", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in SPEC["per_layer"]]
    assert 1 <= len(names) <= 128 and len(set(names)) == len(names)
    assert not set(names) & set(e2e)
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        reader = R.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert one_line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _checkout(tmp_path):
    """A checkout of the benchmark's files (data/ linked in) and the bytes of
    each, to show that nothing there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(R.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "data").symlink_to(os.path.join(R.ROOT, "data"))
    return root, {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_a_cell_is_added_by_new_files_and_entries_alone(tmp_path):
    """A new traffic mix, limits file, per-layer metric and cell: files added
    next to the existing ones and entries added to BENCHMARK.json, no file
    of the benchmark edited."""
    root, before = _checkout(tmp_path)
    spec = json.loads(json.dumps(SPEC))
    (root / "benchmark" / "traffic" / "batch16.json").write_text(json.dumps(dict(
        json.load(open(os.path.join(R.ROOT, "benchmark", "traffic", "batch128.json"))), batch=16)))
    (root / "benchmark" / "limits" / "snmpc.b16.json").write_text(
        json.dumps({"u_gap": 1e-2, "state_gap": 1e-2, "iterate_gap": 1e-2, "pairs_off": 2}))
    (root / "benchmark" / "metrics" / "steps.batch.py").write_text(
        'UNIT = "steps"\nLAYER = "closed loop (sim/closed_loop.py)"\nMOVES = "device_solves_per_s"\n\n\n'
        'def read(rec):\n    return rec["steps"] or None\n')
    spec["workloads"].append(dict(name="snmpc.b16", config="snmpc", traffic="batch16", chips=1,
                                  why="a smaller batch"))
    spec["end_to_end"][0]["workloads"].append("snmpc.b16")
    spec["per_layer"].append(dict(name="steps.batch", unit="steps", better="higher",
                                  source="host_clock", layer="closed loop (sim/closed_loop.py)",
                                  moves="device_solves_per_s", workloads=["snmpc.b16"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = R.cell_of(R.load_spec(str(root)), "snmpc.b16", str(root))
    assert cell.traffic["batch"] == 16 and cell.cfg["mpc"]["controller"] == "snmpc"
    assert [m["name"] for m in cell.e2e] == ["device_solves_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps.batch"]
    assert R.metric_reader("steps.batch", str(root)).read({"steps": 7}) == 7
    after = {p: p.read_bytes() for p in before}
    assert after == before


STUB = '''"""The nominal NMPC with carried state, for the test of the hooks: a count
of successful solves, and a factor on each scenario's stage weights that
follows the jerk the solve applies."""
import torch

from benchmark.reference import controllers


def build(mpc, vp, tp, gg, N, dt, dtype, device):
    return controllers.nominal(mpc, vp, tp, gg, N, dt, dtype, device)


def init(x0):
    B = x0.shape[0]
    return (torch.zeros(B, dtype=torch.int32, device=x0.device),
            torch.full((B,), 2.0, dtype=x0.dtype, device=x0.device))


def problem(p, extra):
    return p._replace(W=p.W * extra[1][:, None])


def advance(extra, x0, window, X, U, A, status):
    ok = status == 0
    return (extra[0] + ok.to(torch.int32),
            torch.where(ok, 0.8 * extra[1] + 0.2 * (1 + U[:, 0, 0].abs()), extra[1]))
'''


class StubExtra(NamedTuple):
    count: torch.Tensor
    factor: torch.Tensor


def _carrying(sim, broken):
    """The port's nominal controller given the stub's carried state; `broken`
    counts double ("count") or moves the factor by another rule ("factor")."""
    from tum_control_tpu_torch.ops.rti import QPMods

    ctrl = sim.controller
    W = ctrl.engine.W

    def init_extra(x0):
        B = x0.shape[0]
        return StubExtra(torch.zeros(B, dtype=torch.int32, device=x0.device),
                         torch.full((B,), 2.0, dtype=x0.dtype, device=x0.device))

    def solve_with_extra(state, extra, x0, window, mods=None):
        out, new = ctrl.solve(state, x0, window, mods=QPMods(W=W * extra.factor[:, None]))
        ok = out.stats[:, 4] == 0
        a = 0.7 if broken == "factor" else 0.8
        count = extra.count + (2 if broken == "count" else 1) * ok.to(torch.int32)
        return out, new, StubExtra(count, torch.where(
            ok, a * extra.factor + (1 - a) * (1 + new.U[:, 0, 0].abs()), extra.factor))

    ctrl.init_extra, ctrl.solve_with_extra = init_extra, solve_with_extra


@pytest.mark.parametrize("broken", [None, "count", "factor"])
def test_a_controller_with_carried_state_is_added_by_new_files_and_entries_alone(
        tmp_path, monkeypatch, broken):
    """A reference controller with carried state (benchmark/reference/
    controller_stub.py: build, init, problem, advance), a configuration that
    names it, a traffic mix, limits and a cell: files added and entries
    added, no file of the benchmark edited. The cell runs on the CPU, the
    reference steps the carried state through the hooks, and the comparison
    judges it: correct, and not correct where the program's carried integer
    or float departs from the reference's."""
    from benchmark import program
    from benchmark.reference.closed_loop import Reference

    root, before = _checkout(tmp_path)
    bench = root / "benchmark"
    (bench / "reference" / "controller_stub.py").write_text(STUB)
    cfg = dict(json.loads((bench / "configs" / "nominal.json").read_text()),
               name="nominal_stub", reference_controller="stub")
    (bench / "configs" / "nominal_stub.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "batch2.json").write_text(json.dumps(dict(
        json.loads((bench / "traffic" / "batch128.json").read_text()), batch=2)))
    # a batch of 2 has 2 pairs a sampled step: one pair off is too many
    (bench / "limits" / "nominal_stub.b2.json").write_text(json.dumps(dict(
        json.loads((bench / "limits" / "nominal.b128.json").read_text()), pairs_off=0)))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(name="nominal_stub", source=cfg["source"],
                                file="benchmark/configs/nominal_stub.json", reduced=[],
                                why="carried state"))
    spec["workloads"].append(dict(name="nominal_stub.b2", config="nominal_stub",
                                  traffic="batch2", chips=1, why="carried state"))
    spec["end_to_end"][0]["workloads"].append("nominal_stub.b2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    ref = Reference(cfg, str(root))
    assert all(getattr(ref.ctrl, h) is not None for h in ("init", "problem", "advance"))
    x0 = torch.zeros(2, 8, dtype=torch.float64)
    assert [t.tolist() for t in ref.init_extra(x0)] == [[0, 0], [2.0, 2.0]]

    build = program.build

    def carrying(ctx, batch):
        sim, carry, lap_points = build(ctx, batch)
        _carrying(sim, broken)
        return sim, sim.init_carry(carry.x_est, carry.x_sim, key=ctx.seed), lap_points

    monkeypatch.setattr(program, "build", carrying)
    n = torch.get_num_threads()
    try:
        res = R.run_cell("nominal_stub.b2", 2**31 + 99, 1.0, False, device="cpu", root=str(root))
    finally:
        torch.set_num_threads(n)
    c = res["compared"]
    if broken is None:
        assert res["correct"] is True, c
    else:
        assert res["correct"] is False, c
        assert c["pairs_off"]["value"] >= 2 > c["pairs_off"]["limit"], c
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        R.cell_of(SPEC, "nominal.b7")
