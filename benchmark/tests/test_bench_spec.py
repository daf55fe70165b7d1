"""BENCHMARK.json against the benchmark's contract, and the files each
cell, configuration, traffic mix and per-layer metric is found by.

    python -m pytest benchmark/tests -q
"""
import json
import os
import re
import shutil

import pytest

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
    assert len(SPEC["per_layer"]) == 12
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        reader = R.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert one_line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_cell_is_added_by_new_files_and_entries_alone(tmp_path):
    """A new traffic mix, limits file, per-layer metric and cell: files added
    next to the existing ones and entries added to BENCHMARK.json, no file
    of the benchmark edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(R.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
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


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        R.cell_of(SPEC, "nominal.b7")
