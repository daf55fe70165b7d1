"""The comparison fails a broken timed path: a run of each cell on the CPU
with the step broken underneath the driver (benchmark/faults.py), the chip
look skipped, comes out `correct` false, with the cells' own limits. The
faults of the whole batch or half of it run at a batch of 4 (a window of
1.5 s); those of one scenario at the cell's own batch (128; rollout16's
16), where that scenario is under 1 % of the entries that a 99th
percentile pools (a window of 6 s: three sampled steps or more). In a
cell that draws disturbances, a plant that gets none (`dropped_draws`) at
a batch of 4. The benchmark runs on one chip, so no exchange between chips
can be left out."""
import pytest
import torch

from benchmark import run as R
from benchmark.faults import planted

SEED = 2**31 + 4321


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_batch(monkeypatch):
    cell_of = R.cell_of

    def small(spec, w, root=R.ROOT):
        c = cell_of(spec, w, root)
        if "batch" in c.traffic:
            c.traffic["batch"] = 4
        return c

    monkeypatch.setattr(R, "cell_of", small)


SPEC = R.load_spec()
BATCH = [w["name"] for w in SPEC["workloads"]
         if R.cell_of(SPEC, w["name"]).traffic["driver"] == "batch"]
# a served cell runs one scenario: it has no half of a batch to leave out
CASES = [(w["name"], f) for w in SPEC["workloads"] for f in ("unchanged", "half_batch", "altered")
         if not (w["name"] not in BATCH and f == "half_batch")]
ONE = [(w, f) for w in BATCH for f in ("one_control", "one_status", "one_state")]
DRAWN = [w for w in BATCH if R.cell_of(SPEC, w).cfg["sim"].get("simulate_disturbances")]


def _batch(workload):
    """The cell's own batch, as its traffic mix states it."""
    return int(R.cell_of(SPEC, workload).traffic["batch"])


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_a_broken_step_is_not_correct(small_batch, workload, fault):
    with planted(fault):
        res = R.run_cell(workload, SEED, 1.5, False, device="cpu")
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("workload,fault", ONE, ids=[f"{w}-{f}" for w, f in ONE])
def test_one_broken_scenario_of_the_full_batch_is_not_correct(workload, fault):
    with planted(fault):
        res = R.run_cell(workload, SEED, 6.0, False, device="cpu")
    assert res["attempted"] >= 3 * _batch(workload)
    assert res["correct"] is False, res["compared"]
    assert res["compared"]["pairs_off"]["value"] > res["compared"]["pairs_off"]["limit"]


@pytest.mark.parametrize("workload", DRAWN)
def test_dropped_draws_are_not_correct(small_batch, workload):
    with planted("dropped_draws"):
        res = R.run_cell(workload, SEED, 1.5, False, device="cpu")
    assert res["correct"] is False, res["compared"]
    assert res["compared"]["state_gap"]["value"] > res["compared"]["state_gap"]["limit"]


def test_the_sound_step_is_correct(small_batch):
    res = R.run_cell("nominal.b128", SEED, 1.5, False, device="cpu")
    assert res["correct"] is True, res["compared"]


@pytest.mark.parametrize("workload", BATCH)
def test_the_sound_step_of_the_full_batch_is_correct(workload):
    res = R.run_cell(workload, SEED, 6.0, False, device="cpu")
    assert res["attempted"] >= 3 * _batch(workload)
    assert res["correct"] is True, res["compared"]
