"""A batch cell's window is `window_steps` closed-loop steps, or
`--seconds` if that comes first (benchmark/driver_batch.py): on the CPU at
a cut batch, the run stops at its step count with `attempted` = B x the
steps, stops on time and says so where the clock comes first, samples the
same steps from one seed however slowly the host issues them, and lists
each failed solve on standard error by its step and scenario."""
import time

import pytest
import torch

from benchmark import driver_batch, program
from benchmark import run as R
from benchmark.compare import Sampler
from benchmark.faults import planted

SEED = 2**31 + 977
SPEC = R.load_spec()
BATCH = [w["name"] for w in SPEC["workloads"]
         if R.cell_of(SPEC, w["name"]).traffic["driver"] == "batch"]


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cut(monkeypatch):
    """cut(batch, window_steps, **more): every cell runs at that batch and
    window, with the traffic's keys `more`."""
    cell_of = R.cell_of

    def set_to(batch, steps, **more):
        def small(spec, w, root=R.ROOT):
            c = cell_of(spec, w, root)
            c.traffic.update(batch=batch, window_steps=steps, **more)
            return c
        monkeypatch.setattr(R, "cell_of", small)
    return set_to


@pytest.mark.parametrize("workload", BATCH)
def test_the_window_ends_at_its_step_count(cut, capsys, workload):
    steps = R.cell_of(SPEC, workload).traffic["window_steps"]
    assert isinstance(steps, int) and steps > 0
    cut(2, 3)
    res = R.run_cell(workload, SEED, 600.0, False, device="cpu")
    assert res["attempted"] == 2 * 3
    assert res["correct"] is True, res["compared"]
    assert "the window ended at window_steps 3," in capsys.readouterr().err


def test_the_clock_ends_a_window_that_has_not_reached_its_steps_and_says_so(cut, capsys):
    cut(2, 10**6)
    t0 = time.perf_counter()
    res = R.run_cell("nominal.b128", SEED, 1.0, False, device="cpu")
    assert time.perf_counter() - t0 < 120
    n, rest = divmod(res["attempted"], 2)
    assert rest == 0 and 0 < n < 10**6
    assert (f"the window reached --seconds 1.0 first: {n} steps of window_steps {10**6}"
            in capsys.readouterr().err)


class Recording(Sampler):
    """compare.Sampler that also records the window step of each slot."""

    def __init__(self, k, seed):
        super().__init__(k, seed)
        self.indices = [None] * k

    def keep(self, before, u0, status, after):
        self.indices[self._slot] = self.seen - 1
        super().keep(before, u0, status, after)


def _sampled(monkeypatch, sleep_s):
    """(attempted, the sampled window steps) of a run whose step sleeps
    `sleep_s` on the host first: a slower host."""
    made = []

    def recording(k, seed):
        made.append(Recording(k, seed))
        return made[-1]

    build = program.build

    def slowed(ctx, batch):
        sim, carry, lap_points = build(ctx, batch)
        step = sim.step

        def slow(*args):
            time.sleep(sleep_s)
            return step(*args)
        sim.step = slow
        return sim, carry, lap_points

    monkeypatch.setattr(driver_batch, "Sampler", recording)
    monkeypatch.setattr(program, "build", slowed)
    res = R.run_cell("nominal.b128", SEED, 600.0, False, device="cpu")
    assert res["correct"] is True, res["compared"]
    return res["attempted"], sorted(made[0].indices)


def test_one_seed_samples_the_same_steps_however_slow_the_host(cut, monkeypatch):
    cut(2, 8, sample_steps=3)
    fast = _sampled(monkeypatch, 0.0)
    slow = _sampled(monkeypatch, 0.4)
    assert fast == slow
    attempted, indices = fast
    assert attempted == 2 * 8 and len(set(indices)) == 3 and indices[-1] < 8
    # the reservoir replaced a step of the first three: the draw mattered
    assert indices != [0, 1, 2]


def test_a_failed_solve_is_listed_with_its_step_and_scenario(cut, capsys):
    cut(4, 3)
    with planted("one_status"):
        res = R.run_cell("nominal.b128", SEED, 600.0, False, device="cpu")
    assert res["attempted"] == 4 * 3 and res["failed"] == 3
    err = capsys.readouterr().err
    # faults.py breaks scenario B // 3 of a batch of B
    for i in range(3):
        assert (f"failed solve: window step {i} (closed-loop step {3 + i}), scenario 1, "
                "status 1.0, control finite True") in err
    assert "failed solves: 3, the first 3 listed" in err


def test_the_failed_solves_listed_are_the_first_in_the_window(capsys):
    B, steps = 3, 30
    status = torch.zeros(B, steps)
    u = torch.zeros(B, steps, 2)
    status[2, :] = 2
    status[0, 1] = 1
    u[1, 5, 0] = float("nan")
    bad = (status != 0) | ~torch.isfinite(u).all(dim=-1)
    driver_batch.list_failed(bad, status, u, 3)
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == driver_batch.MAX_LISTED + 1
    assert lines[0] == ("failed solve: window step 0 (closed-loop step 3), scenario 2, "
                        "status 2.0, control finite True")
    assert lines[1].startswith("failed solve: window step 1 (closed-loop step 4), scenario 0,")
    assert ("failed solve: window step 5 (closed-loop step 8), scenario 1, status 0.0, "
            "control finite False") in lines
    assert lines[-1] == f"failed solves: 32, the first {driver_batch.MAX_LISTED} listed"


def test_no_failed_solve_lists_nothing(capsys):
    bad = torch.zeros(2, 4, dtype=torch.bool)
    driver_batch.list_failed(bad, torch.zeros(2, 4), torch.zeros(2, 4, 2), 3)
    assert capsys.readouterr().err == ""
