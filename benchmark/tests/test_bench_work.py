"""benchmark/work.py's counts against counts made by hand at N = 2."""
import json
import os

import pytest

from benchmark import work

SMALL = dict(N=2, nx=8, nu=2, nz=4, general_rows=6)


def test_linearize_and_condense_by_hand():
    # 2 elements x 250 FLOPs x 4 evaluations x 3 substeps x (1 + 10 tangents)
    assert work.linearize(SMALL) == (66000.0, 2 * (10 + 8 + 80) * 4)
    # per stage 2*8*8*(4+1) + 2*8*2*4 = 768; A, B, xi in and e, Gamma out
    assert work.condense(SMALL) == (1536, (2 * (64 + 16 + 8) + 3 * (8 + 32)) * 4)


def test_qp_solve_by_hand():
    nz, ncg, nc = 4, 6, 10
    chol = nz ** 3 / 3
    normal = 2 * ncg * nz * nz + ncg * nz                                     # 216
    it = normal + chol + 2 * nz * nz + 2 * ncg * nz                           # + rw
    it += 2 * (2 * 2 * nz * nz + 2 * 2 * ncg * nz + 40 * nc) + 100 * nc       # two directions
    pol = (3 * 2 * ncg * nz + 4 * 2 * nz * nz + normal + chol + 54 * 6 * nc)  # polish
    flops = 3 * it + pol + 2 * nz * nz + 2 * ncg * nz                          # + KKT residual
    assert flops == pytest.approx(11141.333333, rel=1e-9)
    f, b = work.qp_solve(SMALL, qp_iters=3)
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == (16 + 4 + 24 + 5 * 10 + 6 * 10 + 4 + 6 * 10 + 1) * 4


def test_small_stages_by_hand():
    assert work.plant(SMALL) == (4 * (4 * 250 + 56), 16 * 4)
    assert work.estimator(SMALL) == (8 * 15 + 8, (2 * 8 * 15 + 16) * 4)
    assert work.planner(SMALL, 10) == (5 * 10 + 10 + 60 + 20 * 3, (51 + 12) * 4)


def test_the_disturbed_plant_and_its_draws_by_hand():
    s = dict(SMALL, plant_integrations=2, drawn_numbers=15)
    # two RK4s; the second adds its disturbance to each of its 16 evaluations
    # and reads it; both write their state
    assert work.plant(s) == (2 * 4 * (4 * 250 + 56) + 16 * 7, (7 + 2 + 7 + 7 + 7) * 4)
    assert work.draws(s) == (15 * 4.0, 15 * 4)
    w, w0 = work.step_work(s, 1, 10, 3), work.step_work(SMALL, 1, 10, 3)
    assert "draws" not in w0 and set(w) == set(w0) | {"draws"}
    assert w["step"][0] == w0["step"][0] + 8 * 1056 - 4 * 1056 + 16 * 7 + 60


def test_stochastic_linearize_counts_the_sample_copies():
    s = dict(SMALL, n_samples=3, uncertainty_propagation_horizon=1)
    # 1 head stage x 4 copies + 1 tail stage, one substep each
    assert work.linearize(s)[0] == 5 * 250 * 4 * 1 * 11


def test_step_is_the_sum_and_scales_with_the_batch():
    w1 = work.step_work(SMALL, 1, 10, 3)
    w8 = work.step_work(SMALL, 8, 10, 3)
    stages = [k for k in w1 if k != "step"]
    assert w1["step"][0] == pytest.approx(sum(w1[k][0] for k in stages))
    assert w8["step"][1] == 8 * w1["step"][1]


def test_least_time_takes_the_binding_roof():
    peaks = {"f32_flops_per_s": 1e12, "bytes_per_s": 1e11}
    assert work.least_time_s(1e12, 1.0, peaks) == 1.0      # compute-bound
    assert work.least_time_s(1.0, 1e11, peaks) == 1.0      # bandwidth-bound


def test_shipped_shapes_use_three_iterations():
    cfg = json.load(open(os.path.join(os.path.dirname(work.__file__), "configs", "nominal.json")))
    assert cfg["mpc"]["qp_iters"] == 3
    f3 = work.qp_solve(cfg["shapes"], 3)[0]
    f4 = work.qp_solve(cfg["shapes"], 4)[0]
    assert f4 > f3
