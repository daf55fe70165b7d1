"""The port's dump_qps (tum_control_tpu_torch/tools/dump_qps.py) against the
JAX package's tools/dump_qps.py, on the CPU in float64, and the port's IPM
on the JAX package's committed QP anchor:

  * dump_qps captures the QPs and IPM solutions of the JAX script's capture
    loop (n_qps = 2, within 1e-8 of each field's max: float64 in another
    operation order; the JAX script runs unchanged but for its scipy solve
    and its write, tests/_torch_tools_jax.py loads it), solves them by the
    same scipy formulation (equal to the JAX script's on a small QP, 1e-10),
    and writes Logs/qp_anchor_torch.npz by default, never tests/data/;
  * the port's IPM on every QP of the committed tests/data/qp_anchor.npz
    against its scipy solutions, at tests/test_qp_anchor.py's tolerances
    (1e-4 run to convergence, 0.15 on u0 at the production budget).
"""
import os
import sys

import numpy as np
import pytest
import torch

import _torch_tools_jax as jt
from tum_control_tpu_torch.ops.ipm import solve_soft_qp_ipm
from tum_control_tpu_torch.ops.soft_qp import CondensedQP
from tum_control_tpu_torch.tools import dump_qps

F64 = torch.float64
CPU = ["--device", "cpu"]
ANCHOR = os.path.join(jt.REPO, "tests", "data", "qp_anchor.npz")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Result:
    status = 1


def test_dump_qps_captures_the_jax_capture_loop(monkeypatch, tmp_path):
    """n_qps = 2: the QPs of steps 0 and 10 and the IPM's solutions equal
    the JAX script's capture loop; scipy is stood in for on both sides (a
    re-solve takes ~12 s here; its formulation is held below)."""
    jmod = jt.load_script("dump_qps")
    saved = {}

    class NoWrite:
        def __getattr__(self, name):
            return getattr(np, name)

        def savez_compressed(self, path, **kw):
            saved.update(kw)

    jmod.np = NoWrite()
    jmod.solve_qp_scipy = lambda *q, n_id: (np.zeros_like(q[1]), _Result())
    monkeypatch.setattr(sys, "argv", ["dump_qps.py", "2"])
    jmod.main()
    monkeypatch.setattr(dump_qps, "solve_qp_scipy", jmod.solve_qp_scipy)
    out = tmp_path / "anchor.npz"
    got = dump_qps.main(["2", "--out", str(out)] + CPU, dtype=F64)
    assert got["out"] == str(out) and got["scipy_fails"] == 0
    data = np.load(out)
    for k, f in enumerate(dump_qps.FIELDS):
        jt.assert_close(np.stack([q[k] for q in got["qps"]]), saved[f], f)
        np.testing.assert_array_equal(data[f], np.stack([q[k] for q in got["qps"]]))
    jt.assert_close(np.stack(got["w_ipm"]), saved["w_ipm_at_dump"], "w_ipm")
    assert int(data["n_id"]) == int(saved["n_id"]) == 76


def test_solve_qp_scipy_is_the_jax_scripts_formulation():
    """A 6-variable soft QP with a hard and a soft general row, soft and
    hard input rows: the port's scipy re-solve equals the JAX script's."""
    rng = np.random.default_rng(3)
    M = rng.normal(size=(6, 6))
    H0, g0 = M @ M.T + np.eye(6), rng.normal(size=6)
    G = rng.normal(size=(2, 6))
    c0 = rng.normal(size=8)
    lb = np.array([-0.5, -1e12] + [-0.3] * 6)
    ub = np.array([0.5, 0.2] + [0.3] * 6)
    z1 = np.full(8, 10.0)
    z2 = np.array([1e8, 100.0, 1e8, 1e8, 100.0, 100.0, 100.0, 100.0])
    args = (H0, g0, G, c0, lb, ub, z1, z2)
    w_j, res_j = jt.load_script("dump_qps").solve_qp_scipy(*args, n_id=6)
    w_t, res_t = dump_qps.solve_qp_scipy(*args, n_id=6)
    assert res_t.status == res_j.status and res_t.status in (1, 2)
    jt.assert_close(w_t, w_j, "w", 1e-10)


def test_dump_qps_writes_outside_tests_data():
    out = dump_qps.parse_args([]).out
    assert out == os.path.join("Logs", "qp_anchor_torch.npz")
    assert "tests" not in os.path.normpath(out).split(os.sep)


def test_port_ipm_on_the_committed_qp_anchor():
    """tests/test_qp_anchor.py's holds on the port's IPM: within 1e-4 of
    scipy when run to convergence (60 iterations, 3 polish steps), u0
    within 0.15 at the production budget cold (6 + 1)."""
    a = np.load(ANCHOR)
    qps = CondensedQP(*[torch.as_tensor(a[f]) for f in dump_qps.FIELDS])
    assert int(a["n_id"]) == qps.g0.shape[1] == 76 and qps.g0.shape[0] >= 100
    w_sp = a["w_scipy"]
    w = solve_soft_qp_ipm(qps, n_iters=60, n_polish=3, n_id=76)[0].numpy()
    assert np.abs(w - w_sp).max() < 1e-4, np.abs(w - w_sp).max()
    w6 = solve_soft_qp_ipm(qps, n_iters=6, n_polish=1, n_id=76)[0].numpy()
    assert np.abs(w6[:, :2] - w_sp[:, :2]).max() < 0.15
