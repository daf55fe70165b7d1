"""The port's ACC24 figure script
(tum_control_tpu_torch/scripts/acc24_figures.py) on the CPU in float64
against the root scripts/acc24_figures.py and the JAX package:

  * `propagate` equals the JAX SNMPC's `_fan` + 14 steps of
    `engine.funcs.dyn_step` at UPH 8 (the root script's loop) to 1e-10 of
    max |samples|;
  * from one full_logs.npz written by the port's `main` (T = 0.4 s), the
    solver-runtime CSV equals the root script's byte for byte;
  * `main` writes every artifact, the three run figures and the two
    run-independent ones.
"""
import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu_torch import main as tmain
from tum_control_tpu_torch.scripts import acc24_figures as acc

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root_script():
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_acc24_figures", os.path.join(REPO, "scripts", "acc24_figures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory with the port's full_logs.npz of 20 closed-loop steps."""
    logs = tmp_path_factory.mktemp("logs")
    tmain.main(["--T", "0.4", "--no-plots", "--device", "cpu", "--logs-path", str(logs)],
               dtype=F64)
    (path,) = glob.glob(os.path.join(str(logs), "run*", "full_logs.npz"))
    return os.path.dirname(path)


def test_propagation_matches_the_jax_snmpc():
    from tum_control_tpu.api import build_controller
    from tum_control_tpu.config import MPCConfig, SimConfig

    ctrl = build_controller(MPCConfig(controller="snmpc", uncertainty_propagation_horizon=8),
                            SimConfig())
    xk = ctrl._fan(jnp.asarray([0.0, 0.0, 0.0, 22.0, 0.0, 0.0, 0.04, 0.3]))
    u = jnp.asarray([0.0, 0.05])
    f = jax.jit(ctrl.engine.funcs.dyn_step)
    want = [np.asarray(xk).reshape(-1, 8)]
    for k in range(acc.N_STEPS):
        xk = f(jnp.asarray(k), xk, u)
        want.append(np.asarray(xk).reshape(-1, 8))
    want = np.stack(want)
    got, mpc_cfg, _ = acc.propagate("cpu", F64)
    assert got.shape == want.shape == (15, 11, 8) and mpc_cfg.uncertainty_propagation_horizon == 8
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    # the samples move below the UPH and freeze from it on
    assert np.all(got[acc.UPH:, 1:] == got[acc.UPH, 1:])
    assert np.abs(got[acc.UPH, 1:] - got[acc.UPH - 1, 1:]).max() > 0


def test_runtime_table_equals_the_root_scripts(run_dir, root_script, tmp_path):
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    acc.runtimes_table(acc.load_runs([run_dir]), str(ours))
    root_script.runtimes_table(root_script.load_runs([run_dir]), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    lines = ours.read_text().splitlines()
    assert lines[0] == "run,mean_ms,max_ms,p99_ms,ok_frac" and len(lines) == 2
    assert lines[1].startswith(os.path.basename(run_dir) + ",") and lines[1].endswith(",1.0000")


def test_main_writes_every_artifact(run_dir, tmp_path):
    out = tmp_path / "figs"
    res = acc.main([run_dir, "--out", str(out), "--device", "cpu"], dtype=F64)
    assert res["runs"] == [os.path.basename(run_dir)]
    assert sorted(res["files"]) == sorted(
        ["solver_time_experiments.csv", "SimResBoxplots.png", "gg_diagrams.png",
         "Monteblanco_Layout.png", "Uncertainty_Propagation.png"])
    for name in res["files"]:
        assert (out / name).stat().st_size > 0, name
    assert np.isfinite(res["samples"]).all()
