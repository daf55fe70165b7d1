"""The port's evaluation tools (tum_control_tpu_torch/tools/{one_lap,
quality_exp,multitrack_eval,wmpc_eval,rl_protocol_eval}.py and their
shared full-lap helper common.lap_run) on the CPU in float64, against the
JAX package's scripts (tools/*.py, run from their paths with a patched
sys.argv; the module-level scripts keep their `log`):

  * lap_run against the JAX scripts' `sim.run` for pairs the controller
    tests do not run: LVMS rnmpc and Modena snmpc (one_lap), sqp_iters = 2
    on Monteblanco (quality_exp, its T = 100 s cut to 0.2 s), WMPC new_BO_F
    on LVMS (wmpc_eval, 23 steps: the policy's first update at step 20
    inside). simU and the plant and prediction states within 1e-8 of their
    max, statuses and WMPC actions equal, the statistics within 1e-8, and
    the printed numbers equal at their printed precision (wall seconds
    excepted);
  * rl_protocol_eval.run_one against the root module's run_one on one
    track, static and one model (1e-8);
  * multitrack_eval prints its 9 rows; one_lap runs as `python -m`;
  * convert_sb3_checkpoint on a synthetic best_model.zip holding
    new_BO_F's weights under SB3's dotted key names: its npz equals the
    root script's key for key, rl_config.yaml is copied, and the port's and
    JAX's load_sb3_policy give the same action probabilities (1e-10);
  * every new entry module raises without a card unless given --device.

Each JAX controller compiles once here (one scan per case).
"""
import importlib
import io
import os
import re
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import _torch_tools_jax as jt
from tum_control_tpu_torch.tools import (
    common, convert_sb3_checkpoint, multitrack_eval, one_lap, quality_exp, rl_protocol_eval,
    wmpc_eval,
)

F64 = torch.float64
CPU = ["--device", "cpu"]
REL = 1e-8
WMPC_MODEL = "data/wmpc_models/new_BO_F"
NEW_MODULES = {
    "tools.one_lap": ["monteblanco", "nominal", "0.04"],
    "tools.quality_exp": ["2", "--T", "0.04"],
    "tools.multitrack_eval": ["0.04"],
    "tools.wmpc_eval": [WMPC_MODEL, "0.04"],
    "tools.rl_protocol_eval": ["0.04"],
    "tools.catalog_noise_validation": ["--T", "0.04"],
    "tools.convert_sb3_checkpoint": ["src", "dst"],
    "scripts.acc24_figures": [],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_script(name, argv, monkeypatch, capsys):
    """tools/<name>.py run from its path with `argv`: (module, its stdout)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + [str(a) for a in argv])
    capsys.readouterr()
    mod = jt.load_script(name)
    return mod, capsys.readouterr().out


def printed_numbers(line):
    """The decimal numbers of a printed stats line, its last (the wall
    seconds) left out."""
    return re.findall(r"-?\d+\.\d+", line)[:-1]


def jax_stats(log):
    lat, vel = np.asarray(log.lat_dev), np.asarray(log.vel_dev)
    return dict(lat_mean=np.abs(lat).mean(), lat_max=np.abs(lat).max(),
                lat_rms=np.sqrt((lat ** 2).mean()), vel_mean=np.abs(vel).mean(),
                vel_rms=np.sqrt((vel ** 2).mean()),
                ok=np.mean(np.asarray(log.simSolverDebug[:, 4]) == 0))


def hold_lap(log, stats, jlog):
    """A lap of the port (SimLog (1, n, ...), its stats) against the JAX
    script's (SimLog (n, ...))."""
    for f in ("simU", "CiLX", "MPC_SimX", "DisturbedX", "lat_dev", "vel_dev"):
        jt.assert_close(getattr(log, f)[0], getattr(jlog, f), f)
    np.testing.assert_array_equal(log.simSolverDebug[0, :, 4].numpy(),
                                  np.asarray(jlog.simSolverDebug[:, 4]))
    np.testing.assert_array_equal(log.wmpc_action[0].numpy(), np.asarray(jlog.wmpc_action))
    for k, want in jax_stats(jlog).items():
        assert abs(stats[k] - want) <= REL * max(abs(want), 1e-12), (k, stats[k], want)


@pytest.mark.parametrize("track,ctrl", [("lvms", "rnmpc"), ("modena", "snmpc")])
def test_one_lap_matches_the_jax_script(track, ctrl, monkeypatch, capsys):
    mod, jout = run_script("one_lap", [track, ctrl, "0.2"], monkeypatch, capsys)
    res = one_lap.main([track, ctrl, "0.2"] + CPU, dtype=F64)
    out = capsys.readouterr().out.splitlines()
    assert res["log"].lat_dev.shape == (1, 10) and res["ok"] == 1.0
    hold_lap(res["log"], res, mod.log)
    jlines = jout.splitlines()
    assert out[-2].split()[-1] == jlines[-2].split()[-1] == str(res["M"])
    assert out[-1].startswith(f"{track} {ctrl} dev_lat mean/max ")
    assert printed_numbers(out[-1]) == printed_numbers(jlines[-1])


def test_quality_exp_matches_the_jax_script(monkeypatch, capsys):
    """sqp_iters = 2 on Monteblanco; the JAX script's fixed T = 100 s is
    cut to 0.2 s through its SimConfig."""
    import tum_control_tpu.config as jcfg

    real = jcfg.SimConfig
    monkeypatch.setattr(jcfg, "SimConfig", lambda **kw: real(**dict(kw, T=0.2)))
    mod, jout = run_script("quality_exp", ["2"], monkeypatch, capsys)
    res = quality_exp.main(["2", "--T", "0.2"] + CPU, dtype=F64)
    out = capsys.readouterr().out.splitlines()
    assert mod.mpc_cfg.sqp_iters == 2 and res["log"].lat_dev.shape == (1, 10)
    assert (res["log"].simSolverDebug[0, :, 2] == 2).all()  # two SQP iterations a step
    hold_lap(res["log"], res, mod.log)
    assert out[-1].startswith("sqp_iters=2 dev_lat mean/max ")
    assert printed_numbers(out[-1]) == printed_numbers(jout.splitlines()[-1])


def test_wmpc_eval_matches_the_jax_script(monkeypatch, capsys):
    """new_BO_F on LVMS for 23 steps: the policy's first update (step 20)
    falls inside."""
    argv = [WMPC_MODEL, "0.46", "lvms"]
    mod, jout = run_script("wmpc_eval", argv, monkeypatch, capsys)
    res = wmpc_eval.main(argv + CPU, dtype=F64)
    out = capsys.readouterr().out.splitlines()
    act = res["log"].wmpc_action[0]
    assert act.shape == (23,) and (act >= 0).all()
    hold_lap(res["log"], res, mod.log)
    assert out[-1].startswith(f"{WMPC_MODEL} on lvms (0s): dev_lat RMS/max ")
    assert printed_numbers(out[-1]) == printed_numbers(jout.splitlines()[-1])


@pytest.mark.parametrize("model,T", [(None, 0.2), ("data/wmpc_models/jax_ppo_s1", 0.46)])
def test_rl_protocol_run_one_matches_the_jax_module(model, T):
    jmod = jt.load_script("rl_protocol_eval")
    want = jmod.run_one("modena", T, model)
    got = rl_protocol_eval.run_one("modena", T, model, device="cpu", dtype=F64)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert abs(g - w) <= REL * max(abs(w), 1e-12), (got, want)


def test_rl_protocol_main_rows(capsys):
    rows = rl_protocol_eval.main(["0.04", WMPC_MODEL] + CPU, dtype=F64)
    out = capsys.readouterr().out.splitlines()
    assert [r["name"] for r in rows] == ["static (MPC_params.yaml)", "new_BO_F"]
    for r, line in zip(rows, out[-2:]):
        assert [lp["track"] for lp in r["laps"]] == list(rl_protocol_eval.TRACKS)
        assert r["worst_max"] == max(lp["lat_max"] for lp in r["laps"])
        assert line.startswith(f"{r['name']:26s} monte: ")
        assert line.endswith(f"| mean RMS {r['mean_rms']:.3f}, worst max {r['worst_max']:.3f}")


def test_multitrack_eval_prints_nine_rows(capsys):
    rows = multitrack_eval.main(["0.04"] + CPU, dtype=F64)
    out = [ln for ln in capsys.readouterr().out.splitlines() if " dev_lat " in ln]
    assert len(rows) == len(out) == 9
    for r, line in zip(rows, out):
        assert line.startswith(f"{r['track']:12s} {r['ctrl']:8s} dev_lat mean/max ")
        assert r["ok"] == 1.0 and r["log"].lat_dev.shape == (1, 2)
        assert common.lap_stats(r["log"])["lat_max"] == r["lat_max"]


def test_one_lap_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=jt.REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "tum_control_tpu_torch.tools.one_lap",
                          "monteblanco", "nominal", "0.04"] + CPU, cwd=jt.REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert re.search(r"^monteblanco nominal dev_lat mean/max \d+\.\d{3}/\d+\.\d{3} dev_vel mean "
                     r"\d+\.\d{3} ok 100\.0% wall \d+\.\ds$", out.stdout, re.M), out.stdout


def test_convert_sb3_checkpoint_matches_the_root_script(tmp_path, capsys):
    import jax.numpy as jnp

    from tum_control_tpu.learn.policy import load_sb3_policy as jax_load
    from tum_control_tpu_torch.learn.policy import load_sb3_policy

    model = os.path.join(jt.REPO, WMPC_MODEL)
    with np.load(os.path.join(model, "policy_weights.npz")) as d:
        sd = {k.replace("__", "."): torch.as_tensor(d[k]) for k in d.files}
    src = tmp_path / "src" / "new_BO_F"
    os.makedirs(src / "best_model")
    buf = io.BytesIO()
    torch.save(sd, buf)
    with zipfile.ZipFile(src / "best_model" / "best_model.zip", "w") as z:
        z.writestr("policy.pth", buf.getvalue())
    shutil.copy(os.path.join(model, "rl_config.yaml"), src / "rl_config.yaml")
    os.makedirs(tmp_path / "src" / "no_zip")  # skipped: no best_model.zip

    assert convert_sb3_checkpoint.main([str(tmp_path / "src"), str(tmp_path / "ours"),
                                        "--device", "cpu"]) == ["new_BO_F"]
    assert "converted new_BO_F" in capsys.readouterr().out
    root = jt.load_script("convert_sb3_checkpoint")
    root.convert(str(src / "best_model" / "best_model.zip"), str(tmp_path / "theirs"))
    ours = np.load(tmp_path / "ours" / "new_BO_F" / "policy_weights.npz")
    theirs = np.load(tmp_path / "theirs" / "policy_weights.npz")
    assert sorted(ours.files) == sorted(theirs.files) and len(ours.files) == len(sd)
    for k in theirs.files:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert (tmp_path / "ours" / "new_BO_F" / "rl_config.yaml").read_bytes() == \
        (src / "rl_config.yaml").read_bytes()
    assert not (tmp_path / "ours" / "no_zip").exists()

    npz = str(tmp_path / "ours" / "new_BO_F" / "policy_weights.npz")
    pol_t, pol_j = load_sb3_policy(npz, device="cpu", dtype=F64), jax_load(npz)
    obs = np.random.default_rng(3).uniform(0, 1, (16, pol_t.pi[0].in_features))
    got = pol_t.action_probabilities(torch.as_tensor(obs)).numpy()
    want = np.asarray(pol_j.action_probabilities(jnp.asarray(obs)))
    assert got.shape == want.shape == (16, 26)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", sorted(NEW_MODULES))
def test_entry_module_needs_cuda_unless_given_a_device(name, monkeypatch):
    """Without --device an entry module resolves to cuda, and raises where
    there is none, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"tum_control_tpu_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(NEW_MODULES[name])
