"""The port's catalog noise validation
(tum_control_tpu_torch/tools/catalog_noise_validation.py) on the CPU in
float64 against the JAX package, 2 sets x 2 tracks x 2 seeds at T = 0.2 s:

  * the JAX side runs the script's own scenario (tools/
    catalog_noise_validation.py::run_one: params_to_mods, init_carry with
    PRNGKey(seed), a scan of sim.step) vmapped over the 8 scenarios and
    keeps each one's state-estimation noise dist_se; every set and track
    of one seed draws the same sequence there (common random numbers);
  * the port gets each seed's recorded sequence (`main(..., noise=...)`)
    and its per-scenario max |lat_dev| and solver-ok share equal JAX's to
    1e-8;
  * the port's own draws: one sequence per seed, the same for every set
    and track of that seed (the step's logged dist_se), another for
    another seed;
  * the JSON has the key layout of the committed Logs/catalog_noise_r5.json.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu_torch.tools import catalog_noise_validation as cn

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKS = ["monteblanco", "lvms"]
SEEDS, T, N_STEPS = 2, 0.2, 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """The first two sets of data/F.csv as a catalog of their own."""
    path = tmp_path_factory.mktemp("catalog") / "F2.csv"
    rows = open(os.path.join(REPO, "data", "F.csv")).read().splitlines()[:2]
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def jax_scenarios(catalog):
    """The JAX script's run_one over the (sets x tracks x seeds) scenarios,
    seeds fastest: (max |lat_dev|, ok share, dist_se (n, N_STEPS, 7))."""
    from tum_control_tpu.api import build_simulation
    from tum_control_tpu.config import MPCConfig, SimConfig
    from tum_control_tpu.learn.bo.objective import params_to_mods
    from tum_control_tpu.learn.wmpc import load_param_table
    from tum_control_tpu.track.trajectory import load_ref_trajectory, stack_trajectories

    sim_cfg = SimConfig(sim_mode=0, T=T, simulate_state_estimation=True)
    sim, *_ = build_simulation(sim_cfg, MPCConfig())
    assert sim_cfg.Nsim == N_STEPS
    stacked = stack_trajectories([
        load_ref_trajectory(os.path.join(sim_cfg.trajectory_path, f"reftraj_{t}_edgar.json"))
        for t in TRACKS])

    def run_one(p, track_idx, seed):
        traj = jax.tree.map(lambda a: a[track_idx], stacked)
        mods = params_to_mods(sim.controller.engine, p)
        px = traj.pos[0]
        x0m = jnp.concatenate([px, jnp.stack([jnp.mod(traj.yaw[0], 2 * jnp.pi), traj.v[0]]),
                               jnp.zeros(4, px.dtype)])
        carry = sim.init_carry(x0m, x0m[:7], jax.random.PRNGKey(seed))

        def step(c, i):
            c, log = sim.step(c, (i, jnp.zeros(7, px.dtype), jnp.zeros(7, px.dtype)),
                              traj=traj, mods=mods)
            return c, (log.lat_dev, log.simSolverDebug[4], log.dist_se)

        _, (lat, status, dist_se) = jax.lax.scan(step, carry, jnp.arange(N_STEPS))
        return (jnp.max(jnp.abs(lat)), jnp.mean((status == 0).astype(px.dtype)), dist_se)

    table = jnp.asarray(load_param_table(catalog))
    S, Tk = table.shape[0], len(TRACKS)
    p = jnp.repeat(table, Tk * SEEDS, axis=0)
    tr = jnp.tile(jnp.repeat(jnp.arange(Tk), SEEDS), S)
    se = jnp.tile(jnp.arange(SEEDS), S * Tk)
    out = jax.jit(jax.vmap(run_one))(p, tr, se)
    return tuple(np.asarray(o) for o in out)


def test_catalog_noise_matches_jax_under_its_noise(catalog, tmp_path):
    jmax, jok, jnoise = jax_scenarios(catalog)
    seed_of = np.tile(np.arange(SEEDS), len(jmax) // SEEDS)
    for i in range(len(jmax)):  # JAX's common random numbers
        np.testing.assert_array_equal(jnoise[i], jnoise[seed_of[i]])
    assert np.abs(jnoise[0] - jnoise[1]).max() > 0
    out = tmp_path / "cat.json"
    res = cn.main(["--T", str(T), "--seeds", str(SEEDS), "--tracks", *TRACKS, "--catalogs",
                   catalog, "--out", str(out), "--device", "cpu"], dtype=F64,
                  noise=torch.tensor(jnoise[:SEEDS]))
    run = res["runs"][catalog]
    assert run["max_lat"].shape == (2, len(TRACKS), SEEDS) and run["scenarios"] == 8
    got = run["max_lat"].ravel()
    assert np.abs(got - jmax).max() <= 1e-8 * np.abs(jmax).max(), (got, jmax)
    assert np.abs(run["ok"].ravel() - jok).max() <= 1e-8 and (jok == 1.0).all()
    entry = json.loads(out.read_text())["catalogs"][catalog]
    assert entry["worst_max_lat_dev"] == float(got.max())
    assert abs(entry["worst_max_lat_dev"] - jmax.max()) <= 1e-8 * jmax.max()
    assert entry["per_set_worst"] == [round(float(v), 3)
                                      for v in jmax.reshape(2, -1).max(axis=1)]


def test_one_noise_sequence_per_seed(catalog):
    """The port's draws: scenarios of one seed get the same noise, on every
    set and track; another seed another sequence."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig
    from tum_control_tpu_torch.learn.wmpc import load_param_table
    from tum_control_tpu_torch.track.trajectory import load_ref_trajectory, stack_trajectories

    sim_cfg = cn.noise_config(0.06)
    sim, *_ = build_simulation(sim_cfg, MPCConfig(), device="cpu", dtype=F64)
    noise = cn.seed_noise(sim, [0, 1, 0], sim_cfg.Nsim)
    assert noise.shape == (3, 3, 7) and torch.equal(noise[0], noise[2])
    assert not torch.equal(noise[0], noise[1])
    stacked = stack_trajectories([
        load_ref_trajectory(os.path.join(sim_cfg.trajectory_path, f"reftraj_{t}_edgar.json"),
                            dtype=F64, device="cpu") for t in TRACKS])
    table = load_param_table(catalog)
    carry, traj, mods, seed_pos = cn.catalog_start(sim, table, stacked, 2)
    assert seed_pos.tolist() == [0, 1] * 4
    zero = torch.zeros_like(carry.x_sim)
    _, log = sim.step(carry, zero, noise[:2][seed_pos][:, 0], traj=traj, mods=mods)
    for i, s in enumerate(seed_pos.tolist()):
        assert torch.equal(log.dist_se[i], noise[s, 0])
    assert (log.dist_deriv == 0).all()


def test_report_has_the_committed_layout(catalog, tmp_path):
    with open(os.path.join(REPO, "Logs", "catalog_noise_r5.json")) as f:
        ref = json.load(f)
    out = tmp_path / "cat.json"
    res = cn.main(["--T", "0.04", "--seeds", "1", "--tracks", "lvms", "--catalogs", catalog,
                   "--out", str(out), "--device", "cpu"], dtype=F64)
    rep = json.loads(out.read_text())
    assert rep == res["report"] and list(rep) == list(ref)
    assert list(rep["catalogs"][catalog]) == list(next(iter(ref["catalogs"].values())))
    assert rep["noise"] == ref["noise"] and rep["seeds"] == 1 and rep["tracks"] == ["lvms"]
