"""The port's scenario data parallelism on the CPU under gloo
(tum_control_tpu_torch/parallel/distributed.py), the counterpart of
tests/test_distributed.py's two-process mesh.

Two OS processes each run 4 of 8 scenarios for 3 steps; the global mean
|lat_dev| and the solver-ok count are all-reduces. Both ranks must agree
bitwise, match a single-process B = 8 run of the port to 1e-12 (a sum of
the same 24 float64 values in another order) and the JAX package's
unsharded run to 1e-8 (the tolerance of the port's short-loop parity
tests). The worker is this file's `__main__` block:

    python tests/test_torch_distributed.py <rank> <world> <port>
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

BATCH, STEPS = 8, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_sim():
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig

    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=STEPS * 0.02), MPCConfig(),
                                          device="cpu", dtype=torch.float64)
    return sim, traj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_gloo_processes_shard_the_closed_loop():
    import jax
    import jax.numpy as jnp

    from tum_control_tpu.api import build_simulation as j_build_simulation
    from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
    from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS",)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out in outs:
        (line,) = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        _, mean, ok, world, local = line.split()
        results.append((mean, int(ok), int(world), float.fromhex(local)))
    assert all(r[2] == 2 for r in results), results
    assert results[0][0] == results[1][0], results        # bitwise, as float.hex
    assert all(r[1] == BATCH * STEPS for r in results), results
    mean = float.fromhex(results[0][0])
    assert mean < 1.0

    # the port, one process, the whole batch
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    sim, traj = _port_sim()
    x0m, x0s = batched_scenarios(traj, BATCH)
    _, log = sim.run(x0m, x0s, STEPS)
    ref = float(log.lat_dev.abs().mean())
    assert abs(mean - ref) <= 1e-12 * ref, (mean, ref)
    # each rank's shard is the unsharded run's rows
    per_rank = log.lat_dev.abs().reshape(2, BATCH // 2 * STEPS).mean(dim=1)
    for r, (_, _, _, local) in enumerate(results):
        assert abs(local - float(per_rank[r])) <= 1e-12 * ref

    # the JAX package, unsharded
    jsim, _, _, jtraj, _ = j_build_simulation(JSim(sim_mode=0, T=STEPS * 0.02), JMPC())
    jm, js = j_batched(jtraj, BATCH, dtype=jnp.float64)
    _, jlog = jax.jit(jax.vmap(lambda a, b: jsim.run(a, b, STEPS)))(jm, js)
    jmean = float(np.mean(np.abs(np.asarray(jlog.lat_dev))))
    assert abs(mean - jmean) <= 1e-8, (mean, jmean)


def test_scaling_report_single_process():
    """Without a process group and in a gloo group of one: one row at n = 1,
    efficiency 1.0; device counts beyond the world raise."""
    import torch.distributed as dist

    from tum_control_tpu_torch.parallel.distributed import (
        initialize_distributed, scaling_report, sharded_run,
    )

    sim, traj = _port_sim()
    rows = scaling_report(sim, traj, batch_per_device=2, steps=2, device="cpu")
    assert [r["devices"] for r in rows] == [1] and rows[0]["batch"] == 2
    assert rows[0]["efficiency"] == 1.0 and rows[0]["solves_per_sec"] > 0
    with pytest.raises(ValueError, match="outside"):
        scaling_report(sim, traj, device_counts=[1, 2], batch_per_device=2, steps=1,
                       device="cpu")

    dev = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert dev.type == "cpu" and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        rows = scaling_report(sim, traj, device_counts=[1], batch_per_device=2, steps=2,
                              device=dev)
        assert set(rows[0]) == {"devices", "batch", "solves_per_sec", "efficiency"}
        assert rows[0]["efficiency"] == 1.0
        run = sharded_run(sim, traj, 2, 2, device=dev)
        assert run.mean_abs_lat_dev == pytest.approx(run.local_mean, rel=1e-15)
        assert run.solver_ok == 4 and run.log.lat_dev.shape == (2, 2)
    finally:
        dist.destroy_process_group()


def test_scaling_eval_tool_two_processes(tmp_path):
    """The tool starts two gloo processes itself and writes rows at 1 and 2
    devices."""
    import json

    out = tmp_path / "scaling.json"
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS",)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "tum_control_tpu_torch.tools.scaling_eval", str(out),
         "--nproc", "2", "--device", "cpu", "--batch-per-device", "2", "--steps", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["world_size"] == 2 and report["backend"] == "gloo"
    assert [r["devices"] for r in report["rows"]] == [1, 2]
    assert [r["batch"] for r in report["rows"]] == [2, 4]
    assert report["rows"][0]["efficiency"] == 1.0
    assert all(r["solves_per_sec"] > 0 for r in report["rows"])


def _worker(rank: int, world: int, port: int):
    """One rank of test_two_gloo_processes_shard_the_closed_loop."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from tum_control_tpu_torch.parallel.distributed import initialize_distributed, sharded_run

    dev = initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        sim, traj = _port_sim()
        run = sharded_run(sim, traj, BATCH, STEPS, device=dev)
        assert run.log.lat_dev.shape == (BATCH // world, STEPS)
        print(f"RESULT {run.mean_abs_lat_dev.hex()} {run.solver_ok} "
              f"{dist.get_world_size()} {run.local_mean.hex()}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
