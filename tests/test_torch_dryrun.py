"""The port's one-step check and multi-device dry run
(tum_control_tpu_torch/dryrun.py), the counterparts of the root
__graft_entry__.py, on the CPU:

  * `dryrun_multichip(2)` in two OS processes under gloo, started as
    tests/test_torch_distributed.py starts its workers: every one of the
    six controller compositions runs, both ranks return the same
    all-reduced means, each finite and equal to the mean |lat_dev| of one
    process's unsharded run over the same 4 scenarios within 1e-12
    relative (a sum of the same float64 values in another order);
  * `entry()`'s step against __graft_entry__.entry()'s on the same
    arguments, float64, within 1e-8 (JAX's `dryrun_multichip` is not
    called: it switches JAX's platform for the process).

The worker is this file's `__main__` block:

    python tests/test_torch_dryrun.py <rank> <world> <port>
"""
import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unsharded_means(batch):
    """Each composition's mean |lat_dev| over `batch` scenarios in one
    process, without the mesh."""
    from tum_control_tpu_torch import dryrun
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    means = {}
    for cfg in dryrun.compositions():
        sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=dryrun.DRYRUN_T), cfg,
                                              device="cpu", dtype=torch.float64)
        x0m, x0s = batched_scenarios(traj, batch)
        _, log = sim.run(x0m, x0s, dryrun.DRYRUN_STEPS, key=0)
        means[dryrun.composition_name(cfg)] = float(log.lat_dev.abs().mean())
    return means


def test_two_gloo_processes_run_every_composition():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS",)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
                               str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for r in range(WORLD)]
    outs = []
    try:
        ref = _unsharded_means(2 * WORLD)
        for p in procs:
            out, err = p.communicate(timeout=400)
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
        results.append({k: float.fromhex(v) for k, v in json.loads(line[7:]).items()})
    assert results[0] == results[1]
    assert list(results[0]) == ["nominal", "snmpc", "rnmpc", "nominal+wmpc", "snmpc+wmpc",
                                "rnmpc+wmpc"]
    for name, mean in results[0].items():
        assert np.isfinite(mean) and mean > 0, name
        assert abs(mean - ref[name]) <= 1e-12 * ref[name], (name, mean, ref[name])


def test_needs_a_process_group_above_one_device(monkeypatch):
    """Without a process group, n > 1 raises; n = 1 opens and closes a
    one-process group of its own."""
    import torch.distributed as dist

    from tum_control_tpu_torch import dryrun
    from tum_control_tpu_torch.config import MPCConfig

    with pytest.raises(RuntimeError, match="process group"):
        dryrun.dryrun_multichip(2, device="cpu")
    monkeypatch.setattr(dryrun, "compositions", lambda: [MPCConfig()])
    means = dryrun.dryrun_multichip(1, device="cpu", dtype=torch.float64)
    assert not dist.is_initialized()
    assert set(means) == {"nominal"} and np.isfinite(means["nominal"])


def test_entry_step_matches_the_jax_entry():
    import jax

    from tum_control_tpu_torch import dryrun

    spec = importlib.util.spec_from_file_location("_graft_entry",
                                                  os.path.join(REPO, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, jargs = graft.entry()
    fn, args = dryrun.entry(device="cpu", dtype=torch.float64)
    assert args[0].shape[0] == 1 and args[3].shape == (1, 8) and args[4].shape == (1, 2)
    np.testing.assert_allclose(args[3][0].numpy(), np.asarray(jargs[3]), rtol=0, atol=1e-12)
    got = fn(*args)
    ref = jax.jit(jfn)(*jargs)
    for name, a, b in zip(("u0", "pred_X", "stats"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a[0].numpy(), b, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(b).max()), err_msg=name)


if __name__ == "__main__":
    rank, world, port = map(int, sys.argv[1:4])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from tum_control_tpu_torch.dryrun import dryrun_multichip
    from tum_control_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        means = dryrun_multichip(world, device="cpu", dtype=torch.float64)
        print("RESULT " + json.dumps({k: float(v).hex() for k, v in means.items()}), flush=True)
    finally:
        dist.destroy_process_group()
