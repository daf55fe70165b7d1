"""Closed-loop NMPC simulation on the GPU (the port's counterpart of the root
main.py):

    python -m tum_control_tpu_torch.main [--controller nominal|snmpc|rnmpc]
        [--config data/Config] [--sim-params EDGAR/sim_main_params.yaml]
        [--mpc-params EDGAR/MPC_params.yaml] [--logs-path Logs/] [--seed 0]
        [--no-plots] [--T SECONDS] [--device cuda|cpu]

Loads the YAML configs, optionally replays recorded disturbances, runs one
scenario's closed loop in chunks on `--device` (cuda by default: without a
card the run raises unless `--device cpu` is given), and writes
`full_logs.npz` (and `RL_WMPC_logs.npz` under WMPC) and the figures into a
timestamped run directory under `--logs-path`, in the reference's layout.
The figures need matplotlib; without it the run raises before it starts
unless `--no-plots` is given.
"""
import argparse
import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

from tum_control_tpu_torch import config as cfg_mod
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import load_mpc_config, load_sim_config
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.eval.logger import assemble_logs, evaluation
from tum_control_tpu_torch.sim.closed_loop import SimLog
from tum_control_tpu_torch.sim.disturbances import load_playback

# steps of the warm-up chunk before the timed run (the JAX entry point
# compiles there): the kernels build at their first launch, and the caching
# allocator takes its blocks
WARMUP_STEPS = 2


def _chunk_sizes(sim_cfg, n_steps):
    """Chunks of min(250, Nsim) steps, or `live_plot_freq` steps under live
    visualization; the last one takes the remainder."""
    live = sim_cfg.live_visualization in (1, 2)
    chunk = max(1, min(int(sim_cfg.live_plot_freq) if live else 250, n_steps))
    sizes = [chunk] * (n_steps // chunk)
    if n_steps % chunk:
        sizes.append(n_steps % chunk)
    return sizes


def _to_host(log: SimLog):
    """Scenario 0 of a chunk's (1, sz, ...) SimLog as numpy arrays, through
    one device->host copy: every field flattened per step into one tensor of
    the log's float dtype (the int32 action and the solver's counts are
    small integers, exact in it) and split again on the host."""
    fields = [f[0] for f in log]
    dtype = log.CiLX.dtype
    flat = torch.cat([f.reshape(f.shape[0], -1).to(dtype) for f in fields], dim=1)
    flat = flat.cpu().numpy()
    out, col = [], 0
    for f in fields:
        w = int(np.prod(f.shape[1:], dtype=np.int64))
        out.append(flat[:, col:col + w].reshape(f.shape).astype(
            np.int32 if f.dtype == torch.int32 else flat.dtype))
        col += w
    return out


def run_main(sim_cfg, mpc_cfg, *, device=None, dtype=torch.float32, logs_path="Logs/", seed=0,
             make_plots=True, config_path=None):
    """The body of the entry point: one scenario (B = 1) of `sim_cfg` under
    `mpc_cfg` on `device` in `dtype`. With `sim_cfg.disturbance_playback`
    the disturbances come from `playback_log_file` (under `logs_path`).

    A warm-up chunk of WARMUP_STEPS steps runs first, outside the timed
    window. Each chunk's wall time, up to its log's copy to the host (and a
    device synchronize), is spread over its steps into simSolverDebug[:, 1];
    the log buffers live on the host, filled chunk by chunk. Under live
    visualization a worker thread renders each chunk boundary from those
    buffers (all matplotlib calls on that thread, no device call).

    Returns (logs dict, summary dict, wall seconds of the timed run)."""
    device = resolve_device(device)
    if make_plots:
        from tum_control_tpu_torch.eval.plots import pyplot

        pyplot()  # without matplotlib, raise before the run
    config_path = config_path or cfg_mod.DEFAULT_CONFIG_PATH
    sim, x0_mpc, x0_sim, traj, track = build_simulation(sim_cfg, mpc_cfg, config_path,
                                                        device=device, dtype=dtype)
    n_steps = sim_cfg.Nsim
    print(f"controller={mpc_cfg.controller} simMode={sim_cfg.sim_mode} "
          f"N={sim_cfg.N} Nsim={n_steps} track={sim_cfg.track_file} device={device}")

    playback = None
    if sim_cfg.disturbance_playback:
        if not sim_cfg.playback_log_file:
            raise ValueError(
                "disturbance_playback is enabled but playback_log_file is empty "
                "(the run would silently replace disturbances with zeros)"
            )
        playback = load_playback(logs_path, sim_cfg.playback_log_file, n_steps, dtype=dtype,
                                 device=device)
        print(f"replaying disturbances from {sim_cfg.playback_log_file}")

    def pb_slice(pos, sz):
        if playback is None:
            return None
        return (playback[0][None, pos:pos + sz], playback[1][None, pos:pos + sz])

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    x0m, x0s = x0_mpc[None], x0_sim[None]
    x0m_host, x0s_host = x0_mpc.cpu().numpy(), x0_sim.cpu().numpy()

    warm = sim.init_carry(x0m, x0s, key=seed)
    _, lg0 = sim.run_from(warm, min(WARMUP_STEPS, n_steps), pb_slice(0, WARMUP_STEPS))
    buffers = SimLog(*(np.empty((n_steps,) + a.shape[1:], a.dtype) for a in _to_host(lg0)))
    sync()

    def partial_assemble(pos):
        part = SimLog(*(b[:pos] for b in buffers))
        return assemble_logs(part, x0m_host, x0s_host, pos * sim_cfg.Ts_sim_step)

    live_view = render_q = render_thread = None
    if sim_cfg.live_visualization in (1, 2):
        from tum_control_tpu_torch.eval.live_viz import LiveView

        gif = (os.path.join(logs_path, sim_cfg.GIF_file_name)
               if sim_cfg.GIF_animation_generation else None)
        live_view = LiveView(track=track, mode=sim_cfg.live_visualization,
                             window=(float(sim_cfg.xwidth), float(sim_cfg.ywidth)),
                             gif_path=gif, show=bool(os.environ.get("DISPLAY")))
        render_q = queue.Queue(maxsize=2)

        def _render_worker():
            # reads buffers[:pos] while the main thread writes [pos:]
            while True:
                p = render_q.get()
                if p is None:
                    break
                live_view.update(partial_assemble(p), p)

        render_thread = threading.Thread(target=_render_worker, daemon=True)
        render_thread.start()

    carry = sim.init_carry(x0m, x0s, key=seed)
    step_times = []
    pos = 0
    t0 = time.perf_counter()
    try:
        for sz in _chunk_sizes(sim_cfg, n_steps):
            tc = time.perf_counter()
            carry, lg = sim.run_from(carry, sz, playback=pb_slice(pos, sz))
            host = _to_host(lg)
            sync()
            step_times.append(np.full(sz, (time.perf_counter() - tc) / sz))
            for b, a in zip(buffers, host):
                b[pos:pos + sz] = a
            pos += sz
            if render_q is not None:
                try:
                    render_q.put_nowait(pos)  # skip frames if the renderer lags
                except queue.Full:
                    pass
        wall = time.perf_counter() - t0
    finally:
        if render_thread is not None:
            render_q.put(None)
            render_thread.join()
    if live_view is not None:
        live_view.update(partial_assemble(pos), pos)
        n_frames = live_view.finish()
        if sim_cfg.GIF_animation_generation:
            print(f"live viz: {n_frames} frames -> "
                  f"{os.path.join(logs_path, sim_cfg.GIF_file_name)}")
    print(f"simulated {n_steps} steps in {wall:.2f}s "
          f"({wall / n_steps * 1e3:.3f} ms/step, warm-up excluded)")

    logs = assemble_logs(buffers, x0m_host, x0s_host, sim_cfg.T,
                         step_times=np.concatenate(step_times))
    param_table = getattr(sim.controller, "param_table", None)
    summary = evaluation(
        logs,
        logs_path=logs_path,
        run_name=sim_cfg.file_logs_name,
        save=sim_cfg.save_logs,
        make_plots=make_plots,
        wall_time=wall,
        wmpc_sets=None if param_table is None else param_table.cpu().numpy(),
    )
    return logs, summary, wall


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="config root (default data/Config)")
    ap.add_argument("--sim-params", default="EDGAR/sim_main_params.yaml")
    ap.add_argument("--mpc-params", default="EDGAR/MPC_params.yaml")
    ap.add_argument("--controller", default=None, choices=["nominal", "snmpc", "rnmpc"])
    ap.add_argument("--logs-path", default="Logs/")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--T", type=float, default=None, help="override simulation time [s]")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config_path = args.config or cfg_mod.DEFAULT_CONFIG_PATH
    sim_cfg = load_sim_config(os.path.join(config_path, args.sim_params))
    if args.T is not None:
        sim_cfg = dataclasses.replace(sim_cfg, T=args.T)
    mpc_cfg = load_mpc_config(os.path.join(config_path, args.mpc_params))
    if args.controller:
        mpc_cfg = dataclasses.replace(mpc_cfg, controller=args.controller)
    return run_main(sim_cfg, mpc_cfg, device=device, dtype=dtype, logs_path=args.logs_path,
                    seed=args.seed, make_plots=not args.no_plots, config_path=config_path)


if __name__ == "__main__":
    main()
