"""This host's real-time scheduling floor with no device work (port of
tools/host_jitter.py):

    python -m tum_control_tpu_torch.tools.host_jitter [--cycles 3000] [--period 0.02]

Runs the native fixed-rate executor (utils/rt_runtime.py, built from the
port's csrc/rt_runtime.cc) with an empty cycle body, the cheapest possible
loop at the period, and reports deadline misses and start-time lateness.
Misses here are the host's scheduling jitter (vCPU preemption, CPU steal),
not the application's: they bound what any user-space serving loop can
reach on the machine. deploy_rt.py makes the same measurement inline
(its sentinel thread) to classify its own late cycle starts.
"""
import argparse

import numpy as np

from tum_control_tpu_torch.utils.rt_runtime import RealtimeExecutor


def main(argv=None):
    """Returns the executor's stats dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=3000)
    ap.add_argument("--period", type=float, default=0.02)
    args = ap.parse_args(argv)

    ex = RealtimeExecutor(period_s=args.period)
    t0s = np.zeros(args.cycles, dtype=np.int64)
    try:
        for i in range(args.cycles):
            t0s[i] = ex.begin_cycle()
            ex.record(t0s[i], 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0)
        stats = ex.stats()
    finally:
        ex.close()

    late = (np.diff(t0s) - int(args.period * 1e9)) / 1e6
    print(stats)
    print(f"empty-loop misses: {stats['deadline_misses']}/{args.cycles}; "
          f"late starts >1 ms: {int((late > 1.0).sum())}; max lateness {late.max():.1f} ms")
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8])
        print(f"/proc/stat steal: {steal} jiffies since boot")
    except (OSError, IndexError, ValueError):
        pass
    return stats


if __name__ == "__main__":
    main()
