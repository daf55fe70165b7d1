"""kernels_per_step.batch: Device kernels launched per closed-loop step in the profiler window (a
count that repeats exactly from run to run).

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "kernels/step"
LAYER = "closed loop (sim/closed_loop.py)"
MOVES = "device_solves_per_s"


def read(rec):
    if rec["mode"] != "batch" or not rec["profile"]["kernels"]:
        return None
    return rec["profile"]["kernels"] / rec["profile"]["steps"]
