"""wall_solves_per_s.batch: B x the closed-loop steps completed in the traced window over its
wall seconds on the host's clock (the window ends after a synchronisation,
so every step counted has finished on the device). The rate a batch user
waits for; the host issues the step and sets it, so it moves with the
host's speed from run to run (PERF.md section 2).

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "solve/s"
LAYER = "closed loop (sim/closed_loop.py)"
MOVES = "device_solves_per_s"


def read(rec):
    if rec["mode"] != "batch" or not rec["steps"] or not rec["window_s"]:
        return None
    return rec["batch"] * rec["steps"] / rec["window_s"]
