"""device_idle_share.batch: 1 - (the union of the device operations' intervals) / the window's
wall time, in the profiler window of closed-loop steps.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "share"
LAYER = "device (H100)"
MOVES = "device_solves_per_s"


def read(rec):
    p = rec["profile"]
    if rec["mode"] != "batch" or not p["window_s"]:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
