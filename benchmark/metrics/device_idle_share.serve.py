"""device_idle_share.serve: 1 - (the union of the device operations' intervals) / the window's
wall time, in the profiler window of served cycles (the waits for the
deadlines included).

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "share"
LAYER = "device (H100)"
MOVES = "cycle_ms_p95"


def read(rec):
    p = rec["profile"]
    if rec["mode"] != "serve" or not p["window_s"]:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
