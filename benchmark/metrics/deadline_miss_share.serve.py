"""deadline_miss_share.serve: The executor's deadline misses over its cycles in the traced window.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "share"
LAYER = "serving (deploy_rt.py, utils/rt_runtime.py)"
MOVES = "cycle_ms_p95"


def read(rec):
    if rec["mode"] != "serve" or not rec["cycles"]:
        return None
    return rec["misses"] / rec["cycles"]
