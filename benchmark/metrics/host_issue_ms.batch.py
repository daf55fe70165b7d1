"""host_issue_ms.batch: Host milliseconds per closed-loop step until `ClosedLoopSim.step`
returns, without waiting for the device: the mean over the traced run's
window, before any profiler session.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "ms"
LAYER = "closed loop (sim/closed_loop.py)"
MOVES = "device_solves_per_s"


def read(rec):
    if rec["mode"] != "batch" or not rec["issue_s"]:
        return None
    return 1e3 * sum(rec["issue_s"]) / len(rec["issue_s"])
