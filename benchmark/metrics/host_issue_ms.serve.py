"""host_issue_ms.serve: Host milliseconds per served cycle from the dispatch of the step until
`deploy_rt.packed_step` returns, before the wait for the packed control
(`.cpu()`): the mean over the traced window.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "ms"
LAYER = "serving (deploy_rt.py, utils/rt_runtime.py)"
MOVES = "cycle_ms_p95"


def read(rec):
    if rec["mode"] != "serve" or not rec["issue_s"]:
        return None
    return 1e3 * sum(rec["issue_s"]) / len(rec["issue_s"])
