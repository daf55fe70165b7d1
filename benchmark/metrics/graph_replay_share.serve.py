"""graph_replay_share.serve: The share of `deploy_rt.packed_step`'s calls in the run that
replayed the served step's CUDA graph: replays over eager, capturing and
replayed calls, from the port's counter `deploy_rt.GRAPH_STEPS` (warm-up,
window and profiled cycles alike).

Reads the port's counter; returns None where it finds nothing to read (a
batch record, a port without the counter, or no call counted)."""
UNIT = "share"
LAYER = "serving (deploy_rt.py, utils/rt_runtime.py)"
MOVES = "cycle_ms_p95"


def read(rec):
    if rec["mode"] != "serve":
        return None
    try:
        from tum_control_tpu_torch import deploy_rt
    except ImportError:
        return None
    counts = getattr(deploy_rt, "GRAPH_STEPS", None)
    if not counts or not sum(counts.values()):
        return None
    return counts["replay"] / sum(counts.values())
