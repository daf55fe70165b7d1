"""step_mfu.batch: The whole step's share of the card's peak: the least time of the step's
counted work (benchmark/work.py::step_work: planner, linearize, condense,
QP assembly, the QP solve, plant, estimator, the draws of a configuration
that draws), max(FLOPs / peak float32
rate, bytes / peak bandwidth), over the card's busy time per step in the
profiled stretch (the union of its operations' intervals), the time that
`device_solves_per_s` divides by: the share bounds that rate. Nothing
where the card's peaks are not known.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
from benchmark.work import least_time_s

UNIT = "%"
LAYER = "device (H100)"
MOVES = "device_solves_per_s"


def read(rec):
    p = rec["profile"]
    if rec["mode"] != "batch" or not rec["peaks"] or not p["busy_s"]:
        return None
    flops, nbytes = rec["work"]["step"]
    return 100.0 * least_time_s(flops, nbytes, rec["peaks"]) / (p["busy_s"] / p["steps"])
