"""step_mfu.serve: The whole step's share of the card's peak at B = 1: the least time of
the step's counted work (benchmark/work.py::step_work) over the mean
wall time of a served cycle's step (dispatch to the packed control on the
host) in the traced window. Nothing where the card's peaks are not known.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
from benchmark.work import least_time_s

UNIT = "%"
LAYER = "device (H100)"
MOVES = "cycle_ms_p95"


def read(rec):
    if rec["mode"] != "serve" or not rec["peaks"] or not rec["solve_s"]:
        return None
    flops, nbytes = rec["work"]["step"]
    wall = sum(rec["solve_s"]) / len(rec["solve_s"])
    return 100.0 * least_time_s(flops, nbytes, rec["peaks"]) / wall
