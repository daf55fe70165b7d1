"""qp_roofline.batch: The QP stage's share of its roofline: its least time on the card,
max(FLOPs / peak float32 rate, bytes / peak bandwidth) of qp_iters
Mehrotra iterations and the polish at the configuration's shapes
(benchmark/work.py::qp_solve), over the device time of every kernel
launched inside the interior-point span (the polish is inside it), per
step of the profiler window. Nothing where the card's peaks are not known
or no kernel was attributed to the span.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
from benchmark.work import least_time_s

UNIT = "%"
LAYER = "kernels (ops/kernels/*.py, csrc/*.cu)"
MOVES = "device_solves_per_s"


def read(rec):
    dev = rec["profile"]["span_device_s"].get("ipm")
    if rec["mode"] != "batch" or not rec["peaks"] or not dev:
        return None
    flops, nbytes = rec["work"]["qp_solve"]
    return 100.0 * least_time_s(flops, nbytes, rec["peaks"]) / (dev / rec["profile"]["steps"])
