"""planner_ms.batch: Host milliseconds a closed-loop step inside the port's `tc.planner`
span (track/planner.py's reference window): the median over the steps that
the port's tracer recorded in the run (tum_control_tpu_torch/utils/trace.py).

Reads the traced run's record (driver_*.py) and the port's tracer; returns
None where it finds nothing to read (a port without the tracer or the span)."""
UNIT = "ms"
LAYER = "closed loop (sim/closed_loop.py)"
MOVES = "device_solves_per_s"


def read(rec):
    if rec["mode"] != "batch":
        return None
    try:
        from tum_control_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.median_ms(trace.snapshot(), "tc.step", ("tc.planner",))
