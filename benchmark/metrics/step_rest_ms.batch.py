"""step_rest_ms.batch: Host milliseconds a closed-loop step outside the layers that have a
metric of their own: the port's `tc.step` span less its planner, QP build,
QP iterations, polish, `tc.plant` and `tc.estimator` spans. The rest is
the RTI's finish (the iterate update, the health check, the nonlinear
cost), the controller's own work around the RTI (the IPM's start among it)
and the step's (the re-init of failed solves, the disturbance draws, the
log). So the seven add up to the step. The median over the steps that the port's
tracer recorded in the run (tum_control_tpu_torch/utils/trace.py).

Reads the traced run's record (driver_*.py) and the port's tracer; returns
None where it finds nothing to read (a port without the tracer or the span)."""
UNIT = "ms"
LAYER = "closed loop (sim/closed_loop.py)"
MOVES = "device_solves_per_s"

PARTS = ("tc.planner", "tc.rti.linearize", "tc.rti.condense", "tc.rti.assemble",
         "tc.rti.build_qp", "tc.qp.iteration", "tc.qp.polish", "tc.plant", "tc.estimator")


def read(rec):
    if rec["mode"] != "batch":
        return None
    try:
        from tum_control_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.median_ms(trace.snapshot(), "tc.step", ("tc.step",), minus=PARTS)
