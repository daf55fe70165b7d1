"""tightening_ms.batch: Host milliseconds a closed-loop step inside the port's
`tc.rnmpc.tighten` span (controllers/rnmpc.py: the covariance recurrence over
the uncertainty propagation horizon, the gradients of the acceleration rows
and the back-offs, kept where the solve succeeded): the median over the
steps that the port's tracer recorded in the run
(tum_control_tpu_torch/utils/trace.py).

Reads the traced run's record (driver_*.py) and the port's tracer; returns
None where it finds nothing to read (a controller without the tightening, a
port without the span)."""
UNIT = "ms"
LAYER = "controller and RTI engine (controllers/*, ops/rti.py, ops/ipm.py, ops/soft_qp.py)"
MOVES = "device_solves_per_s"


def read(rec):
    if rec["mode"] != "batch":
        return None
    try:
        from tum_control_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.median_ms(trace.snapshot(), "tc.step", ("tc.rnmpc.tighten",))
