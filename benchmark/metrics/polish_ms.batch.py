"""polish_ms.batch: Host milliseconds a closed-loop step in the port's `tc.qp.polish` span
(ops/soft_qp.py::newton_polish: K3, K5 and the exact line search). The
median over the steps that the port's tracer recorded in the run
(tum_control_tpu_torch/utils/trace.py).

Reads the traced run's record (driver_*.py) and the port's tracer; returns
None where it finds nothing to read (a port without the tracer or the span)."""
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
    return trace.median_ms(trace.snapshot(), "tc.step", ("tc.qp.polish",))
