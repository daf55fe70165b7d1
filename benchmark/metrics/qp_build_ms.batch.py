"""qp_build_ms.batch: Host milliseconds a closed-loop step building the QP: the port's
`tc.rti.linearize`, `tc.rti.condense` and `tc.rti.assemble` spans (K1, K2,
the Gauss-Newton cost and the constraint rows), or its `tc.rti.build_qp`
span (a controller's own assembly: SNMPC's K1 + K6). The median over the
steps that the port's tracer recorded in the run
(tum_control_tpu_torch/utils/trace.py).

Reads the traced run's record (driver_*.py) and the port's tracer; returns
None where it finds nothing to read (a port without the tracer or the span)."""
UNIT = "ms"
LAYER = "controller and RTI engine (controllers/*, ops/rti.py, ops/ipm.py, ops/soft_qp.py)"
MOVES = "device_solves_per_s"

SPANS = ("tc.rti.linearize", "tc.rti.condense", "tc.rti.assemble", "tc.rti.build_qp")


def read(rec):
    if rec["mode"] != "batch":
        return None
    try:
        from tum_control_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.median_ms(trace.snapshot(), "tc.step", SPANS)
