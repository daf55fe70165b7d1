"""policy_ms.batch: Host milliseconds a closed-loop step inside the port's
`tc.wmpc.policy` span (learn/wmpc.py: the observation, the policy's MLP and
argmax, the parameter table's row and the weights' selects, every step): the
median over the steps that the port's tracer recorded in the run
(tum_control_tpu_torch/utils/trace.py).

Reads the traced run's record (driver_*.py) and the port's tracer; returns
None where it finds nothing to read (a controller without the policy, a
port without the span)."""
UNIT = "ms"
LAYER = "WMPC policy (learn/wmpc.py, learn/policy.py, learn/observation.py)"
MOVES = "device_solves_per_s"


def read(rec):
    if rec["mode"] != "batch":
        return None
    try:
        from tum_control_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.median_ms(trace.snapshot(), "tc.step", ("tc.wmpc.policy",))
