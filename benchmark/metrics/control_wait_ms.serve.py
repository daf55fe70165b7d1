"""control_wait_ms.serve: Host milliseconds a served cycle waits for its packed control: the
port's `tc.cycle.fetch` span around `packed.cpu()` in
deploy_rt.run_synchronous, from the step's last launch to the control on the
host. The median over the cycles that the port's tracer recorded in the run
(tum_control_tpu_torch/utils/trace.py).

Reads the traced run's record (driver_*.py) and the port's tracer; returns
None where it finds nothing to read (a port without the tracer or the span)."""
UNIT = "ms"
LAYER = "serving (deploy_rt.py, utils/rt_runtime.py)"
MOVES = "cycle_ms_p95"


def read(rec):
    if rec["mode"] != "serve":
        return None
    try:
        from tum_control_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.median_ms(trace.snapshot(), "tc.cycle", ("tc.cycle.fetch",))
