"""solve_ms.batch: Host milliseconds per step inside the controller's `solve` span (the
planner window in, the RTI solve: linearize, condense, QP assembly, the
interior-point iterations and the polish), over the traced window.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "ms"
LAYER = "controller and RTI engine (controllers/*, ops/rti.py, ops/ipm.py, ops/soft_qp.py)"
MOVES = "device_solves_per_s"


def read(rec):
    if rec["mode"] != "batch" or "solve" not in rec["spans_s"] or not rec["steps"]:
        return None
    return 1e3 * rec["spans_s"]["solve"] / rec["steps"]
