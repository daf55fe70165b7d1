"""plant_estimator_ms.batch: Host milliseconds per step inside the plant's RK4 span and the
estimator's span, over the traced window.

Reads the traced run's record (driver_*.py); returns None where it finds
nothing to read."""
UNIT = "ms"
LAYER = "plant and estimator (models/, sim/estimator.py)"
MOVES = "device_solves_per_s"


def read(rec):
    names = ("plant_rk4", "estimate")
    if rec["mode"] != "batch" or not rec["steps"] or any(n not in rec["spans_s"] for n in names):
        return None
    return 1e3 * sum(rec["spans_s"][n] for n in names) / rec["steps"]
