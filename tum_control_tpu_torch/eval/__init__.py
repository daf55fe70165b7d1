"""Logs, evaluation and figures of a closed-loop run (port of
tum_control_tpu/eval). matplotlib and imageio are imported only by the
functions that draw."""
