"""Weights-varying MPC inference: the policy MLP, its observation and the
WMPC wrapper (port of tum_control_tpu/learn; training waits)."""
