"""Host-side utilities: checkpoints, the plot palette and the native
real-time executor (port of tum_control_tpu/utils)."""
