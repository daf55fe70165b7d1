"""Host-side utilities: checkpoints and the plot palette (port of
tum_control_tpu/utils)."""
