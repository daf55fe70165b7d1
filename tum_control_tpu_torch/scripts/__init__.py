"""Paper-figure scripts of the port (python -m tum_control_tpu_torch.scripts.<name>)."""
