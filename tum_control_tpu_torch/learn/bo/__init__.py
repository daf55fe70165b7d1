"""Multi-objective Bayesian optimisation of the NMPC cost weights (port of
tum_control_tpu/learn/bo/)."""
