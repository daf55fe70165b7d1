"""Weights-varying MPC and its training: the policy MLP, its observation,
the WMPC wrapper, the RL env and PPO, and the Bayesian optimisation of the
cost weights (port of tum_control_tpu/learn)."""
