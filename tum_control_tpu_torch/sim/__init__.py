"""Closed-loop simulation, state estimation and disturbances."""
