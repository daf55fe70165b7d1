"""Reference trajectories and the planner emulator."""
