"""Vehicle models and integrators."""
