"""Fixed-step explicit RK4 (port of tum_control_tpu/models/integrators.py).

Used for the OCP shooting step (3 substeps over Ts_MPC) and the plant
(4 substeps over Ts). Works on any leading batch shape.
"""
from __future__ import annotations


def rk4_step(f, x, u, dt):
    """One classical RK4 step of xdot = f(x, u)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_multistep(f, x, u, dt, n_steps: int):
    """n_steps RK4 sub-steps covering a total interval dt (zero-order-hold u)."""
    h = dt / n_steps
    for _ in range(n_steps):
        x = rk4_step(f, x, u, h)
    return x
