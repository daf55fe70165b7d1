"""Fixed-step explicit RK4 (port of tum_control_tpu/models/integrators.py).

Used for the OCP shooting step (3 substeps over Ts_MPC) and the plant
(4 substeps over Ts; on the card one kernel, ops/kernels/plant.py). Works
on any leading batch shape; the `_tree` versions take a state that is a
nest of tensors (e.g. a tuple of one tensor per variable,
models/vehicle_stm.py::pred_ode_tuple's form).
"""
from __future__ import annotations

from torch.utils._pytree import tree_map


def rk4_step(f, x, u, dt):
    """One classical RK4 step of xdot = f(x, u)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_multistep(f, x, u, dt, n_steps: int):
    """n_steps RK4 sub-steps covering a total interval dt (zero-order-hold u).
    An `f` that carries its own integrator, `f.integrate(x, u, dt, n_steps)`
    (the plant's kernel, ops/kernels/plant.py::PlantODE), is handed the
    whole integration."""
    fused = getattr(f, "integrate", None)
    if fused is not None:
        return fused(x, u, dt, n_steps)
    h = dt / n_steps
    for _ in range(n_steps):
        x = rk4_step(f, x, u, h)
    return x


def rk4_step_tree(f, x, u, dt):
    """RK4 step where the state is a nest of tensors (a tuple of per-variable
    tensors, say); `f(x, u)` returns a nest of the same structure."""
    axpy = lambda a, k: tree_map(lambda xi, ki: xi + a * ki, x, k)
    k1 = f(x, u)
    k2 = f(axpy(0.5 * dt, k1), u)
    k3 = f(axpy(0.5 * dt, k2), u)
    k4 = f(axpy(dt, k3), u)
    return tree_map(lambda xi, a, b, c, d: xi + (dt / 6.0) * (a + 2.0 * b + 2.0 * c + d),
                    x, k1, k2, k3, k4)


def rk4_multistep_tree(f, x, u, dt, n_steps: int):
    """Nest-state version of `rk4_multistep`."""
    h = dt / n_steps
    for _ in range(n_steps):
        x = rk4_step_tree(f, x, u, h)
    return x
