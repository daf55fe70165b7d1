"""Runs the JAX package's measurement scripts (tools/*.py) on the CPU in
float64 and keeps what their stages compute, for tests/test_torch_tools*.py.

The scripts are imported from their paths and run unchanged; only their
timing helpers (`bench`, `scan_time`) are replaced by ones that jit the
stage, run it and keep its outputs, and their `jnp` by a view of jax.numpy
whose float32 is float64 (the scripts cast their starts to float32, the
tests compare in float64).
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _F64:
    """jax.numpy with float32 read as float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _run(mod, monkeypatch, argv):
    mod.jnp = _F64()
    monkeypatch.setattr(sys, "argv", [mod.__file__] + [str(a) for a in argv])
    mod.main()


def profile_step(monkeypatch, batch):
    """tools/profile_step.py's five stage outputs at `batch`, by the port's
    stage names."""
    mod = load_script("profile_step")
    outs = []

    def bench(fn, *args, n=20):
        outs.append(jax.block_until_ready(fn(*args)))
        return 1.0

    mod.bench = bench
    _run(mod, monkeypatch, [batch])
    return dict(zip(["planner", "build_qp", "ipm+polish", "solve (all)", "full step"], outs))


def chained(name, monkeypatch, argv, skip=()):
    """{stage: carry after R iterations} of tools/<name>.py's scan-chained
    stages (stage_bench, snmpc_dissect), each stage jitted once; stages in
    `skip` are not run."""
    mod = load_script(name)
    out = {}

    def scan_time(step, carry, R, label):
        if label in skip:
            return 1.0
        f = jax.jit(step)
        for _ in range(R):
            carry = f(carry)
        out[label.strip()] = jax.block_until_ready(carry)
        return 1.0

    mod.scan_time = scan_time
    _run(mod, monkeypatch, argv)
    return out


def assert_close(got, want, label, rel=1e-8):
    """max |got - want| <= rel * max(max |want|, 1e-300)."""
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{label}: max abs err {err:.3e} > {rel:.0e} * {scale:.3e}"


def hold_carry(name, got, want):
    """A chained stage's carry against the JAX script's, field by field: a
    tensor, a pair of tensors, a NamedTuple (with its IPM warm start) or the
    closed-loop carry."""
    if hasattr(got, "detach"):
        assert_close(got, want, name)
        return
    if isinstance(got, tuple) and not hasattr(got, "_fields"):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{name}[{i}]")
        return
    if name == "full step":
        pairs = [(f, getattr(got, f), getattr(want, f)) for f in ("x_sim", "x_dist", "x_est",
                                                                   "pose")]
        pairs += [(f"ctrl_state.{f}", getattr(got.ctrl_state, f), getattr(want.ctrl_state, f))
                  for f in ("X", "U")]
    else:
        pairs = [(f, getattr(got, f), getattr(want, f)) for f in got._fields if f != "warm"]
        if hasattr(got, "warm"):
            pairs += [(f"warm.{f}", getattr(got.warm, f), getattr(want.warm, f))
                      for f in got.warm._fields]
    for f, g, w in pairs:
        assert_close(g, w, f"{name}.{f}")
