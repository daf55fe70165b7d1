"""Runs the JAX package's tire-identification tools (tools/fit_tires_es.py,
tools/fit_tires_closedloop.py) on the CPU in float64 for
tests/test_torch_tire_fit.py, and loads tools/golden_attribution.py.

The two fit tools set TUM_DIFFERENTIABLE=1 before they import the JAX
package, a choice the package reads once, at import. A test process imports
the package in its default mode, so they run here in a child process:

    python tests/_torch_tire_fit_jax.py SPEC.json OUT.json

SPEC: {"tool": "fit_tires_es" | "fit_tires_closedloop", "argv": [...],
"golden": NPZ, "golden_snmpc": NPZ, "tmp": DIR, "forward_only": bool}. The
tool runs unchanged from its path with --cpu; its golden paths, output file
and log directory are pointed at the spec's, and its `jax` is a view that
keeps what every jitted function returns (the ES's eval_pop, the fit's
value_and_grad). With forward_only the fit's value_and_grad becomes its
forward and a zero gradient, which compiles in seconds where the reverse
sweep takes minutes. OUT: {"calls": [every jitted call's outputs, as nested
lists], "stdout": the tool's output}.
"""
import contextlib
import importlib.util
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name, repair=None):
    """tools/<name>.py as a module; `repair` (old, new) edits its source
    before it runs."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    with open(path) as fh:
        src = fh.read()
    if repair is not None:
        assert src.count(repair[0]) == 1, repair
        src = src.replace(*repair)
    spec = importlib.util.spec_from_loader(f"jax_tools_{name}", loader=None, origin=path)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = path
    sys.path.insert(0, REPO)
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def load_golden_attribution():
    """tools/golden_attribution.py, whose `write_yaml` misses the `+` that
    joins its header to the YAML body (a SyntaxError as committed): the
    module with that one operator put in."""
    return load_tool("golden_attribution", ('            header\n            "tire_params:\\n"',
                                            '            header +\n            "tire_params:\\n"'))


def _tree(x):
    import numpy as np

    if isinstance(x, (tuple, list)):
        return [_tree(v) for v in x]
    return np.asarray(x).tolist()


def main(spec_path, out_path):
    with open(spec_path) as fh:
        spec = json.load(fh)
    os.environ["TUM_DIFFERENTIABLE"] = "1"
    import jax
    import jax.numpy as jnp

    mod = load_tool(spec["tool"])
    calls = []

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, f, **kw):
            g = jax.jit(f, **kw)

            def run(*a, **k):
                out = g(*a, **k)
                calls.append(_tree(jax.tree_util.tree_leaves(out)))
                return out
            return run

        def value_and_grad(self, f, **kw):
            if not spec.get("forward_only"):
                return jax.value_and_grad(f, **kw)
            return lambda th: (f(th), jnp.zeros_like(th))

    mod.jax = _Jax()
    mod.GOLDEN_NOM, mod.GOLDEN_SNM = spec["golden"], spec["golden_snmpc"]
    mod.REPO = spec["tmp"]
    mod.OUT_YAML = os.path.join(spec["tmp"], "out.yaml")
    sys.argv = [mod.__file__, "--cpu"] + [str(a) for a in spec["argv"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    with open(out_path, "w") as fh:
        json.dump({"calls": calls, "stdout": buf.getvalue()}, fh)


if __name__ == "__main__":
    main(*sys.argv[1:3])
