"""The port's golden attribution (tum_control_tpu_torch/tools/
golden_attribution.py) against the JAX tool on the CPU in float64.

The ACC24 goldens are not in the repository: a module fixture writes a
synthetic pair with the port (nominal, and SNMPC at UPH 15; 20 steps from
the first corner, lap point 215, with pacejka_params_2023fit.yaml on plant
and controller) under a temporary directory. The JAX tool is loaded from
its path (tests/_torch_tire_fit_jax.py::load_golden_attribution: its
`write_yaml` as committed lacks the `+` joining its header to the body, a
SyntaxError; the loader puts that operator in and changes nothing else).

Tolerances: the transition fit after 20 Adam steps (theta, rms0, rms1)
within 1e-8 of JAX's, relative to each value's scale (the same float64
residuals and optax's Adam in another operation order); the YAML writers
give the same text. Nothing under data/ is written: every path is under the
temporary directory.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tire_fit_jax import load_golden_attribution
from tum_control_tpu_torch.config import MPCConfig
from tum_control_tpu_torch.params import TireParams
from tum_control_tpu_torch.tools import golden_attribution, tire_fit

F64 = torch.float64
CORNER, GOLDEN_STEPS, FIT_STEPS = 215, 20, 20
TOL_FIT = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("attribution"))
    torch.set_num_threads(1)
    paths = {}
    for name, cfg in (("nominal", MPCConfig()), ("snmpc", MPCConfig(**tire_fit.SNMPC))):
        paths[name] = os.path.join(tmp, name, "full_logs.npz")
        tire_fit.write_golden(paths[name], cfg, GOLDEN_STEPS, "EDGAR/pacejka_params_2023fit.yaml",
                              "cpu", F64, start=CORNER)
    return dict(tmp=tmp, **paths)


@pytest.fixture(scope="module")
def jax_tool():
    return load_golden_attribution()


def test_fit_tires_matches_jax(goldens, jax_tool):
    d = tire_fit.load_golden(goldens["nominal"])
    tp, rms0, rms1, theta = golden_attribution.fit_tires(d, FIT_STEPS, 0.02, "cpu")
    tp_j, rms0_j, rms1_j = jax_tool.fit_tires(dict(np.load(goldens["nominal"])), FIT_STEPS, 0.02)
    theta_j = np.log(np.array([float(v) for v in tp_j[:8]])) - np.log(np.array(TireParams()[:8]))
    np.testing.assert_allclose(theta, theta_j, rtol=0, atol=TOL_FIT * np.abs(theta_j).max())
    np.testing.assert_allclose([rms0, rms1], [rms0_j, rms1_j], rtol=TOL_FIT)
    np.testing.assert_allclose(np.array(tp[:8]), np.array([float(v) for v in tp_j[:8]]),
                               rtol=TOL_FIT)
    assert rms1 < rms0


def test_yaml_writers_match_jax(goldens, jax_tool, monkeypatch):
    """write_yaml and write_snmpc_blend write the JAX tool's text; the blend
    lands beside the fit as *_snmpc.yaml."""
    tp = TireParams(Bf=8.123456789, Cf=1.23456789, Df=14567.891234, Ef=0.98765432,
                    Br=9.87654321, Cr=1.5432198, Dr=23456.789123, Er=0.9712345, mu=1.0489)
    port = os.path.join(goldens["tmp"], "port", "pacejka_params_2023fit.yaml")
    jx = os.path.join(goldens["tmp"], "jax", "pacejka_params_2023fit.yaml")
    os.makedirs(os.path.dirname(jx), exist_ok=True)
    golden_attribution.write_yaml(tp, port)
    jax_tool.write_yaml(TireParams(*(jnp.asarray(v) for v in tp)), jx)
    with open(port) as a, open(jx) as b:
        assert a.read() == b.read()
    monkeypatch.setattr(jax_tool, "FIT_YAML", jx)
    blend_j = jax_tool.write_snmpc_blend()
    blend = golden_attribution.write_snmpc_blend(port)
    assert blend == port.replace("2023fit.yaml", "2023fit_snmpc.yaml")
    with open(blend) as a, open(blend_j) as b:
        assert a.read() == b.read()


def test_main_runs_its_laps(goldens, capsys):
    """The entry point on the CPU: the fit, both files, the four laps (cut to
    2 steps) and the two verdict lines."""
    out_yaml = os.path.join(goldens["tmp"], "main", "pacejka_params_2023fit.yaml")
    res = golden_attribution.main(["--golden", goldens["nominal"], "--golden-snmpc",
                                   goldens["snmpc"], "--out", out_yaml, "--steps", "5",
                                   "--T", "0.04", "--device", "cpu"], dtype=F64)
    text = capsys.readouterr().out
    assert "attribution (nominal):" in text and "attribution (SNMPC):" in text
    assert os.path.exists(out_yaml) and os.path.exists(res["blend"])
    for name in ("fitted", "shipped", "snmpc_blend", "nominal_blend"):
        assert np.isfinite(res[name]).all() and res[name + "_ok"] == 1.0, name
    assert res["rms1"] < res["rms0"]


def test_missing_golden_is_named(tmp_path):
    missing = str(tmp_path / "none" / "full_logs.npz")
    with pytest.raises(FileNotFoundError, match=missing):
        golden_attribution.main(["--golden", missing, "--device", "cpu",
                                 "--out", str(tmp_path / "o.yaml")], dtype=F64)


def test_default_goldens_are_the_jax_tools(jax_tool):
    """Without --golden / --golden-snmpc the port's tools read the JAX tools'
    default paths (the ACC24 goldens)."""
    from tum_control_tpu_torch.tools import fit_tires_closedloop, fit_tires_es

    for mod in (golden_attribution, fit_tires_closedloop, fit_tires_es):
        args = mod.parse_args(["--device", "cpu"])
        assert (args.golden, args.golden_snmpc) == (jax_tool.GOLDEN, jax_tool.GOLDEN_SNMPC)
