"""The port's full-ZoRo augmented model (controllers/robust_utils.py) against
the JAX package's, on the CPU in float64: the packed symmetric layout,
`aug_ode` and an 8-substep `make_aug_step` at tests/test_controllers.py's
state, W and Sigma_0 (and two states about it, as a batch), to 1e-10
relative to each output's max, and the UPH freeze.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu import config as jcm
from tum_control_tpu.config import (
    SimConfig as JSim, load_tire_params as j_tp, load_vehicle_params as j_vp,
)
from tum_control_tpu.controllers import robust_utils as jru
from tum_control_tpu.models.vehicle_stm import pred_ode as j_pred_ode
from tum_control_tpu_torch.config import (
    DEFAULT_CONFIG_PATH, SimConfig, load_tire_params, load_vehicle_params,
)
from tum_control_tpu_torch.controllers import robust_utils as ru
from tum_control_tpu_torch.models.vehicle_stm import pred_ode

TOL = 1e-10
F64 = torch.float64
DT = 0.08
W = np.diag([0.01, 0.8, 0.35, 0.035]) ** 2
X0 = np.array([0.0, 0.0, 0.2, 18.0, 0.05, 0.02, 0.01, 0.3])
SIGMA0 = np.diag([1e-5, 1e-5, 1e-4, 0.4, 0.17, 0.017, 1e-5, 1e-5]) ** 2
U = np.array([0.2, 0.01])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    cfg = SimConfig()
    vp = load_vehicle_params(DEFAULT_CONFIG_PATH, cfg.veh_params_file_MPC)
    tp = load_tire_params(DEFAULT_CONFIG_PATH, cfg.tire_params_file_MPC)
    jcfg = JSim()
    jvp = j_vp(jcm.DEFAULT_CONFIG_PATH, jcfg.veh_params_file_MPC)
    jtp = j_tp(jcm.DEFAULT_CONFIG_PATH, jcfg.tire_params_file_MPC)
    return (lambda x, u: pred_ode(x, u, vp, tp)), (lambda x, u: j_pred_ode(x, u, jvp, jtp))


def _batch():
    """X0 and two states about it, each with Sigma_0 scaled, and inputs."""
    rng = np.random.default_rng(0)
    x = X0 + np.stack([np.zeros(8), *(rng.normal(size=(2, 8)) * [0.5, 0.5, 0.05, 2, 0.05, 0.02,
                                                                   0.01, 0.3])])
    sig = SIGMA0[None] * np.array([1.0, 2.0, 0.5])[:, None, None]
    u = U + np.stack([np.zeros(2), *(rng.normal(size=(2, 2)) * [0.3, 0.02])])
    return x, sig, u


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * np.abs(b).max())


def test_packed_layout_round_trip():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(3, 8, 8))
    M = M + M.transpose(0, 2, 1)
    v = ru.sym_mat2vec(torch.tensor(M))
    assert v.shape == (3, ru.NSIG) and ru.NSIG == 36
    np.testing.assert_array_equal(ru.vec2sym_mat(v).numpy(), M)
    # the JAX package's element order
    for b in range(3):
        np.testing.assert_array_equal(v[b].numpy(), np.asarray(jru.sym_mat2vec(jnp.asarray(M[b]))))
    np.testing.assert_array_equal(ru.B_SEL, jru.B_SEL)


def test_aug_ode_and_step_match_jax():
    f, jf = _models()
    x, sig, u = _batch()
    xa = ru.aug_initial_state(torch.tensor(x), torch.tensor(sig))
    assert xa.shape == (3, 8 + ru.NSIG)
    jxa = jax.vmap(jru.aug_initial_state)(jnp.asarray(x), jnp.asarray(sig))
    np.testing.assert_array_equal(xa.numpy(), np.asarray(jxa))

    dot = ru.aug_ode(f, xa, torch.tensor(u), W)
    jdot = jax.vmap(lambda a, b: jru.aug_ode(jf, a, b, jnp.asarray(W)))(jxa, jnp.asarray(u))
    _close(dot[:, :8].numpy(), jdot[:, :8])
    _close(dot[:, 8:].numpy(), jdot[:, 8:])

    step = ru.make_aug_step(f, W, DT, substeps=8)
    jstep = jru.make_aug_step(jf, jnp.asarray(W), DT, substeps=8)
    xa1 = step(xa, torch.tensor(u), 0.0)
    jxa1 = jax.vmap(lambda a, b: jstep(a, b, 0.0))(jxa, jnp.asarray(u))
    _close(xa1[:, :8].numpy(), jxa1[:, :8])
    _close(xa1[:, 8:].numpy(), jxa1[:, 8:])
    Sigma1 = ru.vec2sym_mat(xa1[:, 8:]).numpy()
    assert (np.linalg.eigvalsh(Sigma1) > -1e-12).all()
    assert Sigma1[0, 3, 3] > SIGMA0[3, 3]  # vlong variance grows under W


def test_uph_freeze():
    """Stop flag 1 leaves Sigma unchanged (as a float and per scenario) while
    the nominal state moves as the plain model's RK4."""
    from tum_control_tpu_torch.models.integrators import rk4_multistep

    f, _ = _models()
    x, sig, u = _batch()
    xa = ru.aug_initial_state(torch.tensor(x), torch.tensor(sig))
    ut = torch.tensor(u)
    step = ru.make_aug_step(f, W, DT, substeps=8)
    frozen = step(xa, ut, 1.0)
    np.testing.assert_array_equal(frozen[:, 8:].numpy(), xa[:, 8:].numpy())
    x1 = rk4_multistep(f, torch.tensor(x), ut, DT, 8)
    np.testing.assert_allclose(frozen[:, :8].numpy(), x1.numpy(), rtol=0, atol=1e-12)
    mixed = step(xa, ut, torch.tensor([1.0, 0.0, 1.0], dtype=F64))
    np.testing.assert_array_equal(mixed[[0, 2], 8:].numpy(), xa[[0, 2], 8:].numpy())
    np.testing.assert_array_equal(mixed[1].numpy(), step(xa, ut, 0.0)[1].numpy())
