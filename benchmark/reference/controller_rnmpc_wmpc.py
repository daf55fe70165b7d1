"""R2NMPC under the weights-varying policy (WMPC) for the reference (see
__init__): TUM-CONTROL's Reduced Robustified NMPC (zero-order constraint
tightening from a propagated state covariance, Reduced_Robustified_NMPC_
class.py) with `enable_WMPC`: every `weights_update_period` solves the PPO
policy of SafeRL_WMPC picks a row of the Pareto table F.csv from an
observation of the deviations and the reference preview, and that row
becomes the cost weights and the slack penalties.

The OCP is the nominal one (controllers.nominal). The carried state, in the
order of the port's WMPCExtra with its R2NMPC part last, is

    steps (B,) int32, obs (B, 22), action (B,) int32, W (B, 6), We (B, 4),
    L1 (B,), L2 (B,), corr_steer (B, N+1), corr_acc (B, N+1, nh)

- problem: the bounds tightened by the carried back-offs at nodes 1..N-1
  (con_lb + [0, corr_steer], con_ub - [corr_acc, corr_steer]); node 0 and the
  terminal node keep their bounds. The weights W, We and the soft rows'
  z1 / z2 (rows with z1 > 0) are those of the carried `action`: F.csv's row
  once an update has happened (the carried observation is not zero), the
  build-time weights before. The carried W, We, L1, L2 are not used, so a
  program whose weights do not follow its action is off at every sampled
  step.
- advance: the back-offs from Sigma_0 and Sigma_{k+1} = A_k Sigma_k A_k' +
  B W_disc B' over the stages below the uncertainty propagation horizon
  (UPH), A_k `engine.rti`'s last linearization, W_disc = Ts_MPC diag(stds
  of [yaw, vlong, vlat, yawrate])^2; the acceleration rows' back-off
  sqrt(g' Sigma_k g) with g the gradient of the row at the new X (reverse-
  mode autograd), the steering bound's sqrt(Sigma_k[6, 6]); node 0 none,
  the nodes from UPH on the last one; updated only where the solve's status
  is 0. Then, where `steps` has reached the period, the observation, the
  policy's argmax, F.csv's row, and `steps` back to 1; elsewhere `steps`
  counts on and the observation stays.

Departures from the published description (the first two, to make a fault
show at a sampled step and a float32 program comparable with a float64
reference) and readings of it:

- the returned action is argmax(policy(observation)) of the returned
  observation at every step (0 while it is zero), not the carried action
  passed through: a program whose action does not follow its observation
  is off at every sampled step, not only at the one step in 20 that updates;
- a float of the returned state (the weights, the back-offs) whose new value
  lies within ROUNDING (1e-6, relative) of the carried one keeps the carried
  one. The comparison scales a gap by the entry's change across the step,
  floored at 1e-12, and an entry that a step leaves as it was (the steering
  back-off, which the recurrence never moves: the steering angle has no
  disturbance and its row of A is a unit row; a weight the update leaves)
  would read the program's float32 rounding over that floor. An entry that
  the program changes where it should not, or leaves where it should change,
  is still off;
- Sigma_0 = (0.5 diag([1e-5, 1e-5, yaw, vlong, vlat, yawrate, 1e-5, 1e-5]
  stds))^2: coeff_Sigma 0.5, and a floor of 1e-5 where the class's stds
  give none (the JAX package's reading of it);
- the observation (RL_WMPC/observation.py): [lat_dev, vel_dev] of the
  estimate against the window's first point, 10 of the window's 39
  velocities and 10 of its 29 yaw rates (indices linspace(0, n - 1, 10)
  truncated), the rates diff(unwrap(yaw)) / Ts smoothed by a 10-point moving
  average ('valid'), min-max normalised by [-3, 3] m, [-5, 5] m/s, [0, 39]
  m/s, [-3.2, 3.2] rad/s, not clipped. Ts is the simulator's 0.02 s
  although the window's points are Ts_MPC = 0.08 s apart, so the rates are
  4x the true ones: the trained policies were trained on that, so it is kept;
- the policy (SB3 MlpPolicy: tanh layers 128, 256, 128, the action head) in
  float64 from the converted checkpoint `policy_weights.npz`, the
  deterministic action its argmax; F.csv's row with no 0.01 factor (the
  trained policies and the table assume none), as W = [p0, p0, p1, p2, p3,
  p4], We = [p0, p0, p1, p2], L1 = p5, L2 = p6.

It reads the checkpoint of `mpc.WMPC_model` and data/F.csv, and implements
what new_BO_F's rl_config.yaml sets: one observation of 10 points (no
stack) over F.csv. Each load of this file (controllers.controller) is its own module, so the
settings `build` keeps in `_S` belong to one Reference.
"""
from __future__ import annotations

import math
import os
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference import controllers
from benchmark.reference.model import acc_constraints

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OBS_TS = 0.02         # the simulator's period (sim_main_params.yaml), the rates' divisor
N_POINTS = 10         # obs_n_anticipation_points
SMOOTH = 10           # the yaw rates' moving average
OBS_LO = [-3.0, -5.0] + [0.0] * N_POINTS + [-3.2] * N_POINTS
OBS_HI = [3.0, 5.0] + [39.0] * N_POINTS + [3.2] * N_POINTS
SIGMA_FLOOR = 1e-5
COEFF_SIGMA = 0.5
STEER = 6             # delta_f in the 8-state model
DISTURBED = (2, 3, 4, 5)   # yaw, vlong, vlat, yawrate
POLICY_LAYERS = (0, 2, 4)
ROUNDING = 1e-6       # relative: a few roundings of float32 (2^-23 each), far below a change

_S = SimpleNamespace()


def _model_dir(mpc: dict) -> str:
    d = mpc["WMPC_model"]
    return d if os.path.isabs(d) else os.path.join(ROOT, d)


def build(mpc, vp, tp, gg, N, dt, dtype, device):
    if not mpc.get("enable_WMPC", False):
        raise ValueError("controller_rnmpc_wmpc is R2NMPC with enable_WMPC")
    prob, fan = controllers.nominal(mpc, vp, tp, gg, N, dt, dtype, device)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    with np.load(os.path.join(_model_dir(mpc), "policy_weights.npz")) as d:
        layers = [(t(d[f"mlp_extractor__policy_net__{i}__weight"]),
                   t(d[f"mlp_extractor__policy_net__{i}__bias"])) for i in POLICY_LAYERS]
        head = (t(d["action_net__weight"]), t(d["action_net__bias"]))
    table = t(np.loadtxt(os.path.join(ROOT, "data", "F.csv"), delimiter=","))
    if head[0].shape[0] != table.shape[0]:
        raise ValueError(f"the policy has {head[0].shape[0]} actions and F.csv "
                         f"{table.shape[0]} rows")
    stds = np.asarray(mpc["stds"], dtype=np.float64)
    sig0 = np.full(8, SIGMA_FLOOR)
    sig0[list(DISTURBED)] = stds[list(DISTURBED)]
    Bsel = np.zeros((8, len(DISTURBED)))
    Bsel[list(DISTURBED), range(len(DISTURBED))] = 1.0
    W_disc = dt * np.diag(stds[list(DISTURBED)]) ** 2
    uph = int(mpc["uncertainty_propagation_horizon"])
    if not 2 <= uph <= N:
        raise ValueError(f"the reference tightens nodes 1..UPH-1 from UPH >= 2, got {uph}")
    mask = np.zeros(N + 1)
    mask[1:N] = 1.0
    shape = mpc["combined_acc_limits"]
    _S.__dict__.update(
        N=N, uph=uph, period=int(mpc["weights_update_period"]), layers=layers, head=head,
        table=table, Sigma0=t(np.diag(COEFF_SIGMA * sig0) ** 2), BWB=t(Bsel @ W_disc @ Bsel.T),
        mask=t(mask), W=prob.W, We=prob.We, L1=t(mpc["L1_pen"]), L2=t(mpc["L2_pen"]),
        lo=t(OBS_LO), span=t(np.asarray(OBS_HI) - np.asarray(OBS_LO)),
        h=lambda x: acc_constraints(x[..., 3], x[..., 7], x[..., 3] * x[..., 5], gg, vp.acc_min,
                                    shape))
    return prob, fan


def init(x0):
    B = x0.shape[0]
    zeros_i = torch.zeros((B,), dtype=torch.int32, device=x0.device)
    full = lambda v: v.to(x0.dtype).expand(B).clone()
    nh = _S.h(x0[:1]).shape[-1]
    return (zeros_i, x0.new_zeros((B, len(OBS_LO))), zeros_i.clone(),
            _S.W.expand(B, -1).clone(), _S.We.expand(B, -1).clone(), full(_S.L1), full(_S.L2),
            x0.new_zeros((B, _S.N + 1)), x0.new_zeros((B, _S.N + 1, nh)))


def weights(action, obs):
    """(W (B, 6), We (B, 4), L1 (B,), L2 (B,)) of the actions: F.csv's rows
    where the observation is not zero (an update has happened), the
    build-time weights elsewhere."""
    p = _S.table[action.long()]
    updated = (obs != 0).any(dim=-1)
    We = torch.stack([p[:, 0], p[:, 0], p[:, 1], p[:, 2]], dim=1)
    W = torch.cat([We, p[:, 3:5]], dim=1)
    pick = lambda row, build: torch.where(updated.view((-1,) + (1,) * (row.dim() - 1)), row,
                                          build.to(row.dtype))
    return pick(W, _S.W), pick(We, _S.We), pick(p[:, 5], _S.L1), pick(p[:, 6], _S.L2)


def logits(obs):
    h = obs
    for w, b in _S.layers:
        h = torch.tanh(h @ w.T + b)
    return h @ _S.head[0].T + _S.head[1]


def policy_action(obs):
    """argmax of the policy's logits (int32), 0 where the observation is zero."""
    a = torch.argmax(logits(obs), dim=-1).to(torch.int32)
    return torch.where((obs != 0).any(dim=-1), a, torch.zeros_like(a))


def problem(p, extra):
    _, obs, action, *_, corr_steer, corr_acc = extra
    W, We, L1, L2 = weights(action, obs)
    steer = _S.mask * corr_steer
    con_lb = p.con_lb + torch.cat([torch.zeros_like(corr_acc), steer[..., None]], dim=-1)
    con_ub = p.con_ub - torch.cat([_S.mask[:, None] * corr_acc, steer[..., None]], dim=-1)
    soft_c, soft_u = p.con_z1 > 0, p.u_z1 > 0
    L1, L2 = L1[:, None, None], L2[:, None, None]
    return p._replace(W=W, We=We, con_lb=con_lb, con_ub=con_ub,
                      con_z1=torch.where(soft_c, L1, p.con_z1),
                      con_z2=torch.where(soft_c, L2, p.con_z2),
                      u_z1=torch.where(soft_u, L1, p.u_z1), u_z2=torch.where(soft_u, L2, p.u_z2))


def _gradients(X):
    """(B, n, nh, 8): each acceleration row's gradient at the nodes X (B, n, 8)."""
    with torch.enable_grad():
        x = X.detach().requires_grad_(True)
        h = _S.h(x)
        return torch.stack([torch.autograd.grad(h[..., j].sum(), x, retain_graph=True)[0]
                            for j in range(h.shape[-1])], dim=-2)


def back_offs(X, A):
    """(corr_steer (B, N+1), corr_acc (B, N+1, nh)) from the new X (B, N+1, 8)
    and the linearization A (B, N, 8, 8)."""
    B, uph, N = X.shape[0], _S.uph, _S.N
    g = _gradients(X[:, 1:uph])
    Sigma = _S.Sigma0.expand(B, 8, 8)
    cs, ca = [], []
    for k in range(1, uph):
        Sigma = A[:, k - 1] @ Sigma @ A[:, k - 1].transpose(1, 2) + _S.BWB
        gk = g[:, k - 1]
        ca.append(torch.sqrt(torch.clamp(((gk @ Sigma) * gk).sum(dim=-1), min=0.0)))
        cs.append(torch.sqrt(torch.clamp(Sigma[:, STEER, STEER], min=0.0)))
    cs, ca = torch.stack(cs, dim=1), torch.stack(ca, dim=1)
    tail = N + 1 - uph
    corr_steer = torch.cat([X.new_zeros((B, 1)), cs, cs[:, -1:].expand(B, tail)], dim=1)
    corr_acc = torch.cat([X.new_zeros((B, 1, ca.shape[-1])), ca,
                          ca[:, -1:].expand(B, tail, ca.shape[-1])], dim=1)
    return corr_steer, corr_acc


def unwrap(p):
    """numpy's unwrap along the last axis (period 2 pi)."""
    d = torch.diff(p, dim=-1)
    jumps = torch.where(d.abs() > math.pi, -2.0 * math.pi * torch.round(d / (2.0 * math.pi)),
                        torch.zeros_like(d))
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(jumps, dim=-1)], dim=-1)


def observation(x0, window):
    """(B, 22) normalised observations of the estimates x0 (B, 8) against the
    planner's window."""
    yaw = x0[:, 2]
    dx = window.pos[:, 0, 0] - x0[:, 0]
    dy = window.pos[:, 0, 1] - x0[:, 1]
    lat_dev = -torch.sin(yaw) * dx + torch.cos(yaw) * dy
    vel_dev = x0[:, 3] - window.v[:, 0]
    rate = torch.diff(unwrap(window.yaw), dim=-1) / OBS_TS
    c = torch.cumsum(torch.nn.functional.pad(rate, (1, 0)), dim=-1)
    smooth = (c[:, SMOOTH:] - c[:, :-SMOOTH]) / SMOOTH
    take = lambda a: a[:, np.linspace(0, a.shape[1] - 1, N_POINTS).astype(int)]
    raw = torch.cat([lat_dev[:, None], vel_dev[:, None], take(window.v), take(smooth)], dim=1)
    return (raw - _S.lo) / _S.span


def settled(new, carried):
    """`new`, with the carried value where new lies within ROUNDING of it."""
    return torch.where((new - carried).abs() <= ROUNDING * new.abs(), carried, new)


def advance(extra, x0, window, X, U, A, status):
    steps, obs, action, W, We, L1, L2, corr_steer, corr_acc = extra
    ok = (status == 0)
    cs, ca = back_offs(X, A)
    cs = torch.where(ok[:, None], cs, corr_steer)
    ca = torch.where(ok[:, None, None], ca, corr_acc)
    update = steps >= _S.period
    obs_new = torch.where(update[:, None], observation(x0, window), obs)
    action_new = policy_action(obs_new)
    kept = tuple(settled(n, c) for n, c in zip(weights(action_new, obs_new), (W, We, L1, L2)))
    steps_new = torch.where(update, torch.ones_like(steps), steps + 1)
    return (steps_new, obs_new, action_new, *kept, settled(cs, corr_steer),
            settled(ca, corr_acc))
