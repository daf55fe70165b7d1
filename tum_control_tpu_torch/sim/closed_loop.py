"""Closed-loop simulation over a batch of scenarios (port of
tum_control_tpu/sim/closed_loop.py).

One `step` performs, for B scenarios at once:

    planner window extraction -> NMPC RTI solve -> re-initialization of
    failed solves -> plant integration (+ derivative disturbances +
    measurement noise) -> moving-average state estimation -> log slice

  * sim_mode 0 (CiL): separate 7-state plant stepped at Ts with input
    [a, steering_rate], a = the predicted acceleration state at node 1,
  * sim_mode 1 (MPC-in-loop): the plant is the MPC's node-1 prediction.

`run` / `run_from` loop over steps in Python (the JAX package's `lax.scan`)
and return the SimLog fields stacked as (B, n_steps, ...). A step may plan
every scenario on a lap of its own (`traj`), and `select_carry` latches or
resets scenarios one by one (the RL env's auto-reset, the BO objective's
done / crash freeze).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tum_control_tpu_torch.models.integrators import rk4_multistep
from tum_control_tpu_torch.ops.kernels.plant import Plant
from tum_control_tpu_torch.sim.disturbances import TYPE_NONE, DisturbanceConfig, draw_disturbance
from tum_control_tpu_torch.sim.estimator import estimate, init_estimator
from tum_control_tpu_torch.track.planner import planner_emulator
from tum_control_tpu_torch.track.trajectory import RefTrajectory
from tum_control_tpu_torch.utils.trace import span

PLANT_SUBSTEPS = 4  # CasADi 'rk' number_of_finite_elements


class SimCarry(NamedTuple):
    ctrl_state: object        # controller warm-start state (RTIState)
    extra: object             # controller-specific carried state (WMPC, R2NMPC corrections;
    #                           None for a controller without `init_extra`)
    x_sim: torch.Tensor       # (B, 7) true plant state
    x_dist: torch.Tensor      # (B, 7) disturbed/measured plant state
    x_est: torch.Tensor       # (B, 8) estimated MPC state (controller input)
    est_state: object         # EstimatorState
    pose: torch.Tensor        # (B, 2) planner query position
    key: torch.Generator      # source of the disturbance draws


class SimLog(NamedTuple):
    """Per-step log slices; names mirror the reference Logger. Each field is
    (B, ...) per step and (B, n_steps, ...) from run / run_from."""

    MPC_SimX: torch.Tensor        # (8,) x_next_MPC (node-1 prediction)
    CiLX: torch.Tensor            # (7,) true plant next state
    DisturbedX: torch.Tensor      # (7,) disturbed next state
    simU: torch.Tensor            # (2,) applied [jerk, steering_rate]
    simREF: torch.Tensor          # (4,) ref pos_x/pos_y/yaw/v at window head
    simSolverDebug: torch.Tensor  # (5,) [cost, time, sqp_iter, qp_iter, status]
    lat_dev: torch.Tensor         # ()
    vel_dev: torch.Tensor         # ()
    dist_deriv: torch.Tensor      # (7,) applied derivative disturbance
    dist_se: torch.Tensor         # (7,) applied measurement noise
    wmpc_action: torch.Tensor     # () int32 active WMPC weight-set index (-1: no WMPC)


def select_carry(mask, a, b):
    """Per scenario, `a` where mask (B,) is True, else `b`: torch.where over
    every tensor of two SimCarry (or any NamedTuple / None tree of (B, ...)
    tensors), the controller's RTIState, its IPM warm start and `extra`
    included. The disturbance generator is not a tensor and is shared by the
    batch: the result keeps `a`'s. A reset scenario therefore continues the
    batch's draw stream instead of restarting one of its own; the RL env and
    the BO objective draw nothing from it (they run without disturbances)."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    if isinstance(a, tuple):
        return type(a)(*(select_carry(mask, x, y) for x, y in zip(a, b)))
    return a


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class ClosedLoopSim:
    def __init__(self, controller, traj: RefTrajectory, sim_mode: int, Ts: float, Tp: float,
                 N: int, vp_sim, tp_sim, dist_deriv: DisturbanceConfig,
                 dist_se: DisturbanceConfig, playback: bool = False):
        if sim_mode not in (0, 1):
            raise ValueError(f"sim_mode must be 0 or 1, got {sim_mode}")
        self.playback = playback
        self.controller = controller
        self.traj = traj
        self.sim_mode = sim_mode
        self.Ts, self.Tp, self.N = Ts, Tp, N
        self.vp_sim, self.tp_sim = vp_sim, tp_sim
        self.dist_deriv, self.dist_se = dist_deriv, dist_se

    @property
    def tp_sim(self):
        return self.plant.tp

    @tp_sim.setter
    def tp_sim(self, tp):
        """New plant tires rebuild the plant's constants and tire table."""
        self.plant = Plant(self.vp_sim, tp, self.Ts, PLANT_SUBSTEPS)

    # ------------------------------------------------------------------
    def set_tires(self, tp):
        """Replace the tires of the plant and the controller: floats, or
        tensors, 0-d or (B,) with one set per scenario (a population of tire
        parameters as one batch; tools/fit_tires_es.py)."""
        self.tp_sim = tp
        self.controller.set_tires(tp)

    def integrate_plant(self, x, u, w=None):
        """The plant over one step Ts from x (B, 7) under u (B, 2) = [a,
        steering rate], disturbed by w (B, 7) where given: one call of
        `rk4_multistep`, one kernel launch on the card."""
        return rk4_multistep(self.plant.ode(w), x, u, self.Ts, PLANT_SUBSTEPS)

    def init_carry(self, x0_mpc, x0_sim, key=None) -> SimCarry:
        """x0_mpc (B, 8), x0_sim (B, 7); `key` a torch.Generator or an int seed."""
        if x0_mpc.dim() != 2 or x0_sim.dim() != 2:
            raise ValueError("init_carry takes batched initial states (B, 8) and (B, 7)")
        if not isinstance(key, torch.Generator):
            key = make_generator(0 if key is None else key, x0_mpc.device)
        init_extra = getattr(self.controller, "init_extra", None)
        return SimCarry(
            ctrl_state=self.controller.init_state(x0_mpc),
            extra=None if init_extra is None else init_extra(x0_mpc),
            x_sim=x0_sim,
            x_dist=x0_sim,
            x_est=x0_mpc,
            est_state=init_estimator(x0_mpc.shape[0], 8, x0_mpc.dtype, x0_mpc.device),
            pose=x0_mpc[:, :2],
            key=key,
        )

    # ------------------------------------------------------------------
    def step(self, carry: SimCarry, w_deriv_play, w_se_play, traj=None, mods=None) -> tuple:
        """One closed-loop step for every scenario; the playback inputs are
        (B, 7) recorded disturbances, used when the sim was built with
        playback=True. `traj` overrides the sim's lap, e.g. with one lap per
        scenario (track/trajectory.py::select_laps); `mods` (a QPMods)
        overrides QP weights and bounds for this solve. The step is the span
        `tc.step` (utils/trace.py), its layers the spans inside it."""
        with span("tc.step"):
            return self._step(carry, w_deriv_play, w_se_play, traj, mods)

    def _step(self, carry: SimCarry, w_deriv_play, w_se_play, traj, mods) -> tuple:
        B = carry.x_sim.shape[0]
        traj = self.traj if traj is None else traj
        with span("tc.planner"):
            _, window = planner_emulator(traj, carry.pose, self.Tp, self.N + 1)
        if carry.extra is not None:
            out, ctrl_state, extra = self.controller.solve_with_extra(
                carry.ctrl_state, carry.extra, carry.x_est, window, mods=mods)
        else:
            out, ctrl_state = self.controller.solve(carry.ctrl_state, carry.x_est, window,
                                                    mods=mods)
            extra = None
        status = out.stats[:, 4]

        # solver failure -> re-initialize that scenario's solver memory at
        # the current estimate; `extra` stays as the controller returned it
        failed = status != 0
        reinit = self.controller.init_state(carry.x_est)
        pick = lambda a, b: torch.where(failed.view((B,) + (1,) * (a.dim() - 1)), a, b)
        ctrl_state = type(ctrl_state)(
            X=pick(reinit.X, ctrl_state.X),
            U=pick(reinit.U, ctrl_state.U),
            warm=type(ctrl_state.warm)(*(pick(a, b) for a, b in zip(reinit.warm, ctrl_state.warm))),
        )

        a_in = out.pred_X[:, 1, 7]
        u_plant = torch.stack([a_in, out.u0[:, 1]], dim=1)
        zeros7 = torch.zeros_like(carry.x_sim)
        if self.sim_mode == 1:
            x_next8 = out.pred_X[:, 1]
            x_sim_next = x_next8[:, :7]
            x_dist_next = x_sim_next
            w_deriv = w_se = zeros7
            pose_next = x_next8[:, :2]
        else:
            with span("tc.plant"):
                x_sim_next = self.integrate_plant(carry.x_sim, u_plant)
            if self.dist_deriv.kind != TYPE_NONE:
                w_deriv = (w_deriv_play if self.playback
                           else draw_disturbance(self.dist_deriv, carry.key, B))
                with span("tc.plant"):
                    x_dist_next = self.integrate_plant(carry.x_sim, u_plant, w_deriv)
            else:
                w_deriv = zeros7
                x_dist_next = x_sim_next
            if self.dist_se.kind != TYPE_NONE:
                w_se = w_se_play if self.playback else draw_disturbance(self.dist_se, carry.key, B)
                x_dist_next = x_dist_next + w_se
            else:
                w_se = zeros7
            x_next8 = torch.cat([x_dist_next, a_in[:, None]], dim=1)
            pose_next = x_sim_next[:, :2]

        with span("tc.estimator"):
            x_est_next, est_state = estimate(carry.est_state, x_next8)

        # metrics at the *current* state vs the window head
        yaw = carry.x_sim[:, 2]
        dx = window.pos[:, 0, 0] - carry.x_sim[:, 0]
        dy = window.pos[:, 0, 1] - carry.x_sim[:, 1]
        log = SimLog(
            MPC_SimX=out.pred_X[:, 1] if self.sim_mode == 0 else x_next8,
            CiLX=x_sim_next,
            DisturbedX=x_dist_next,
            simU=out.u0,
            simREF=torch.cat([window.pos[:, 0], window.yaw[:, 0:1], window.v[:, 0:1]], dim=1),
            simSolverDebug=out.stats,
            lat_dev=torch.sin(-yaw) * dx + torch.cos(-yaw) * dy,
            vel_dev=carry.x_sim[:, 3] - window.v[:, 0],
            dist_deriv=w_deriv,
            dist_se=w_se,
            wmpc_action=(extra.action if hasattr(extra, "action")
                         else torch.full((B,), -1, dtype=torch.int32, device=yaw.device)),
        )
        new_carry = SimCarry(
            ctrl_state=ctrl_state, extra=extra, x_sim=x_sim_next, x_dist=x_dist_next,
            x_est=x_est_next, est_state=est_state, pose=pose_next, key=carry.key,
        )
        return new_carry, log

    # ------------------------------------------------------------------
    def run(self, x0_mpc, x0_sim, n_steps: int, key=None, playback=None):
        """Run the closed loop; returns (final_carry, SimLog of (B, n_steps, ...))."""
        return self.run_from(self.init_carry(x0_mpc, x0_sim, key), n_steps, playback=playback)

    def run_from(self, carry: SimCarry, n_steps: int, playback=None):
        """Continue the closed loop from an existing carry. `playback`:
        (w_d, w_s) recorded disturbances of shape (B, n_steps, 7)."""
        logs = []
        zeros = torch.zeros_like(carry.x_sim)
        for i in range(n_steps):
            w_d, w_s = (zeros, zeros) if playback is None else (playback[0][:, i], playback[1][:, i])
            carry, log = self.step(carry, w_d, w_s)
            logs.append(log)
        stacked = SimLog(*(torch.stack(f, dim=1) for f in zip(*logs)))
        return carry, stacked
