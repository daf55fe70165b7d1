"""One closed-loop step of the reference (see __init__): planner window ->
RTI solve under the controller's carried state -> the carried state's
advance -> re-initialisation of failed solves -> plant RK4 (sim_mode 0),
with the disturbed plant's RK4 and the estimation noise where the
configuration draws them -> moving-average estimator."""
from __future__ import annotations

import contextlib
import json
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import controllers
from benchmark.reference.engine import rti
from benchmark.reference.model import GG, data_paths, load_tires, load_vehicle, rk4, sim_ode

PLANT_SUBSTEPS = 4
MAX_WINDOW = 512
EST_BUF = 15
EST_WINDOWS = (1, 1, 4, 2, 2, 3, 4, 2)
CARRY_KEYS = ("X", "U", "warm", "x_sim", "x_est", "est_buf", "est_count", "pose", "extra",
              "gen_state")
# the draws of a step, in the port's order: (switch, kind, magnitudes) keys
# of a configuration's `sim` settings
DRAWS = (("simulate_disturbances", "disturbance_type_derivatives", "w_derivatives"),
         ("simulate_state_estimation", "disturbance_type_state_estimation", "w_state_estimation"))


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on (the control) or off (the reference) for matmuls on the card,
    restored on exit."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class Lap:
    """The reference lap from its raw file, with the segment times and their
    prefix sums computed in float64."""

    def __init__(self, path, dtype, device):
        with open(path, "r") as fh:
            raw = json.load(fh)
        pos = np.stack([np.asarray(raw["pos_x"]), np.asarray(raw["pos_y"])], axis=1)
        v = np.asarray(raw["ref_v"], dtype=np.float64)
        seg = np.linalg.norm(pos - np.roll(pos, 1, axis=0), axis=1) / v
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.pos, self.v = t(pos), t(v)
        self.yaw = t(np.asarray(raw["ref_yaw"], dtype=np.float64))
        self.cum_time = t(np.concatenate([[0.0], np.cumsum(seg)]))
        self.M = int(pos.shape[0])


def planner(lap: Lap, pose, Tp: float, n_out: int):
    """(pos (B, n_out, 2), yaw (B, n_out), v (B, n_out)): the window of
    Tp seconds ahead of the nearest lap point, resampled to n_out points."""
    M = lap.M
    dx = lap.pos[None, :, 0] - pose[:, 0:1]
    dy = lap.pos[None, :, 1] - pose[:, 1:2]
    d2 = dx * dx + dy * dy
    cc = torch.argmin(d2, dim=1)[:, None]
    P = lap.cum_time
    idx = torch.arange(P.shape[-1], device=P.device)[None, :]
    target = P[cc + 1] + Tp
    mask_u = (idx >= cc + 2) & (idx <= M) & (idx <= cc + MAX_WINDOW)
    count_u = torch.sum(mask_u & (P[None] <= target), dim=1)
    mask_w = (idx >= 1) & (idx <= MAX_WINDOW - 1 + cc + 1 - M)
    count_w = torch.sum(mask_w & (P[None] <= target - P[M]), dim=1)
    n_pts = 2 + count_u + count_w
    dt = d2.dtype
    steps = torch.full((n_out,), n_out - 1, dtype=dt, device=d2.device)
    base = torch.arange(n_out, dtype=dt, device=d2.device) / steps
    last = (n_pts - 1)[:, None]
    q = base[None, :] * last.to(dt)
    i0 = torch.minimum(torch.clamp(torch.floor(q).long(), min=0), last)
    i1 = torch.minimum(i0 + 1, last)
    frac = q - i0.to(dt)
    g0, g1 = torch.remainder(cc + i0, M), torch.remainder(cc + i1, M)
    w0, w1 = 1.0 - frac, frac
    pos = lap.pos[g0] * w0[..., None] + lap.pos[g1] * w1[..., None]
    v = lap.v[g0] * w0 + lap.v[g1] * w1
    y0, y1 = lap.yaw[g0], lap.yaw[g1]
    d = torch.remainder(y1 - y0 + math.pi, 2 * math.pi) - math.pi
    return pos, torch.remainder(y0 + frac * d, 2 * math.pi), v


class Window(NamedTuple):
    """The planner's window of N + 1 points, as the port's RefWindow."""
    pos: torch.Tensor   # (B, N+1, 2)
    yaw: torch.Tensor   # (B, N+1)
    v: torch.Tensor     # (B, N+1)


def draw(kind: str, mag, g, batch: int, dtype, device):
    """(batch, n) disturbances of `kind` with magnitudes `mag` (n,), as the
    port's sim/disturbances.py::draw_disturbance draws them: uniform inside
    the axis-aligned ellipsoid (radius ~ U^(1/n), direction a normalised
    gaussian), independent gaussians, or the constant bound. The numbers come
    from the generator `g` in the program's `dtype` on its `device`; the
    rest is computed in mag's dtype."""
    n = mag.shape[0]
    kw = dict(generator=g, dtype=dtype, device=device)
    cast = lambda t: t.to(mag.device, mag.dtype)
    if kind == "uniform":
        r = cast(torch.rand((batch, 1), **kw)) ** (1.0 / n)
        x = cast(torch.randn((batch, n), **kw))
        return mag * (x / torch.linalg.vector_norm(x, dim=1, keepdim=True) * r)
    if kind == "gaussian":
        return mag * cast(torch.randn((batch, n), **kw))
    if kind == "absolute":
        return mag.expand(batch, n).clone()
    raise ValueError(f"unknown disturbance type '{kind}'")


def estimate(buf, count, x):
    """Push x (B, 8) into the ring buffers; the mean over each state's window."""
    buf = torch.cat([buf[:, :, 1:], x[:, :, None]], dim=2)
    count = torch.clamp(count + 1, max=EST_BUF)
    w = torch.tensor(EST_WINDOWS, dtype=torch.long, device=x.device)
    ages = torch.arange(EST_BUF, device=x.device)
    eff = torch.minimum(w[None, :], count[:, None])
    take = ages[None, None, :] >= (EST_BUF - eff[:, :, None])
    return torch.sum(torch.where(take, buf, torch.zeros_like(buf)), dim=2) / eff.to(buf.dtype), \
        buf, count


class Reference:
    """The step of configuration `cfg` (a benchmark configuration file's
    `mpc` and `sim` settings, and `reference_controller`, the reference's
    controller where it is not `mpc.controller`) in `dtype` on `device`;
    `root` is the checkout that holds data/ and benchmark/."""

    def __init__(self, cfg: dict, root: str, dtype=torch.float64, device="cpu"):
        mpc, sim = cfg["mpc"], cfg["sim"]
        if int(sim["sim_mode"]) != 0 or sim.get("disturbance_playback", False):
            raise ValueError("the reference steps sim_mode 0, its disturbances drawn and not "
                             "played back")
        paths = data_paths(root, sim, mpc)
        self.dtype, self.device = dtype, torch.device(device)
        self.Ts, self.Tp = float(sim["Ts"]), float(sim["Tp"])
        self.N = int(self.Tp / float(sim["Ts_MPC"]))
        self.vp_sim, self.tp_sim = load_vehicle(paths["veh_sim"]), load_tires(paths["tire_sim"])
        vp = load_vehicle(paths["veh_pred"])
        self.vp = vp
        gg = GG(paths["gg"], dtype, self.device)
        self.ctrl = controllers.controller(cfg.get("reference_controller", mpc["controller"]),
                                           root)
        self.prob, self.fan = self.ctrl.build(mpc, vp, load_tires(paths["tire_pred"]), gg,
                                              self.N, float(sim["Ts_MPC"]), dtype, self.device)
        self.lap = Lap(paths["traj"], dtype, self.device)
        self.draws = tuple(
            (sim[kind], torch.as_tensor(sim[mag], dtype=dtype, device=self.device))
            if sim.get(on, False) and sim[kind] != "none" else None for on, kind, mag in DRAWS)

    def _stack(self, x_est):
        if self.fan is None:
            return x_est
        return (x_est[:, None, :] + self.fan).flatten(-2)

    def _cast(self, key, v):
        """A carried tensor in the reference's dtype on its device; integers
        stay integers, the generator state stays as the program's."""
        if key in ("warm", "extra"):
            return tuple(self._cast(None, t) for t in v)
        if key == "gen_state":
            return v
        if key == "est_count":
            return v.to(self.device, torch.int32)
        return v.to(self.device, self.dtype if v.is_floating_point() else v.dtype)

    def init_extra(self, x0):
        """The controller's carried state for the scenarios x0 (B, 8), or
        None for a controller that carries none."""
        return None if self.ctrl.init is None else self.ctrl.init(x0.to(self.device, self.dtype))

    def references(self, pose):
        """(window, yref (B, N, ny), yref_e (B, ny_e)) ahead of `pose` (B, 2)."""
        N = self.N
        pos, yaw, v = planner(self.lap, pose, self.Tp, N + 1)
        zeros = torch.zeros((pose.shape[0], N, 2), dtype=self.dtype, device=self.device)
        yref = torch.cat([pos[:, :N], yaw[:, :N, None], v[:, :N, None], zeros], dim=2)
        yref_e = torch.cat([pos[:, N], yaw[:, N, None], v[:, N, None]], dim=1)
        return Window(pos, yaw, v), yref, yref_e

    def _disturbances(self, raw: dict, B: int):
        """(w_deriv, w_se), each (B, 7) or None, drawn from the generator
        state `gen_state` of the carry `raw` on the program's device and in
        its dtype (those of raw's x_sim)."""
        if not any(self.draws):
            return None, None
        if "gen_state" not in raw:
            raise ValueError("the configuration draws disturbances and the carry holds no "
                             "generator state")
        g = torch.Generator(device=raw["x_sim"].device)
        g.set_state(raw["gen_state"])
        return tuple(None if d is None else draw(d[0], d[1], g, B, raw["x_sim"].dtype,
                                                 raw["x_sim"].device) for d in self.draws)

    def step(self, raw: dict) -> dict:
        """One step from the carry `raw` (CARRY_KEYS, any dtype and device).
        Returns the new carry's tensors, the step's u0 (B, 2) and status, and
        the disturbances drawn (w_deriv, w_se; None where not drawn)."""
        c = {k: self._cast(k, v) for k, v in raw.items() if k in CARRY_KEYS}
        extra = c.get("extra")
        if extra is not None and self.ctrl.advance is None:
            raise ValueError("the program carries controller state and the reference's "
                             "controller has no `advance` hook")
        B = c["x_sim"].shape[0]
        window, yref, yref_e = self.references(c["pose"])
        p = self.prob if extra is None or self.ctrl.problem is None else \
            self.ctrl.problem(self.prob, extra)
        X, U, warm, status, A = rti(p, c["X"], c["U"], c["warm"], self._stack(c["x_est"]), yref,
                                    yref_e)
        if extra is not None:
            extra = self.ctrl.advance(extra, c["x_est"], window, X, U, A, status)
        u0 = torch.stack([U[:, 0, 0], torch.clamp(U[:, 0, 1], self.vp.delta_f_dot_min,
                                                  self.vp.delta_f_dot_max)], dim=1)
        a_in = X[:, 1, 7]
        failed = (status != 0)
        pick = lambda a, b: torch.where(failed.view((B,) + (1,) * (a.dim() - 1)), a, b)
        X0 = self._stack(c["x_est"])[:, None, :].expand_as(X)
        X_c, U_c = pick(X0, X), pick(torch.zeros_like(U), U)
        warm_c = tuple(pick(torch.ones_like(w), w) for w in warm)
        u_plant = torch.stack([a_in, u0[:, 1]], dim=1)
        f = lambda x, u: sim_ode(x, u, self.vp_sim, self.tp_sim)
        x_sim = rk4(f, c["x_sim"], u_plant, self.Ts, PLANT_SUBSTEPS)
        w_deriv, w_se = self._disturbances(raw, B)
        x_dist = x_sim if w_deriv is None else \
            rk4(lambda x, u: f(x, u) + w_deriv, c["x_sim"], u_plant, self.Ts, PLANT_SUBSTEPS)
        if w_se is not None:
            x_dist = x_dist + w_se
        x_est, buf, count = estimate(c["est_buf"], c["est_count"],
                                     torch.cat([x_dist, a_in[:, None]], dim=1))
        out = dict(u0=u0, status=status, X=X_c, U=U_c, warm=warm_c, x_sim=x_sim, x_est=x_est,
                   est_buf=buf, est_count=count, pose=x_sim[:, :2], w_deriv=w_deriv, w_se=w_se)
        if extra is not None:
            out["extra"] = tuple(extra)
        return out
