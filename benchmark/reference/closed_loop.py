"""One closed-loop step of the reference (see __init__): planner window ->
RTI solve -> re-initialisation of failed solves -> plant RK4 (sim_mode 0,
undisturbed) -> moving-average estimator."""
from __future__ import annotations

import contextlib
import json
import math

import numpy as np
import torch

from benchmark.reference import controllers
from benchmark.reference.engine import rti
from benchmark.reference.model import GG, data_paths, load_tires, load_vehicle, rk4, sim_ode

PLANT_SUBSTEPS = 4
MAX_WINDOW = 512
EST_BUF = 15
EST_WINDOWS = (1, 1, 4, 2, 2, 3, 4, 2)
CARRY_KEYS = ("X", "U", "warm", "x_sim", "x_est", "est_buf", "est_count", "pose")


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
    `mpc` and `sim` settings) in `dtype` on `device`; `root` is the
    checkout that holds data/."""

    def __init__(self, cfg: dict, root: str, dtype=torch.float64, device="cpu"):
        mpc, sim = cfg["mpc"], cfg["sim"]
        paths = data_paths(root, sim, mpc)
        self.dtype, self.device = dtype, torch.device(device)
        self.Ts, self.Tp = float(sim["Ts"]), float(sim["Tp"])
        self.N = int(self.Tp / float(sim["Ts_MPC"]))
        self.vp_sim, self.tp_sim = load_vehicle(paths["veh_sim"]), load_tires(paths["tire_sim"])
        vp = load_vehicle(paths["veh_pred"])
        self.vp = vp
        gg = GG(paths["gg"], dtype, self.device)
        self.prob, self.fan = controllers.builder(mpc["controller"])(
            mpc, vp, load_tires(paths["tire_pred"]), gg, self.N, float(sim["Ts_MPC"]), dtype,
            self.device)
        self.lap = Lap(paths["traj"], dtype, self.device)

    def _stack(self, x_est):
        if self.fan is None:
            return x_est
        return (x_est[:, None, :] + self.fan).flatten(-2)

    def step(self, c: dict) -> dict:
        """One step from the carry `c` (CARRY_KEYS, any dtype and device).
        Returns the new carry's tensors and the step's u0 (B, 2) and status."""
        c = {k: (tuple(t.to(self.device, self.dtype) for t in v) if k == "warm" else
                 v.to(self.device, torch.int32 if k == "est_count" else self.dtype))
             for k, v in c.items() if k in CARRY_KEYS}
        p, N = self.prob, self.N
        B = c["x_sim"].shape[0]
        pos, yaw, v = planner(self.lap, c["pose"], self.Tp, N + 1)
        zeros = torch.zeros((B, N, 2), dtype=self.dtype, device=self.device)
        yref = torch.cat([pos[:, :N], yaw[:, :N, None], v[:, :N, None], zeros], dim=2)
        yref_e = torch.cat([pos[:, N], yaw[:, N, None], v[:, N, None]], dim=1)
        X, U, warm, status = rti(p, c["X"], c["U"], c["warm"], self._stack(c["x_est"]), yref,
                                 yref_e)
        u0 = torch.stack([U[:, 0, 0], torch.clamp(U[:, 0, 1], self.vp.delta_f_dot_min,
                                                  self.vp.delta_f_dot_max)], dim=1)
        a_in = X[:, 1, 7]
        failed = (status != 0)
        pick = lambda a, b: torch.where(failed.view((B,) + (1,) * (a.dim() - 1)), a, b)
        X0 = self._stack(c["x_est"])[:, None, :].expand_as(X)
        X_c, U_c = pick(X0, X), pick(torch.zeros_like(U), U)
        warm_c = tuple(pick(torch.ones_like(w), w) for w in warm)
        u_plant = torch.stack([a_in, u0[:, 1]], dim=1)
        x_sim = rk4(lambda x, u: sim_ode(x, u, self.vp_sim, self.tp_sim), c["x_sim"], u_plant,
                    self.Ts, PLANT_SUBSTEPS)
        x_est, buf, count = estimate(c["est_buf"], c["est_count"],
                                     torch.cat([x_sim, a_in[:, None]], dim=1))
        return dict(u0=u0, status=status, X=X_c, U=U_c, warm=warm_c, x_sim=x_sim, x_est=x_est,
                    est_buf=buf, est_count=count, pose=x_sim[:, :2])
