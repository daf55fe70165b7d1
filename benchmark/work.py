"""The work of one closed-loop step, counted from its shapes: FLOPs and
device-memory bytes per stage, float32 (4 bytes a number).

The formulas of `tum_control_tpu_torch/tools/roofline.py::kernel_model`
(linearize, condense, the Cholesky factor and solves), with the shipped
qp_iters = 3 in place of the tool's default of 4, extended to the whole
step: planner window, QP assembly, the interior-point iterations and the
polish in full, the plant's RK4 and the estimator. Bytes count each input
of a stage read once and each output written once, whatever an
implementation reads again; FLOPs follow the algorithm, not the kernels
that implement it. So the counts stay the same whatever a later change
fuses, removes or redesigns.

`shapes` is a configuration file's `shapes` block (N, nx, nu, nz,
general_rows; for the stochastic NMPC also n_samples and
uncertainty_propagation_horizon; where the plant is disturbed
plant_integrations, the plant RK4s of a step, 1 where absent, and
drawn_numbers, the random numbers a scenario draws a step, 0 where absent),
`lap_points` the reference lap's length.
"""
from __future__ import annotations

F32 = 4
ODE_FLOPS = 250.0     # one evaluation of the single-track ODE with the Pacejka trigonometry
PLANT_SUBSTEPS = 4
SHOOTING_SUBSTEPS = 3
CON_FLOPS = 30.0      # one gg-constraint row's value (interpolation, division, square)
LINE_SEARCH_POINTS = 9 + 45   # bracket points and bisections of the polish
ROW_FLOPS = 100.0     # a Mehrotra iteration's elementwise work per constraint row
DRAW_FLOPS = 4.0      # a drawn number's transform into its disturbance


def planner(s: dict, M: int):
    n_out = s["N"] + 1
    flops = 5 * M + M + 2 * 3 * M + 20 * n_out   # distances, argmin, time walk, resampling
    return flops, ((5 * M + 1) + 4 * n_out) * F32


def linearize(s: dict):
    """RK4 rollout of every shooting element and its nx + nu forward tangents."""
    nx, nu, N = 8, s["nu"], s["N"]
    if "n_samples" in s:
        uph = s["uncertainty_propagation_horizon"]
        elements, sub = uph * (s["n_samples"] + 1) + (N - uph), 1
    else:
        elements, sub = N, SHOOTING_SUBSTEPS
    flops = elements * ODE_FLOPS * 4 * sub * (1 + nx + nu)
    return flops, elements * ((nx + nu) + nx + nx * (nx + nu)) * F32


def condense(s: dict):
    """The Gamma recurrence: per stage (nx, nx) @ (nx, nz + 1) and the input
    block; the stochastic NMPC propagates every sample copy below the
    horizon and recombines the nominal row as their PCE mean."""
    nx, nu, N, nz = 8, s["nu"], s["N"], s["nz"]
    per_stage = 2 * nx * nx * (nz + 1) + 2 * nx * nu * nz
    if "n_samples" in s:
        uph, ns1 = s["uncertainty_propagation_horizon"], s["n_samples"] + 1
        flops = uph * (ns1 * per_stage + 2 * (ns1 - 1) * nx * (nz + 1)) + (N - uph) * per_stage
        elements = uph * ns1 + (N - uph)
        out = (N + 1) * ns1 * nx + (N + 1) * nx * nz + (uph + 1) * ns1 * nx * nz
        return flops, (elements * (nx * nx + nx * nu + nx) + out) * F32
    flops = N * per_stage
    return flops, (N * (nx * nx + nx * nu + nx) + (N + 1) * (nx + nx * nz)) * F32


def qp_assembly(s: dict):
    """Gauss-Newton Hessian and gradient of the 4 state cost rows (the input
    rows are diagonal), and the general rows G = Jc Gamma with their values."""
    nx, N, nz, ncg = 8, s["N"], s["nz"], s["general_rows"]
    nc = ncg + nz
    rows = 4
    flops = 2 * rows * N * nz * nz + 2 * rows * nz * nz + 2 * rows * (N + 1) * nz
    flops += 2 * ncg * nx * nz + (N + 1) * nx * CON_FLOPS
    gam_in = (N + 1) * nx * nz
    if "n_samples" in s:
        uph, ns = s["uncertainty_propagation_horizon"], s["n_samples"]
        flops += (uph + 1) * ns * (2 * nx * nz + nx * CON_FLOPS)
        gam_in += (uph + 1) * (ns + 1) * nx * nz
    out = nz * nz + nz + ncg * nz + 5 * nc
    return flops, (gam_in + (N + 1) * nx + N * s["nu"] + out) * F32


def qp_solve(s: dict, qp_iters: int, n_polish: int = 1):
    """qp_iters Mehrotra iterations (normal matrix, Cholesky, the
    stationarity residual, two directions of two triangular solves and the
    row products each) and n_polish semismooth-Newton steps (gradient,
    normal matrix, Cholesky, solve, exact line search), then the KKT
    residual. Bytes: the QP and the warm start in, w and the warm start out."""
    nz, ncg = s["nz"], s["general_rows"]
    nc = ncg + nz
    chol = nz ** 3 / 3
    normal = 2 * ncg * nz * nz + ncg * nz
    it = normal + chol + (2 * nz * nz + 2 * ncg * nz)
    it += 2 * (2 * 2 * nz * nz + 2 * 2 * ncg * nz + 40 * nc) + ROW_FLOPS * nc
    pol = (2 * ncg * nz + 2 * nz * nz + 2 * ncg * nz + normal + chol + 2 * 2 * nz * nz
           + 2 * ncg * nz + 2 * nz * nz + LINE_SEARCH_POINTS * 6 * nc)
    flops = qp_iters * it + n_polish * pol + 2 * nz * nz + 2 * ncg * nz
    qp_in = nz * nz + nz + ncg * nz + 5 * nc
    return flops, (qp_in + 6 * nc + nz + 6 * nc + 1) * F32


def plant(s: dict):
    """One RK4 over the plant's 7 states per integration; the disturbed one
    adds its disturbance to each derivative and writes its own state."""
    k = s.get("plant_integrations", 1)
    flops = k * PLANT_SUBSTEPS * (4 * ODE_FLOPS + 4 * 7 * 2) + (k - 1) * PLANT_SUBSTEPS * 4 * 7
    return flops, (7 + 2 + 7 + (k - 1) * (7 + 7)) * F32


def draws(s: dict):
    """The disturbances' random numbers: each turned into its disturbance
    (the ellipsoid's norm and scale, or the noise's scale and add) and
    written once."""
    n = s.get("drawn_numbers", 0)
    return DRAW_FLOPS * n, n * F32


def estimator(s: dict, buf: int = 15, nx: int = 8):
    return nx * buf + nx, (2 * nx * buf + 2 * nx) * F32


def step_work(shapes: dict, batch: int, lap_points: int, qp_iters: int) -> dict:
    """{stage: (FLOPs, bytes)} of one closed-loop step of `batch` scenarios,
    and "step", their sum."""
    per = dict(planner=planner(shapes, lap_points), linearize=linearize(shapes),
               condense=condense(shapes), qp_assembly=qp_assembly(shapes),
               qp_solve=qp_solve(shapes, qp_iters), plant=plant(shapes),
               estimator=estimator(shapes))
    if shapes.get("drawn_numbers"):
        per["draws"] = draws(shapes)
    out = {k: (f * batch, b * batch) for k, (f, b) in per.items()}
    out["step"] = (sum(f for f, _ in out.values()), sum(b for _, b in out.values()))
    return out


def least_time_s(flops: float, nbytes: float, peaks: dict) -> float:
    """max(FLOPs / peak float32 rate, bytes / peak bandwidth)."""
    return max(flops / peaks["f32_flops_per_s"], nbytes / peaks["bytes_per_s"])
