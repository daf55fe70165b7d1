#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tum_control_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

It checks on the card what no card test (tests/test_torch_cuda.py) and no
benchmark cell (benchmark/) checks, and times the hand-written kernels.
Closed-loop rates and latencies are the benchmark's (python3 benchmark/run.py).
Phases (any failure raises and the script exits non-zero):
  1. prints the card (`nvidia-smi` name and power limit) and the TF32
     setting, and builds the hand-written kernels from
     tum_control_tpu_torch/csrc with nvcc for sm_90a (register and spill
     lines);
  2. runs each kernel (K1-K8 and the plant's RK4) at its closed loop's
     shapes (B = 128 scenarios; nominal: N = 38, nx = 8, nu = 2, nz = 76, 78
     general rows; K1 also at SNMPC's 88 elements per scenario and with one
     tire set per scenario, K6 at SNMPC's tails, K8 on K2's inputs and bitwise
     against K2, K7 on K3's and K5's; K1-K5 also at ENTRY_BATCHES, the plant
     at PLANT_BATCHES) on inputs from a seeded numpy generator, holds each
     output against its plain PyTorch version on the same inputs (TOL; K3
     and K7 also on an ill-conditioned IPM-shaped H by backward error, K4 on
     that H's factor against the float64 plain version within LATE_FACTOR of
     the float32 plain version's own distance), and times it: device time
     over 100 launches queued behind a sleep (`device_ms`), one launch with
     the host's launch path (`launch_ms`), the plain version per call, the
     PyTorch library call where there is one, and the least time (`bound`);
  3. drives each path's closed loop (PATHS: the nominal NMPC, the SNMPC, the
     R2NMPC, WMPC over the R2NMPC and the nominal NMPC with the EXTERNAL
     cost) at B = 128 in float32, a settle run and a second run, the launch
     counters reset just before and read just after: the path's kernels and
     no other, solver-ok >= 0.99, finite logs, WMPC's actions (its weight
     switches and action histogram printed); then steps after the window
     (WMPC: one policy period) under torch.cuda.set_sync_debug_mode("error");
  3b. `bench`, tum_control_tpu_torch/bench.py's main in-process at B = 128
     and cut depth: its last stdout line (four keys, finite), solver-ok >=
     0.99 on the nominal NMPC, the SNMPC and the R2NMPC, K1-K6 launched;
  4. the tuning loops: `ppo`, PPO training of the WMPC policy (16 envs on the
     Monteblanco and Modena laps, 20 closed-loop steps an env step, 2 updates
     of 8 env steps, one evaluation: metrics, rewards, parameters moved,
     artifacts), and `bo`, the multi-objective BO of the cost weights (8
     Sobol candidates and one BayesianOptimizer step on both segment groups,
     150 steps a rollout: trials, objectives finite where feasible,
     hypervolume), then one objective chunk of 128 scenarios;
  5. the user-facing entry points (ENTRY): `main` (run_main on the shipped
     YAML configs, B = 1, 200 steps; its full_logs.npz in the reference
     layout), `main_playback` (recorded with both disturbance kinds and
     replayed: disturbances equal, CiLX within TOL_PLAYBACK), `sweep` (the
     baseline sweep's entry module, 52 scenarios; its npz and summary.csv)
     and `policy` (run_policy and action_probability_trace of new_BO_F);
  6. `serve`, deploy_rt in-process at B = 1, SERVE_CYCLES cycles synchronous
     and as many with --pipeline 2 (telemetry read back: every record,
     status 0, finite; the controls against run_from's within TOL_SERVE);
     `distributed`, NCCL at world size 1 (the sharded loop's all-reduced
     mean |lat_dev| against the local one, scaling_report), and in its group
     `dryrun` (dryrun_multichip(1): six finite means) and `dryrun/entry`
     (one nominal step against the CPU's float64 and float32 steps, TOL_U);
  7. `eval`: the evaluation tools (EVAL) at full width and cut depth in a
     child process (`--eval-child`): normal exit, finite numbers, their
     printed statistics recomputed from what they return, solver-ok >= 0.99,
     their kernels and no other; acc24_figures' propagation within
     TOL_PROPAGATION of the CPU's float64 one; the sqp_iters = 2 and the
     catalog paths set up for phase 10 (EVAL_HOLD);
  8. `fit`: golden_attribution, fit_tires_es and fit_tires_closedloop on a
     golden pair the card writes, in a child process (`--fit-child`):
     normal exit, finite numbers, K1-K6 and the plant and no other; then
     `qp/newton` and `qp/ipm` (qp_hold), the soft-QP API on QPs of general
     rows only against the CPU's float64 solve;
  9. the profiler's device time of each kernel case of phase 2
     (`profiled_ms`), after the runs on the card;
 10. reruns each path's first steps on the CPU (plain versions) in float64
     and in float32 from the card's own carry at that step and holds the
     card's inputs simU to each (TOL_U, at most MAX_F32_FLIPS float32 flips;
     WMPC: actions equal to the float64 run's, probabilities within
     TOL_PROB); one env step (TOL_ENV) and three objectives (TOL_OBJ) of
     phase 4; the entry paths (ENTRY_CPU) and the eval paths likewise. Beside
     them, at TOOLS_SIDE_NICE: diag_precision --tf32, dump_qps
     (`--tools-child`) and the fit holds' references (`--fit-cpu-child`,
     `--fit-card-child`);
 11. the fit holds (the closed-loop fit's first loss terms and gradient
     against the CPU, TOL_FIT_TERMS, TOL_GRAD; the ES's generation as one
     batch against single runs, TOL_FIT_DEV; the attribution's theta,
     TOL_FIT_THETA); `diffmode`, the tire gradient through K1-K5 on the card
     (its kernels and no other, every solve ok there and in the CPU's
     float64 run); `robust_utils`, one full-ZoRo augmented step at AUG_B
     against the CPU's float64 step (TOL_AUG); `tools`, the nine measurement
     tools at B = 128 in a child process (`--tools-child`): normal exit,
     finite numbers, their kernels and no other;
 12. one {"kernels": [...]} line (launches per path and per step) and, last,
     the device line.

    python3 chip_smoke.py --kernels-only   # phases 1, 2 and the kernels' profiles

which prints the kernels' times as {"kernel_times": [...]}, without launch
counts: no path runs, so no counter is read.

Some functions are also the card tests' helpers: tests/test_torch_cuda.py
calls qp_hold, diffmode_gradient and diffmode_references, and holds what this
run leaves to it (the tire gradient's value, the served cycle without a host
sync).

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM data sheet: HBM bandwidth, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# back-to-back calls per device-time measurement
LAUNCHES_TIMED = 100

B, N, NX, NU = 128, 38, 8, 2
NZ, NCG = N * NU, (N + 1) * 2   # 76 condensed controls, 78 general rows (nh=1 + delta_f per node)
NC = NCG + NZ
# SNMPC: 10 samples + the nominal copy, uncertainty horizon 5 stages; K1 runs
# on 5 x 11 head + 33 tail elements per scenario, K6 on the 33-stage tail
NS1, UPH = 11, 5
N2, COL0 = N - UPH, UPH * NU
# the tire-identification tools' SNMPC: UPH 15 (K1 on 15 x 11 + 23 elements
# a scenario, K6 on the 23-stage tail from column 30)
UPH15 = 15
# K1's parameter block slots (kernel_params) of the tire table's columns:
# Bf .. Er, Fmax_f, Fmax_r, 1 / Fmax_f, 1 / Fmax_r
TABLE_SLOTS = (14, 15, 16, 17, 18, 19, 20, 21, 12, 13, 24, 25)
# K1's input states in kernel_phase: normal about lap states, by this spread
STATE_SPREAD = np.array([0.5, 0.5, 0.05, 1, 0.1, 0.05, 0.02, 0.5])
# the entry paths' batches, at which kernel_phase also holds K1-K5: one
# scenario (main, main_playback, policy) and the sweep's 26 sets x 2 laps
ENTRY_BATCHES = (1, 52)
# the plant's RK4 kernel (csrc/plant.cu) in the kernel phase: one scenario
# (main.py, the served cycle), SafeRL_WMPC's 16 rollouts and the batch cells'
# 128; its operations: 4 model evaluations a substep of ~250 each
# (benchmark/work.py's ODE_FLOPS) and the RK4's 4 x 8 multiply-adds
PLANT_BATCHES = (128, 16, 1)
PLANT_ODE_OPS = 250
# per path: settle steps, steps, steps rerun on the CPU (WMPC: 25, so that
# its first policy update, at step 20, falls inside)
PATHS = {"nominal": (50, 300, 20), "snmpc": (50, 200, 10), "rnmpc": (50, 200, 10),
         "wmpc_rnmpc": (50, 200, 25), "nominal_external": (20, 100, 10)}
# the MPCConfig of each path (Monteblanco, sim_mode 0, full width and depth)
WMPC = dict(enable_WMPC=True, WMPC_model="data/wmpc_models/new_BO_F")
PATH_CONFIG = {"nominal": {}, "snmpc": dict(controller="snmpc"), "rnmpc": dict(controller="rnmpc"),
               "wmpc_rnmpc": dict(controller="rnmpc", **WMPC),
               "nominal_external": dict(costfunction_type="EXTERNAL")}
# the tuning loops (phase 4), both over the nominal MPCConfig()
TUNING = ("ppo", "bo")
# the user-facing entry points (phase 5), each a path of its own: main.py's
# closed loop of one scenario (the shipped YAML configs, nominal NMPC), the
# same recorded and replayed with both disturbance kinds, the baseline sweep
# (26 sets of data/F.csv x 2 laps = 52 scenarios), run_policy and
# action_probability_trace of the new_BO_F policy (one scenario). Depth is
# cut: main 4 s of the shipped T = 100 s (200 steps), playback 2 s (100
# steps, twice), the sweep 2 s of the reference's 40 s (100 steps), the
# policy 1 s of a 40 s lap (50 steps, two policy updates)
ENTRY = ("main", "main_playback", "sweep", "policy")
MAIN_T, PLAYBACK_T, SWEEP_T, POLICY_T = 4.0, 2.0, 2.0, 1.0
SWEEP_TRACKS = ("monteblanco", "lvms")
# per entry path: steps on the card before the CPU re-solve, steps re-solved
# (the policy's: its update period, then the update and 5 steps after it)
ENTRY_CPU = {"main": (0, 10), "main_playback": (0, 10), "sweep": (0, 5), "policy": (20, 6)}
# main's and the policy's CPU holds start at this point of the Monteblanco
# lap, its first corner ~16 s in (yaw rate ~0.3 rad/s at 11 m/s), in the
# state batched_scenarios gives it. Both runs start on the straight, where
# the steering rate (1e-4 - 1e-3 rad/s) lies within 20-200x of float32's
# floor on it (~5e-6 rad/s between the CPU's float32 and float64 steps
# from one carry): held at TOL_U of such a window's own max, the check
# would measure float32, not the kernels
HOLD_LAP_POINT = 215
WMPC_MODEL = "data/wmpc_models/new_BO_F"
# the replay's plant trace against the recording's: max |difference| within
# TOL_PLAYBACK of max |CiLX| (the same float32 steps from the same
# disturbances; the playback branch skips the draws)
TOL_PLAYBACK = 1e-4
# the 14 arrays of the reference Logger's full_logs.npz and their shapes at
# n steps
FULL_LOGS = {"MPC_SimX": (1, 8), "CiLX": (1, 7), "simU": (0, 2), "simREF": (0, 4),
             "simSolverDebug": (0, 5), "sim_disturbance_derivatives": (0, 7),
             "sim_disturbance_state_estimation": (0, 7), "a_lat": (1,), "dev_lat": (0,),
             "dev_long": (0,), "dev_vel": (0,), "dev_yaw": (0,), "t": (0,),
             "DisturbedX": (1, 7)}
# the kernels each path must launch; every other counter must stay 0. One
# RTI solve of the nominal NMPC launches SOLVE_KERNELS; a closed-loop step
# (sim_mode 0) adds the plant's RK4
SOLVE_KERNELS = ("linearize", "condense", "cholesky", "chol_solve", "ipm_iteration")
NOMINAL_KERNELS = SOLVE_KERNELS + ("plant",)
PATH_KERNELS = {
    "nominal": NOMINAL_KERNELS,
    "snmpc": ("linearize", "condense_from", "cholesky", "chol_solve", "ipm_iteration", "plant"),
    "rnmpc": NOMINAL_KERNELS,
    "wmpc_rnmpc": NOMINAL_KERNELS,
    "nominal_external": NOMINAL_KERNELS,
    "ppo": NOMINAL_KERNELS,
    "bo": NOMINAL_KERNELS,
    **{path: NOMINAL_KERNELS for path in ENTRY},
    "serve": NOMINAL_KERNELS,
    "distributed": NOMINAL_KERNELS,
    "diffmode": NOMINAL_KERNELS,
    "robust_utils": (),
    # bench.py's three controllers; the n_id = 0 QPs run no fused IPM iteration
    # (JAX's rule: only n_id = nz reaches the kernel); the six compositions of
    # the dry run include the SNMPC; the entry step is one nominal solve
    "bench": ("linearize", "condense", "condense_from", "cholesky", "chol_solve",
              "ipm_iteration", "plant"),
    "qp/newton": ("cholesky", "chol_solve"),
    "qp/ipm": ("cholesky", "chol_solve"),
    "dryrun": ("linearize", "condense", "condense_from", "cholesky", "chol_solve",
               "ipm_iteration", "plant"),
    "dryrun/entry": SOLVE_KERNELS,
}
# the benchmark entry, the soft-QP API and the dry run, each a path of its own
API = ("bench", "qp/newton", "qp/ipm", "dryrun", "dryrun/entry")
# the port's headline entry, tum_control_tpu_torch/bench.py, in-process after
# the loops (phase 3b): bench.py's protocol at full width (B = 128, N = 38,
# the nominal NMPC, then the SNMPC and the R2NMPC) and cut depth:
# BENCH_SETTLE of its 100 settle steps, BENCH_STEPS of its 1,000 timed steps
# (the single stream's too; the SNMPC's and R2NMPC's min(steps, 300))
BENCH_B, BENCH_SETTLE, BENCH_STEPS = 128, 20, 100
# the qp hold (after the fit phase): QP_B random QPs of general rows only
# (n_id = 0) at the nominal widths (nz = NZ, NCG rows), tests/test_soft_qp.py's
# draw with each row of G scaled to unit expected norm (condensed rows' scale)
# and no hard row, float32 on the card against the CPU's float64 solve of the
# same QPs. solve_soft_qp (QP_NEWTON_ITERS Newton steps from w = 0) on the
# L2-penalised QPs (z1 = 0): from zero the semismooth Newton solve does not
# converge in 15 steps where L1 kinks are active (its exact line search then
# amplifies rounding: JAX's own solve moves by O(0.1) when its start moves by
# 1e-9), and on these it lands on the minimizer; its w within TOL_QP_W of max
# |w| (the CPU's float32 solve lies within 4.4e-7) and its objective within
# TOL_QP_OBJ of max(1, |objective|). solve_soft_qp_ipm(n_id=0) (30 iterations
# and 2 polish steps, the defaults) on the L1 + L2 QPs: float32 resolves its
# point to ~1e-2 of max |w| there (the CPU's float32 solve lies within 2.4e-2,
# median 1.6e-3; its objective within 6.5e-4), so w and the objective are
# held, over the batch, to the larger of TOL_QP_W / TOL_QP_OBJ and
# LATE_FACTOR times the CPU float32 solve's own distance from float64
QP_B, QP_NEWTON_ITERS = 128, 15
TOL_QP_W, TOL_QP_OBJ = 1e-5, 1e-5
# the tuning loops at full width, cut in depth (phase 4)
TRACKS_PPO = ("monteblanco", "modena")
TRACKS_BO = ("modena", "monteblanco")
PPO = dict(n_envs=16, n_steps=8, batch_size=64, n_epochs=2)
PPO_UPDATES, PPO_MPC_STEPS = 2, 20
BO = dict(n_initial=8, batch_size=5, n_mc=64)
BO_MAX_STEPS, BO_CHUNK = 150, 128
# one env step (20 closed-loop steps) from the card's env state, against the
# CPU float64 step from the same state: |obs| and reward within TOL_ENV
# absolute (both lie in [0, 1]-scale units). A float32 closed-loop step lies
# within 3e-4 of max |simU| of float64 (cpu phase); over 20 steps that moves
# lat_dev by ~1e-4 m, 2e-5 of the observation's 6 m range
TOL_ENV = 1e-3
# one (candidate, segment) objective (max |lat_dev| in m, RMS vel_dev in m/s
# over 150 steps) on the card against the CPU float64 rollout from the same
# start, absolute: 1 % of the smallest span between a reference point of the
# BO (-0.4 m, -0.75 m/s) and a perfect objective
TOL_OBJ = 4e-3
# no JAX caller reaches these kernels; held in the kernel phase only
OFF_PATH = {"condense_mxu", "cholesky_unblocked", "chol_solve_unblocked"}
# phase 6, serving, sharding and differentiating (each a path of its own):
# the serving entry module (deploy_rt) at B = 1, synchronous and with
# --pipeline 2, SERVE_CYCLES cycles of SERVE_PERIOD each; the sharded
# nominal loop under NCCL at world size 1 (DIST_B scenarios, DIST_STEPS
# steps) and scaling_report at one card (SCALING); the gradient of mean
# |lat_dev| over DIFF_STEPS steps at DIFF_B scenarios from HOLD_LAP_POINT
# with respect to the 8 tire log-multipliers (the kernels in the forward,
# the plain versions' VJP in the backward); one full-ZoRo augmented step (8
# RK4 substeps) at AUG_B scenarios
SERVE = ("serve", "distributed", "diffmode")
SERVE_CYCLES, SERVE_PERIOD = 250, 0.02
DIST_B, DIST_STEPS = 128, 20
SCALING = dict(device_counts=[1], batch_per_device=128, steps=50)
DIFF_B, DIFF_STEPS = 8, 5
AUG_B = 128
# the served controls against run_from's from the same carry on the card:
# the same float32 steps, so equal but for the packed vector's float32
# rounding (max |difference| per input over its max |u|)
TOL_SERVE = 1e-6
# the card's float32 gradient against reference gradients from the same
# start, per component: |g_i - r_i| <= TOL_GRAD * max(|r_i|, GRAD_FLOOR *
# max |r|) (the Pacejka E factors' components are ~2e-3 of the largest).
# The references: the CPU's float64 gradient, and the CPU's float32 gradient
# with K2's outputs plain, and valued by the plain version in float64 (a
# float32 K2 more exact than the plain one). The float32 loop's gradient is
# bimodal there: a move of a kernel's outputs by float32 rounding lands the
# first solve's exact line search (ops/soft_qp.py) on either side of a
# kink, and the gradient takes one of two values; float64's moves by far
# less (the phase prints each reference's gap from float64, and float64's
# with K2 valued in float32). The card's gradient must lie within TOL_GRAD
# of one of them
TOL_GRAD, GRAD_FLOOR = 1e-3, 1e-3
# the card's float32 augmented step against the CPU's float64 step: each
# state column over its max |x|, each diagonal entry of Sigma over itself
# (they span 1e-10 .. 0.2), each entry of Sigma over sqrt(S_ii S_jj). The
# CPU's own float32 step lies within 4e-7, 1.8e-6 and 2.5e-6 of float64
TOL_AUG = 1e-5

# phase 10, the measurement and diagnostic tools (tum_control_tpu_torch/tools),
# each at full width (B = 128 scenarios of the shipped N = 38; stage_bench and
# profile_step on the nominal NMPC and the SNMPC) and cut depth (tens of steps
# or repeats), in child processes (`--tools-child`), so that no profiler
# session of this process slows their host clocks: TOOLS_MAIN in one, the two
# tools that take profiler windows last (profile_step times both
# controllers' stages before its first window, roofline its batches before
# its windows); diag_precision --tf32 (the TF32 flags are global to a
# process) and dump_qps (one QP and its scipy re-solve on the host), whose
# times are no measurements, each alone in a process at a lower priority
# (TOOLS_SIDE_NICE) beside the CPU re-solves of phase 8
TOOLS_MAIN = [
    ("batch_sweep", ["1", "128", "1024", "--steps", "20", "--settle", "10"]),
    ("sweep_qpiters", ["3", "4", "--batch", "128", "--steps", "20", "--settle", "10"]),
    ("diag_tail", ["128", "20", "--settle", "10"]),
    ("diag_precision", ["--steps", "20", "--settle", "10"]),
    ("stage_bench", ["128", "10", "nominal"]),
    ("stage_bench", ["128", "10", "snmpc"]),
    ("snmpc_dissect", ["128", "10"]),
    ("profile_step", ["128", "--repeats", "10", "--controller", "nominal", "snmpc"]),
    ("roofline", ["128", "1024", "--steps", "10"]),
]
TOOLS_SIDE_NICE = 10
TOOLS_SIDE = [[("diag_precision", ["--tf32", "--steps", "20", "--settle", "10"])],
              [("dump_qps", ["1", "--out", os.path.join("build", "chip_smoke",
                                                          "qp_anchor_torch.npz")])]]
# phase 11, the evaluation tools (tum_control_tpu_torch/tools and scripts)
# on the card, at full width (N = 38; the catalogs at their full batches) and
# cut depth, in one child process (`--eval-child`) after the serving and
# sharding phases, before any profiler session: one_lap (the SNMPC, 1 s),
# quality_exp at K = 2 (1 s of its 100 s), multitrack_eval (0.5 s of 100),
# wmpc_eval (1 s of 40, LVMS), rl_protocol_eval (0.5 s of 120, two of its
# four models), catalog_noise_validation (1 s of 40, three seeds, every
# catalog as one batch), the SB3 converter on a checkpoint written from
# new_BO_F's weights, and the uncertainty propagation of acc24_figures (its
# figures need matplotlib, which the card's machine may lack)
EVAL_OUT = os.path.join("build", "chip_smoke")
EVAL = [
    ("one_lap", ["monteblanco", "snmpc", "1"]),
    ("quality_exp", ["2", "--T", "1"]),
    ("multitrack_eval", ["0.5"]),
    ("wmpc_eval", [WMPC_MODEL, "1", "lvms"]),
    ("rl_protocol_eval", ["0.5", WMPC_MODEL, "data/wmpc_models/jax_ppo_r2"]),
    ("catalog_noise_validation", ["--T", "1", "--seeds", "3", "--out",
                                  os.path.join(EVAL_OUT, "catalog_noise_torch.json")]),
    ("convert_sb3_checkpoint", [os.path.join(EVAL_OUT, "sb3_src"),
                                os.path.join(EVAL_OUT, "sb3_out")]),
    ("acc24_figures", []),
]
# each catalog's scenarios: sets x 3 tracks x 3 seeds, one batch
CATALOG_SCENARIOS = {"data/F.csv": 234, "data/F_jax_r4.csv": 315,
                     "data/F_jax_r4_lowrisk.csv": 252}
# the card's float32 propagation of acc24_figures against the CPU's float64,
# max |difference| over max |samples| (14 plain RK4 steps of 11 copies)
TOL_PROPAGATION = 1e-5
# the two evaluation paths that no earlier chip run held, re-solved on the
# CPU from the card's carry (cpu_phase): sqp_iters = 2 (B scenarios spread
# along the Monteblanco lap, `settle` steps on the card, `n` re-solved) and
# the catalog's (F_jax_r4.csv's 315 scenarios on their laps, under their
# weights and their seed's noise, `settle` steps on the card, then `subset`
# of them re-solved `n` steps, fed the card's noise)
EVAL_HOLD = {"sqp2": dict(B=16, settle=10, n=10),
             "catalog": dict(catalog="data/F_jax_r4.csv", settle=10, n=5, subset=16)}
EVAL_TRACKS = ("monteblanco", "modena", "lvms")
EVAL_CPU = tuple(EVAL_HOLD)
# what a tool returns that is no headline number (carries, outputs, QPs)
TOOL_BULK = {"carry", "out", "qps", "w_ipm", "w_scipy", "log", "noise"}
NONFINITE = re.compile(r"\b(nan|inf)\b", re.IGNORECASE)

# the `fit` phase (after `eval`, before any profiler session): the
# tire-identification tools (tum_control_tpu_torch/tools/golden_attribution,
# fit_tires_es, fit_tires_closedloop) on a synthetic golden pair the card
# writes, since the ACC24 goldens are not in the repository: FIT_GOLDEN_STEPS
# steps (1 s of the goldens' 120 s) of the nominal NMPC and of the SNMPC at
# UPH 15 from FIT_LAP_POINT in the first corner (in batched_scenarios'
# state), B = 1, FIT_TIRES on plant and controller. Not from the lap's
# start: on the opening straight |dev_lat| is ~1e-3 m (the ES's laps
# there, held below), and a trace term, a mean square of differences of
# such deviations, lies within a few float32 spacings of Monteblanco's
# coordinates (1.5e-5 m between 128 and 256 m); nor from lap point 215,
# where a cold-started SNMPC chunk fails solves inside the masked steps and
# the failed solves' re-initialisation parts float32 from float64 further.
# The ES's laps start at the lap's start regardless (the tool's own). The
# tools run at full width (N = 38; SNMPC 10 samples, UPH 15)
# and cut depth in one child process (`--fit-child`): the attribution's
# transition fit (200 of its 3,000 Adam steps) and its four laps cut to
# 0.5 s of 120; the ES at pop 8 (of 16) for 2 (of 60) generations of the
# golden's full 1 s lap; the closed-loop fit at 2 (of 24) chunks of 6 (of
# 250) steps, skip 2 (of 50), for 2 (of 150) gradients. Held beside the CPU
# re-solves (children at TOOLS_SIDE_NICE): the fit's first loss terms
# against the CPU's float64 ones (TOL_FIT_TERMS) and its first gradient
# against the nearest of the CPU's four references (TOL_GRAD, as diffmode);
# the ES's first generation (pop 8 as one batch) against 8 single-member
# runs on the card (TOL_FIT_DEV); the attribution's fitted theta against
# the CPU's float64 fit (TOL_FIT_THETA)
FIT_TIRES = "EDGAR/pacejka_params_2023fit.yaml"
FIT_GOLDEN_STEPS = 50
FIT_LAP_POINT = 240
FIT_DIR = os.path.join("build", "chip_smoke", "fit")
FIT_RUNS = [("golden_attribution", ["--steps", "200", "--T", "0.5"]),
            ("fit_tires_es", ["--pop", "8", "--gens", "2"]),
            ("fit_tires_closedloop", ["--n-chunks", "2", "--chunk-len", "6", "--skip", "2",
                                      "--steps", "2"])]
FIT_KERNELS = ("linearize", "condense", "condense_from", "cholesky", "chol_solve",
               "ipm_iteration", "plant")
# the card's first loss terms against the CPU's float64 ones: both ratios
# within TOL_FIT_TERMS relative, the solver-ok shares equal. A trace (the
# mean square of |dev_lat| minus the golden's) is a difference of two
# float32 lateral deviations, which float32 resolves to a few spacings of
# the coordinates (the CPU's own float32 |dev_lat| parts from float64 by up
# to ~5e-5 m over a 6-step chunk, its traces by ~1.4e-3 relative): each is
# held to what a |dev_lat| within TOL_FIT_DEV moves it by, 2 sqrt(trace)
# TOL_FIT_DEV + TOL_FIT_DEV^2; the loss to what the ratio and trace bounds
# move it by. The ES's members as one batch against single-member runs,
# both float32 on the card: mean and max |lat_dev| within TOL_FIT_DEV,
# solver-ok equal. The batch size changes a library kernel's summation
# order, and the two loops part by float32 spacings of the coordinates, a
# large share of the ~1e-3 m deviations of the opening straight
# (tests/test_torch_tire_fit.py holds the batch to single runs in float64
# at 1e-10). TOL_FIT_DEV is ~7 spacings
TOL_FIT_TERMS = 1e-3
TOL_FIT_DEV = 1e-4
# the attribution's fitted log-multipliers, absolute: both fits run in float64
TOL_FIT_THETA = 1e-3
FIT_TERMS = ("loss", "rn", "rs", "tn", "ts", "okn", "oks")

# tolerance of each kernel against its plain version on the same inputs, held
# for every output on its own (for K1 every column of J) as
# max |kernel - plain| <= TOL * max |plain|. float32 on both sides in
# different operation orders; each plain version's float32 result lies within
# 1e-6 of its float64 result relative to that output's max (K4: 3e-6, its
# directions go through a factor of cond ~1e3), so TOL leaves 10-30x of room
TOL = {"linearize": 2e-5, "condense": 2e-5, "condense_from": 2e-5, "cholesky": 2e-5,
       "chol_solve": 2e-5, "ipm_iteration": 1e-4, "condense_mxu": 2e-5,
       "cholesky_unblocked": 2e-5, "chol_solve_unblocked": 2e-5, "plant": 2e-5}
# K3 and K7 on an ill-conditioned H (cond ~1e7-1e8): max |L L^T - H| / max |H|,
# against n eps ~4.5e-6 at n = 76
BACKWARD_TOL = 2e-5
# K4 on a late iteration's factor (that H's): its directions go through cond
# ~1e7-1e8, where two float32 orders part by more than TOL. Each output is
# held against the float64 plain version on the same inputs, to the larger
# of TOL and LATE_FACTOR times the float32 plain version's own distance from
# it (two float32 evaluations of one function, each within its rounding of
# the exact result, lie within twice that of each other)
LATE_FACTOR = 2.0
# the card's applied inputs simU against the CPU's float32 and float64 step
# from the same carry: max |card - cpu| <= TOL_U * max |simU f64| per input.
# One float32 step lies within 3e-4 (nominal) and 2e-4 (SNMPC) of the
# float64 step on this scale
TOL_U = 2e-3
# the card's WMPC action probabilities against the CPU float64 step's from
# the same carry, absolute (they lie in [0, 1], as TOL_ENV's observations)
TOL_PROB = 1e-3
# A (scenario, step) where the CPU's own float32 step lies beyond TOL_U of its
# float64 step is a state float32 cannot resolve: a soft row within one float32
# ulp of its bound lands on the other side, the polish's semismooth Newton step
# takes another active set, and simU moves by more than TOL_U (seen once on
# the nominal path, 2.5e-3 of max |simU| at one of 2,560 pairs, where the
# card's step lay with the CPU's float32 step). There the card is held to the
# float32 step alone, and no looser than it is held to float64 elsewhere: its
# distance from the float32 step there may not exceed the path's largest
# card - cpu f64 over the other pairs. At most MAX_F32_FLIPS such pairs per path
MAX_F32_FLIPS = 2
CARRY = ("w", "Gw", "su", "sl", "pu", "pl", "lam_u", "lam_l", "mu_u", "mu_l")
REPLACES = {
    "linearize": "tum_control_tpu/ops/pallas_kernels/linearize.py:41",
    "condense": "tum_control_tpu/ops/pallas_kernels/condense.py:67",
    "condense_from": "tum_control_tpu/ops/pallas_kernels/condense.py:291",
    "cholesky": "tum_control_tpu/ops/pallas_kernels/chol.py:90",
    "ipm_iteration": "tum_control_tpu/ops/pallas_kernels/ipm_iter.py:173",
    "chol_solve": "tum_control_tpu/ops/pallas_kernels/chol.py:139",
    "condense_mxu": "tum_control_tpu/ops/pallas_kernels/condense.py:178",
    "cholesky_unblocked": "tum_control_tpu/ops/pallas_kernels/chol.py:33",
    "chol_solve_unblocked": "tum_control_tpu/ops/pallas_kernels/chol.py:58",
    "plant": "none: the JAX package integrates the plant in plain JAX "
             "(tum_control_tpu/sim/closed_loop.py:152)",
}
SOURCE = {
    "linearize": "tum_control_tpu_torch/csrc/linearize.cu",
    "condense": "tum_control_tpu_torch/csrc/condense.cu",
    "condense_from": "tum_control_tpu_torch/csrc/condense.cu",
    "cholesky": "tum_control_tpu_torch/csrc/chol.cu",
    "ipm_iteration": "tum_control_tpu_torch/csrc/ipm_iter.cu",
    "chol_solve": "tum_control_tpu_torch/csrc/chol.cu",
    "condense_mxu": "tum_control_tpu_torch/csrc/condense.cu",
    "cholesky_unblocked": "tum_control_tpu_torch/csrc/chol.cu",
    "chol_solve_unblocked": "tum_control_tpu_torch/csrc/chol.cu",
    "plant": "tum_control_tpu_torch/csrc/plant.cu",
}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def say(*a):
    print(*a, flush=True)


def launch_ms(fn, runs, warmup=2):
    """Median milliseconds of one call of `fn` between two CUDA events, after
    warm-up. The device is idle when the start event is recorded, so the
    figure includes the host's launch path (Python, the wrapper's checks and
    allocation, ctypes) as well as the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms():
    """Clock cycles of `torch.cuda._sleep` per millisecond on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, launches=LAUNCHES_TIMED):
    """Mean device milliseconds per call of `fn`: `launches` back-to-back
    calls between one pair of CUDA events, queued behind a
    `torch.cuda._sleep` that lasts twice the host's time to enqueue them, so
    the device reaches the start event only when every call is queued and
    the host's launch path stays out of the figure. None when the host
    could not get ahead of the device (a call that synchronizes with the
    host, as `torch.linalg.cholesky` does on CUDA)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(sleep_cycles_per_ms() * (2.0 * host_ms + 1.0))
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / launches
        cycles *= 4
    return None


def profiled_ms(fn, launches=LAUNCHES_TIMED):
    """Device milliseconds per call of `fn` by torch.profiler: the sum of
    the device time of every kernel the calls launched, over `launches`
    back-to-back calls. None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    from tum_control_tpu_torch.tools.common import device_us
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(r) for r in prof.key_averages() if str(r.device_type).endswith("CUDA"))
    return us / launches / 1e3 if us > 0 else None


def bound(n_bytes, n_ops):
    """Least time (ms) for the work: the larger of bytes over the HBM rate
    and float32 operations over the fp32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def tri_bytes(n, batch=B):
    """Bytes of the lower triangles of `batch` float32 n x n matrices: all
    that a factorization needs of H and a triangular solve of L."""
    return batch * n * (n + 1) // 2 * 4


def compare(name, outputs):
    """Holds each (label, kernel, plain) output to TOL[name] * max|plain|.
    Returns the max abs error over all outputs and each output's max abs
    error relative to its own max |plain|."""
    err, rel = 0.0, {}
    for label, g, r in outputs:
        check(g.shape == r.shape, f"{name}.{label}: shape {tuple(g.shape)} != {tuple(r.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}.{label}: non-finite kernel output")
        e = float((g.double() - r.double()).abs().max())
        scale = float(r.abs().max())
        check(e <= TOL[name] * scale,
              f"{name}.{label}: max abs err {e:.3e} > {TOL[name]:.0e} * {scale:.3e}")
        err, rel[label] = max(err, e), e / scale if scale > 0 else 0.0
    return err, rel


def random_qp(rng, device, batch=B, nz=NZ, ncg=NCG):
    """A soft QP (float32; the main path's shapes by default), drawn as
    tests/test_ipm_fused.py draws its problems (mixed one-sided, two-sided
    and hard rows): (H0, g0, G, c0, lb, ub, z1, z2)."""
    f32, nc = np.float32, ncg + nz
    G = rng.standard_normal((batch, ncg, nz)).astype(f32)
    A = rng.standard_normal((batch, nz, nz + 4)).astype(f32)
    H0 = (np.einsum("bij,bkj->bik", A, A) / nz + 2.0 * np.eye(nz)).astype(f32)
    g0 = rng.standard_normal((batch, nz)).astype(f32)
    c0 = rng.standard_normal((batch, nc)).astype(f32)
    lb = (c0 - np.abs(rng.standard_normal((batch, nc))) - 0.1).astype(f32)
    ub = (c0 + np.abs(rng.standard_normal((batch, nc))) + 0.1).astype(f32)
    ub[:, ::7] = 1e13
    lb[:, 1::5] = -1e13
    z1 = (np.abs(rng.standard_normal((batch, nc))) * 5 + 0.5).astype(f32)
    z2 = (np.abs(rng.standard_normal((batch, nc))) * 5 + 0.5).astype(f32)
    z2[:, 2::6] = 1e7
    t = lambda a: torch.tensor(a, device=device)
    return tuple(t(a) for a in (H0, g0, G, c0, lb, ub, z1, z2))


def ipm_start(qp):
    """The IPM's cold-start carry for a QP (as ops/ipm.py builds it without a
    warm start), the active-row count nt, and the first normal matrix
    H = H0 + G' diag(sigma) G + diag(sigma_id + 1e-11)."""
    from tum_control_tpu_torch.ops.kernels.ipm_iter import masks_of, sigma_of
    H0, g0, G, c0, lb, ub, z1, z2 = qp
    ncg = G.shape[1]
    act_u, act_l, s_u, s_l = masks_of(lb, ub, z2)
    one, zero = torch.ones_like(c0), torch.zeros_like(c0)
    su, sl = torch.where(s_u, one, zero), torch.where(s_l, one, zero)
    pu = torch.where(act_u, torch.clamp(ub + su - c0, min=1.0), one)
    pl = torch.where(act_l, torch.clamp(c0 + sl - lb, min=1.0), one)
    lam_u, lam_l = torch.where(act_u, one, zero), torch.where(act_l, one, zero)
    mu_u, mu_l = torch.where(s_u, one, zero), torch.where(s_l, one, zero)
    nt = (act_u.sum(1) + act_l.sum(1) + s_u.sum(1) + s_l.sum(1)).to(c0.dtype)
    carry = (torch.zeros_like(g0), torch.zeros_like(c0), su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l)
    sig = sigma_of(su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l)
    H = (H0 + torch.matmul(G.transpose(1, 2) * sig[:, None, :ncg], G)
         + torch.diag_embed(sig[:, ncg:] + 1e-11)).contiguous()
    return carry, nt, H


def k4_args(qp, carry, nt, L):
    """K4's inputs before the carry: (L, G, rw, c0, lb, ub, z1, z2, nt), with
    the stationarity residual rw = H0 w + g0 + [G; I]'(lam_u - lam_l)."""
    H0, g0, G, c0, lb, ub, z1, z2 = qp
    ncg = G.shape[1]
    lam_d = carry[6] - carry[7]
    rw = (torch.matmul(H0, carry[0][..., None])[..., 0] + g0
          + torch.matmul(lam_d[:, None, :ncg], G)[:, 0] + lam_d[:, ncg:]).contiguous()
    return (L, G, rw, c0, lb, ub, z1, z2, nt)


def ipm_shaped_h(rng, batch, nz, ncg):
    """(batch, nz, nz) float32 normal matrices H0 + G^T diag(sigma) G +
    diag(sigma_box) as an interior-point iteration builds them late in a
    solve: H0 and G drawn as random_qp draws them, sigma ~ |N(0, 1)| + 0.1
    on the soft rows and log-uniform over 1e-4 .. 10^6.5 on the hard rows
    (every 6th row from row 2, as random_qp marks them). At nz = 76, 78
    general rows: cond(H) median ~1e7-2e7, max ~1e8. With sigma up to 1e7
    (cond up to ~5e8) the float32 plain version itself breaks down (a
    negative pivot) in about one matrix of 128."""
    nc = ncg + nz
    G = rng.standard_normal((batch, ncg, nz))
    A = rng.standard_normal((batch, nz, nz + 4))
    H0 = np.einsum("bij,bkj->bik", A, A) / nz + 2.0 * np.eye(nz)
    sig = np.abs(rng.standard_normal((batch, nc))) + 0.1
    sig[:, 2::6] = 10.0 ** rng.uniform(-4.0, 6.5, sig[:, 2::6].shape)
    H = H0 + np.einsum("bic,bi,bid->bcd", G, sig[:, :ncg], G) + sig[:, ncg:, None] * np.eye(nz)
    return (0.5 * (H + H.transpose(0, 2, 1))).astype(np.float32)


def plant_case(batch, tires="shared", device="cpu", dtype=torch.float64, seed=20):
    """(Plant, x (batch, 7), u (batch, 2), w (batch, 7)) of the simulator's
    vehicle on `device` in `dtype`, drawn from `seed` alone: states about
    curvature-consistent lap starts spread by STATE_SPREAD, every eighth row
    from the fourth starting below VLONG_EPS (the low-speed guard), every
    eighth from the sixth at +-12 m/s^2 (the rear axle's combined-slip clamp,
    0.98 of Fmax_r, lies at ~8.6), u's steering rate ~0.1 rad/s, w uniform
    within the shipped derivative disturbance's magnitudes. Tires "shared"
    (floats: the shipped set), "one" (0-d tensors, the shipped set x 1.02: a
    table of one row) or "per" (one set a scenario, the shipped set times
    exp(theta_b), theta_b ~ N(0, 0.05^2): a table of `batch` rows)."""
    from tum_control_tpu_torch.config import (
        DEFAULT_CONFIG_PATH, SimConfig, load_tire_params, load_vehicle_params,
    )
    from tum_control_tpu_torch.models.vehicle_stm import VLONG_EPS
    from tum_control_tpu_torch.ops.kernels.plant import Plant
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios
    from tum_control_tpu_torch.sim.closed_loop import PLANT_SUBSTEPS
    from tum_control_tpu_torch.track.trajectory import load_ref_trajectory

    cfg = SimConfig()
    rng = np.random.default_rng(seed)
    traj = load_ref_trajectory(os.path.join(cfg.trajectory_path, cfg.ref_traj_file),
                               torch.float64, device="cpu")
    x = batched_scenarios(traj, batch, dtype=torch.float64)[1].numpy()
    x = x + rng.normal(0, 1, (batch, 7)) * STATE_SPREAD[:7]
    x[3::8, 3] = rng.uniform(-VLONG_EPS, VLONG_EPS, len(x[3::8]))
    u = rng.normal(0, 1, (batch, 2)) * [1.0, 0.1]
    u[5::8, 0] = 12.0 * np.sign(rng.normal(0, 1, len(u[5::8])))
    w = rng.uniform(-1, 1, (batch, 7)) * np.array(cfg.w_derivatives)
    theta = rng.normal(0, 0.05, (batch, 8))
    vp = load_vehicle_params(DEFAULT_CONFIG_PATH, cfg.veh_params_file_simulator)
    tp = load_tire_params(DEFAULT_CONFIG_PATH, cfg.tire_params_file_simulator)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    if tires == "one":
        tp = type(tp)(*(t(v * 1.02) for v in tp[:8]), mu=tp.mu)
    elif tires == "per":
        tp = type(tp)(*t(np.exp(np.log(np.array(tp[:8])) + theta).T).unbind(0), mu=tp.mu)
    return Plant(vp, tp, cfg.Ts, PLANT_SUBSTEPS), t(x), t(u), t(w)


def backward_error(L, H):
    """max over the batch of max |L L^T - H| / max |H|, in float64."""
    Ld, Hd = L.double(), H.double()
    err = (Ld @ Ld.transpose(1, 2) - Hd).abs().amax(dim=(1, 2)) / Hd.abs().amax(dim=(1, 2))
    return float(err.max())


def kernel_phase(dev):
    from tum_control_tpu_torch.api import build_controller
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.kernels.chol import (
        chol_solve_cuda, chol_solve_ref, chol_solve_unblocked_cuda, chol_solve_unblocked_ref,
        cholesky_cuda, cholesky_ref, cholesky_unblocked_cuda, cholesky_unblocked_ref,
    )
    from tum_control_tpu_torch.ops.kernels.condense import (
        condense_cuda, condense_from_cuda, condense_from_ref, condense_mxu_cuda,
        condense_mxu_ref, condense_ref,
    )
    from tum_control_tpu_torch.ops.kernels.ipm_iter import fused_iteration_cuda, iteration_ref
    from tum_control_tpu_torch.ops.kernels.linearize import (
        LinearizeRollout, linearize_cuda, linearize_ref,
    )
    from tum_control_tpu_torch.ops.kernels.plant import plant_cuda, plant_ref
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios
    from tum_control_tpu_torch.params import TireParams
    from tum_control_tpu_torch.track.trajectory import load_ref_trajectory

    rng = np.random.default_rng(0)
    results, jobs = {}, []

    def record(name, err_rel, kernel, plain, bytes_, ops, library=None, library_sync=None,
               case="nominal", plain_runs=5, extra=None):
        """Times one shape case of a kernel and records it; a kernel's
        top-level numbers are those of its first case, every case is listed
        under "cases". `ms` is the kernel's device time (`device_ms`),
        `ms_launch` one launch with the host's launch path; the plain version
        is timed per call, host included (it is hundreds of small launches).
        `library_ms` is the library call's device time as the kernel's `ms`
        is taken; where the call synchronizes with the host, so that no
        launches queue up, it is the profiler's device time, filled in by
        `profile_kernels`, and the per-call time with the host's path goes
        to `library_call_ms`. `library_sync` (a call known to synchronize)
        is timed per call, host included (`library_sync_call_ms`). The
        profiler's times (`ms_profiler`, `library_ms_profiler`) come later,
        from `profile_kernels` over `jobs`."""
        err, rel = err_rel
        ms = device_ms(kernel)
        check(ms is not None, f"{name}/{case}: the host could not queue the launches ahead")
        ms_launch = launch_ms(kernel, 50)
        plain_ms = launch_ms(plain, plain_runs, warmup=1)
        library_ms = None
        b_ms, b_by = bound(bytes_, ops)
        lib = "null"
        if library is not None:
            library_ms = device_ms(library)
            syncs = library_ms is None
            lib = f"{library_ms:.5f} ms device" if not syncs else "device time from the profiler"
        entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=library_ms, ms_profiler=None, ms_launch=ms_launch,
                     max_rel_err=rel, **(extra or {}))
        if library is not None:
            entry.update(library_synchronizes=syncs, library_ms_profiler=None)
            if syncs:
                entry["library_call_ms"] = launch_ms(library, 50)
                lib += f" (it synchronizes; {entry['library_call_ms']:.4f} ms per call)"
        if library_sync is not None:
            entry["library_sync_call_ms"] = launch_ms(library_sync, 50)
            lib += f", synchronizing call {entry['library_sync_call_ms']:.4f} ms per call"
        if name not in results:
            results[name] = dict(name=name, route="cuda", source=SOURCE[name],
                                 replaces=REPLACES[name], **entry, cases=[])
        results[name]["cases"].append(dict(case=case, **entry))
        jobs.append((name, len(results[name]["cases"]) - 1, kernel, library))
        worst = max(rel, key=rel.get)
        say(f"[{name}/{case}] max abs err {err:.3e}; worst output {worst}: {rel[worst]:.3e} of "
            f"its max|plain| | kernel {ms:.5f} ms device (mean of {LAUNCHES_TIMED} behind a "
            f"sleep; one launch with the host path {ms_launch:.4f})"
            f" | plain {plain_ms:.3f} ms | library {lib} | bound {b_ms:.5f} ms ({b_by})")

    def lap_inputs(batch):
        """K1's (batch, N, nx + nu) float32 inputs: states spread about
        curvature-consistent starts along the lap, random inputs."""
        x0, _ = batched_scenarios(traj, batch, dtype=torch.float64)
        X = x0.numpy()[:, None, :] + rng.normal(0, 1, (batch, N, NX)) * STATE_SPREAD
        U = rng.normal(0, 1, (batch, N, NU)) * [1.0, 0.1]
        return x0, torch.tensor(np.concatenate([X, U], axis=2), dtype=torch.float32, device=dev)

    def hold_linearize(XU, lin, case):
        """K1 with `lin`'s tires: its argument block's shared set, or its
        tire table's rows (one per scenario), read once each."""
        F, J = linearize_cuda(XU, lin.prm, lin.n_sub, tires=lin.table)
        Fp, Jp = linearize_ref(XU, lin.step, NX)
        err = compare("linearize", [("F", F, Fp)] + [(f"J[..., {c}]", J[..., c], Jp[..., c])
                                                     for c in range(NX + NU)])
        # operations per element: 4 model evaluations per RK4 substep of ~112
        # primitive operations, and the 10 input directions' tangents at ~2
        # operations per primitive each
        ops = XU.shape[0] * XU.shape[1] * 4 * lin.n_sub * 112 * (1 + 2 * 10)
        table = () if lin.table is None else (lin.table,)
        record("linearize", err, lambda: linearize_cuda(XU, lin.prm, lin.n_sub, tires=lin.table),
               lambda: linearize_ref(XU, lin.step, NX), nbytes(XU, F, J, *table), ops, case=case,
               plain_runs=3)
        return J

    def condense_inputs(J):
        """K2's inputs on K1's sensitivities J: (A, B, xi, d0)."""
        batch = J.shape[0]
        xi = torch.tensor(rng.normal(0, 0.01, (batch, N, NX)), dtype=torch.float32, device=dev)
        d0 = torch.tensor(rng.normal(0, 0.1, (batch, NX)), dtype=torch.float32, device=dev)
        return J[..., :NX].contiguous(), J[..., NX:].contiguous(), xi, d0

    def condense_ops(batch, n_st=N):
        # A_k Gam_k needs nx^2 (k nu) FMAs (columns past k nu are zero), e: nx^2
        return batch * sum(2 * NX * NX * (k * NU + 1) + 2 * NX * NU for k in range(n_st))

    def hold_k8(args8, k2_out, case):
        """K8 against its plain version and, bitwise, against K2's outputs
        `k2_out` on the same inputs."""
        e8, G8 = condense_mxu_cuda(*args8)
        e8p, G8p = condense_mxu_ref(*args8)
        err = compare("condense_mxu", [("e", e8, e8p), ("Gamma", G8, G8p)])
        de, dg = (float((a - b).abs().max()) for a, b in ((e8, k2_out[0]), (G8, k2_out[1])))
        say(f"[condense_mxu/{case}] against K2 on the same inputs: max |e8 - e2| {de:.3e}, "
            f"max |Gamma8 - Gamma2| {dg:.3e}")
        check(torch.equal(e8, k2_out[0]) and torch.equal(G8, k2_out[1]),
              f"condense_mxu/{case}: K8 differs from K2 ({de:.3e}, {dg:.3e})")
        batch, n_st = args8[1].shape[:2]
        record("condense_mxu", err, functools.partial(condense_mxu_cuda, *args8),
               functools.partial(condense_mxu_ref, *args8),
               nbytes(*args8) + batch * (n_st + 1) * NX * (n_st * NU + 1) * 4,
               condense_ops(batch, n_st), case=case)

    def hold_condense(args2, case):
        e, Gam = condense_cuda(*args2)
        ep, Gamp = condense_ref(*args2)
        err = compare("condense", [("e", e, ep), ("Gamma", Gam, Gamp)])
        record("condense", err, functools.partial(condense_cuda, *args2),
               functools.partial(condense_ref, *args2), nbytes(*args2, e, Gam),
               condense_ops(args2[0].shape[0]), case=case)
        return e, Gam

    chol = {"cholesky": (cholesky_cuda, cholesky_ref),
            "cholesky_unblocked": (cholesky_unblocked_cuda, cholesky_unblocked_ref)}
    solve = {"chol_solve": (chol_solve_cuda, chol_solve_ref),
             "chol_solve_unblocked": (chol_solve_unblocked_cuda, chol_solve_unblocked_ref)}

    def chol_ops(batch):
        return batch * (NZ ** 3 / 3 + NZ ** 2)

    def hold_cholesky(name, H, case):
        """A factor kernel against its plain version; bytes: the lower
        triangle of H read, the whole L written (its strict upper triangle is
        0). torch.linalg.cholesky_ex is the library yardstick;
        torch.linalg.cholesky, which synchronizes with the host on CUDA, is
        timed beside it per call."""
        kern, plain = chol[name]
        Lk = kern(H)
        err = compare(name, [("L", Lk, plain(H))])
        check(int(torch.count_nonzero(torch.triu(Lk, 1))) == 0, f"{name}: nonzero upper triangle")
        record(name, err, functools.partial(kern, H), functools.partial(plain, H),
               tri_bytes(NZ, H.shape[0]) + nbytes(Lk), chol_ops(H.shape[0]),
               library=functools.partial(torch.linalg.cholesky_ex, H),
               library_sync=functools.partial(torch.linalg.cholesky, H), case=case)
        return Lk

    def hold_solve(name, Lk, b, case):
        """A solve kernel on its factor; it reads L's lower triangle and b,
        writes x."""
        kern, plain = solve[name]
        x = kern(Lk, b)
        err = compare(name, [("x", x, plain(Lk, b))])
        record(name, err, functools.partial(kern, Lk, b), functools.partial(plain, Lk, b),
               tri_bytes(NZ, b.shape[0]) + nbytes(b, x), b.shape[0] * 2 * NZ * NZ,
               library=functools.partial(torch.cholesky_solve, b[..., None], Lk), case=case)

    def ipm_ops(batch):
        # two directions of con_tmul + fwd/bwd substitution + con_mul, plus
        # ~60 elementwise operations per constraint row
        return batch * (2 * (4 * NCG * NZ + 2 * NZ * NZ) + 60 * NC)

    def hold_ipm(qp, carry, nt, Lk, case):
        """K4's first IPM iteration of `qp` on the factor Lk; of L only its
        lower triangle is read."""
        args = k4_args(qp, carry, nt, Lk)
        kc, ksig, kunc = fused_iteration_cuda(*args, carry)
        pc, psig, punc = iteration_ref(*args, carry)
        err = compare("ipm_iteration", list(zip(CARRY + ("sigma",), kc + (ksig,), pc + (psig,))))
        check(torch.equal(kunc, punc), f"ipm_iteration/{case}: unconverged flags differ")
        record("ipm_iteration", err, functools.partial(fused_iteration_cuda, *args, carry),
               functools.partial(iteration_ref, *args, carry),
               tri_bytes(NZ, Lk.shape[0]) + nbytes(*args[1:], *carry, *kc, ksig, kunc),
               ipm_ops(Lk.shape[0]), case=case)

    # K1: linearize at curvature-consistent states spread along the lap
    ctrl = build_controller(MPCConfig(), SimConfig(), device=dev)
    lr = ctrl.engine.funcs.lin_rollout
    traj = load_ref_trajectory(os.path.join(SimConfig().trajectory_path,
                                            SimConfig().ref_traj_file), torch.float64,
                               device="cpu")
    x0, XU = lap_inputs(B)
    J = hold_linearize(XU, lr, "nominal")

    # K2: condense the sensitivities K1 just produced
    args2 = condense_inputs(J)
    A_, B_, xi, d0 = args2
    e, Gam = hold_condense(args2, "nominal")

    # K8 on the same inputs: one augmented (B, N+1, nx, nz+1) output, held
    # per output (e, Gamma) against its plain version and bitwise against
    # K2's (K8 is K2's kernel with the augmented store); the same
    # active-triangle operation count. Then K8 at N = 64 (nz + 1 = 129
    # columns, five blocks a scenario) against its plain version.
    hold_k8(args2, (e, Gam), "nominal")
    k2_ms = device_ms(lambda: condense_cuda(A_, B_, xi, d0))
    k8_ms = results["condense_mxu"]["ms"]
    say(f"[condense_mxu] K2 again in the same place: {k2_ms:.5f} ms device; K8 / K2 "
        f"{k8_ms / k2_ms:.3f} (target <= 1.25)")
    results["condense_mxu"]["k2_ms_same_place"] = k2_ms
    rng64 = np.random.default_rng(64)
    t64 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    args64 = (t64(0.97 * np.eye(NX) + rng64.normal(0, 0.05, (B, 64, NX, NX))),
              t64(rng64.normal(0, 1, (B, 64, NX, NU))), t64(rng64.normal(0, 0.01, (B, 64, NX))),
              t64(rng64.normal(0, 0.1, (B, NX))))
    hold_k8(args64, condense_cuda(*args64), "n64")

    # K1 at SNMPC's shapes: one RK4 substep; the head rows are every copy of
    # the fanned state at the 5 head stages, the tail rows the nominal copy
    # at the other 33, in the order lin_structured builds them
    sctrl = build_controller(MPCConfig(controller="snmpc"), SimConfig(), device=dev)
    slr = sctrl.lin_roll8
    fan = sctrl._fan(x0.to(dev, torch.float32)).reshape(B, NS1, NX).double().cpu().numpy()
    Xs = fan[:, None] + rng.normal(0, 1, (B, N, NS1, NX)) * STATE_SPREAD
    Us = rng.normal(0, 1, (B, N, NU)) * [1.0, 0.1]
    head = np.concatenate([Xs[:, :UPH], np.broadcast_to(Us[:, :UPH, None], (B, UPH, NS1, NU))],
                          axis=-1).reshape(B, UPH * NS1, NX + NU)
    tail = np.concatenate([Xs[:, UPH:, 0], Us[:, UPH:]], axis=-1)
    XUs = torch.tensor(np.concatenate([head, tail], axis=1), dtype=torch.float32, device=dev)
    Js = hold_linearize(XUs, slr, "snmpc")

    # K6: SNMPC's nominal tail from a head carry, on the tail rows' K1
    # sensitivities; Gamma0 is nonzero in its first COL0 columns, as the
    # head's carry is
    At = Js[:, UPH * NS1:, :, :NX].contiguous()
    Bt = Js[:, UPH * NS1:, :, NX:].contiguous()
    xit = torch.tensor(rng.normal(0, 0.01, (B, N2, NX)), dtype=torch.float32, device=dev)
    e0 = torch.tensor(rng.normal(0, 0.1, (B, NX)), dtype=torch.float32, device=dev)
    G0 = np.zeros((B, NX, NZ))
    G0[..., :COL0] = rng.normal(0, 0.1, (B, NX, COL0))
    G0 = torch.tensor(G0, dtype=torch.float32, device=dev)
    args6 = (At, Bt, xit, e0, G0, COL0)
    e6, G6 = condense_from_cuda(*args6)
    e6p, G6p = condense_from_ref(*args6)
    err = compare("condense_from", [("e", e6, e6p), ("Gamma", G6, G6p)])
    # A_t Gam_t over the columns this carry fills (COL0 + t nu), e, and B
    ops = B * sum(2 * NX * NX * (COL0 + t * NU + 1) + 2 * NX * NU for t in range(N2))
    record("condense_from", err, lambda: condense_from_cuda(*args6),
           lambda: condense_from_ref(*args6), nbytes(At, Bt, xit, e0, G0, e6, G6), ops,
           case="snmpc")

    # K3, K5, K4 on one random QP's first IPM iteration
    qp = random_qp(rng, dev, B)
    carry, nt, H = ipm_start(qp)

    # K3 and K7 on the QP's H, K5 and the K7 solve on their factors
    factor = {name: hold_cholesky(name, H, "nominal") for name in chol}
    b = torch.tensor(rng.standard_normal((B, NZ)), dtype=torch.float32, device=dev)
    hold_solve("chol_solve", factor["cholesky"], b, "nominal")
    hold_solve("chol_solve_unblocked", factor["cholesky_unblocked"], b, "nominal")
    L = factor["cholesky"]

    # K3 and K7 on an ill-conditioned IPM-shaped H (cond up to ~1e8), where
    # two float32 orders of one factorization part by more than TOL: held by
    # backward error, to BACKWARD_TOL and to twice the plain version's own
    Hill = torch.tensor(ipm_shaped_h(rng, B, NZ, NCG), device=dev)
    for name, (kern, plain) in chol.items():
        Lk, Lp = kern(Hill), plain(Hill)
        check(bool(torch.isfinite(Lk).all()) and bool(torch.isfinite(Lp).all()),
              f"{name}/ill_conditioned: non-finite factor")
        check(int(torch.count_nonzero(torch.triu(Lk, 1))) == 0, f"{name}: nonzero upper triangle")
        be, be_plain = backward_error(Lk, Hill), backward_error(Lp, Hill)
        say(f"[{name}/ill_conditioned] max |L L^T - H| / max |H| {be:.3e}, plain version's "
            f"{be_plain:.3e} (tol {BACKWARD_TOL:.0e} and 2x the plain version's)")
        check(be <= BACKWARD_TOL and be <= 2.0 * be_plain,
              f"{name}/ill_conditioned: backward error {be:.3e} beyond the bound")
        e = float((Lk.double() - Lp.double()).abs().max())
        record(name, (e, {"L": e / float(Lp.abs().max())}), functools.partial(kern, Hill),
               functools.partial(plain, Hill), tri_bytes(NZ) + nbytes(Lk), chol_ops(B),
               library=functools.partial(torch.linalg.cholesky_ex, Hill), case="ill_conditioned",
               extra=dict(backward_err=be, plain_backward_err=be_plain))

    hold_ipm(qp, carry, nt, L, "nominal")

    # K4 at a late iteration: the same QP and carry with the float64 factor of
    # the ill-conditioned H above (sigma up to 10^6.5 on the hard rows)
    L_late = torch.tensor(np.linalg.cholesky(Hill.double().cpu().numpy()), dtype=torch.float32,
                          device=dev)
    args_l = k4_args(qp, carry, nt, L_late)
    kc, ksig, kunc = fused_iteration_cuda(*args_l, carry)
    pc, psig, punc = iteration_ref(*args_l, carry)
    qc, qsig, qunc = iteration_ref(*(a.double() for a in args_l), tuple(c.double() for c in carry))
    check(torch.equal(kunc, punc) and torch.equal(kunc, qunc),
          "ipm_iteration/late_iteration: unconverged flags differ")
    err, rel, vs64, plain_vs64 = 0.0, {}, {}, {}
    for label, k, p, q in zip(CARRY + ("sigma",), kc + (ksig,), pc + (psig,), qc + (qsig,)):
        scale = float(q.abs().max())
        vs64[label] = float((k.double() - q).abs().max()) / scale
        plain_vs64[label] = float((p.double() - q).abs().max()) / scale
        lim = max(TOL["ipm_iteration"], LATE_FACTOR * plain_vs64[label])
        check(bool(torch.isfinite(k).all()) and vs64[label] <= lim,
              f"ipm_iteration/late_iteration.{label}: {vs64[label]:.3e} of max |plain f64| from "
              f"the float64 plain version, beyond {lim:.3e}")
        e = float((k.double() - p.double()).abs().max())
        err, rel[label] = max(err, e), e / float(p.abs().max())
    worst = max(vs64, key=vs64.get)
    say(f"[ipm_iteration/late_iteration] against the float64 plain version, worst output {worst}:"
        f" kernel {vs64[worst]:.3e}, float32 plain version {plain_vs64[worst]:.3e} of its max "
        f"(held to max({TOL['ipm_iteration']:.0e}, {LATE_FACTOR:g}x the plain version's)); "
        f"largest plain f32 - f64 over the outputs {max(plain_vs64.values()):.3e}")
    record("ipm_iteration", (err, rel), functools.partial(fused_iteration_cuda, *args_l, carry),
           functools.partial(iteration_ref, *args_l, carry),
           tri_bytes(NZ) + nbytes(*args_l[1:], *carry, *kc, ksig, kunc), ipm_ops(B),
           case="late_iteration", extra=dict(err_vs_f64=vs64, plain_err_vs_f64=plain_vs64))

    # K1-K5 at the entry paths' batches, on inputs drawn as above: B = 1
    # (a grid of one block, most of its lanes idle) and the sweep's 52
    for batch in ENTRY_BATCHES:
        case = f"b{batch}"
        _, XUb = lap_inputs(batch)
        args2b = condense_inputs(hold_linearize(XUb, lr, case))
        k2b = hold_condense(args2b, case)
        if batch == 1:
            hold_k8(args2b, k2b, case)
        qpb = random_qp(rng, dev, batch)
        carryb, ntb, Hb = ipm_start(qpb)
        Lb = hold_cholesky("cholesky", Hb, case)
        hold_solve("chol_solve", Lb, torch.tensor(rng.standard_normal((batch, NZ)),
                                                  dtype=torch.float32, device=dev), case)
        hold_ipm(qpb, carryb, ntb, Lb, case)

    # K1 with one tire set per scenario (the batched population of
    # tools/fit_tires_es.py). First, bitwise: the kernel reading a table
    # whose every row holds the argument block's own tire values equals the
    # shared-tire launch, at the nominal shape
    prm = list(lr.prm)
    rows = torch.tensor([prm[i] for i in TABLE_SLOTS], dtype=torch.float32,
                        device=dev).expand(B, -1).contiguous()
    F1, J1 = linearize_cuda(XU, lr.prm, lr.n_sub)
    F2, J2 = linearize_cuda(XU, lr.prm, lr.n_sub, tires=rows)
    check(torch.equal(F1, F2) and torch.equal(J1, J2),
          "linearize: the table launch differs from the shared-tire launch on the same values")
    say("[linearize/tires] the table launch equals the shared-tire launch bit for bit")
    # then distinct tires: the shipped set times exp(theta_b), theta_b ~
    # N(0, 0.05^2) per scenario and coefficient, at the nominal shape and at
    # the SNMPC's at UPH 15 (15 x 11 head and 23 tail elements a scenario)
    tvals = np.exp(np.log(np.array(lr.tp[:8])) + rng.normal(0, 0.05, (B, 8)))
    tpB = TireParams(*torch.tensor(tvals.T, dtype=torch.float32, device=dev).unbind(0),
                     mu=lr.tp.mu)
    hold_linearize(XU, LinearizeRollout(lr.vp, tpB, lr.dt, lr.n_sub), "tires")
    head15 = np.concatenate([Xs[:, :UPH15], np.broadcast_to(Us[:, :UPH15, None],
                                                            (B, UPH15, NS1, NU))],
                            axis=-1).reshape(B, UPH15 * NS1, NX + NU)
    tail15 = np.concatenate([Xs[:, UPH15:, 0], Us[:, UPH15:]], axis=-1)
    XU15 = torch.tensor(np.concatenate([head15, tail15], axis=1), dtype=torch.float32, device=dev)
    J15 = hold_linearize(XU15, LinearizeRollout(lr.vp, tpB, slr.dt, 1), "snmpc_uph15_tires")

    # K6 at the UPH 15 tail: 23 stages from a carry dense in its first 30
    # columns, on the tail rows' K1 sensitivities
    n15, col15 = N - UPH15, UPH15 * NU
    At = J15[:, UPH15 * NS1:, :, :NX].contiguous()
    Bt = J15[:, UPH15 * NS1:, :, NX:].contiguous()
    xit = torch.tensor(rng.normal(0, 0.01, (B, n15, NX)), dtype=torch.float32, device=dev)
    e0 = torch.tensor(rng.normal(0, 0.1, (B, NX)), dtype=torch.float32, device=dev)
    G0 = np.zeros((B, NX, NZ))
    G0[..., :col15] = rng.normal(0, 0.1, (B, NX, col15))
    G0 = torch.tensor(G0, dtype=torch.float32, device=dev)
    args15 = (At, Bt, xit, e0, G0, col15)
    e6, G6 = condense_from_cuda(*args15)
    e6p, G6p = condense_from_ref(*args15)
    err = compare("condense_from", [("e", e6, e6p), ("Gamma", G6, G6p)])
    ops = B * sum(2 * NX * NX * (col15 + t * NU + 1) + 2 * NX * NU for t in range(n15))
    record("condense_from", err, lambda: condense_from_cuda(*args15),
           lambda: condense_from_ref(*args15), nbytes(At, Bt, xit, e0, G0, e6, G6), ops,
           case="uph15")

    # the plant's RK4 (one launch a closed-loop step) at PLANT_BATCHES, then
    # at B = 128 with a derivative disturbance and with one tire set per
    # scenario (its table); each state component held against the float32
    # plain version on the card, and printed against the float64 one
    def hold_plant(batch, tires, disturbed, case):
        plant, x, u, w = plant_case(batch, tires, dev, torch.float32)
        w = w if disturbed else None
        kern = functools.partial(plant_cuda, x, u, w, plant.prm, plant.n_sub, plant.table)
        plain = functools.partial(plant_ref, x, u, w, plant.vp, plant.tp, plant.dt, plant.n_sub)
        out, ref = kern(), plain()
        err = compare("plant", [(f"x[:, {i}]", out[:, i], ref[:, i]) for i in range(7)])
        p64, x64, u64, w64 = plant_case(batch, tires)
        ref64 = plant_ref(x64, u64, w64 if disturbed else None, p64.vp, p64.tp, p64.dt,
                          p64.n_sub)
        vs64 = max(float((out[:, i].double().cpu() - ref64[:, i]).abs().max())
                   / float(ref64[:, i].abs().max()) for i in range(7))
        say(f"[plant/{case}] against the float64 plain version: worst state {vs64:.3e} of its "
            "max")
        table = () if plant.table is None else (plant.table,)
        ops = batch * plant.n_sub * (4 * PLANT_ODE_OPS + 4 * 8 * 2)
        record("plant", err, kern, plain, nbytes(x, u, out, *table, *(() if w is None else (w,))),
               ops, case=case, extra=dict(max_rel_err_f64=vs64))

    for batch in PLANT_BATCHES:
        hold_plant(batch, "shared", False, f"b{batch}")
    hold_plant(B, "shared", True, "disturbed")
    hold_plant(B, "per", False, "tires")
    return results, jobs


def profile_kernels(results, jobs):
    """The profiler's device time per launch of each timed kernel case and
    its library call, over LAUNCHES_TIMED launches; it is the `library_ms`
    of a library call that synchronizes with the host. Run after the card's
    loops: a profiler session slows the host's launches for the rest of the
    process (on the H100 the nominal step took 73 ms after the kernel
    phase's profiler sessions, 43 ms with none before it)."""
    for name, i, kernel, library in jobs:
        case = results[name]["cases"][i]
        prof = {"ms_profiler": profiled_ms(kernel)}
        if library is not None:
            prof["library_ms_profiler"] = profiled_ms(library)
            if case["library_synchronizes"]:
                prof["library_ms"] = prof["library_ms_profiler"]
        case.update(prof)
        if i == 0:
            results[name].update(prof)
        fmt = lambda v: "not measured" if v is None else f"{v:.5f} ms"
        say(f"[{name}/{case['case']}] profiler: kernel {fmt(prof['ms_profiler'])} per launch "
            f"(events {case['ms']:.5f} ms)" + (f", library {fmt(prof['library_ms_profiler'])}"
                                               if library is not None else ""))


def move_carry(carry, device, dtype):
    """A copy of a SimCarry on `device` with its floating tensors in `dtype`
    and a fresh disturbance generator (the smoke configuration draws none)."""
    from tum_control_tpu_torch.sim.closed_loop import make_generator

    def mv(v):
        if isinstance(v, torch.Tensor):
            return v.to(device, dtype if v.is_floating_point() else v.dtype, copy=True)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(mv(a) for a in v))
        return v
    return mv(carry)._replace(key=make_generator(0, device))


def check_launches(path, launches):
    """The path's kernels, and no other, were launched."""
    for name, n in launches.items():
        if name in PATH_KERNELS[path]:
            check(n > 0, f"kernel {name} was not launched on the {path} path")
        else:
            check(n == 0, f"kernel {name} was launched on the {path} path, which does not run it")


def stacked_laps(tracks, device, dtype):
    from tum_control_tpu_torch.config import SimConfig
    from tum_control_tpu_torch.track.trajectory import load_ref_trajectory, stack_trajectories

    path = SimConfig().trajectory_path
    return stack_trajectories([
        load_ref_trajectory(os.path.join(path, f"reftraj_{t}_edgar.json"), dtype=dtype,
                            device=device) for t in tracks])


def make_env(device, dtype):
    """The RL env of the ppo path: nominal NMPC, one lap per env."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.learn.env import RLEnv, RLEnvConfig
    from tum_control_tpu_torch.learn.observation import ObservationConfig
    from tum_control_tpu_torch.learn.wmpc import load_param_table

    sim_cfg = SimConfig(sim_mode=0)
    sim = build_simulation(sim_cfg, MPCConfig(), device=device, dtype=dtype)[0]
    table = load_param_table(os.path.join(REPO, "data", "F.csv"))
    return RLEnv(sim, stacked_laps(TRACKS_PPO, device, dtype), table,
                 ObservationConfig(Ts=sim_cfg.Ts), RLEnvConfig(n_mpc_steps=PPO_MPC_STEPS))


def ppo_phase(dev):
    """PPO training of the WMPC policy on the card, counters reset just
    before and read just after; then 3 env steps."""
    from tum_control_tpu_torch.learn.policy import load_sb3_policy, save_policy_npz
    from tum_control_tpu_torch.learn.ppo import EvalCallback, PPOConfig, PPOTrainer
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.sim.closed_loop import make_generator

    env = make_env(dev, torch.float32)
    trainer = PPOTrainer(env, PPOConfig(**PPO), seed=0)
    params0 = [p.detach().clone() for p in trainer.policy.parameters()]
    out = os.path.join(OUT_DIR, "ppo")
    for f in ("evaluations.npz", "policy_weights.npz", "best_model/policy_weights.npz"):
        if os.path.exists(os.path.join(out, f)):
            os.remove(os.path.join(out, f))
    # one evaluation: eval_freq 2 evaluates after update 0 of the 2
    callback = EvalCallback(trainer, out, eval_freq=2, n_envs=PPO["n_envs"],
                            n_steps=PPO["n_steps"])
    build.reset_launches()
    history = trainer.train(PPO_UPDATES, seed=1, callback=callback)
    launches = dict(build.LAUNCHES)
    save_policy_npz(trainer.policy, os.path.join(out, "policy_weights.npz"))
    say(f"[ppo] launches over {PPO_UPDATES} updates and one evaluation: {json.dumps(launches)}")
    check_launches("ppo", launches)
    say(f"[ppo] metrics {history}")
    for m in history:
        check(all(np.isfinite(v) for v in m.values()), f"ppo: non-finite metrics {m}")
        check(0.0 < m["reward_mean"] <= 1.0, f"ppo: mean reward {m['reward_mean']} not in (0, 1]")
    changed = max(float((p.detach() - q).abs().max())
                  for p, q in zip(trainer.policy.parameters(), params0))
    check(changed > 0.0, "ppo: the policy's parameters did not change")
    for f in ("policy_weights.npz", "evaluations.npz", "best_model/policy_weights.npz"):
        check(os.path.exists(os.path.join(out, f)), f"ppo: {f} was not written")
    check(len(callback.history) == 1, f"ppo: {len(callback.history)} evaluations, not one")
    best = load_sb3_policy(os.path.join(out, "best_model", "policy_weights.npz"), device=dev)
    check(best.n_actions == env.n_actions, "ppo: the best model has another action count")

    # env steps from fresh envs; the carry before the last one is kept for
    # the CPU hold
    es, obs = env.reset(PPO["n_envs"], make_generator(2, dev))
    actions = torch.randint(0, env.n_actions, (4, PPO["n_envs"]),
                            generator=make_generator(3, dev), device=dev)
    es, obs, _, _ = env.step(es, actions[0])
    for a in actions[1:3]:
        es, obs, reward, done = env.step(es, a)
    check(bool(((reward > 0) & (reward <= 1)).all()), "ppo: an env reward outside (0, 1]")
    check(bool(torch.isfinite(obs).all()), "ppo: non-finite observations")
    return dict(launches=launches, env=env, es=es, action=actions[3])


def bo_phase(dev):
    """The BO of the cost weights on the card: initial Sobol data and one
    step, counters reset just before and read just after; then one
    objective chunk of BO_CHUNK scenarios."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.learn.bo.objective import ObjectiveEvaluator, make_segment_batch
    from tum_control_tpu_torch.learn.bo.optimizer import BayesianOptimizer, BOConfig
    from tum_control_tpu_torch.learn.bo.segmentation import get_train_segments
    from tum_control_tpu_torch.ops.kernels import build

    sim = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device=dev,
                           dtype=torch.float32)[0]
    evaluator = ObjectiveEvaluator(sim, stacked_laps(TRACKS_BO, dev, torch.float32),
                                   max_steps=BO_MAX_STEPS, chunk=BO_CHUNK)
    groups = get_train_segments(tracks=TRACKS_BO)
    check([len(g) for g in groups] == [10, 10], f"bo: segment groups {[len(g) for g in groups]}")
    segs = [make_segment_batch(g, list(TRACKS_BO), dev) for g in groups]
    bo = BayesianOptimizer([functools.partial(evaluator.evaluate, seg=s) for s in segs],
                           BOConfig(**BO), seed=0, device=dev)
    build.reset_launches()
    bo.generate_initial_data()
    bo.step(0)
    launches = dict(build.LAUNCHES)
    say(f"[bo] launches over the initial data and one step: {json.dumps(launches)}")
    check_launches("bo", launches)
    say(f"[bo] one step: {len(bo._gp_warm)} GP fits")
    n_trials = BO["n_initial"] + BO["batch_size"]
    check(len(bo.trials) == n_trials, f"bo: {len(bo.trials)} trials, not {n_trials}")
    for t in bo.trials:
        for g in range(2):
            finite = bool(np.isfinite(t.objectives[g]).all())
            check(finite == bool(t.feasible[g]),
                  f"bo: objectives {t.objectives[g]} against feasible {t.feasible[g]}")
    hv = [bo.hypervolume(g) for g in range(2)]
    feas = [sum(bool(t.feasible[g]) for t in bo.trials) for g in range(2)]
    check(all(np.isfinite(hv)), f"bo: hypervolume {hv}")
    say(f"[bo] trials {len(bo.trials)}, feasible per group {feas}, hypervolume {hv}")

    # one full chunk: the initial candidates x both groups' segments, the
    # first BO_CHUNK pairs
    P = torch.tensor(np.stack([t.params for t in bo.trials[:BO["n_initial"]]]),
                     dtype=torch.float32, device=dev)
    tr = torch.cat([s.track for s in segs])
    st = torch.cat([s.start for s in segs])
    en = torch.cat([s.end for s in segs])
    S = tr.shape[0]
    pairs = (P.repeat_interleave(S, 0)[:BO_CHUNK], tr.repeat(len(P))[:BO_CHUNK],
             st.repeat(len(P))[:BO_CHUNK], en.repeat(len(P))[:BO_CHUNK])
    f, feasible = evaluator.run_chunk(*pairs)
    group = (torch.arange(BO_CHUNK, device=dev) % S >= segs[0].track.shape[0]).long()
    per_group = [f"{int(feasible[group == g].sum())} of {int((group == g).sum())}" for g in range(2)]
    say(f"[bo] objective chunk of {BO_CHUNK} scenarios x {BO_MAX_STEPS} steps: feasible pairs "
        f"per group {per_group}")
    check(bool((torch.isfinite(f).all(dim=1) == feasible).all()),
          "bo: the chunk's objectives are not finite exactly where feasible")
    return dict(launches=launches, pairs=pairs, f=f, feasible=feasible, group=group)


def ppo_cpu_check(run):
    """One env step from the card's env state and the CPU float64 (and
    float32) env step from the same state, with the same actions and reset
    draws: obs and reward held to TOL_ENV."""
    env, es, action = run["env"], run["es"], run["action"]
    draws = env.draw_reset(es.key, action.shape[0])
    cards = env.step(es, action, draws)
    out = {}
    for dt in (torch.float64, torch.float32):
        cenv = make_env("cpu", dt)
        ces = es._replace(carry=move_carry(es.carry, "cpu", dt), t=es.t.cpu(),
                          track=es.track.cpu(), key=None)
        out[dt] = cenv.step(ces, action.cpu(), tuple(d.cpu() for d in draws))
    for i, name in ((1, "obs"), (2, "reward")):
        card = cards[i].double().cpu()
        e64 = float((card - out[torch.float64][i]).abs().max())
        e32 = float((out[torch.float32][i].double() - out[torch.float64][i]).abs().max())
        say(f"[cpu/ppo] env step ({action.shape[0]} envs, {PPO_MPC_STEPS} closed-loop steps): "
            f"max |{name} card - cpu f64| {e64:.3e}, cpu f32 - cpu f64 {e32:.3e} "
            f"(tol {TOL_ENV:.0e})")
        check(e64 <= TOL_ENV, f"ppo: {name} of the card's env step {e64:.3e} from the CPU "
                              f"float64 step, beyond {TOL_ENV:.0e}")
    check(torch.equal(cards[3].cpu(), out[torch.float64][3]), "ppo: done differs from the CPU's")


def bo_cpu_check(run):
    """Three of the chunk's (candidate, segment) rollouts again on the CPU in
    float64 from the same starts, in one batch: the first pair the card
    counts feasible on group 0, and the first it counts feasible and the
    first it counts infeasible on group 1 (the straights, where the
    candidates crash). Feasibility equal to the card's, and f0, f1 within
    TOL_OBJ where feasible."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.learn.bo.objective import ObjectiveEvaluator

    sim = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device="cpu",
                           dtype=torch.float64)[0]
    ev = ObjectiveEvaluator(sim, stacked_laps(TRACKS_BO, "cpu", torch.float64),
                            max_steps=BO_MAX_STEPS)
    feasible, group = run["feasible"].cpu(), run["group"].cpu()
    picks = []
    for label, mask in (("group 0, feasible", (group == 0) & feasible),
                        ("group 1, feasible", (group == 1) & feasible),
                        ("group 1, infeasible", (group == 1) & ~feasible)):
        if bool(mask.any()):
            picks.append((label, int(torch.nonzero(mask)[0])))
        else:
            say(f"[cpu/bo] the chunk has no pair of {label}")
    check(len(picks) > 0, "bo: no pair to hold against the CPU")
    idx = torch.tensor([i for _, i in picks])
    p, tr, st, en = (a.cpu()[idx] for a in run["pairs"])
    f64, feas64 = ev.run_chunk(p.double(), tr, st, en)
    card = run["f"].double().cpu()[idx]
    for k, (label, i) in enumerate(picks):
        err = float((card[k] - f64[k]).abs().max()) if bool(feas64[k]) else 0.0
        say(f"[cpu/bo] pair {i} ({label}; lap {int(tr[k])}, segment {int(st[k])}..{int(en[k])}): "
            f"card {card[k].tolist()}, cpu f64 {f64[k].tolist()}, max |difference| {err:.3e} "
            f"(tol {TOL_OBJ:.0e})")
        check(bool(feas64[k]) == bool(feasible[i]),
              f"bo: pair {i}'s feasibility on the card differs from the CPU float64 run's")
        check(err <= TOL_OBJ, f"bo: pair {i}'s objective {err:.3e} from the CPU float64 run")


def loop_phase(dev, path):
    """Drives one controller's closed loop on the card; the launch counters
    are reset just before the settle run and read just after the second
    run. Returns what the CPU re-solve needs."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    settle, steps, _ = PATHS[path]
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(**PATH_CONFIG[path]),
                                          device=dev, dtype=torch.float32)
    x0m, x0s = batched_scenarios(traj, B, dtype=torch.float32, device=dev)
    carry = sim.init_carry(x0m, x0s, key=0)
    carry0 = move_carry(carry, "cpu", torch.float32)

    build.reset_launches()
    carry, log_settle = sim.run_from(carry, settle)
    carry, log = sim.run_from(carry, steps)
    launches = dict(build.LAUNCHES)
    say(f"[loop/{path}] launches over {settle + steps} steps: {json.dumps(launches)}")
    check_launches(path, launches)

    for lg in (log_settle, log):
        for f, v in lg._asdict().items():
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"{path}: non-finite values in SimLog.{f}")
    status = log.simSolverDebug[..., 4]
    ok = float((status == 0).float().mean())
    say(f"[loop/{path}] solver ok fraction {ok:.5f}")
    check(ok >= 0.99, f"{path}: solver ok fraction {ok} < 0.99")
    # after the window: steps that may not synchronize with the host (WMPC:
    # one policy period, so that an update falls inside)
    n_sync = getattr(sim.controller, "period", 1)
    without_sync(lambda: sim.run_from(carry, n_sync), f"loop/{path}", n_sync)
    act = log.wmpc_action
    if PATH_CONFIG[path].get("enable_WMPC"):
        check(bool((act >= 0).all()), f"{path}: a WMPC step logged no action")
        change = act[:, 1:] != act[:, :-1]
        hist = torch.bincount(act.flatten().long().cpu(), minlength=sim.controller.policy.n_actions)
        say(f"[loop/{path}] weight switches in the last {steps} steps: {int(change.any(0).sum())} "
            f"steps switched in some scenario, {int(change.sum())} (scenario, step) switches; "
            f"action histogram over (scenario, step) {hist.tolist()}")
    else:
        check(bool((act == -1).all()), f"{path}: actions logged without WMPC")
    return dict(launches=launches, sim=sim, carry0=carry0)


def without_sync(fn, tag, n_steps):
    """fn() under torch.cuda.set_sync_debug_mode("error"), where every
    operation that makes the host wait for the card raises (a tensor made
    from host data, a copy to the host, .item(), a stream synchronize).
    Returns fn's result."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    say(f"[sync/{tag}] {n_steps} step(s) under sync debug mode 'error': no host sync")
    return out


def cpu_phase(path, sim, carry, n, sim_cfg, mpc_cfg, inputs=None):
    """`n` steps of the card's `sim` from its `carry` (on the card), each
    again on the CPU, where the port takes its plain versions, in float32
    and float64 (simulations of `sim_cfg`, `mpc_cfg`) from the card's own
    carry at that step: the card's simU is held to each within TOL_U of the
    window's max |simU f64| per input, in every scenario and step, except
    that where the CPU's float32 step itself lies beyond TOL_U of its
    float64 step (a float32 flip), the card is held to the float32 step
    alone, within the largest card - cpu f64 of the other pairs. Under WMPC
    the card's actions must equal the CPU float64 run's and its action
    probabilities lie within TOL_PROB of them. `inputs(sim, carry, k)`
    gives step k's disturbance rows and keyword arguments (per-scenario laps
    and weights) for `sim`, the card's or a CPU one; by default none.

    A free run from the same initial states is no such yardstick: within 20
    steps a few scenarios of two float32 runs drift apart by O(1) in jerk
    (a 3-iteration IPM per step amplifies roundoff along the trajectory)."""
    from tum_control_tpu_torch.api import build_simulation

    wmpc = mpc_cfg.enable_WMPC
    f32, f64 = torch.float32, torch.float64
    dts = (f32, f64)
    cpu = {dt: build_simulation(sim_cfg, mpc_cfg, device="cpu", dtype=dt)[0] for dt in dts}

    def step(s, c, k):
        if inputs is None:
            zero = torch.zeros_like(c.x_sim)
            return s.step(c, zero, zero)
        w_d, w_s, kw = inputs(s, c, k)
        return s.step(c, w_d, w_s, **kw)

    U = {"card": [], **{dt: [] for dt in dts}}
    acts = {"card": [], f64: []}
    probs = {"card": [], f64: []}
    margins = []
    for k in range(n):
        here = move_carry(carry, "cpu", f32)
        carry, lg = step(sim, carry, k)
        U["card"].append(lg.simU.double().cpu())
        acts["card"].append(lg.wmpc_action.cpu())
        if wmpc:
            probs["card"].append(
                sim.controller.policy.action_probabilities(carry.extra.obs).double().cpu())
        for dt in dts:
            c_dt, lg_dt = step(cpu[dt], move_carry(here, "cpu", dt), k)
            U[dt].append(lg_dt.simU.double())
            if dt == f64:
                acts[f64].append(lg_dt.wmpc_action)
                if not wmpc:
                    continue
                ctrl = cpu[f64].controller
                probs[f64].append(ctrl.policy.action_probabilities(c_dt.extra.obs))
                if bool((here.extra.steps >= ctrl.period).any()):
                    # a policy update this step: how far the argmax is from a tie
                    top2 = torch.topk(ctrl.policy.logits(c_dt.extra.obs), 2).values
                    margins.append(float((top2[:, 0] - top2[:, 1]).min()))
    U = {k: torch.stack(v, dim=1) for k, v in U.items()}   # (B, n, nu)
    acts = {k: torch.stack(v, dim=1) for k, v in acts.items()}
    if wmpc:
        check(len(margins) > 0, f"{path}: no policy update in the {n} re-solved steps")
        same = torch.equal(acts["card"], acts[f64])
        say(f"[cpu/{path}] actions card = cpu f64 in every scenario and step: {same}; "
            f"{len(margins)} policy update(s) in the window, smallest top-2 logit margin "
            f"{min(margins):.4e}")
        check(same, f"{path}: the card's WMPC actions differ from the CPU float64 run's")
        gap = float((torch.stack(probs["card"]) - torch.stack(probs[f64])).abs().max())
        say(f"[cpu/{path}] max |action probability card - cpu f64| {gap:.3e} "
            f"(tol {TOL_PROB:.0e})")
        check(gap <= TOL_PROB, f"{path}: the card's action probabilities {gap:.3e} from the "
                               f"CPU float64 run's")
    scale = U[f64].abs().amax(dim=(0, 1))
    say(f"[cpu/{path}] {n} steps x {U[f64].shape[0]} scenarios, each from the card's carry, on "
        f"the CPU; max |simU f64| per input {scale.tolist()}")
    pairs = [("card - cpu f64", "card", f64), ("card - cpu f32", "card", f32),
             ("cpu f32 - cpu f64", f32, f64)]
    flips = ((U[f32] - U[f64]).abs() > TOL_U * scale).any(dim=2)
    held = {}
    for label, a, b in pairs:
        d = (U[a] - U[b]).abs()
        worst = d.amax(dim=(0, 1))
        s, k = divmod(int(d.amax(dim=2).argmax()), n)
        if b is f64:
            d = d.masked_fill(flips[..., None], 0.0)
        held[label] = d.amax(dim=(0, 1))
        say(f"[cpu/{path}] max |simU {label}| per input {worst.tolist()}, "
            f"{(worst / scale).tolist()} of max |simU| (tol {TOL_U:.0e}; worst at "
            f"scenario {s}, step {k}); held {(held[label] / scale).tolist()}")
    limit = float((held["card - cpu f64"] / scale).max())
    for s, k in torch.nonzero(flips).tolist():
        off = (U["card"][s, k] - U[f32][s, k]).abs() / scale
        say(f"[cpu/{path}] float32 flip at scenario {s}, step {k}: cpu f32 - cpu f64 "
            f"{((U[f32][s, k] - U[f64][s, k]).abs() / scale).tolist()} of max |simU|, "
            f"card - cpu f32 {off.tolist()} (held to {limit:.3e}, the largest card - cpu f64 "
            f"of the other pairs)")
        check(float(off.max()) <= limit,
              f"{path}: at the float32 flip ({s}, {k}) the card lies {float(off.max()):.3e} from "
              f"the float32 step, beyond {limit:.3e}")
    check(int(flips.sum()) <= MAX_F32_FLIPS,
          f"{path}: {int(flips.sum())} float32 flips, more than {MAX_F32_FLIPS}")
    for label, worst in held.items():
        check(bool((worst <= TOL_U * scale).all()),
              f"{path}: max |simU {label}| beyond the tolerance")


def shipped_configs(**sim_kw):
    """The shipped EDGAR/sim_main_params.yaml and MPC_params.yaml, as
    `python -m tum_control_tpu_torch.main` loads them, with `sim_kw` set."""
    import dataclasses

    from tum_control_tpu_torch.config import (
        DEFAULT_CONFIG_PATH, load_mpc_config, load_sim_config,
    )
    sim = load_sim_config(os.path.join(DEFAULT_CONFIG_PATH, "EDGAR", "sim_main_params.yaml"))
    mpc = load_mpc_config(os.path.join(DEFAULT_CONFIG_PATH, "EDGAR", "MPC_params.yaml"))
    return dataclasses.replace(sim, **sim_kw), mpc


def check_full_logs(path, n, tag):
    """A full_logs.npz as the reference Logger writes it: the 14 names at
    their shapes for n steps, all finite, the solve times > 0."""
    logs = np.load(path)
    check(sorted(logs.files) == sorted(FULL_LOGS), f"{tag}: full_logs.npz holds {logs.files}")
    for k, (extra, *width) in FULL_LOGS.items():
        shape = (n + extra, *width)
        check(logs[k].shape == shape, f"{tag}: {k} has shape {logs[k].shape}, not {shape}")
        check(bool(np.isfinite(logs[k]).all()), f"{tag}: non-finite values in {k}")
    check(bool((logs["simSolverDebug"][:, 1] > 0).all()), f"{tag}: a solve time is not > 0")


def entry_phase(dev):
    """The user-facing entry points on the card, each with the counters reset
    just before and read just after: main.py's run_main (B = 1) with plots
    off, the same recorded with both disturbance kinds and replayed from its
    full_logs.npz with another seed, the baseline sweep's entry module (52
    scenarios), and run_policy with action_probability_trace."""
    import dataclasses
    import shutil

    from tum_control_tpu_torch import get_baseline_performances as sweep_entry
    from tum_control_tpu_torch import main as entry_main
    from tum_control_tpu_torch.eval.logger import save_logs
    from tum_control_tpu_torch.learn.evaluation import action_probability_trace, run_policy
    from tum_control_tpu_torch.ops.kernels import build

    out = os.path.join(OUT_DIR, "entry")
    shutil.rmtree(out, ignore_errors=True)
    warm = entry_main.WARMUP_STEPS
    runs = {}

    # main: the shipped configs, T cut to MAIN_T
    cfg, mpc = shipped_configs(T=MAIN_T, file_logs_name="main")
    n = cfg.Nsim
    build.reset_launches()
    logs, summary, _ = entry_main.run_main(cfg, mpc, device=dev, logs_path=out,
                                           make_plots=False)
    launches = dict(build.LAUNCHES)
    say(f"[entry/main] launches over {n} steps and the {warm}-step warm-up: "
        f"{json.dumps(launches)}")
    check_launches("main", launches)
    (path,) = [os.path.join(out, d, "full_logs.npz") for d in os.listdir(out)
               if d.startswith("main")]
    check_full_logs(path, n, "main")
    ok = summary["solver_ok_frac"]
    check(ok >= 0.99, f"main: solver ok fraction {ok} < 0.99")
    say(f"[entry/main] B=1, {n} steps: solver ok {ok:.4f}, |lat_dev| max "
        f"{summary['dev_lat_max']:.4f} m, mean {summary['dev_lat_mean']:.4f} m")
    runs["main"] = dict(launches=launches, steps=n + warm, cfg=cfg, mpc=mpc)

    # main with playback: record, then replay from the recording's file
    rec_cfg, _ = shipped_configs(T=PLAYBACK_T, simulate_disturbances=True,
                                 simulate_state_estimation=True, save_logs=False)
    n = rec_cfg.Nsim
    build.reset_launches()
    rec, _, _ = entry_main.run_main(rec_cfg, mpc, device=dev, logs_path=out, seed=3,
                                    make_plots=False)
    rec_file = os.path.join(out, "recording", "full_logs.npz")
    save_logs(rec, rec_file)
    play_cfg = dataclasses.replace(rec_cfg, disturbance_playback=True,
                                   playback_log_file=rec_file)
    play, summary, _ = entry_main.run_main(play_cfg, mpc, device=dev, logs_path=out,
                                           seed=11, make_plots=False)
    launches = dict(build.LAUNCHES)
    say(f"[entry/main_playback] launches over 2 x ({n} steps and the warm-up): "
        f"{json.dumps(launches)}")
    check_launches("main_playback", launches)
    for k in ("sim_disturbance_derivatives", "sim_disturbance_state_estimation"):
        check(float(np.abs(rec[k]).max()) > 0, f"main_playback: the recording's {k} is zero")
        check(np.array_equal(play[k], rec[k]), f"main_playback: the replayed {k} differs")
    for k, v in rec.items():
        check(bool(np.isfinite(v).all()), f"main_playback: non-finite values in {k}")
    gap = float(np.abs(play["CiLX"] - rec["CiLX"]).max())
    scale = float(np.abs(rec["CiLX"]).max())
    say(f"[entry/main_playback] {n} steps replayed with another seed: "
        f"disturbances equal, max |CiLX replay - recording| {gap:.3e} ({gap / scale:.3e} of "
        f"max |CiLX|, tol {TOL_PLAYBACK:.0e}); solver ok {summary['solver_ok_frac']:.4f}")
    check(gap <= TOL_PLAYBACK * scale, f"main_playback: CiLX {gap:.3e} from the recording")
    runs["main_playback"] = dict(launches=launches, steps=2 * (n + warm), cfg=play_cfg)

    # the baseline sweep through its entry module
    sweep_dir = os.path.join(out, "baseline")
    n = int(SWEEP_T / 0.02)
    build.reset_launches()
    summaries = sweep_entry.main(["--T", str(SWEEP_T), "--tracks", *SWEEP_TRACKS,
                                  "--out", sweep_dir, "--device", str(dev)])
    launches = dict(build.LAUNCHES)
    say(f"[entry/sweep] launches over {n} steps: {json.dumps(launches)}")
    check_launches("sweep", launches)
    n_sets = len(summaries[0])
    for track, summ in zip(SWEEP_TRACKS, summaries):
        files = sorted(os.listdir(os.path.join(sweep_dir, track)))
        check(files == sorted([f"{i}.npz" for i in range(n_sets)] + ["summary.csv"]),
              f"sweep: {track} holds {files}")
        for i in range(n_sets):
            d = np.load(os.path.join(sweep_dir, track, f"{i}.npz"))
            check(d["lat_devs"].shape == (n,) and d["simU"].shape == (n, 2)
                  and d["status"].shape == (n,) and d["params"].shape == (7,),
                  f"sweep: {track}/{i}.npz shapes")
            for k in d.files:
                check(bool(np.isfinite(d[k]).all()), f"sweep: non-finite {k} in {track}/{i}")
        say(f"[entry/sweep] {track}: solver ok fraction over the {n_sets} sets "
            f"{float(summ[:, 2].mean()):.4f} (lowest set {float(summ[:, 2].min()):.4f}); "
            f"max |lat_dev| range [{float(summ[:, 0].min()):.4f}, {float(summ[:, 0].max()):.4f}]"
            f" m")
    runs["sweep"] = dict(launches=launches, steps=n)

    # the policy: a lap of run_policy, then the action-probability trace
    n = int(POLICY_T / 0.02)
    build.reset_launches()
    logs, summary = run_policy(WMPC_MODEL, T=POLICY_T, device=dev)
    probs, actions = action_probability_trace(WMPC_MODEL, T=POLICY_T, device=dev)
    launches = dict(build.LAUNCHES)
    say(f"[entry/policy] launches over 2 x {n} steps: {json.dumps(launches)}")
    check_launches("policy", launches)
    act = logs["RL_actions"]
    check(act.shape == (n,) and bool(((act >= 0) & (act < 26)).all()),
          f"policy: RL_actions outside [0, 26): {act}")
    for k, v in logs.items():
        check(bool(np.isfinite(v).all()), f"policy: non-finite values in {k}")
    check(probs.shape == (n, 26) and bool(np.isfinite(probs).all()),
          "policy: action probabilities not finite or of another shape")
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    check(row_err <= 1e-5, f"policy: a probability row sums to 1 +- {row_err:.3e}")
    say(f"[entry/policy] run_policy {n} steps: summary {summary}; actions "
        f"{sorted(set(act.tolist()))}, trace actions equal: {np.array_equal(actions, act)}; "
        f"max |sum of a probability row - 1| {row_err:.3e}")
    runs["policy"] = dict(launches=launches, steps=2 * n)
    entry_holds(dev, runs, rec)
    return runs


def entry_holds(dev, runs, rec):
    """Each entry path's closed loop again on the card, set up for
    cpu_phase (`runs[path]["hold"]`): main from HOLD_LAP_POINT,
    main_playback from the shipped configs' initial state fed the recorded
    disturbances (a step's disturbance moves the plant, and so the next
    step's solve), the sweep's 52 scenarios on their laps under their
    weights, and the policy from HOLD_LAP_POINT after its first
    ENTRY_CPU["policy"][0] steps, so that its first update falls inside the
    window."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.get_baseline_performances import sweep_start
    from tum_control_tpu_torch.learn.evaluation import lap_config
    from tum_control_tpu_torch.learn.wmpc import load_param_table
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    def hold(path, sim_cfg, mpc_cfg, inputs=None, key=0, corner=True):
        sim, x0m, x0s, traj, _ = build_simulation(sim_cfg, mpc_cfg, device=dev)
        start = sim.init_carry(x0m[None], x0s[None], key=key)
        carry = start
        if corner:
            xm, xs = batched_scenarios(traj, traj.n_points)
            carry = sim.init_carry(xm[None, HOLD_LAP_POINT], xs[None, HOLD_LAP_POINT], key=key)
        settle, n = ENTRY_CPU[path]
        if settle:
            carry, _ = sim.run_from(carry, settle)
        runs[path]["hold"] = dict(sim=sim, carry=carry, n=n, sim_cfg=sim_cfg, mpc_cfg=mpc_cfg,
                                  inputs=inputs)

    hold("main", runs["main"]["cfg"], runs["main"]["mpc"])

    def playback(s, c, k):
        row = lambda name: torch.as_tensor(rec[name][k][None], dtype=c.x_sim.dtype,
                                           device=c.x_sim.device)
        return (row("sim_disturbance_derivatives"), row("sim_disturbance_state_estimation"), {})
    check(ENTRY_CPU["main_playback"][1] <= len(rec["CiLX"]) - 1,
          "main_playback: the CPU hold is longer than the recording")
    hold("main_playback", runs["main_playback"]["cfg"], runs["main"]["mpc"], playback, key=11,
         corner=False)

    table = load_param_table(os.path.join(REPO, "data", "F.csv"))
    laps = {}

    def sweep_inputs(s, c, k):
        if s not in laps:
            laps[s] = sweep_start(s, table, stacked_laps(SWEEP_TRACKS, c.x_sim.device,
                                                         c.x_sim.dtype))[1:]
        zero = torch.zeros_like(c.x_sim)
        return zero, zero, dict(zip(("traj", "mods"), laps[s]))
    sim_cfg, mpc_cfg = SimConfig(sim_mode=0), MPCConfig()
    sim = build_simulation(sim_cfg, mpc_cfg, device=dev)[0]
    carry = sweep_start(sim, table, stacked_laps(SWEEP_TRACKS, dev, torch.float32))[0]
    runs["sweep"]["hold"] = dict(sim=sim, carry=carry, n=ENTRY_CPU["sweep"][1], sim_cfg=sim_cfg,
                                 mpc_cfg=mpc_cfg, inputs=sweep_inputs)

    hold("policy", lap_config("monteblanco", POLICY_T),
         MPCConfig(enable_WMPC=True, WMPC_model=WMPC_MODEL))


def serve_phase(dev):
    """The serving entry module in-process (deploy_rt.main): SERVE_CYCLES
    cycles synchronous, then as many with --pipeline 2, each with its
    telemetry exported and read back; the counters are reset just before
    the first run and read just after the second. Then both runs' controls
    against run_from's from the same carry."""
    from tum_control_tpu_torch import deploy_rt
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.utils.rt_runtime import read_telemetry

    out = os.path.join(OUT_DIR, "serve")
    os.makedirs(out, exist_ok=True)
    recs, res = {}, {}
    build.reset_launches()
    for mode, extra in (("sync", []), ("pipeline", ["--pipeline", "2"])):
        tele = os.path.join(out, f"telemetry_{mode}.bin")
        if os.path.exists(tele):
            os.remove(tele)  # the export appends
        res[mode] = deploy_rt.main(["--cycles", str(SERVE_CYCLES), "--period", str(SERVE_PERIOD),
                                    "--controller", "nominal", "--telemetry", tele,
                                    "--device", str(dev), *extra])
        recs[mode] = read_telemetry(tele)
    launches = dict(build.LAUNCHES)
    applied = res["pipeline"].pop("apply_log")
    say(f"[serve] launches over 2 x (the warm-up's eager step and its graph's capture): "
        f"{json.dumps(launches)}")
    check_launches("serve", launches)
    for mode, rec in recs.items():
        st = res[mode]["stats"]
        check(rec.shape == (SERVE_CYCLES,) and st["cycles"] == SERVE_CYCLES,
              f"serve/{mode}: {rec.shape[0]} records, {st['cycles']} cycles")
        check(bool((rec["status"] == 0).all()), f"serve/{mode}: statuses {set(rec['status'])}")
        for f in rec.dtype.names:
            check(bool(np.isfinite(rec[f]).all()), f"serve/{mode}: non-finite telemetry {f}")

    # the served controls against run_from from the same carry: cycle i's
    # in the synchronous run, the step applied at cycle i (apply_log) in the
    # pipelined one, which reads the pinned row behind the copy's event
    sim, x0m, x0s, _, _ = build_simulation(SimConfig(sim_mode=0, T=SERVE_CYCLES * SERVE_PERIOD),
                                           MPCConfig(), device=dev)
    _, log = sim.run_from(sim.init_carry(x0m[None], x0s[None], key=0), SERVE_CYCLES)
    u = log.simU[0].double().cpu().numpy()
    scale = np.abs(u).max(axis=0)
    for mode, steps in (("sync", np.arange(SERVE_CYCLES)), ("pipeline", applied)):
        served = np.stack([recs[mode]["u0"], recs[mode]["u1"]], axis=1).astype(np.float64)
        gap = np.abs(served - u[steps]).max(axis=0)
        say(f"[serve/{mode}] u0/u1 against run_from's {SERVE_CYCLES} steps: max |gap| "
            f"{gap.tolist()} of max |u| {scale.tolist()} (tol {TOL_SERVE:.0e})")
        check(bool((gap <= TOL_SERVE * scale).all()),
              f"serve/{mode}: controls {gap} from run_from's")
    # the kernel wrappers count the steps each run launches eagerly: the
    # warm-up's eager call, and the capture's side-stream step and captured
    # step; the replayed cycles launch the same kernels through the graph
    return dict(launches=launches, steps=2 * (deploy_rt.WARMUP_STEPS + 1))


def bench_phase(dev):
    """`bench`: tum_control_tpu_torch/bench.py's main in-process at BENCH_B
    scenarios and cut depth (its SETTLE set to BENCH_SETTLE), the counters
    reset just before and read just after. Holds its last stdout line
    (bench.py's four keys, finite), solver-ok >= 0.99 on all three
    controllers and K1-K6 launched."""
    import io

    from tum_control_tpu_torch import bench
    from tum_control_tpu_torch.ops.kernels import build

    settle, bench.SETTLE = bench.SETTLE, BENCH_SETTLE
    out = io.StringIO()
    try:
        build.reset_launches()
        with contextlib.redirect_stdout(out):
            res = bench.main([str(BENCH_B), str(BENCH_STEPS), "--device", str(dev)])
        launches = dict(build.LAUNCHES)
    finally:
        bench.SETTLE = settle
    lines = out.getvalue().strip().splitlines()
    say(f"[bench] launches: {json.dumps(launches)}")
    check_launches("bench", launches)
    last = json.loads(lines[-1])
    check(set(last) == {"metric", "value", "unit", "vs_baseline"}, f"bench: keys {sorted(last)}")
    check(last["metric"] == "nmpc_solves_per_sec" and last["unit"] == "solve/s",
          f"bench: line {last}")
    check(all(np.isfinite([last["value"], last["vs_baseline"]])) and last["value"] > 0,
          f"bench: values {last}")
    m = res["measure"]
    oks = {"nominal": m["ok"], **{k: v["ok"] for k, v in m["controllers"].items()}}
    for name, ok in oks.items():
        check(ok >= 0.99, f"bench/{name}: solver ok fraction {ok} < 0.99")
    for name, lg in m["logs"].items():
        check(bool(torch.isfinite(lg.lat_dev).all() and torch.isfinite(lg.simU).all()),
              f"bench/{name}: non-finite log")
    say(f"[bench] solver ok {json.dumps(oks)}")
    steps = (BENCH_SETTLE + 2 + BENCH_STEPS + 2 * BENCH_STEPS
             + 4 * min(BENCH_STEPS, bench.MAX_CONTROLLER_STEPS))
    return dict(launches=launches, steps=steps)


def general_qp(rng, batch, nz=NZ, ncg=NCG, l1=True):
    """float64 numpy (H0, g0, G, c0, lb, ub, z1, z2) of `batch` QPs of general
    rows only: tests/test_soft_qp.py's draw without hard rows, each row of G
    scaled by 1 / sqrt(nz); z1 = 0 (L2 penalties only) unless `l1`."""
    A = rng.standard_normal((batch, nz + 4, nz))
    H0 = np.einsum("bki,bkj->bij", A, A) / nz + 0.1 * np.eye(nz)
    g0 = rng.standard_normal((batch, nz))
    G = rng.standard_normal((batch, ncg, nz)) / np.sqrt(nz)
    c0 = rng.standard_normal((batch, ncg))
    lb = -rng.uniform(0.1, 1.0, (batch, ncg))
    ub = rng.uniform(0.1, 1.0, (batch, ncg))
    z1 = rng.uniform(10.0, 200.0, (batch, ncg)) if l1 else np.zeros((batch, ncg))
    z2 = rng.uniform(1.0, 20.0, (batch, ncg))
    return (H0, g0, G, c0, lb, ub, z1, z2)


def qp_hold(dev):
    """The soft-QP API on QPs of general rows only (n_id = 0), QP_B of them
    at the nominal widths, float32 on the card, each solver with the counters
    reset just before and read just after: `qp/newton`, solve_soft_qp
    (QP_NEWTON_ITERS steps: K3 and K5 each step), `qp/ipm`,
    solve_soft_qp_ipm(n_id=0) (K3 each of its 30 iterations, the plain
    iteration, K3 + K5 each of its 2 polish steps; never K4). Each against
    the CPU's float64 solve of the same QPs (module constants TOL_QP_W,
    TOL_QP_OBJ): w over max |w| and the float64 objective at the card's
    point over max(1, |objective|), both over the batch."""
    from tum_control_tpu_torch.ops.ipm import solve_soft_qp_ipm
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.ops.soft_qp import CondensedQP, objective, solve_soft_qp

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(13)
    runs = {}
    for path, l1, solve, counts in (
            ("qp/newton", False, lambda q: solve_soft_qp(q, n_iters=QP_NEWTON_ITERS),
             dict(cholesky=QP_NEWTON_ITERS, chol_solve=QP_NEWTON_ITERS)),
            ("qp/ipm", True, lambda q: solve_soft_qp_ipm(q, n_id=0), dict(cholesky=32, chol_solve=2))):
        arrays = general_qp(rng, QP_B, l1=l1)
        qp = lambda device, dtype: CondensedQP(*(torch.tensor(a, dtype=dtype, device=device)
                                                  for a in arrays))
        card = qp(dev, f32)
        build.reset_launches()
        w, kkt = solve(card)
        launches = dict(build.LAUNCHES)
        say(f"[{path}] launches: {json.dumps(launches)}")
        check_launches(path, launches)
        for name, n in counts.items():
            check(launches[name] == n, f"{path}: {launches[name]} {name} launches, not {n}")
        check(bool(torch.isfinite(w).all() and torch.isfinite(kkt).all()
                   and torch.isfinite(objective(card, w)).all()), f"{path}: non-finite result")
        q64 = qp("cpu", f64)
        w64 = solve(q64)[0]
        w32 = solve(qp("cpu", f32))[0]
        o64 = objective(q64, w64)
        scale_w, scale_o = w64.abs().amax(1), o64.abs().clamp(min=1.0)
        gap_w = lambda x: float(((x.double().cpu() - w64).abs().amax(1) / scale_w).max())
        gap_o = lambda x: float(((objective(q64, x.double().cpu()) - o64).abs() / scale_o).max())
        card_w, card_o, floor_w, floor_o = gap_w(w), gap_o(w), gap_w(w32), gap_o(w32)
        tol_w, tol_o = TOL_QP_W, TOL_QP_OBJ
        if path == "qp/ipm":
            tol_w, tol_o = max(tol_w, LATE_FACTOR * floor_w), max(tol_o, LATE_FACTOR * floor_o)
        say(f"[{path}] B={QP_B}, nz={NZ}, {NCG} general rows: "
            f"card - cpu f64: w {card_w:.3e} of max |w| (tol {tol_w:.3e}), "
            f"objective {card_o:.3e} (tol {tol_o:.3e}); cpu f32 - cpu f64: w {floor_w:.3e}, "
            f"objective {floor_o:.3e}")
        check(card_w <= tol_w, f"{path}: w {card_w:.3e} from the CPU's float64 > {tol_w:.3e}")
        check(card_o <= tol_o, f"{path}: objective {card_o:.3e} from float64 > {tol_o:.3e}")
        runs[path] = dict(launches=launches, steps=1, err_w=card_w, err_obj=card_o)
    return runs


def dryrun_hold(dev):
    """Inside the distributed phase's process group (NCCL, world size 1):
    `dryrun`, tum_control_tpu_torch/dryrun.py's dryrun_multichip(1) over the
    six controller compositions (each mean |lat_dev| finite, K1-K6
    launched), and `dryrun/entry`, entry()'s one nominal step on the card
    (K1-K5) against the CPU's float64 step: u0 within TOL_U of max |u0| (one
    cold-start step on the opening straight, where the steering rate lies
    within a few times float32's floor of itself) and, per input, within
    TOL_U of |u0_i| of the CPU's float32 step; the status 0. Each with the
    counters reset just before and read just after."""
    from tum_control_tpu_torch.dryrun import dryrun_multichip, entry
    from tum_control_tpu_torch.ops.kernels import build

    build.reset_launches()
    means = dryrun_multichip(1, device=dev)
    launches = dict(build.LAUNCHES)
    say(f"[dryrun] six compositions, 2 steps each at B = 2: "
        f"launches {json.dumps(launches)}; mean |lat_dev| {json.dumps(means)}")
    check_launches("dryrun", launches)
    check(len(means) == 6 and all(np.isfinite(list(means.values()))), f"dryrun: means {means}")

    fn, args = entry(device=dev)
    build.reset_launches()
    u0, _, stats = fn(*args)
    torch.cuda.synchronize()
    e_launches = dict(build.LAUNCHES)
    say(f"[dryrun/entry] launches {json.dumps(e_launches)}")
    check_launches("dryrun/entry", e_launches)
    refs = {}
    for dtype in (torch.float64, torch.float32):
        fn_c, args_c = entry(device="cpu", dtype=dtype)
        refs[dtype] = fn_c(*args_c)[0].double()
    u, u64, u32 = u0.double().cpu(), refs[torch.float64], refs[torch.float32]
    gap64 = float((u - u64).abs().max() / u64.abs().max())
    gap32 = float(((u - u32).abs() / u64.abs()).max())
    say(f"[dryrun/entry] u0 card {u.tolist()}, cpu f64 {u64.tolist()}: card - cpu f64 "
        f"{gap64:.3e} of max |u0|, card - cpu f32 {gap32:.3e} of |u0_i| (tol {TOL_U})")
    check(gap64 <= TOL_U and gap32 <= TOL_U, "dryrun/entry: the card's step is off the CPU's")
    check(float(stats[0, 4]) == 0.0, f"dryrun/entry: status {float(stats[0, 4])}")
    return {"dryrun": dict(launches=launches, steps=6 * 2, means=means),
            "dryrun/entry": dict(launches=e_launches, steps=1, gap64=gap64, gap32=gap32)}


def distributed_phase(dev):
    """initialize_distributed with NCCL at world size 1 on a free localhost
    port; the sharded nominal loop (its all-reduced mean |lat_dev| against
    the local reduction) and scaling_report at one card; the counters reset
    just before the loop and read just after the report. Then, in the same
    process group, the dry run's holds (dryrun_hold), returned as `holds`."""
    import socket

    import torch.distributed as dist

    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.parallel.distributed import (
        initialize_distributed, scaling_report, sharded_run,
    )

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    d = initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device=dev)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()} on the card")
        sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device=d)
        build.reset_launches()
        run = sharded_run(sim, traj, DIST_B, DIST_STEPS, device=d)
        rows = scaling_report(sim, traj, device=d, **SCALING)
        launches = dict(build.LAUNCHES)
        holds = dryrun_hold(d)
    finally:
        dist.destroy_process_group()
    say(f"[distributed] launches over {DIST_STEPS} sharded steps and 2 x {SCALING['steps']} "
        f"scaling steps: {json.dumps(launches)}")
    check_launches("distributed", launches)
    ok = run.solver_ok / (DIST_B * DIST_STEPS)
    gap = abs(run.mean_abs_lat_dev - run.local_mean)
    say(f"[distributed] world 1 (nccl), B={DIST_B}, {DIST_STEPS} steps: all-reduced mean "
        f"|lat_dev| {run.mean_abs_lat_dev:.9e} m, local {run.local_mean:.9e} m (gap {gap:.3e}); "
        f"solver ok {run.solver_ok}/{DIST_B * DIST_STEPS}")
    check(gap <= 1e-12 * run.local_mean, f"distributed: all-reduce {gap:.3e} from the local mean")
    check(ok >= 0.99, f"distributed: solver ok fraction {ok} < 0.99")
    check(len(rows) == 1 and rows[0]["devices"] == 1 and rows[0]["efficiency"] == 1.0,
          f"distributed: scaling rows {rows}")
    return dict(launches=launches, steps=DIST_STEPS + 2 * SCALING["steps"], holds=holds)


@contextlib.contextmanager
def k2_valued(dtype):
    """Inside, K2's outputs (ops/rti.py's condense) take the values of its
    plain version computed in `dtype` and keep the derivative of the type
    they are computed in; `dtype` None changes nothing."""
    from tum_control_tpu_torch.ops import rti

    if dtype is None:
        yield
        return
    condense = rti.condense

    def valued(*args):
        out = condense(*args)
        with torch.no_grad():
            val = condense(*(t.to(dtype) for t in args))
        return tuple(t + (v.to(t) - t.detach()) for t, v in zip(out, val))

    rti.condense = valued
    try:
        yield
    finally:
        rti.condense = condense


def diffmode_gradient(device, dtype, k2_values=None):
    """mean |lat_dev| over DIFF_STEPS steps of the nominal loop at DIFF_B
    scenarios from HOLD_LAP_POINT, and its gradient with respect to the 8
    tire log-multipliers (tires in plant and controller), and the count of
    solves with status 0. With `k2_values` (a dtype), K2's outputs take the
    values of its plain version computed in that dtype, and keep the
    derivative of the plain version in `dtype`."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import (
        DEFAULT_CONFIG_PATH, MPCConfig, SimConfig, load_tire_params,
    )
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios
    from tum_control_tpu_torch.params import scaled_tire_params

    if k2_values is not None:
        with k2_valued(k2_values):
            return diffmode_gradient(device, dtype)
    theta = torch.zeros(8, dtype=dtype, device=device, requires_grad=True)
    tp = scaled_tire_params(load_tire_params(DEFAULT_CONFIG_PATH, SimConfig().tire_params_file_MPC),
                            theta)
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device=device,
                                          dtype=dtype, tire_params=tp)
    xm, xs = batched_scenarios(traj, traj.n_points)
    p = HOLD_LAP_POINT
    _, log = sim.run(xm[p:p + DIFF_B], xs[p:p + DIFF_B], DIFF_STEPS)
    loss = log.lat_dev.abs().mean()
    (g,) = torch.autograd.grad(loss, theta)
    ok = int((log.simSolverDebug[..., 4] == 0).sum())
    return g.double().cpu().numpy(), float(loss.detach()), ok


def grad_gap(g, ref):
    """|g - ref| per component over max(|ref_i|, GRAD_FLOOR max |ref|)."""
    return np.abs(g - ref) / np.maximum(np.abs(ref), GRAD_FLOOR * np.abs(ref).max())


def diffmode_references(g64):
    """The CPU's reference gradients (TOL_GRAD): float64 (`g64`), float64
    with K2 valued in float32, float32, float32 with K2 valued in float64."""
    return {"cpu f64": g64,
            "cpu f64, K2 valued in f32": diffmode_gradient("cpu", torch.float64, torch.float32)[0],
            "cpu f32": diffmode_gradient("cpu", torch.float32)[0],
            "cpu f32, K2 valued in f64": diffmode_gradient("cpu", torch.float32, torch.float64)[0]}


def diffmode_phase(dev):
    """The tire gradient on the card in float32 through the kernels (the
    counters reset just before and read just after): the nominal path's
    kernels and no other, and every solve ok on the card and in the CPU's
    float64 run from the same start. The gradient itself is held by
    tests/test_torch_cuda.py::test_tire_gradient_through_the_kernels_matches_cpu."""
    from tum_control_tpu_torch.ops.kernels import build

    build.reset_launches()
    ok32 = diffmode_gradient(dev, torch.float32)[2]
    launches = dict(build.LAUNCHES)
    ok64 = diffmode_gradient("cpu", torch.float64)[2]
    say(f"[diffmode] launches over one gradient of {DIFF_STEPS} steps: {json.dumps(launches)}")
    check_launches("diffmode", launches)
    check(ok32 == DIFF_B * DIFF_STEPS and ok64 == DIFF_B * DIFF_STEPS,
          f"diffmode: solver ok {ok32} / {ok64} of {DIFF_B * DIFF_STEPS}")
    return dict(launches=launches, steps=DIFF_STEPS)


def robust_utils_phase(dev):
    """One full-ZoRo augmented step (make_aug_step, 8 substeps) at AUG_B lap
    states on the card in float32 against the CPU float64 step."""
    from tum_control_tpu_torch.config import (
        DEFAULT_CONFIG_PATH, SimConfig, load_tire_params, load_vehicle_params,
    )
    from tum_control_tpu_torch.controllers import robust_utils as ru
    from tum_control_tpu_torch.track.trajectory import load_ref_trajectory
    from tum_control_tpu_torch.models.vehicle_stm import pred_ode
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    cfg = SimConfig()
    vp = load_vehicle_params(DEFAULT_CONFIG_PATH, cfg.veh_params_file_MPC)
    tp = load_tire_params(DEFAULT_CONFIG_PATH, cfg.tire_params_file_MPC)
    f = lambda x, u: pred_ode(x, u, vp, tp)
    traj = load_ref_trajectory(os.path.join(cfg.trajectory_path, cfg.ref_traj_file),
                               dtype=torch.float64, device="cpu")
    x0, _ = batched_scenarios(traj, AUG_B)
    rng = np.random.default_rng(0)
    u = torch.tensor(rng.normal(size=(AUG_B, 2)) * [0.3, 0.02])
    W = np.diag([0.01, 0.8, 0.35, 0.035]) ** 2
    sig0 = torch.tensor(np.diag([1e-5, 1e-5, 1e-4, 0.4, 0.17, 0.017, 1e-5, 1e-5]) ** 2)
    xa = ru.aug_initial_state(x0, sig0.expand(AUG_B, 8, 8))
    step = ru.make_aug_step(f, W, 0.08, substeps=8)
    ref = step(xa, u, 0.0)
    build.reset_launches()
    out = step(xa.to(dev, torch.float32), u.to(dev, torch.float32), 0.0)
    launches = dict(build.LAUNCHES)
    check_launches("robust_utils", launches)
    out = out.double().cpu()
    check(bool(torch.isfinite(out).all()), "robust_utils: non-finite augmented step")
    gx = ((out[:, :8] - ref[:, :8]).abs().amax(0) / ref[:, :8].abs().amax(0)).numpy()
    S, S_ref = ru.vec2sym_mat(out[:, 8:]), ru.vec2sym_mat(ref[:, 8:])
    d = torch.diagonal(S_ref, dim1=-2, dim2=-1)
    gd = (torch.diagonal(S - S_ref, dim1=-2, dim2=-1).abs() / d).amax(0).numpy()
    gc = float(((S - S_ref).abs() / torch.sqrt(d[:, :, None] * d[:, None, :])).max())
    say(f"[robust_utils] B={AUG_B}, one 8-substep augmented step on the card: "
        f"x gap per column {np.array2string(gx, precision=3, max_line_width=10**4)}; Sigma "
        f"diagonal gap per state {np.array2string(gd, precision=3, max_line_width=10**4)}; "
        f"Sigma gap in sqrt(S_ii S_jj) {gc:.3e} (tol {TOL_AUG:.0e})")
    check(bool((gx <= TOL_AUG).all() and (gd <= TOL_AUG).all()) and gc <= TOL_AUG,
          f"robust_utils: gaps {gx} / {gd} / {gc:.3e}")


def tool_kernels(name, argv):
    """The kernels a tool's run must launch (every other counter stays 0):
    snmpc_dissect assembles QPs and solves none (K1, K6), the SB3 converter
    and the acc24 propagation none, multitrack_eval the nominal and the
    snmpc paths', a run on the SNMPC the snmpc path's, on the nominal NMPC or
    the R2NMPC (named, or by default) the nominal path's."""
    if name == "snmpc_dissect":
        return ("linearize", "condense_from")
    if name in ("convert_sb3_checkpoint", "acc24_figures"):
        return ()
    if name == "multitrack_eval":
        return tuple(set(PATH_KERNELS["nominal"]) | set(PATH_KERNELS["snmpc"]))
    paths = [p for p in ("nominal", "snmpc") if p in argv] or ["nominal"]
    return tuple({k for p in paths for k in PATH_KERNELS[p]})


def headline(x):
    """A tool's returned data without its bulk (TOOL_BULK, tensors, arrays):
    the numbers it prints, as JSON values."""
    if isinstance(x, dict):
        return {str(k): headline(v) for k, v in x.items() if k not in TOOL_BULK
                and not isinstance(v, (torch.Tensor, np.ndarray))}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [headline(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    return str(type(x).__name__)


def tools_child(runs, nice):
    """`--tools-child RUNS NICE`: at niceness NICE, runs each [tool, argv]
    of RUNS (JSON) in this process on the card, the launch counters reset
    just before and read just after, and prints the tool's output, then one
    `TOOL {...}` line: its launches, whether every number it returned and
    printed is finite, and its headline numbers. A tool that raises ends the
    process with a traceback and a non-zero exit."""
    import contextlib
    import importlib
    import io
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.tools.common import all_finite

    os.nice(nice)
    for name, argv in runs:
        mod = importlib.import_module(f"tum_control_tpu_torch.tools.{name}")
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        printed = buf.getvalue()
        print(printed, end="", flush=True)
        rec = dict(name=name, argv=argv, launches=dict(build.LAUNCHES),
                   finite=all_finite(res) and not NONFINITE.search(printed),
                   headline=headline(res))
        print("TOOL " + json.dumps(rec), flush=True)
    return 0


def start_tool_children(groups, nice=0, mode="--tools-child"):
    """Starts each group of (tool, argv) in a child process of its own
    (`mode`: --tools-child, or --eval-child for EVAL) at niceness `nice`,
    all at once; returns [(process, log file)]."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = []
    try:
        for i, runs in enumerate(groups):
            log = open(os.path.join(OUT_DIR, f"tools_child_{runs[0][0]}_{i}.log"), "w+")
            cmd = [sys.executable, os.path.join(REPO, "chip_smoke.py"), mode,
                   json.dumps(runs), str(nice)]
            procs.append((subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                           text=True, env=dict(os.environ, OMP_NUM_THREADS="1")),
                          log))
    except BaseException:
        stop_tool_children(procs)
        raise
    return procs


def stop_tool_children(procs):
    for proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def finish_tool_children(procs, timeout=600):
    """Waits for the children of start_tool_children and returns their TOOL
    records in order; fails when a child exits non-zero. No child outlives
    the call."""
    try:
        recs = []
        for proc, log in procs:
            rc = proc.wait(timeout=timeout)
            log.seek(0)
            out = log.read()
            for line in out.splitlines():
                if line.startswith("TOOL "):
                    recs.append(json.loads(line[5:]))
                else:
                    say(f"[tools] | {line}")
            check(rc == 0, f"tools child {proc.args[3]} exited {rc}:\n{out[-3000:]}")
        return recs
    finally:
        stop_tool_children(procs)


def tools_phase(smi, side_recs):
    """Phase 10: the nine tools, TOOLS_MAIN in a child process
    (`side_recs`: TOOLS_SIDE's records, whose children ran beside the CPU
    re-solves); each must exit normally, return and print finite numbers and
    launch its kernels (tool_kernels) and no other. Prints each tool's
    headline numbers beside the card, diag_precision's two modes side by
    side, and profile_step's kernels per stage."""
    torch.cuda.empty_cache()
    recs = finish_tool_children(start_tool_children([TOOLS_MAIN])) + side_recs
    check(sorted({r["name"] for r in recs}) == sorted({n for n, _ in TOOLS_MAIN}
                                                      | {g[0][0] for g in TOOLS_SIDE}),
          "a tool did not report")
    for r in recs:
        tag = f"[tools/{r['name']} {' '.join(r['argv'])}]"
        check(r["finite"], f"{tag}: non-finite numbers")
        for name, n in r["launches"].items():
            if name in tool_kernels(r["name"], r["argv"]):
                check(n > 0, f"{tag}: kernel {name} was not launched")
            else:
                check(n == 0, f"{tag}: kernel {name} was launched")
        launched = {k: n for k, n in r["launches"].items() if n}
        say(f"{tag} {smi}: launches {json.dumps(launched)}; {json.dumps(r['headline'])}")
    prec = [r["headline"] for r in recs if r["name"] == "diag_precision"]
    for a, b in zip(*prec):
        say(f"[tools/diag_precision] scenario {a['scen']}: max |lat_dev| default "
            f"{a['run_max']:.6f} m, tf32 {b['run_max']:.6f} m (difference "
            f"{b['run_max'] - a['run_max']:+.3e}); ok {a['ok']} / {b['ok']}")
    for r in recs:
        if r["name"] != "profile_step":
            continue
        for ctrl, h in r["headline"].items():
            check(all(h[k]["kernels"] for k in h), f"profile_step {ctrl}: a window holds no kernel")
            parts = sum(h[k]["kernels"] for k in ("planner", "solve (all)", "plant+estimator"))
            say(f"[tools/profile_step {ctrl}] device kernels: planner + solve + plant+estimator "
                f"{parts:.0f}, full step {h['full step']['kernels']:.0f}")
    return recs


def make_sb3_checkpoint(src_root):
    """SRC/new_BO_F/best_model/best_model.zip as stable-baselines3 writes it
    (policy.pth, a torch state dict under SB3's dotted names), holding the
    shipped new_BO_F weights, and its rl_config.yaml; for the converter."""
    import io
    import shutil
    import zipfile

    model = os.path.join(REPO, WMPC_MODEL)
    src = os.path.join(src_root, "new_BO_F")
    shutil.rmtree(src_root, ignore_errors=True)
    os.makedirs(os.path.join(src, "best_model"))
    with np.load(os.path.join(model, "policy_weights.npz")) as d:
        sd = {k.replace("__", "."): torch.as_tensor(d[k]) for k in d.files}
    buf = io.BytesIO()
    torch.save(sd, buf)
    with zipfile.ZipFile(os.path.join(src, "best_model", "best_model.zip"), "w") as z:
        z.writestr("policy.pth", buf.getvalue())
    shutil.copy(os.path.join(model, "rl_config.yaml"), os.path.join(src, "rl_config.yaml"))


DECIMAL = re.compile(r"-?\d+\.\d+")


def lap_numbers(log):
    """A one-scenario SimLog's statistics, recomputed here on the host in
    float64: |lat_dev| mean, max, RMS; |vel_dev| mean, RMS; solver-ok share."""
    lat = log.lat_dev.double().cpu().numpy().ravel()
    vel = log.vel_dev.double().cpu().numpy().ravel()
    status = log.simSolverDebug[..., 4].cpu().numpy().ravel()
    return dict(mean=np.abs(lat).mean(), max=np.abs(lat).max(), rms=np.sqrt((lat ** 2).mean()),
                vmean=np.abs(vel).mean(), vrms=np.sqrt((vel ** 2).mean()),
                ok=float(np.mean(status == 0)),
                finite=bool(np.isfinite(lat).all() and np.isfinite(vel).all()))


def eval_recheck(name, argv, res, printed):
    """What an evaluation tool printed against what it returned: its
    statistics recomputed from the returned logs (laps) or arrays (catalogs)
    and formatted as the tool formats them, equal to the printed decimals;
    solver-ok >= 0.99 on every lap and catalog; the catalog's JSON as
    written, with the committed Logs/catalog_noise_r5.json's keys and the
    full batches. Returns the mismatches (empty when all hold)."""
    errors = []
    lines = printed.splitlines()

    def expect(tag, line, want):
        got = DECIMAL.findall(line)[:len(want)]
        if got != want:
            errors.append(f"{tag}: printed {got}, recomputed {want}")

    def lap(tag, log, line, digits, rms=False):
        m = lap_numbers(log)
        if not m["finite"] or m["ok"] < 0.99:
            errors.append(f"{tag}: finite {m['finite']}, solver ok {m['ok']}")
        keys = ("rms", "max", "vrms") if rms else ("mean", "max", "vmean")
        expect(tag, line, [f"{m[k]:.{digits}f}" for k in keys] + [f"{m['ok'] * 100:.1f}"])

    stats_lines = [ln for ln in lines if " dev_lat " in ln]
    if name in ("one_lap", "quality_exp"):
        lap(name, res["log"], stats_lines[-1], 4 if name == "quality_exp" else 3)
    elif name == "multitrack_eval":
        if len(res) != 9 or len(stats_lines) != 9:
            errors.append(f"multitrack_eval: {len(res)} rows, {len(stats_lines)} lines")
        for r, line in zip(res, stats_lines):
            lap(f"multitrack_eval {r['track']} {r['ctrl']}", r["log"], line, 3)
    elif name == "wmpc_eval":
        lap(name, res["log"], stats_lines[-1], 3, rms=True)
        if not bool((res["log"].wmpc_action >= 0).all()):
            errors.append("wmpc_eval: a step logged no action")
    elif name == "rl_protocol_eval":
        row_lines = [ln for ln in lines if "| mean RMS" in ln]
        if len(row_lines) != len(res):
            errors.append(f"rl_protocol_eval: {len(res)} rows, {len(row_lines)} lines")
        for r, line in zip(res, row_lines):
            ms = [lap_numbers(lp["log"]) for lp in r["laps"]]
            for lp, m in zip(r["laps"], ms):
                if not m["finite"] or m["ok"] < 0.99:
                    errors.append(f"rl_protocol_eval {r['name']} {lp['track']}: {m}")
            want = [f"{m[k]:.3f}" for m in ms for k in ("rms", "max", "vrms")]
            want += [f"{np.mean([m['rms'] for m in ms]):.3f}", f"{max(m['max'] for m in ms):.3f}"]
            expect(f"rl_protocol_eval {r['name']}", line, want)
    elif name == "catalog_noise_validation":
        with open(res["out"]) as f:
            report = json.load(f)
        with open(os.path.join(REPO, "Logs", "catalog_noise_r5.json")) as f:
            ref = json.load(f)
        if report != res["report"] or list(report) != list(ref):
            errors.append(f"catalog: the JSON written differs or has keys {list(report)}")
        for cat, run in res["runs"].items():
            mx, ok = run["max_lat"], run["ok"]
            entry = report["catalogs"][cat]
            worst, low = mx.max(axis=(1, 2)), ok.min(axis=(1, 2))
            want = {"n_sets": mx.shape[0], "worst_max_lat_dev": float(worst.max()),
                    "median_max_lat_dev": float(np.median(worst)),
                    "min_solver_ok": float(low.min()),
                    "sets_flagged": [int(i) for i in np.nonzero((worst > 2.0) | (low < 1.0))[0]],
                    "per_set_worst": [round(float(v), 3) for v in worst],
                    "per_set_ok": [round(float(v), 4) for v in low]}
            if entry != want or list(entry) != list(next(iter(ref["catalogs"].values()))):
                errors.append(f"catalog {cat}: JSON entry {entry} != recomputed {want}")
            if mx.size != CATALOG_SCENARIOS.get(cat, mx.size) or not np.isfinite(mx).all():
                errors.append(f"catalog {cat}: {mx.size} scenarios, finite {np.isfinite(mx).all()}")
            if low.min() < 0.99:
                errors.append(f"catalog {cat}: min solver ok {low.min()}")
            (line,) = [ln for ln in lines if ln.startswith(f"{cat}: ")]
            expect(f"catalog {cat}", line, [f"{want['worst_max_lat_dev']:.3f}",
                                            f"{want['median_max_lat_dev']:.3f}",
                                            f"{want['min_solver_ok']:.4f}"])
    elif name == "convert_sb3_checkpoint":
        out = os.path.join(REPO, argv[1], "new_BO_F")
        with np.load(os.path.join(out, "policy_weights.npz")) as got, \
                np.load(os.path.join(REPO, WMPC_MODEL, "policy_weights.npz")) as want:
            if sorted(got.files) != sorted(want.files) or any(
                    not np.array_equal(got[k], want[k]) for k in want.files):
                errors.append("convert_sb3_checkpoint: the npz differs from the shipped one")
        if res != ["new_BO_F"] or not os.path.exists(os.path.join(out, "rl_config.yaml")):
            errors.append(f"convert_sb3_checkpoint: converted {res}")
    return errors


def eval_child(runs):
    """`--eval-child RUNS`: each [tool, argv] of RUNS (JSON) on the card in
    this process, the launch counters reset just before and read just
    after; prints the tool's output, then one `TOOL {...}` line: its
    launches, whether every number it returned and printed is finite, its
    headline numbers, `errors` (eval_recheck; for acc24_figures the
    propagation's gap from the CPU's float64 one beyond TOL_PROPAGATION) and
    `extra`: closed-loop steps (laps), scenarios (catalogs), the
    propagation's gap. A tool that raises ends the process with a traceback
    and a non-zero exit."""
    import contextlib
    import importlib
    import io
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.tools.common import all_finite

    for name, argv in runs:
        if name == "convert_sb3_checkpoint":
            make_sb3_checkpoint(os.path.join(REPO, argv[0]))
        pkg = "scripts" if name == "acc24_figures" else "tools"
        mod = importlib.import_module(f"tum_control_tpu_torch.{pkg}.{name}")
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            if name == "acc24_figures":
                res = mod.propagate(torch.device("cuda"))[0]
            else:
                res = mod.main(argv)
        launches = dict(build.LAUNCHES)
        printed = buf.getvalue()
        print(printed, end="", flush=True)
        extra = {}
        if name == "acc24_figures":
            ref = mod.propagate("cpu", torch.float64)[0]
            extra["gap"] = float(np.abs(res - ref).max() / np.abs(ref).max())
            errors = ([] if extra["gap"] <= TOL_PROPAGATION else
                      [f"acc24_figures: propagation {extra['gap']:.3e} from the CPU's float64"])
            errors += [] if res.shape == (15, 11, 8) else [f"samples of shape {res.shape}"]
        else:
            errors = eval_recheck(name, argv, res, printed)
        if isinstance(res, dict) and "log" in res:
            extra["steps"] = res["log"].lat_dev.shape[1]
        if name == "catalog_noise_validation":
            extra["catalogs"] = {c: r["scenarios"] for c, r in res["runs"].items()}
        rec = dict(name=name, argv=argv, launches=launches,
                   finite=all_finite(res) and not NONFINITE.search(printed),
                   headline=headline(res), errors=errors, extra=extra)
        print("TOOL " + json.dumps(rec), flush=True)
    return 0


def eval_phase(smi):
    """Phase 11: the evaluation tools (EVAL) in a child process; each must
    exit normally, return and print finite numbers, print what it returned
    (eval_recheck), and launch its kernels (tool_kernels) and no other.
    Prints each one's headline numbers beside the card and quality_exp's
    and one_lap's launches per step. Returns {"eval/<tool>": launches}."""
    torch.cuda.empty_cache()
    recs = finish_tool_children(start_tool_children([EVAL], mode="--eval-child"))
    check([r["name"] for r in recs] == [n for n, _ in EVAL], "an evaluation tool did not report")
    out = {}
    for r in recs:
        tag = f"[eval/{r['name']} {' '.join(r['argv'])}]"
        check(r["finite"], f"{tag}: non-finite numbers")
        check(not r["errors"], f"{tag}: " + "; ".join(r["errors"]))
        for name, n in r["launches"].items():
            if name in tool_kernels(r["name"], r["argv"]):
                check(n > 0, f"{tag}: kernel {name} was not launched")
            else:
                check(n == 0, f"{tag}: kernel {name} was launched")
        launched = {k: n for k, n in r["launches"].items() if n}
        say(f"{tag} {smi}: launches {json.dumps(launched)}; "
            f"{json.dumps(r['extra'])}; {json.dumps(r['headline'])}")
        if r["name"] in ("quality_exp", "one_lap") and r["extra"].get("steps"):
            per = {k: n / r["extra"]["steps"] for k, n in launched.items()}
            say(f"{tag} launches per closed-loop step: {json.dumps(per)}")
        out[f"eval/{r['name']}"] = r["launches"]
    return out


def eval_holds(dev):
    """The sqp_iters = 2 and catalog paths on the card, set up for cpu_phase
    (EVAL_HOLD): sqp2 from B lap points after `settle` card steps; the
    catalog's 315 scenarios of F_jax_r4.csv on their laps under their weights
    and their seed's noise for `settle` card steps, then `subset` of them,
    spread over sets, tracks and seeds, each step fed the card's noise for
    that step and its own lap and weights on the CPU's device and type."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.learn.wmpc import load_param_table
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios
    from tum_control_tpu_torch.tools import catalog_noise_validation as cn
    from tum_control_tpu_torch.tools.common import take_rows

    f32, holds = torch.float32, {}
    h = EVAL_HOLD["sqp2"]
    sim_cfg, mpc_cfg = SimConfig(sim_mode=0), MPCConfig(sqp_iters=2)
    sim, _, _, traj, _ = build_simulation(sim_cfg, mpc_cfg, device=dev)
    x0m, x0s = batched_scenarios(traj, h["B"], dtype=f32, device=dev)
    carry, log = sim.run(x0m, x0s, h["settle"], key=0)
    check(bool((log.simSolverDebug[..., 2] == 2).all()), "sqp2: a step ran another SQP count")
    holds["sqp2"] = dict(sim=sim, carry=carry, n=h["n"], sim_cfg=sim_cfg, mpc_cfg=mpc_cfg)

    h = EVAL_HOLD["catalog"]
    n_seeds = 3
    sim_cfg, mpc_cfg = cn.noise_config((h["settle"] + h["n"]) * 0.02), MPCConfig()
    sim = build_simulation(sim_cfg, mpc_cfg, device=dev)[0]
    table = load_param_table(os.path.join(REPO, h["catalog"]))
    noise = cn.seed_noise(sim, range(n_seeds), h["settle"] + h["n"])
    carry, traj, mods, seed_pos = cn.catalog_start(sim, table, stacked_laps(EVAL_TRACKS, dev, f32),
                                                  n_seeds)
    check(carry.x_sim.shape[0] == CATALOG_SCENARIOS[h["catalog"]], "catalog hold: batch size")
    w_se, zero = noise[seed_pos], torch.zeros_like(carry.x_sim)
    for k in range(h["settle"]):
        carry, _ = sim.step(carry, zero, w_se[:, k], traj=traj, mods=mods)
    idx = torch.linspace(0, carry.x_sim.shape[0] - 1, h["subset"], device=dev).round().long()
    laps = {}

    def inputs(s, c, k):
        d, dt = c.x_sim.device, c.x_sim.dtype
        if s not in laps:
            _, tr, md, _ = cn.catalog_start(s, table, stacked_laps(EVAL_TRACKS, d, dt), n_seeds)
            laps[s] = dict(traj=take_rows(tr, idx), mods=take_rows(md, idx))
        w = w_se[idx, h["settle"] + k].to(d, dt)
        return torch.zeros_like(c.x_sim), w, laps[s]
    holds["catalog"] = dict(sim=sim, carry=take_rows(carry, idx), n=h["n"], sim_cfg=sim_cfg,
                            mpc_cfg=mpc_cfg, inputs=inputs)
    return holds


def jsonable(x):
    """Nested dicts, NamedTuples, sequences, arrays and tensors as JSON values."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if hasattr(x, "_asdict"):
        return jsonable(x._asdict())
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def fit_argv(name, argv):
    """A fit tool's argv with the synthetic goldens and outputs under FIT_DIR."""
    d = os.path.join(REPO, FIT_DIR)
    out = {"golden_attribution": ["--out", os.path.join(d, "attribution",
                                                        "pacejka_params_2023fit.yaml")],
           "fit_tires_es": ["--out", os.path.join(d, "es.yaml"), "--log",
                            os.path.join(d, "es.txt")],
           "fit_tires_closedloop": ["--out", os.path.join(d, "cl.yaml"), "--log",
                                    os.path.join(d, "cl.txt")]}[name]
    return argv + ["--golden", os.path.join(d, "nominal", "full_logs.npz"),
                   "--golden-snmpc", os.path.join(d, "snmpc", "full_logs.npz")] + out


def check_fit_launches(tag, launches):
    """K1-K6 of the nominal NMPC and the SNMPC and the plant's RK4, and no
    other kernel."""
    for name, n in launches.items():
        if name in FIT_KERNELS:
            check(n > 0, f"{tag}: kernel {name} was not launched")
        else:
            check(n == 0, f"{tag}: kernel {name} was launched")


def fit_child(runs):
    """`--fit-child RUNS`: each [tool, argv] of RUNS (JSON) on the card in
    this process, the launch counters reset just before and read just
    after; prints the tool's output, then one `TOOL {...}` line: its
    launches, whether every number it returned and printed is finite, and
    what it returned (`result`). A tool that raises ends the process with a
    traceback and a non-zero exit."""
    import importlib
    import io
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.tools.common import all_finite

    for name, argv in runs:
        mod = importlib.import_module(f"tum_control_tpu_torch.tools.{name}")
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        printed = buf.getvalue()
        print(printed, end="", flush=True)
        rec = dict(name=name, argv=argv, launches=dict(build.LAUNCHES),
                   finite=all_finite(jsonable(res)) and not NONFINITE.search(printed),
                   result=jsonable(res))
        print("TOOL " + json.dumps(rec), flush=True)
    return 0


def fit_phase(dev, smi):
    """The `fit` phase: the synthetic goldens on the card, then the three
    tools in a child process; each must exit normally, return and print
    finite numbers, and launch K1-K6 (FIT_KERNELS) and no other. Returns
    dict(launches per path "fit/<tool>", recs by tool)."""
    from tum_control_tpu_torch.config import MPCConfig
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.tools import tire_fit

    d = os.path.join(REPO, FIT_DIR)
    build.reset_launches()
    for name, cfg in (("nominal", MPCConfig()), ("snmpc", MPCConfig(**tire_fit.SNMPC))):
        logs = tire_fit.write_golden(os.path.join(d, name, "full_logs.npz"), cfg,
                                     FIT_GOLDEN_STEPS, FIT_TIRES, dev, torch.float32,
                                     start=FIT_LAP_POINT)
        check(bool(np.isfinite(logs["CiLX"]).all()), f"fit/golden {name}: non-finite states")
        failed = np.flatnonzero(logs["simSolverDebug"][:, 4] != 0).tolist()
        say(f"[fit/golden] {name}: {FIT_GOLDEN_STEPS} steps, mean |dev_lat| "
            f"{np.abs(logs['dev_lat']).mean():.6f} m; failed solves at steps {failed}")
    launches = {"fit/golden": dict(build.LAUNCHES)}
    check_fit_launches("fit/golden", launches["fit/golden"])
    torch.cuda.empty_cache()
    recs = finish_tool_children(start_tool_children(
        [[(n, fit_argv(n, a)) for n, a in FIT_RUNS]], mode="--fit-child"))
    check([r["name"] for r in recs] == [n for n, _ in FIT_RUNS], "a fit tool did not report")
    for r in recs:
        tag = f"[fit/{r['name']}]"
        check(r["finite"], f"{tag}: non-finite numbers")
        check_fit_launches(tag, r["launches"])
        launches[f"fit/{r['name']}"] = r["launches"]
        launched = {k: n for k, n in r["launches"].items() if n}
        say(f"{tag} {smi}: launches {json.dumps(launched)}")
    res = {r["name"]: r["result"] for r in recs}
    a = res["golden_attribution"]
    say(f"[fit/golden_attribution] {smi}: {FIT_RUNS[0][1][1]} Adam steps, one-step RMS "
        f"{a['rms0']:.6f} -> {a['rms1']:.6f}; verdicts {a['verdict']} / {a['verdict_snmpc']}")
    for k, g in enumerate(res["fit_tires_es"]["generations"]):
        b = g["best"]
        say(f"[fit/fit_tires_es] {smi}: generation {k}: 8 members x "
            f"2 laps of {FIT_GOLDEN_STEPS} steps; best fit {g['fit'][b]:.6f}, ratios "
            f"{g['rn'][b]:.6f} / {g['rs'][b]:.6f}, ok {g['okn'][b]} / {g['oks'][b]}")
    for k, it in enumerate(res["fit_tires_closedloop"]["iterations"]):
        say(f"[fit/fit_tires_closedloop] {smi}: gradient {k}: loss "
            f"{it['loss']:.6e}, ratios {it['rn']:.6f} / {it['rs']:.6f}, |g| {it['gnorm']:.4e}, "
            f"sanitizer: smallest state scale {it['min_scale']:.4e}, largest |theta cotangent| "
            f"{it['max_g_theta']:.4e}")
    return dict(launches=launches, recs=res)


def fit_cpu_child(runs, nice):
    """`--fit-cpu-child RUNS NICE`: the CPU references of the fit phase at
    niceness NICE: the closed-loop fit's loss terms and gradient at theta0
    (float64, float64 with K2 valued in float32, float32, float32 with K2
    valued in float64; the diffmode phase's four) and the attribution's
    float64 transition fit; one `TOOL {...}` line."""
    from tum_control_tpu_torch.tools import fit_tires_closedloop as cl
    from tum_control_tpu_torch.tools import golden_attribution as ga
    from tum_control_tpu_torch.tools import tire_fit

    os.nice(nice)
    ((_, spec),) = runs
    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    args = cl.parse_args(spec["cl_argv"] + ["--device", "cpu"])
    refs = {}
    for label, dtype, valued in (("cpu f64", f64, None), ("cpu f64, K2 valued in f32", f64, f32),
                                 ("cpu f32", f32, None), ("cpu f32, K2 valued in f64", f32, f64)):
        with k2_valued(valued):
            prob = cl.FitProblem(args, cpu, dtype)
            loss, aux, g = prob.value_and_grad(prob.theta0)
        refs[label] = dict(zip(FIT_TERMS, [float(loss)] + [float(v) for v in aux]),
                           grad=g.double().numpy().tolist())
    ga_args = ga.parse_args(spec["attr_argv"] + ["--device", "cpu"])
    _, rms0, rms1, theta = ga.fit_tires(tire_fit.load_golden(ga_args.golden), ga_args.steps,
                                        device=cpu)
    attr = dict(theta=theta.tolist(), rms0=rms0, rms1=rms1)
    print("TOOL " + json.dumps(dict(name="fit_cpu_holds", refs=refs, attribution=attr)),
          flush=True)
    return 0


def fit_card_child(runs, nice):
    """`--fit-card-child RUNS NICE`: at niceness NICE, the ES's first
    generation on the card as one batch of its members and as one run of
    each; one `TOOL {...}` line with the lap statistics of each."""
    from tum_control_tpu_torch.tools.fit_tires_es import Population

    os.nice(nice)
    ((_, spec),) = runs
    pop = Population(spec["n"], torch.device("cuda"), torch.float32)
    cand = np.array(spec["cand"])
    batch = pop.lap_stats(cand)
    singles = [pop.lap_stats(cand[p:p + 1]) for p in range(cand.shape[0])]
    print("TOOL " + json.dumps(dict(name="fit_es_singles", batch=jsonable(batch),
                                    singles=jsonable(singles))), flush=True)
    return 0


def start_fit_holds(fit):
    """The fit phase's two hold children (fit_cpu_child, fit_card_child),
    started at TOOLS_SIDE_NICE beside the CPU re-solves."""
    argv = dict(FIT_RUNS)
    spec = dict(cl_argv=fit_argv("fit_tires_closedloop", argv["fit_tires_closedloop"]),
                attr_argv=fit_argv("golden_attribution", argv["golden_attribution"]))
    es = dict(n=FIT_GOLDEN_STEPS, cand=fit["recs"]["fit_tires_es"]["generations"][0]["cand"])
    return (start_tool_children([[("fit_cpu_holds", spec)]], TOOLS_SIDE_NICE,
                                mode="--fit-cpu-child")
            + start_tool_children([[("fit_es_singles", es)]], TOOLS_SIDE_NICE,
                                  mode="--fit-card-child"))


def fit_holds(fit, recs, smi):
    """The fit phase's holds, from its children's records: the closed-loop
    fit's first loss terms (TOL_FIT_TERMS of the CPU's float64) and first
    gradient (finite; the nearest of the four CPU references within
    TOL_GRAD per component, each reference's gap from float64 printed: a
    bimodal float32 gradient shows there); the ES's first generation as one
    batch against single-member runs (TOL_FIT_DEV), and that batch
    against the ES's own; the attribution's theta (TOL_FIT_THETA)."""
    by = {r["name"]: r for r in recs}
    cpu, card = by["fit_cpu_holds"], by["fit_es_singles"]
    refs = cpu["refs"]
    it0 = fit["recs"]["fit_tires_closedloop"]["iterations"][0]
    r64, r32 = refs["cpu f64"], refs["cpu f32"]
    tol = {k: TOL_FIT_TERMS * abs(r64[k]) for k in ("rn", "rs")}
    tol.update(okn=0.0, oks=0.0)
    for k in ("tn", "ts"):
        tol[k] = 2.0 * np.sqrt(r64[k]) * TOL_FIT_DEV + TOL_FIT_DEV ** 2
    tol["loss"] = (2.0 * abs(r64["rn"] - 1.0) * tol["rn"] + 2.0 * abs(r64["rs"] - 1.0) * tol["rs"]
                   + 0.3 * (tol["tn"] + tol["ts"]))
    gap = {k: abs(it0[k] - r64[k]) for k in FIT_TERMS}
    say(f"[fit/hold] {smi}: first loss terms, card f32 / cpu f64 (|gap|, bound; cpu f32's "
        f"|gap|): " + "; ".join(f"{k} {it0[k]:.9e} / {r64[k]:.9e} ({gap[k]:.2e}, {tol[k]:.2e}; "
                                f"{abs(r32[k] - r64[k]):.2e})" for k in FIT_TERMS))
    check(all(gap[k] <= tol[k] for k in FIT_TERMS),
          f"fit/hold: loss terms beyond their bounds from the CPU's float64: {gap}")
    g32 = np.array(it0["grad"])
    check(bool(np.isfinite(g32).all()) and float(np.abs(g32).max()) > 0,
          f"fit/hold: card gradient {g32}")
    g64 = np.array(r64["grad"])
    fmt = lambda a: np.array2string(np.asarray(a), max_line_width=10**4,
                                    formatter={"float_kind": lambda v: f"{v:.3e}"})
    say(f"[fit/hold] first gradient card f32 {fmt(g32)}, cpu f64 {fmt(g64)}")
    near = {}
    for label, r in refs.items():
        g = np.array(r["grad"])
        near[label] = grad_gap(g32, g)
        say(f"[fit/hold] reference {label}: gap from cpu f64 {fmt(grad_gap(g, g64))}; the "
            f"card's from it {fmt(near[label])}")
    best = min(near, key=lambda label: near[label].max())
    say(f"[fit/hold] nearest reference {best} (tol {TOL_GRAD:.0e}, floor {GRAD_FLOOR:.0e} of "
        f"max |g|)")
    check(bool((near[best] <= TOL_GRAD).all()),
          f"fit/hold: card gradient per component {near[best]} from the nearest reference, {best}")

    batch = np.array(card["batch"])                       # (ctrl, stat, P)
    singles = np.concatenate([np.array(s) for s in card["singles"]], axis=2)
    pop_gap = np.abs(batch - singles)
    pop_rel = pop_gap / np.maximum(np.abs(singles), 1e-300)
    say(f"[fit/hold] ES generation 0, pop {batch.shape[2]} as one batch vs single-member runs on "
        f"the card (mean, max |lat_dev| in m, ok): largest |gap| nominal "
        f"{fmt(pop_gap[0].max(axis=1))}, snmpc {fmt(pop_gap[1].max(axis=1))}; relative "
        f"{fmt(pop_rel[0].max(axis=1))}, {fmt(pop_rel[1].max(axis=1))}; largest values "
        f"{fmt(singles[:, :2].max(axis=2).ravel())}")
    check(float(pop_gap[:, :2].max()) <= TOL_FIT_DEV and float(pop_gap[:, 2].max()) == 0.0,
          f"fit/hold: population batch vs single runs {pop_gap.max(axis=2)} beyond "
          f"{TOL_FIT_DEV:.0e} m or a solver status apart")
    g0 = fit["recs"]["fit_tires_es"]["generations"][0]
    own = np.array([[g0["xn"], g0["okn"]], [g0["xs"], g0["oks"]]])
    rerun = float(np.abs(own - batch[:, 1:]).max())
    say(f"[fit/hold] the batch in another process against the ES's own generation 0 (max "
        f"|lat_dev|, ok): largest |gap| {rerun:.3e}")
    check(rerun <= TOL_FIT_DEV, "fit/hold: the ES's generation 0 did not repeat on the card")

    ta = np.array(fit["recs"]["golden_attribution"]["theta"])
    tc = np.array(cpu["attribution"]["theta"])
    say(f"[fit/hold] attribution theta card f64 {fmt(ta)}, cpu f64 {fmt(tc)}; max |gap| "
        f"{np.abs(ta - tc).max():.3e}")
    check(float(np.abs(ta - tc).max()) <= TOL_FIT_THETA,
          f"fit/hold: attribution theta {np.abs(ta - tc).max():.3e} from the CPU's")
    return dict(terms_gap=gap, nearest=best, grad_gap=near[best].max(),
                population_gap=float(pop_gap.max()), population_rel=float(pop_rel.max()))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    say(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")

    logs = build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")

    if sys.argv[1:2] == ["--tools-child"]:
        return tools_child(json.loads(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--eval-child"]:
        return eval_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--fit-child"]:
        return fit_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--fit-cpu-child"]:
        return fit_cpu_child(json.loads(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--fit-card-child"]:
        return fit_card_child(json.loads(sys.argv[2]), int(sys.argv[3]))
    results, jobs = kernel_phase(dev)
    if "--kernels-only" in sys.argv[1:]:
        profile_kernels(results, jobs)
        say(json.dumps({"kernel_times": list(results.values())}))
        return 0
    # every run on the card before the kernels' profiler sessions, which slow
    # every later launch of the process, and before the CPU re-solves
    runs = {}
    for path in PATHS:
        runs[path] = loop_phase(dev, path)
    runs["bench"] = bench_phase(dev)
    runs["ppo"] = ppo_phase(dev)
    runs["bo"] = bo_phase(dev)
    runs.update(entry_phase(dev))
    runs["serve"] = serve_phase(dev)
    runs["distributed"] = distributed_phase(dev)
    runs.update(runs["distributed"].pop("holds"))
    eval_launches = eval_phase(smi.splitlines()[0])
    holds = eval_holds(dev)
    fit = fit_phase(dev, smi.splitlines()[0])
    runs.update(qp_hold(dev))
    profile_kernels(results, jobs)
    # the tools whose times are not measurements (diag_precision --tf32,
    # dump_qps's scipy re-solve on the host) run beside the CPU re-solves
    side = start_tool_children(TOOLS_SIDE, TOOLS_SIDE_NICE)
    try:
        side += start_fit_holds(fit)
        for path in PATHS:
            run = runs[path]
            cpu_phase(path, run["sim"], move_carry(run["carry0"], dev, torch.float32),
                      PATHS[path][2], SimConfig(sim_mode=0), MPCConfig(**PATH_CONFIG[path]))
        ppo_cpu_check(runs["ppo"])
        bo_cpu_check(runs["bo"])
        for path in ENTRY:
            cpu_phase(path, **runs[path]["hold"])
        for path in EVAL_CPU:
            cpu_phase(f"eval/{path}", **holds[path])
    except BaseException:
        stop_tool_children(side)
        raise
    side_recs = finish_tool_children(side)
    fit_recs = [r for r in side_recs if r["name"].startswith("fit_")]
    side_recs = [r for r in side_recs if not r["name"].startswith("fit_")]
    fit_holds(fit, fit_recs, smi.splitlines()[0])
    runs["diffmode"] = diffmode_phase(dev)
    robust_utils_phase(dev)
    tools_phase(smi.splitlines()[0], side_recs)
    all_paths = (list(PATHS) + list(TUNING) + list(ENTRY) + list(SERVE) + list(API)
                 + list(eval_launches) + list(fit["launches"]))
    per_path = {path: runs[path]["launches"] for path in all_paths if path in runs}
    per_path.update(eval_launches)
    per_path.update(fit["launches"])
    check(set(results) == set(build.LAUNCHES), "kernel list and launch counters differ")
    kernels = []
    for name in build.LAUNCHES:
        n = {path: per_path[path][name] for path in all_paths}
        if name in OFF_PATH:
            check(sum(n.values()) == 0, f"kernel {name} was launched on a path")
        else:
            check(sum(n.values()) > 0, f"kernel {name} was launched on no path")
        head = {k: results[name].pop(k) for k in ("name", "route", "source", "replaces")}
        per_step = {path: n[path] / runs[path]["steps"] for path in ENTRY + SERVE}
        kernels.append(dict(head, launches=sum(n.values()), **results[name], launches_per_path=n,
                            launches_per_step=per_step,
                            path=None if name in OFF_PATH else [p for p in all_paths if n[p] > 0]))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
