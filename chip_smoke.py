#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tum_control_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. prints the card (`nvidia-smi` name and power limit) and the TF32
     setting, and builds the hand-written kernels from
     tum_control_tpu_torch/csrc with nvcc for sm_90a;
  2. runs each kernel (K1-K8) at its closed loop's shapes (B = 128
     scenarios; nominal: N = 38, nx = 8, nu = 2, nz = 76, 78 general rows;
     K1 also at SNMPC's 88 elements per scenario and one RK4 substep; K6 at
     SNMPC's nominal tail, 33 stages from the carry of its 5 head stages;
     K8 on K2's inputs, bitwise against K2 there and at B = 1, and at
     N = 64 (nz + 1 = 129 columns), K7 on K3's and K5's, since no path
     launches them;
     K1-K5 also at the entry paths' batches, ENTRY_BATCHES: one scenario
     and 52; K1 also with one tire set per scenario, read from its tire
     table, at the nominal shape and at the SNMPC's at UPH 15, 15 x 11 + 23
     elements, after a bitwise check of the table launch against the
     shared-tire launch on the same values; K6 also at the UPH 15 tail, 23
     stages from column 30) on inputs from a seeded numpy generator, holds it against its plain
     PyTorch version on the same inputs (K3 and K7 also on an
     ill-conditioned IPM-shaped H, by backward error; K4 also on that H's
     factor, a late iteration's, against the float64 plain version within
     LATE_FACTOR of the float32 plain version's own distance), and times
     it: the kernel's device time over 100 back-to-back launches queued
     behind a sleep (`device_ms`), one launch with the host's launch path
     (`launch_ms`); the plain version per call; for K3, K5, K7 the PyTorch
     library call's device time (K3, K7: `torch.linalg.cholesky_ex`, and
     `torch.linalg.cholesky` beside it per call, which synchronizes with
     the host);
  3. drives each ported path's closed loop (PATHS: the nominal NMPC, the
     SNMPC, the R2NMPC, WMPC over the R2NMPC and the nominal NMPC with the
     EXTERNAL cost): `build_simulation` on cuda in float32 with
     `batched_scenarios` at B = 128, a settle run and a timed run, with the
     launch counters reset just before and read just after; checks that the
     path's kernels (and no other) were launched, solver health and finite
     logs; prints solves/s and |lat_dev| p50/p99 (WMPC: the weight switches
     and the action histogram);
  4. the two tuning loops, each with the counters reset just before and
     read just after: `ppo`, PPO training of the WMPC policy (RLEnv over
     the nominal NMPC on the stacked Monteblanco + Modena laps, one lap per
     env; 16 envs, 20 closed-loop steps per env step, the 26 Pareto sets of
     data/F.csv, the [128, 256, 128] MLP; 2 updates of 8 env steps, batch
     64, 2 epochs, one EvalCallback evaluation), and `bo`, the
     multi-objective BO of the cost weights (ObjectiveEvaluator on both
     segment groups, 10 segments each on the two laps, 150 steps a rollout;
     8 Sobol candidates, then one BayesianOptimizer step: 3 GP fits,
     MC-EHVI with 64 samples, q = 5), then one timed objective chunk of
     128 scenarios; checks losses, rewards, parameters, artifacts,
     objectives against feasibility, trial count and hypervolume;
  5. the user-facing entry points (ENTRY), each with the counters reset
     just before and read just after: `main`, the entry module's run_main
     on the shipped YAML configs (one scenario, nominal NMPC, 200 steps,
     plots off; its full_logs.npz read back: the reference's 14 arrays at
     their shapes, finite, solve times > 0; ms per step and solves/s at
     B = 1), `main_playback` (100 steps with both disturbance kinds,
     recorded to full_logs.npz and replayed from it with another seed: the
     disturbances equal, CiLX within TOL_PLAYBACK), `sweep`, the baseline
     sweep's entry module (the 26 sets of data/F.csv x Monteblanco and LVMS,
     52 scenarios, 100 steps; its npz and summary.csv layout), and `policy`,
     run_policy and action_probability_trace of the new_BO_F policy (50
     steps each; actions in [0, 26), probability rows summing to 1);
  6. serving and sharding, each with the counters reset just before and
     read just after: `serve`, the entry module deploy_rt in-process at
     B = 1 (nominal, SERVE_CYCLES cycles of 20 ms synchronous, then as many
     with --pipeline 2; telemetry exported and read back: every record, status
     0, finite; p50/p99/max solve or age ms, misses, stale cycles, distinct
     controls, the age decomposition, freezes and late starts), and, untimed,
     the controls of both runs against run_from's from the same carry
     (TOL_SERVE; the pipelined run's at the step each cycle applied); `distributed`, initialize_distributed with NCCL at world
     size 1, the sharded nominal loop (DIST_B, DIST_STEPS; the all-reduced
     mean |lat_dev| against the local one) and scaling_report at one card;
  7. after all loops (a profiler session slows every later step's host
     time), a torch.profiler window of PROFILE_STEPS steps of each loop, of
     one env step, one objective chunk and `main`, and the profiler's
     device time of each kernel case of phase 2 and its library call
     (`profiled_ms`; the `library_ms` of a library call that synchronizes
     with the host, so that `ms` and `library_ms` are both device time);
  8. reruns each path's first steps on the CPU (plain versions) in float64
     and in float32 from the card's own carry at that step and holds the
     card's inputs simU to each (WMPC: and its actions to the float64
     run's); holds one env step from the card's trained-env state, and three
     (candidate, segment) objectives of the timed chunk (a feasible pair of
     each segment group and an infeasible one of group 1), against the CPU
     float64 run from the same state; and each entry path's first steps
     (ENTRY_CPU) as the loops' are held, from the card's own carry on the
     same closed loop at B = 1 or 52: main from HOLD_LAP_POINT, the
     playback fed the recorded disturbances, the sweep's 52 scenarios on
     their laps and weights, the policy across its first update (actions
     equal, probabilities within TOL_PROB);
  9. `diffmode`: the gradient of mean |lat_dev| over DIFF_STEPS steps at
     DIFF_B scenarios from HOLD_LAP_POINT with respect to the 8 tire
     log-multipliers on the card in float32 (twice, the second timed; the
     counters reset just before and read just after: K1-K5 launch in the
     forward, their backward is the plain versions' VJP), held per
     component (TOL_GRAD, GRAD_FLOOR) to the nearest of the CPU's float64
     gradient and its float32 gradients, K2 plain and valued in float64
     (the float32 loop's gradient is bimodal there);
     `robust_utils`: one full-ZoRo augmented step at AUG_B lap states on the
     card in float32 against the CPU float64 step, per state column, per
     diagonal entry of Sigma and per entry in units of sqrt(S_ii S_jj)
     (TOL_AUG);
 10. `tools`: the nine measurement and diagnostic tools
     (tum_control_tpu_torch/tools) at B = 128 and cut depth, in child
     processes (TOOLS_MAIN; TOOLS_SIDE beside phase 8's CPU re-solves, at
     a lower priority): each must exit normally, return and print finite
     numbers, and launch its path's kernels (K1-K5; on the SNMPC K1,
     K3-K6; snmpc_dissect K1 and K6) and no other; prints each one's
     headline numbers beside the card's name and power limit,
     diag_precision's default and --tf32 runs side by side, and
     profile_step's device kernels per stage beside the loops' kernels per
     step;
 11. `eval`: the evaluation tools (EVAL: one_lap, quality_exp at
     sqp_iters = 2, multitrack_eval, wmpc_eval, rl_protocol_eval,
     catalog_noise_validation with every catalog as one batch of 234 / 315
     / 252 scenarios, the SB3 converter, acc24_figures' propagation) at
     full width and cut depth in a child process (`--eval-child`), after
     phase 6 and before any profiler session: each must exit normally,
     return and print finite numbers, print what it returned (its
     statistics recomputed from the returned logs or arrays, solver-ok
     >= 0.99), launch its path's kernels and no other; the propagation
     within TOL_PROPAGATION of the CPU's float64 one. The sqp_iters = 2 and
     the catalog paths are also held as the loops are in phase 8
     (EVAL_HOLD, from the card's carry, the catalog's subset fed the card's
     noise). Each loop path (phase 3, after its timed window; WMPC for one
     policy period) and one served cycle of the pipelined dispatcher
     (phase 6) run under torch.cuda.set_sync_debug_mode("error"): no step
     may make the host wait for the card;
 11b. `fit`: the tire-identification tools (golden_attribution,
     fit_tires_es, fit_tires_closedloop) on a golden pair the card writes
     (FIT_GOLDEN_STEPS of the nominal NMPC and the SNMPC at UPH 15 from
     FIT_LAP_POINT, FIT_TIRES on plant and controller), in a child process
     (`--fit-child`) after `eval` and before any profiler session: each must
     exit normally, return and print finite numbers and launch K1-K6 and no
     other; prints the seconds per Adam run, ES generation and gradient. Held
     beside phase 8's CPU re-solves (children at TOOLS_SIDE_NICE): the
     closed-loop fit's first loss terms against the CPU's float64 ones
     (TOL_FIT_TERMS, TOL_FIT_DEV) and its first gradient against the nearest
     of the CPU's four references (TOL_GRAD), the ES's first generation as one
     batch against single-member runs on the card (TOL_FIT_DEV), the
     attribution's theta against the CPU's float64 fit (TOL_FIT_THETA);
 12. prints the seconds each phase took, one {"kernels": [...]} line
     (launches per path, the evaluation tools' as "eval/<tool>", the fit
     tools' and the goldens' as "fit/<tool>", and per
     closed-loop step on the entry, serving, sharding and differentiable
     paths; K7 and K8, which no path launches, with 0 and "path": null)
     and, last, the device line.

    python3 chip_smoke.py --kernels-only   # phases 1, 2 and the kernels' profiles

which prints the kernels' times as {"kernel_times": [...]}, without launch
counts: no path runs, so no counter is read.

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
# per path: settle steps, timed steps, steps rerun on the CPU (WMPC: 25, so
# that its first policy update, at step 20, falls inside)
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
# the untraced closed-loop step (ms) of PERF.md section 5, before the
# estimator's per-step host sync was removed (H100 80GB HBM3, 700 W),
# printed beside this run's
EARLIER_NOMINAL_STEP_MS = 51.357
# the kernels each path must launch; every other counter must stay 0
NOMINAL_KERNELS = ("linearize", "condense", "cholesky", "chol_solve", "ipm_iteration")
PATH_KERNELS = {
    "nominal": NOMINAL_KERNELS,
    "snmpc": ("linearize", "condense_from", "cholesky", "chol_solve", "ipm_iteration"),
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
}
# the tuning loops at full width, cut in depth (phase 4)
TRACKS_PPO = ("monteblanco", "modena")
TRACKS_BO = ("modena", "monteblanco")
PPO = dict(n_envs=16, n_steps=8, batch_size=64, n_epochs=2)
PPO_UPDATES, PPO_MPC_STEPS = 2, 20
BO = dict(n_initial=8, batch_size=5, n_mc=64)
BO_MAX_STEPS, BO_CHUNK = 150, 128
# closed-loop steps in every profile window
PROFILE_STEPS = 5
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
               "ipm_iteration")
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
       "cholesky_unblocked": 2e-5, "chol_solve_unblocked": 2e-5}
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
    return results, jobs


def profile_kernels(results, jobs):
    """The profiler's device time per launch of each timed kernel case and
    its library call, over LAUNCHES_TIMED launches; it is the `library_ms`
    of a library call that synchronizes with the host. Run after the timed
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


def profile_window(run, n_prof, step_s, tag):
    """A short torch.profiler window of a loop: `run()` drives `n_prof`
    closed-loop steps; device time by kernel and the device's busy share of
    the untraced step (`step_s` seconds). Returns the device kernels per
    step (None when the trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from tum_control_tpu_torch.tools.common import HAND_KERNEL, device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    kernels = [r for r in prof.key_averages() if str(r.device_type).endswith("CUDA")]
    dev_us = sum(device_us(r) for r in kernels)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{tag}.txt"), "w") as fh:
        fh.write("\n".join(f"{device_us(r):12.1f} us {r.count:7d}  {r.key}"
                           for r in sorted(kernels, key=lambda r: -device_us(r))))
    say(f"[profile/{tag}] window of {n_prof} steps and its trace: {time.perf_counter() - t0:.1f} s")
    wall_us, step_us = (t1 - t0) * 1e6, step_s * 1e6
    if dev_us > 0:
        say(f"[profile/{tag}] {n_prof} traced steps: {sum(r.count for r in kernels) / n_prof:.0f} "
            f"kernels/step, device busy {dev_us / n_prof:.1f} us/step; traced wall "
            f"{wall_us / n_prof:.1f} us/step, untraced {step_us:.1f} us/step -> device idle "
            f"share {1 - dev_us / n_prof / step_us:.4f} of the untraced step")
        for r in sorted(kernels, key=lambda r: -device_us(r))[:10]:
            say(f"[profile/{tag}]   {device_us(r) / n_prof:9.1f} us/step {r.count / n_prof:7.1f}"
                f" launches/step  {r.key[:80]}")
        hand = [r for r in kernels if HAND_KERNEL.search(r.key)]
        say(f"[profile/{tag}] hand-written kernels: " + "; ".join(
            f"{HAND_KERNEL.search(r.key).group(1)} {device_us(r) / n_prof:.1f} us/step in "
            f"{r.count / n_prof:.1f} launches" for r in sorted(hand, key=lambda r: -device_us(r))))
        return sum(r.count for r in kernels) / n_prof
    say(f"[profile/{tag}] no device time in the trace: device busy share not measured")
    return None


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
    before and read just after; then 3 timed env steps."""
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
    stamps = []

    def on_update(u, policy, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        callback(u, policy, m)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = trainer.train(PPO_UPDATES, seed=1, callback=on_update)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    save_policy_npz(trainer.policy, os.path.join(out, "policy_weights.npz"))
    say(f"[ppo] launches over {PPO_UPDATES} updates and one evaluation: {json.dumps(launches)}")
    check_launches("ppo", launches)
    update_s = [stamps[0] - t0] + [stamps[2 * i] - stamps[2 * i - 1]
                                   for i in range(1, PPO_UPDATES)]
    eval_s = sum(stamps[2 * i + 1] - stamps[2 * i] for i in range(PPO_UPDATES))
    say(f"[ppo] seconds per update (rollout of {PPO['n_steps']} env steps x {PPO['n_envs']} "
        f"envs x {PPO_MPC_STEPS} closed-loop steps, {PPO['n_epochs']} epochs): {update_s}; "
        f"evaluation {eval_s:.3f} s; metrics {history}")
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

    # timed env steps from fresh envs; the carry before the last one is
    # kept for the CPU hold and the profile window
    es, obs = env.reset(PPO["n_envs"], make_generator(2, dev))
    actions = torch.randint(0, env.n_actions, (4, PPO["n_envs"]),
                            generator=make_generator(3, dev), device=dev)
    es, obs, _, _ = env.step(es, actions[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for a in actions[1:3]:
        es, obs, reward, done = env.step(es, a)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / 2 * 1e3
    check(bool(((reward > 0) & (reward <= 1)).all()), "ppo: an env reward outside (0, 1]")
    check(bool(torch.isfinite(obs).all()), "ppo: non-finite observations")
    say(f"[ppo] env step ({PPO['n_envs']} envs x {PPO_MPC_STEPS} closed-loop steps) "
        f"{step_ms:.3f} ms, {step_ms / PPO_MPC_STEPS:.3f} ms per closed-loop step")
    return dict(launches=launches, env=env, es=es, action=actions[3],
                step_s=step_ms / PPO_MPC_STEPS / 1e3, update_s=update_s, eval_s=eval_s)


def bo_phase(dev):
    """The BO of the cost weights on the card: initial Sobol data and one
    step, counters reset just before and read just after; then one timed
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
    # (scenarios, s) of each group's objective call; every call here is one
    # chunk (8 x 10 and 5 x 10 pairs)
    chunks = []

    def timed_evaluate(p, seg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = evaluator.evaluate(p, seg)
        torch.cuda.synchronize()
        chunks.append((len(p) * seg.track.shape[0], time.perf_counter() - t))
        return out

    bo = BayesianOptimizer([functools.partial(timed_evaluate, seg=s) for s in segs],
                           BOConfig(**BO), seed=0, device=dev)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bo.generate_initial_data()
    t1 = time.perf_counter()
    bo.step(0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    say(f"[bo] launches over the initial data and one step: {json.dumps(launches)}")
    check_launches("bo", launches)
    fits = len(bo._gp_warm)
    say(f"[bo] initial data {t1 - t0:.3f} s, one step {t2 - t1:.3f} s ({fits} GP fits); "
        f"objective chunks (scenarios, s): {chunks}")
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
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    f, feasible = evaluator.run_chunk(*pairs)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t3
    group = (torch.arange(BO_CHUNK, device=dev) % S >= segs[0].track.shape[0]).long()
    per_group = [f"{int(feasible[group == g].sum())} of {int((group == g).sum())}" for g in range(2)]
    say(f"[bo] objective chunk of {BO_CHUNK} scenarios x {BO_MAX_STEPS} steps: {chunk_s:.3f} s, "
        f"{chunk_s / BO_MAX_STEPS * 1e3:.3f} ms per closed-loop step; feasible pairs per "
        f"group {per_group}")
    check(bool((torch.isfinite(f).all(dim=1) == feasible).all()),
          "bo: the chunk's objectives are not finite exactly where feasible")
    return dict(launches=launches, evaluator=evaluator, pairs=pairs, f=f, feasible=feasible,
                group=group, chunk_s=chunk_s, step_s=chunk_s / BO_MAX_STEPS, chunks=chunks)


def tuning_profile_windows(ppo, bo):
    """The tuning loops' profile windows: one env step and one objective
    chunk, each of PROFILE_STEPS closed-loop steps, by an env and an
    evaluator of their own over the phases' closed loops."""
    from tum_control_tpu_torch.learn.bo.objective import ObjectiveEvaluator
    from tum_control_tpu_torch.learn.env import RLEnv

    env = ppo["env"]
    env_short = RLEnv(env.sim, env.stacked, env.table.cpu().numpy(), env.obs_cfg,
                      env.cfg._replace(n_mpc_steps=PROFILE_STEPS))
    profile_window(functools.partial(env_short.step, ppo["es"], ppo["action"]), PROFILE_STEPS,
                   ppo["step_s"], "ppo")
    ev = bo["evaluator"]
    ev_short = ObjectiveEvaluator(ev.sim, ev.stacked, max_steps=PROFILE_STEPS, chunk=ev.chunk)
    profile_window(functools.partial(ev_short.run_chunk, *bo["pairs"]), PROFILE_STEPS,
                   bo["step_s"], "bo")


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
    are reset just before the settle run and read just after the timed run.
    Returns what the profile window and the CPU re-solve need."""
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, log_settle = sim.run_from(carry, settle)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    carry, log = sim.run_from(carry, steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    say(f"[loop/{path}] launches over {settle + steps} steps: {json.dumps(launches)}")
    check_launches(path, launches)

    for lg in (log_settle, log):
        for f, v in lg._asdict().items():
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"{path}: non-finite values in SimLog.{f}")
    status = log.simSolverDebug[..., 4]
    ok = float((status == 0).float().mean())
    lat = log.lat_dev.abs().flatten().double().cpu()
    sps = B * steps / (t2 - t1)
    p50, p99 = float(torch.quantile(lat, 0.5)), float(torch.quantile(lat, 0.99))
    say(f"[loop/{path}] B={B} settle {settle} steps {t1 - t0:.3f} s, timed {steps} steps "
        f"{t2 - t1:.3f} s: {sps:.1f} solves/s, {(t2 - t1) / steps * 1e3:.3f} ms/step")
    say(f"[loop/{path}] solver ok fraction {ok:.5f}; |lat_dev| p50 {p50:.4f} m, p99 {p99:.4f} m")
    if path == "nominal":
        say(f"[loop/{path}] untraced step {(t2 - t1) / steps * 1e3:.3f} ms (with the "
            f"estimator's host sync, PERF.md section 5: {EARLIER_NOMINAL_STEP_MS} ms)")
    check(ok >= 0.99, f"{path}: solver ok fraction {ok} < 0.99")
    # after the timed window: steps that may not synchronize with the host
    # (WMPC: one policy period, so that an update falls inside)
    n_sync = getattr(sim.controller, "period", 1)
    without_sync(lambda: sim.run_from(carry, n_sync), f"loop/{path}", n_sync)
    act = log.wmpc_action
    if PATH_CONFIG[path].get("enable_WMPC"):
        check(bool((act >= 0).all()), f"{path}: a WMPC step logged no action")
        change = act[:, 1:] != act[:, :-1]
        hist = torch.bincount(act.flatten().long().cpu(), minlength=sim.controller.policy.n_actions)
        say(f"[loop/{path}] weight switches in the {steps} timed steps: {int(change.any(0).sum())} "
            f"steps switched in some scenario, {int(change.sum())} (scenario, step) switches; "
            f"action histogram over (scenario, step) {hist.tolist()}")
    else:
        check(bool((act == -1).all()), f"{path}: actions logged without WMPC")
    return dict(launches=launches, sim=sim, carry0=carry0, carry=carry, step_s=(t2 - t1) / steps)


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
    t0 = time.perf_counter()
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
        f"the CPU in {time.perf_counter() - t0:.1f} s; max |simU f64| per input {scale.tolist()}")
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


def entry_phase(dev, smi):
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
    logs, summary, wall = entry_main.run_main(cfg, mpc, device=dev, logs_path=out,
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
    say(f"[entry/main] {smi}: B=1, {n} steps in {wall:.3f} s: {wall / n * 1e3:.3f} ms/step, "
        f"{n / wall:.2f} solves/s; solver ok {ok:.4f}, |lat_dev| max "
        f"{summary['dev_lat_max']:.4f} m, mean {summary['dev_lat_mean']:.4f} m")
    runs["main"] = dict(launches=launches, steps=n + warm, step_s=wall / n, cfg=cfg, mpc=mpc)

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
    play, summary, wall = entry_main.run_main(play_cfg, mpc, device=dev, logs_path=out,
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
    say(f"[entry/main_playback] {n} steps replayed in {wall:.3f} s with another seed: "
        f"disturbances equal, max |CiLX replay - recording| {gap:.3e} ({gap / scale:.3e} of "
        f"max |CiLX|, tol {TOL_PLAYBACK:.0e}); solver ok {summary['solver_ok_frac']:.4f}")
    check(gap <= TOL_PLAYBACK * scale, f"main_playback: CiLX {gap:.3e} from the recording")
    runs["main_playback"] = dict(launches=launches, steps=2 * (n + warm), cfg=play_cfg)

    # the baseline sweep through its entry module
    sweep_dir = os.path.join(out, "baseline")
    n = int(SWEEP_T / 0.02)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summaries = sweep_entry.main(["--T", str(SWEEP_T), "--tracks", *SWEEP_TRACKS,
                                  "--out", sweep_dir, "--device", str(dev)])
    sweep_s = time.perf_counter() - t0
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
    say(f"[entry/sweep] {n_sets} sets x {len(SWEEP_TRACKS)} tracks = "
        f"{n_sets * len(SWEEP_TRACKS)} scenarios x {n} steps: {sweep_s:.3f} s for the entry "
        f"module (build, sweep and {n_sets * len(SWEEP_TRACKS)} npz), "
        f"{sweep_s / n * 1e3:.3f} ms per closed-loop step")
    runs["sweep"] = dict(launches=launches, steps=n, seconds=sweep_s)

    # the policy: a lap of run_policy, then the action-probability trace
    n = int(POLICY_T / 0.02)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs, summary = run_policy(WMPC_MODEL, T=POLICY_T, device=dev)
    torch.cuda.synchronize()
    policy_s = time.perf_counter() - t0
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
    say(f"[entry/policy] run_policy {n} steps in {policy_s:.3f} s "
        f"({policy_s / n * 1e3:.3f} ms/step incl. build); summary {summary}; actions "
        f"{sorted(set(act.tolist()))}, trace actions equal: {np.array_equal(actions, act)}; "
        f"max |sum of a probability row - 1| {row_err:.3e}")
    runs["policy"] = dict(launches=launches, steps=2 * n)
    entry_holds(dev, runs, rec)
    return runs


def entry_holds(dev, runs, rec):
    """Each entry path's closed loop again on the card, untimed, set up for
    cpu_phase (`runs[path]["hold"]`): main from HOLD_LAP_POINT,
    main_playback from the shipped configs' initial state fed the recorded
    disturbances (a step's disturbance moves the plant, and so the next
    step's solve), the sweep's 52 scenarios on their laps under their
    weights, and the policy from HOLD_LAP_POINT after its first
    ENTRY_CPU["policy"][0] steps, so that its first update falls inside the
    window. main's profile window starts from the shipped configs' initial
    state (`runs["main"]["start"]`)."""
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
        return start

    runs["main"]["start"] = hold("main", runs["main"]["cfg"], runs["main"]["mpc"])

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


def entry_profile_window(run):
    """main.py's closed loop (B = 1) in a profile window of PROFILE_STEPS
    steps, from the shipped configs' initial state."""
    profile_window(functools.partial(run["hold"]["sim"].run_from, run["start"], PROFILE_STEPS),
                   PROFILE_STEPS, run["step_s"], "main")


def serve_phase(dev, smi):
    """The serving entry module in-process (deploy_rt.main): SERVE_CYCLES
    cycles synchronous, then as many with --pipeline 2, each with its
    telemetry exported and read back; the counters are reset just before
    the first run and read just after the second. Then, untimed, the
    synchronous controls against run_from's from the same carry."""
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
    say(f"[serve] launches over 2 x ({SERVE_CYCLES} cycles and the warm-up step): "
        f"{json.dumps(launches)}")
    check_launches("serve", launches)
    for mode, rec in recs.items():
        st = res[mode]["stats"]
        check(rec.shape == (SERVE_CYCLES,) and st["cycles"] == SERVE_CYCLES,
              f"serve/{mode}: {rec.shape[0]} records, {st['cycles']} cycles")
        check(bool((rec["status"] == 0).all()), f"serve/{mode}: statuses {set(rec['status'])}")
        for f in rec.dtype.names:
            check(bool(np.isfinite(rec[f]).all()), f"serve/{mode}: non-finite telemetry {f}")
        what = "solve" if mode == "sync" else "age"
        say(f"[serve/{mode}] {smi}: {what} ms p50 {st['solve_ms_p50']:.3f} p99 "
            f"{st['solve_ms_p99']:.3f} max {st['solve_ms_max']:.3f} mean {st['solve_ms_mean']:.3f};"
            f" misses {st['deadline_misses']}/{st['cycles']} at {SERVE_PERIOD * 1e3:.0f} ms")
    r = res["pipeline"]
    a = r["age"]
    say(f"[serve/pipeline] stale cycles {r['stale_cycles']}/{SERVE_CYCLES}, distinct controls "
        f"{r['distinct_controls']}; completion p50/p99 {a['completion_p50']:.3f}/"
        f"{a['completion_p99']:.3f} ms (host enqueue {a['enqueue_p50']:.3f}/"
        f"{a['enqueue_p99']:.3f}), phase wait p50/p99 {a['phase_wait_p50']:.3f}/"
        f"{a['phase_wait_p99']:.3f} ms, final lead {a['final_lead_ms']:.3f} ms; freezes "
        f"{r['freezes']} ({r['frozen_ms']:.1f} ms), late starts {r['late_starts']} "
        f"({r['late_env']} environment / {r['late_app']} application), stale holds attributed "
        f"{r['stale_attributed']}, steal {r['steal_s']}")
    say(f"[serve] {json.dumps({'sync': res['sync'], 'pipeline': res['pipeline']})}")

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

    # one served cycle of the pipelined dispatcher (the step, its packed
    # vector copied into pinned memory, an event behind the copy) may not
    # make the host wait for the card
    carry = sim.init_carry(x0m[None], x0s[None], key=0)
    zeros = torch.zeros_like(carry.x_sim)
    rows = torch.empty((2, deploy_rt.PACKED), dtype=torch.float32, pin_memory=True)
    carry, ev = deploy_rt.dispatch_step(sim, carry, zeros, rows[0])
    ev.synchronize()
    _, ev = without_sync(lambda: deploy_rt.dispatch_step(sim, carry, zeros, rows[1]), "serve", 1)
    ev.synchronize()
    check(bool(torch.isfinite(rows).all()) and float(rows[1, 6]) == 0.0,
          f"serve: the dispatched cycle's packed row {rows[1].tolist()}")
    return dict(launches=launches, steps=2 * (SERVE_CYCLES + 1), results=res)


def distributed_phase(dev):
    """initialize_distributed with NCCL at world size 1 on a free localhost
    port; the sharded nominal loop (its all-reduced mean |lat_dev| against
    the local reduction) and scaling_report at one card; the counters reset
    just before the loop and read just after the report."""
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
    say(f"[distributed] scaling_report {json.dumps(rows)}")
    return dict(launches=launches, steps=DIST_STEPS + 2 * SCALING["steps"], rows=rows)


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
    tire log-multipliers (tires in plant and controller); seconds with the
    device synchronized. With `k2_values` (a dtype), K2's outputs take the
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
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
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
    sync()
    ok = int((log.simSolverDebug[..., 4] == 0).sum())
    return g.double().cpu().numpy(), float(loss.detach()), ok, time.perf_counter() - t0


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


def diffmode_phase(dev, smi):
    """The tire gradient on the card in float32 through the kernels (twice,
    the second timed; the counters reset just before and read just after)
    against the nearest of the CPU's reference gradients from the same
    start, per component (TOL_GRAD)."""
    from tum_control_tpu_torch.ops.kernels import build

    build.reset_launches()
    g_warm, _, _, s_first = diffmode_gradient(dev, torch.float32)
    g32, loss32, ok32, s32 = diffmode_gradient(dev, torch.float32)
    launches = dict(build.LAUNCHES)
    g64, loss64, ok64, s64 = diffmode_gradient("cpu", torch.float64)
    refs = diffmode_references(g64)
    say(f"[diffmode] launches over 2 gradients of {DIFF_STEPS} steps: {json.dumps(launches)}")
    check_launches("diffmode", launches)
    check(bool(np.isfinite(g32).all()) and float(np.abs(g32).max()) > 0,
          f"diffmode: card gradient {g32}")
    check(ok32 == DIFF_B * DIFF_STEPS and ok64 == DIFF_B * DIFF_STEPS,
          f"diffmode: solver ok {ok32} / {ok64} of {DIFF_B * DIFF_STEPS}")
    gap = np.abs(g32 - g64)
    rel = grad_gap(g32, g64)
    rerun = float(np.abs(g32 - g_warm).max())
    say(f"[diffmode] {smi}: B={DIFF_B}, {DIFF_STEPS} steps from lap point {HOLD_LAP_POINT}: "
        f"loss card f32 {loss32:.9e} cpu f64 {loss64:.9e}; gradient card f32 "
        f"{np.array2string(g32, precision=6, max_line_width=10**4)}, cpu f64 "
        f"{np.array2string(g64, precision=6, max_line_width=10**4)}; per-component gap from "
        f"cpu f64 {np.array2string(rel, precision=3, max_line_width=10**4)}; max |gap| / max "
        f"|g| {gap.max() / np.abs(g64).max():.3e}; rerun gap {rerun:.3e}")
    fmt = lambda a: np.array2string(a, precision=3, max_line_width=10**4)
    near = {name: grad_gap(g32, r) for name, r in refs.items()}
    for name, r in refs.items():
        say(f"[diffmode] reference {name}: per-component gap from cpu f64 {fmt(grad_gap(r, g64))};"
            f" the card's from it {fmt(near[name])}")
    best = min(near, key=lambda name: near[name].max())
    say(f"[diffmode] seconds per gradient: card f32 {s32:.3f} s (first {s_first:.3f} s), "
        f"cpu f64 {s64:.3f} s ({torch.get_num_threads()} threads)")
    say(f"[diffmode] nearest reference {best} (tol {TOL_GRAD:.0e}, floor {GRAD_FLOOR:.0e} of "
        f"max |g|)")
    check(bool((near[best] <= TOL_GRAD).all()),
          f"diffmode: card gradient per component {near[best]} from the nearest reference, {best}")
    return dict(launches=launches, steps=2 * DIFF_STEPS,
                result=dict(g32=g32.tolist(), g64=g64.tolist(), rel=rel.tolist(), nearest=best,
                            s32=s32, s_first=s_first, s64=s64))


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(xa.to(dev, torch.float32), u.to(dev, torch.float32), 0.0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check_launches("robust_utils", launches)
    out = out.double().cpu()
    check(bool(torch.isfinite(out).all()), "robust_utils: non-finite augmented step")
    gx = ((out[:, :8] - ref[:, :8]).abs().amax(0) / ref[:, :8].abs().amax(0)).numpy()
    S, S_ref = ru.vec2sym_mat(out[:, 8:]), ru.vec2sym_mat(ref[:, 8:])
    d = torch.diagonal(S_ref, dim1=-2, dim2=-1)
    gd = (torch.diagonal(S - S_ref, dim1=-2, dim2=-1).abs() / d).amax(0).numpy()
    gc = float(((S - S_ref).abs() / torch.sqrt(d[:, :, None] * d[:, None, :])).max())
    say(f"[robust_utils] B={AUG_B}, one 8-substep augmented step on the card in {secs:.3f} s: "
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
    `TOOL {...}` line: its seconds, launches, whether every number it
    returned and printed is finite, and its headline numbers. A tool that
    raises ends the process with a traceback and a non-zero exit."""
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        printed = buf.getvalue()
        print(printed, end="", flush=True)
        rec = dict(name=name, argv=argv, seconds=secs, launches=dict(build.LAUNCHES),
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


def tools_phase(smi, loop_kernels, side_recs):
    """Phase 10: the nine tools, TOOLS_MAIN in a child process
    (`side_recs`: TOOLS_SIDE's records, whose children ran beside the CPU
    re-solves); each must exit normally, return and print finite numbers and
    launch its kernels (tool_kernels) and no other. Prints each tool's
    headline numbers beside the card, diag_precision's two modes side by
    side, and profile_step's kernels per stage against the loops' kernels
    per step (`loop_kernels`, their profile windows)."""
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
        say(f"{tag} {smi}: {r['seconds']:.1f} s; launches {json.dumps(launched)}; "
            f"{json.dumps(r['headline'])}")
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
                f"{parts:.0f}, full step {h['full step']['kernels']:.0f}; the {ctrl} loop's "
                f"profile window {loop_kernels[ctrl]:.0f} per step")
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
    seconds, launches, whether every number it returned and printed is
    finite, its headline numbers, `errors` (eval_recheck; for
    acc24_figures the propagation's gap from the CPU's float64 one beyond
    TOL_PROPAGATION) and `extra`: closed-loop steps (laps), scenarios and
    steps a second (catalogs), the propagation's gap. A tool that raises
    ends the process with a traceback and a non-zero exit."""
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if name == "acc24_figures":
                res = mod.propagate(torch.device("cuda"))[0]
            else:
                res = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
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
            steps = int(round(float(argv[argv.index("--T") + 1]) / 0.02))
            extra["catalogs"] = {c: dict(scenarios=r["scenarios"], seconds=r["seconds"],
                                         solves_per_s=r["scenarios"] * steps / r["seconds"])
                                 for c, r in res["runs"].items()}
        rec = dict(name=name, argv=argv, seconds=secs, launches=launches,
                   finite=all_finite(res) and not NONFINITE.search(printed),
                   headline=headline(res), errors=errors, extra=extra)
        print("TOOL " + json.dumps(rec), flush=True)
    return 0


def eval_phase(smi):
    """Phase 11: the evaluation tools (EVAL) in a child process; each must
    exit normally, return and print finite numbers, print what it returned
    (eval_recheck), and launch its kernels (tool_kernels) and no other.
    Prints each one's headline numbers and seconds beside the card,
    quality_exp's launches per step, and each catalog's scenarios and
    solves/s. Returns {"eval/<tool>": launches}."""
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
        say(f"{tag} {smi}: {r['seconds']:.1f} s; launches {json.dumps(launched)}; "
            f"{json.dumps(r['extra'])}; {json.dumps(r['headline'])}")
        if r["name"] in ("quality_exp", "one_lap") and r["extra"].get("steps"):
            per = {k: n / r["extra"]["steps"] for k, n in launched.items()}
            say(f"{tag} launches per closed-loop step: {json.dumps(per)}")
        for cat, c in r["extra"].get("catalogs", {}).items():
            say(f"[eval/catalog] {cat} {smi}: {c['scenarios']} scenarios in one batch, "
                f"{c['seconds']:.3f} s, {c['solves_per_s']:.1f} solves/s")
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
    """K1-K6 of the nominal NMPC and the SNMPC, and no other kernel."""
    for name, n in launches.items():
        if name in FIT_KERNELS:
            check(n > 0, f"{tag}: kernel {name} was not launched")
        else:
            check(n == 0, f"{tag}: kernel {name} was launched")


def fit_child(runs):
    """`--fit-child RUNS`: each [tool, argv] of RUNS (JSON) on the card in
    this process, the launch counters reset just before and read just
    after; prints the tool's output, then one `TOOL {...}` line: its seconds,
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        printed = buf.getvalue()
        print(printed, end="", flush=True)
        rec = dict(name=name, argv=argv, seconds=secs, launches=dict(build.LAUNCHES),
                   finite=all_finite(jsonable(res)) and not NONFINITE.search(printed),
                   result=jsonable(res))
        print("TOOL " + json.dumps(rec), flush=True)
    return 0


def fit_phase(dev, smi):
    """The `fit` phase: the synthetic goldens on the card, then the three
    tools in a child process; each must exit normally, return and print
    finite numbers, and launch K1-K6 (FIT_KERNELS) and no other. Prints the
    seconds of each unit of work beside the card. Returns dict(launches per
    path "fit/<tool>", recs by tool, golden_s)."""
    from tum_control_tpu_torch.config import MPCConfig
    from tum_control_tpu_torch.ops.kernels import build
    from tum_control_tpu_torch.tools import tire_fit

    d = os.path.join(REPO, FIT_DIR)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, cfg in (("nominal", MPCConfig()), ("snmpc", MPCConfig(**tire_fit.SNMPC))):
        logs = tire_fit.write_golden(os.path.join(d, name, "full_logs.npz"), cfg,
                                     FIT_GOLDEN_STEPS, FIT_TIRES, dev, torch.float32,
                                     start=FIT_LAP_POINT)
        check(bool(np.isfinite(logs["CiLX"]).all()), f"fit/golden {name}: non-finite states")
        failed = np.flatnonzero(logs["simSolverDebug"][:, 4] != 0).tolist()
        say(f"[fit/golden] {name}: {FIT_GOLDEN_STEPS} steps, mean |dev_lat| "
            f"{np.abs(logs['dev_lat']).mean():.6f} m; failed solves at steps {failed}")
    torch.cuda.synchronize()
    golden_s = time.perf_counter() - t0
    launches = {"fit/golden": dict(build.LAUNCHES)}
    check_fit_launches("fit/golden", launches["fit/golden"])
    say(f"[fit/golden] {smi}: both goldens in {golden_s:.2f} s")
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
        say(f"{tag} {smi}: {r['seconds']:.2f} s; launches {json.dumps(launched)}")
    res = {r["name"]: r["result"] for r in recs}
    a = res["golden_attribution"]
    say(f"[fit/golden_attribution] {smi}: {FIT_RUNS[0][1][1]} Adam steps in {a['fit_s']:.3f} s "
        f"({a['fit_s'] / int(FIT_RUNS[0][1][1]) * 1e3:.3f} ms a step, float64); one-step RMS "
        f"{a['rms0']:.6f} -> {a['rms1']:.6f}; laps (s): {json.dumps(a['laps_s'])}; "
        f"verdicts {a['verdict']} / {a['verdict_snmpc']}")
    for k, g in enumerate(res["fit_tires_es"]["generations"]):
        b = g["best"]
        say(f"[fit/fit_tires_es] {smi}: generation {k}: {g['seconds']:.3f} s for 8 members x "
            f"2 laps of {FIT_GOLDEN_STEPS} steps; best fit {g['fit'][b]:.6f}, ratios "
            f"{g['rn'][b]:.6f} / {g['rs'][b]:.6f}, ok {g['okn'][b]} / {g['oks'][b]}")
    for k, it in enumerate(res["fit_tires_closedloop"]["iterations"]):
        say(f"[fit/fit_tires_closedloop] {smi}: gradient {k}: {it['seconds']:.3f} s; loss "
            f"{it['loss']:.6e}, ratios {it['rn']:.6f} / {it['rs']:.6f}, |g| {it['gnorm']:.4e}, "
            f"sanitizer: smallest state scale {it['min_scale']:.4e}, largest |theta cotangent| "
            f"{it['max_g_theta']:.4e}")
    return dict(launches=launches, recs=res, golden_s=golden_s)


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
        t0 = time.perf_counter()
        with k2_valued(valued):
            prob = cl.FitProblem(args, cpu, dtype)
            loss, aux, g = prob.value_and_grad(prob.theta0)
        refs[label] = dict(zip(FIT_TERMS, [float(loss)] + [float(v) for v in aux]),
                           grad=g.double().numpy().tolist(), seconds=time.perf_counter() - t0)
    ga_args = ga.parse_args(spec["attr_argv"] + ["--device", "cpu"])
    t0 = time.perf_counter()
    _, rms0, rms1, theta = ga.fit_tires(tire_fit.load_golden(ga_args.golden), ga_args.steps,
                                        device=cpu)
    attr = dict(theta=theta.tolist(), rms0=rms0, rms1=rms1, seconds=time.perf_counter() - t0)
    print("TOOL " + json.dumps(dict(name="fit_cpu_holds", refs=refs, attribution=attr,
                                    threads=torch.get_num_threads())), flush=True)
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
        say(f"[fit/hold] reference {label} ({r['seconds']:.1f} s on {cpu['threads']} thread(s)):"
            f" gap from cpu f64 {fmt(grad_gap(g, g64))}; the card's from it {fmt(near[label])}")
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
    t_start = time.perf_counter()
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

    def lap(phase, since):
        now = time.perf_counter()
        say(f"[time] {phase}: {now - since:.1f} s")
        return now

    t = lap("start and build", t_start)
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
    t = lap("kernel phase", t)
    if "--kernels-only" in sys.argv[1:]:
        profile_kernels(results, jobs)
        say(json.dumps({"kernel_times": list(results.values())}))
        return 0
    # every timed loop before any profiler session and any CPU re-solve, so
    # that no path's host clock runs after either
    runs = {}
    for path in PATHS:
        runs[path] = loop_phase(dev, path)
        t = lap(f"loop/{path}", t)
    runs["ppo"] = ppo_phase(dev)
    t = lap("ppo", t)
    runs["bo"] = bo_phase(dev)
    t = lap("bo", t)
    runs.update(entry_phase(dev, smi.splitlines()[0]))
    t = lap("entry", t)
    runs["serve"] = serve_phase(dev, smi.splitlines()[0])
    t = lap("serve", t)
    runs["distributed"] = distributed_phase(dev)
    t = lap("distributed", t)
    eval_launches = eval_phase(smi.splitlines()[0])
    t = lap("eval", t)
    holds = eval_holds(dev)
    t = lap("eval holds on the card", t)
    fit = fit_phase(dev, smi.splitlines()[0])
    t = lap("fit", t)
    for path in PATHS:
        run = runs[path]
        run["kernels_per_step"] = profile_window(
            functools.partial(run["sim"].run_from, run["carry"], PROFILE_STEPS), PROFILE_STEPS,
            run["step_s"], path)
    ppo, bo = runs["ppo"], runs["bo"]
    tuning_profile_windows(ppo, bo)
    entry_profile_window(runs["main"])
    t = lap("profile windows", t)
    profile_kernels(results, jobs)
    t = lap("kernel profiles", t)
    # the tools whose times are not measurements (diag_precision --tf32,
    # dump_qps's scipy re-solve on the host) run beside the CPU re-solves
    side = start_tool_children(TOOLS_SIDE, TOOLS_SIDE_NICE)
    try:
        side += start_fit_holds(fit)
        for path in PATHS:
            run = runs[path]
            cpu_phase(path, run["sim"], move_carry(run["carry0"], dev, torch.float32),
                      PATHS[path][2], SimConfig(sim_mode=0), MPCConfig(**PATH_CONFIG[path]))
            t = lap(f"cpu/{path}", t)
        ppo_cpu_check(ppo)
        t = lap("cpu/ppo", t)
        bo_cpu_check(bo)
        t = lap("cpu/bo", t)
        for path in ENTRY:
            cpu_phase(path, **runs[path]["hold"])
            t = lap(f"cpu/{path}", t)
        for path in EVAL_CPU:
            cpu_phase(f"eval/{path}", **holds[path])
            t = lap(f"cpu/eval/{path}", t)
    except BaseException:
        stop_tool_children(side)
        raise
    side_recs = finish_tool_children(side)
    t = lap("tools beside the CPU re-solves", t)
    fit_recs = [r for r in side_recs if r["name"].startswith("fit_")]
    side_recs = [r for r in side_recs if not r["name"].startswith("fit_")]
    fit_holds(fit, fit_recs, smi.splitlines()[0])
    runs["diffmode"] = diffmode_phase(dev, smi.splitlines()[0])
    t = lap("diffmode", t)
    robust_utils_phase(dev)
    t = lap("robust_utils", t)
    tools_phase(smi.splitlines()[0], {path: runs[path]["kernels_per_step"]
                                      for path in ("nominal", "snmpc")}, side_recs)
    t = lap("tools", t)
    lap("whole script after the imports", t_start)
    all_paths = (list(PATHS) + list(TUNING) + list(ENTRY) + list(SERVE) + list(eval_launches)
                 + list(fit["launches"]))
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
