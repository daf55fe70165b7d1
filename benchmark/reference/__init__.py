"""Plain float64 reference of one closed-loop step, for both configurations.

A frozen copy of the plain path of `tum_control_tpu_torch` at commit
abaf9f73f952ff615086276e65521445df3d44a8, rewritten without any kernel
dispatch and without importing the port:

  model.py        <- models/vehicle_stm.py, models/integrators.py, params.py,
                     controllers/common.py (gg limits), config.py (loaders)
  qp.py           <- ops/ipm.py, ops/soft_qp.py, ops/kernels/ipm_iter.py
                     (iteration_ref), ops/kernels/chol.py (the plain
                     factorization and solve, as torch.linalg calls)
  engine.py       <- ops/rti.py (the generic Gauss-Newton branch, the
                     health check), ops/kernels/condense.py (condense_ref),
                     ops/kernels/linearize.py (linearize_ref)
  controllers.py  <- controllers/nominal.py, controllers/snmpc.py (the dense
                     formulation, `structured=False`), controllers/pce.py
  closed_loop.py  <- sim/closed_loop.py (step, sim_mode 0, undisturbed),
                     track/planner.py, track/trajectory.py, sim/estimator.py

It reads only the raw data files (vehicle, tire and gg tables, the
reference lap) and the settings of a benchmark configuration file, and
takes the program's carries as plain tensors. TF32 is switched off while it
runs (`tf32_off`); a float32 run of it with TF32 on is the correctness
control (benchmark/compare.py).
"""
