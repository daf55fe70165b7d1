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
                     formulation, `structured=False`), controllers/pce.py;
                     a later controller is a file `controller_<name>.py`
                     beside it, with hooks of its carried state
  closed_loop.py  <- sim/closed_loop.py (step, sim_mode 0: the plant, and
                     where the configuration draws them the disturbed
                     plant's RK4 and the estimation noise),
                     sim/disturbances.py (draw_disturbance), track/planner.py,
                     track/trajectory.py, sim/estimator.py

It reads only the raw data files (vehicle, tire and gg tables, the
reference lap) and the settings of a benchmark configuration file, and
takes the program's carries as plain tensors: the controller's carried
state, and the state of the program's generator, from which it draws the
step's disturbances itself. TF32 is switched off while it runs (`tf32`); a
float32 run of it with TF32 on is the correctness control
(benchmark/compare.py).
"""
