"""PyTorch/CUDA port of tum_control_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one, with the same module layout and names.
It reads the same `data/Config` and `data/Trajectories` files and imports
neither `jax` nor `tum_control_tpu`.

Idiom differences from the JAX package:
  * tensors are batch-first `(B, ...)` with the scenario batch written out
    (the JAX package writes per-scenario code under `vmap`);
  * Python loops replace `lax.scan`;
  * every function takes an explicit `device` / `dtype` (or inherits them
    from its input tensors);
  * random draws come from a `torch.Generator`.

Every Pallas TPU kernel of the JAX package (K1-K8) is a hand-written CUDA
C++ kernel for sm_90a under `csrc/`, bound through `ops/kernels/`. Each kernel
wrapper dispatches by tensor: a CPU tensor runs the plain PyTorch version,
a CUDA float32 tensor launches the kernel, anything else raises.

Entry points (`api.build_simulation`) run on `cuda` unless the caller asks
for `device="cpu"`.
"""

__version__ = "0.1.0"
