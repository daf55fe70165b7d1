"""Hand-written Hopper kernels of the nominal closed loop and their plain
PyTorch versions (one module per TPU kernel file of the JAX package)."""
