"""Hand-written Hopper kernels (K1-K8) and their plain PyTorch versions (one
module per TPU kernel file of the JAX package)."""
