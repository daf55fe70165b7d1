"""SQP-RTI engine, interior-point QP solver and the CUDA kernels."""
