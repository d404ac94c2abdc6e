"""Tensor ops of the port: pooling wrappers and the CUDA kernels."""
