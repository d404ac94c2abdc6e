"""Hand-written CUDA kernels (sources in ``pretorched_tpu_torch/csrc``)."""
