"""Hand-written CUDA kernels (sources in ``loops_tpu_torch/csrc/``), each
with its plain PyTorch version beside it."""
