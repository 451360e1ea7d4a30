"""The hand-written CUDA kernels (sources in brush_tpu_torch/csrc/), their
wrappers, their plain PyTorch versions and the nvcc build."""
