"""Tensor ops of the port; ``refine`` holds its CUDA kernel wrapper."""
