"""Tensor ops of the port; ``refine``, ``warp_fused`` and ``ssim_fused``
hold its CUDA kernel wrappers."""
