"""PyTorch/CUDA port of the frame-interpolation framework.

A package of its own beside ``ai_based_frame_interpolation_tpu`` (the JAX
reference): it imports ``torch`` and never JAX or the JAX package, and keeps
that package's module names so each counterpart is easy to find. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""
