"""The flow sampler: CUDA kernel and plain version.

Counterpart of the JAX package's ``ops/pallas/warp_fused.py``. For frames
``f1, f2``, a motion field ``F`` (frame1 -> frame2, pixels), a blend mask
``m`` and a time ``t`` per batch item::

    g0  = warp(f1, -t * F)          # shifts semantics, f32 (ops/warp.py)
    g1  = warp(f2, (1 - t) * F)
    out = ((1-t) m g0 + t (1-m) g1) / ((1-t) m + t (1-m) + 1e-6)

:func:`sample_fused` launches ``csrc/sample_fused.cu`` for CUDA tensors and
runs :func:`sample_fused_reference` for CPU tensors. Both take the JAX
function's NHWC layout and return f32 ``(out, g0, g1)``; the kernel takes
its inputs at any strides, so views of NCHW tensors go in without a copy.

The kernel has two paths: a tiled one for gray frames whose inputs all
have a column stride of 1 (the flow model's layout), and a general one
for everything else; :func:`kernel_path` asks the kernel which a call
takes.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build
from .warp import backward_warp


def config_eligible(cfg) -> bool:
    """Whether the sampler computes this config's warps: the single-field
    shifts warp (the cascade's stages run before it and do not change
    that). The bidirectional field and the other warps are sampled in stock
    PyTorch (``models/flow.py:sample_parts``), as JAX samples them in XLA."""
    return not cfg.flow_bidir and cfg.warp_impl == "shifts"


def eligible(cfg, channels_last_shape) -> bool:
    """Whether the sampler (kernel or plain) serves this config and frame
    shape: :func:`config_eligible`, gray or RGB frames of at least 2x2
    pixels. The kernel reads its taps directly, so it has no width bound
    (the JAX kernel's lane padding needs ``W >= 2*max_flow + 2``)."""
    h, w, c = channels_last_shape[-3:]
    return config_eligible(cfg) and c in (1, 3) and h >= 2 and w >= 2


def sample_fused_reference(f1: torch.Tensor, f2: torch.Tensor,
                           flow: torch.Tensor, mask: torch.Tensor,
                           t: torch.Tensor, max_flow: int = 32):
    """The sampler in plain PyTorch: two ``backward_warp`` calls and the
    blend, all in f32. Arguments as :func:`sample_fused`."""
    tb = t.float().view(-1, 1, 1, 1)
    flow = flow.float()
    m = mask.float()
    g0 = backward_warp(f1, -tb * flow, "shifts", max_flow)
    g1 = backward_warp(f2, (1.0 - tb) * flow, "shifts", max_flow)
    w0 = (1.0 - tb) * m
    w1 = tb * (1.0 - m)
    out = (w0 * g0 + w1 * g1) / (w0 + w1 + 1e-6)
    return out, g0, g1


def _lib():
    lib = _build.load("sample_fused")
    fn = lib.sample_fused
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 +
                       [ctypes.POINTER(ctypes.c_longlong)] +
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 +
                       [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.sample_fused_path.argtypes = [ctypes.POINTER(ctypes.c_longlong)] + [
            ctypes.c_int] * 3
        lib.sample_fused_path.restype = ctypes.c_int
    return fn


def _strides(f1, f2, flow, mask):
    return (ctypes.c_longlong * 15)(*f1.stride(), *f2.stride(),
                                    *flow.stride(), *mask.stride()[:3])


def kernel_path(f1, f2, flow, mask) -> str:
    """The path the kernel takes for these :func:`sample_fused` arguments,
    ``"tiled"`` or ``"general"``, as the built kernel decides it."""
    _lib()
    b, h, w, c = f1.shape
    tiled = _build.load("sample_fused").sample_fused_path(
        _strides(f1, f2, flow, mask), h, w, c)
    return "tiled" if tiled else "general"


def sample_fused(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                 mask: torch.Tensor, t: torch.Tensor, max_flow: int = 32):
    """The flow sampler: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (which raises on what the kernel does not take).

    f1, f2 : [B,H,W,C] frames, C 1 or 3, bf16 or f32 (the same dtype)
    flow   : [B,H,W,2] f32, (dx, dy) in pixels
    mask   : [B,H,W,1] f32 blend weight toward the frame1 candidate
    t      : [B] f32 sample times
    returns: ``(out, g0, g1)``, each [B,H,W,C] f32, contiguous
    ``sample_fused.launches`` counts kernel launches. The kernel has no
    backward: for CUDA tensors it raises under grad mode when an input
    requires grad (``_build.refuse_grad``).
    """
    if f1.device.type == "cpu":
        return sample_fused_reference(f1, f2, flow, mask, t, max_flow)
    if f1.device.type != "cuda":
        raise ValueError(f"sample_fused: unsupported device {f1.device}")
    _build.refuse_grad("sample_fused", f1, f2, flow, mask, t)
    b, h, w, c = f1.shape
    dev = f1.device
    if c not in (1, 3) or not (2 <= h <= 2 ** 22 and 2 <= w <= 2 ** 22):
        raise ValueError(f"sample_fused kernel: frames {tuple(f1.shape)} "
                         "are not supported (C in {1, 3}, H and W in "
                         "[2, 2^22])")
    if f1.dtype not in (torch.bfloat16, torch.float32) or f2.dtype != f1.dtype:
        raise ValueError("sample_fused kernel: f1 and f2 must both be bf16 "
                         f"or both f32, got {f1.dtype} and {f2.dtype}")
    want = {"f2": (f2, (b, h, w, c)), "flow": (flow, (b, h, w, 2)),
            "mask": (mask, (b, h, w, 1)), "t": (t, (b,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"sample_fused: {name} {tuple(x.shape)} on "
                             f"{x.device} does not match {shape} on {dev}")
        if name != "f2" and x.dtype != torch.float32:
            raise ValueError(f"sample_fused: {name} must be f32, got {x.dtype}")
    t = t.contiguous()
    strides = _strides(f1, f2, flow, mask)
    # out, g0 and g1: one allocation, three contiguous [B,H,W,C] views, each
    # at a 16-byte aligned offset (the kernel's 16-byte stores)
    n = b * h * w * c
    part = (n + 3) // 4 * 4
    buf = torch.empty(3 * part, dtype=torch.float32, device=dev)
    out, g0, g1 = (buf[k * part:k * part + n].view(b, h, w, c)
                   for k in range(3))
    fn = _lib()
    here = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        err = fn(f1.data_ptr(), f2.data_ptr(), flow.data_ptr(),
                 mask.data_ptr(), t.data_ptr(), strides, out.data_ptr(),
                 g0.data_ptr(), g1.data_ptr(), b, h, w, c, int(max_flow),
                 int(f1.dtype == torch.float32),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sample_fused kernel launch failed: CUDA error {err}")
    sample_fused.launches += 1
    return out, g0, g1


sample_fused.launches = 0
