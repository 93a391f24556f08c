"""The U-Net core's fused double conv and decoder up block: CUDA kernel and
plain versions.

Counterpart of the JAX package's ``ops/pallas/dconv_fused.py``. Both take
channels-last activations (``[B, H, W, C]``, what an implicit GEMM wants:
the contraction's channels contiguous) and the port's PyTorch conv weights
(``[out, in, 3, 3]``) with their biases::

    double_conv(x)          = relu(bf16(conv3x3(z1)) + b2)
        z1                  = relu(bf16(conv3x3(x)) + b1)     # bias add in bf16
    up_double_conv(skip, low) = double_conv(concat(skip, up2(low)))

``up2`` is the half-pixel 2x bilinear upsample with the TPU kernel's
rounding points (:func:`upsample2x_half_pixel_nhwc`), the skip channels
first. :func:`double_conv_fused` and :func:`up_double_conv_fused` launch
``csrc/double_conv.cu`` for CUDA tensors and run the plain versions for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build


def double_conv_reference(x: torch.Tensor, w1, b1, w2, b2,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The double conv in plain PyTorch: each conv in ``compute_dtype`` with
    its output rounded there, then the bias added and the ReLU, in that
    dtype (the port's ``DoubleConv``, folded). x ``[B,H,W,Cin]`` ->
    ``[B,H,W,Cout]`` contiguous."""
    cdt = compute_dtype
    v = x.permute(0, 3, 1, 2)
    for w, b in ((w1, b1), (w2, b2)):
        v = F.relu(F.conv2d(v.to(cdt), w.to(cdt), None, padding=1)
                   + b.to(cdt).view(1, -1, 1, 1))
    return v.permute(0, 2, 3, 1).contiguous()


def _lerp2x(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x2 half-pixel lerp along ``axis`` in f32, edges clamped:
    ``out[2i] = 0.25 x[i-1] + 0.75 x[i]``, ``out[2i+1] = 0.75 x[i] +
    0.25 x[i+1]``. Each product is exact in f32, so the sum rounds once."""
    n = x.shape[axis]
    f = x.float()
    prev = torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)], axis)
    even = 0.25 * prev + 0.75 * f
    odd = 0.75 * f + 0.25 * nxt
    out = torch.stack([even, odd], axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return out.reshape(shape).to(x.dtype)


def upsample2x_half_pixel_nhwc(low: torch.Tensor) -> torch.Tensor:
    """``[B,h,w,C] -> [B,2h,2w,C]`` half-pixel bilinear with the Pallas up
    kernel's rounding points (``dconv_fused.py:337-354``): the W pass over
    the input, rounded to its dtype, then the H pass over those values,
    rounded again. ``F.interpolate`` takes both taps at once and rounds
    once, which differs by an ulp of bf16 here and there."""
    return _lerp2x(_lerp2x(low, 2), 1)


def up_double_conv_reference(skip: torch.Tensor, low: torch.Tensor, w1, b1,
                             w2, b2, compute_dtype=torch.bfloat16
                             ) -> torch.Tensor:
    """The decoder up block in plain PyTorch: the double conv of
    ``concat([skip, up2(low)])`` on the channel axis. skip ``[B,H,W,Cs]``,
    low ``[B,H/2,W/2,Cu]``, w1 ``[mid, Cs+Cu, 3, 3]``."""
    up = upsample2x_half_pixel_nhwc(low.to(compute_dtype))
    x = torch.cat([skip.to(compute_dtype), up], -1)
    return double_conv_reference(x, w1, b1, w2, b2, compute_dtype)


def _ceil16(c: int) -> int:
    return (c + 15) // 16 * 16


def pack_dconv_weights(w1, b1, w2, b2, split: Optional[int] = None) -> dict:
    """The kernel's weight layouts, built once per model: w1 as
    ``[9][midp][k]`` (tap, out, in) and w2 as ``[9][coutp][midp]``, bf16
    with bf16 biases, every channel count rounded up to 16 with zeros. For
    the up block ``split`` is the skip's channel count: the skip and up
    parts of w1's input axis are padded each on its own, as the kernel lays
    them out in shared memory."""
    mid, cin = int(w1.shape[0]), int(w1.shape[1])
    cout = int(w2.shape[0])
    midp, coutp = _ceil16(mid), _ceil16(cout)
    parts = [(0, cin)] if split is None else [(0, split), (split, cin)]
    bf16 = torch.bfloat16

    def taps(w, nout, nin, noutp):       # [out,in,3,3] -> [9][noutp][nin]
        t = w.permute(2, 3, 0, 1).reshape(9, nout, nin).to(bf16)
        return F.pad(t, (0, 0, 0, noutp - nout))

    t1 = taps(w1, mid, cin, midp)
    w1p = torch.cat([F.pad(t1[..., lo:hi], (0, _ceil16(hi - lo) - (hi - lo)))
                     for lo, hi in parts], -1)
    t2 = taps(w2, cout, mid, coutp)
    return {"w1": w1p.contiguous(),
            "b1": F.pad(b1.to(bf16), (0, midp - mid)).contiguous(),
            "w2": F.pad(t2, (0, midp - mid)).contiguous(),
            "b2": F.pad(b2.to(bf16), (0, coutp - cout)).contiguous(),
            "split": split}


def _lib():
    fn = _build.load("double_conv").double_conv_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 +
                       [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def check_packed(packed: Optional[dict], w1, w2, c0: int, c1: int,
                 split: Optional[int]) -> None:
    """Raise unless ``packed`` is :func:`pack_dconv_weights` of weights of
    w1's and w2's shapes, for ``c0`` (+ ``c1`` up) input channels split at
    ``split``: what the kernel reads."""
    if packed is None:
        raise ValueError("double_conv: the kernel takes the weights packed "
                         "once per model (pack_dconv_weights); got none")
    mid, cout = int(w1.shape[0]), int(w2.shape[0])
    kin = _ceil16(c0) + (_ceil16(c1) if c1 else 0)
    if packed["split"] != split or \
            tuple(packed["w1"].shape) != (9, _ceil16(mid), kin) or \
            tuple(packed["w2"].shape) != (9, _ceil16(cout), _ceil16(mid)):
        raise ValueError(f"double_conv: packed weights (split "
                         f"{packed['split']}, w1 {tuple(packed['w1'].shape)})"
                         f" do not match w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)} split at {split}")


def _launch(x, low, w1, b1, w2, b2, packed, compute_dtype, split):
    """Check the inputs, then launch the kernel on the current stream."""
    if compute_dtype != torch.bfloat16:
        raise ValueError("the double_conv kernel computes in bf16; got "
                         f"compute_dtype={compute_dtype}")
    dev = x.device
    b, h, w, c0 = x.shape
    c1 = 0 if low is None else int(low.shape[-1])
    mid, cout = int(w1.shape[0]), int(w2.shape[0])
    if int(w1.shape[1]) != c0 + c1 or int(w2.shape[1]) != mid:
        raise ValueError(f"double_conv: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit {c0}+{c1} input "
                         "channels")
    if any(c % 8 for c in (c0, c1, mid, cout)):
        raise ValueError("the double_conv kernel takes channel counts that "
                         f"are multiples of 8; got {c0}, {c1}, {mid}, {cout}")
    if low is not None and (tuple(low.shape) != (b, h // 2, w // 2, c1)
                            or h % 2 or w % 2 or low.device != dev):
        raise ValueError(f"up_double_conv: low {tuple(low.shape)} is not "
                         f"half of skip {tuple(x.shape)} on {dev}")
    check_packed(packed, w1, w2, c0, c1, split)
    if any(packed[k].device != dev for k in ("w1", "b1", "w2", "b2")):
        raise ValueError("double_conv: weights must be on the input's device")
    xb = x.to(torch.bfloat16).contiguous()
    lb = None if low is None else low.to(torch.bfloat16).contiguous()
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _lib()(xb.data_ptr(), None if lb is None else lb.data_ptr(),
                     b, h, w, c0, c1, mid, cout, packed["w1"].data_ptr(),
                     packed["b1"].data_ptr(), packed["w2"].data_ptr(),
                     packed["b2"].data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"double_conv kernel launch failed: CUDA error {err}")
    return out


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def double_conv_fused(x: torch.Tensor, w1, b1, w2, b2,
                      compute_dtype=torch.bfloat16,
                      packed: Optional[dict] = None) -> torch.Tensor:
    """The double conv: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (which raises on what the kernel does not take).
    Arguments as :func:`double_conv_reference`; ``packed`` is
    :func:`pack_dconv_weights` of the weights, which the kernel needs (the
    plain version ignores it). ``double_conv_fused.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return double_conv_reference(x, w1, b1, w2, b2, compute_dtype)
    _check_device(x, "double_conv_fused")
    out = _launch(x, None, w1, b1, w2, b2, packed, compute_dtype, None)
    double_conv_fused.launches += 1
    return out


def up_double_conv_fused(skip: torch.Tensor, low: torch.Tensor, w1, b1, w2,
                         b2, compute_dtype=torch.bfloat16,
                         packed: Optional[dict] = None) -> torch.Tensor:
    """The decoder up block: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors. Arguments as :func:`up_double_conv_reference`;
    ``packed`` is :func:`pack_dconv_weights` with ``split`` the skip's
    channels, which the kernel needs. ``up_double_conv_fused.launches``
    counts kernel launches."""
    if skip.device.type == "cpu":
        return up_double_conv_reference(skip, low, w1, b1, w2, b2,
                                        compute_dtype)
    _check_device(skip, "up_double_conv_fused")
    out = _launch(skip, low, w1, b1, w2, b2, packed, compute_dtype,
                  int(skip.shape[-1]))
    up_double_conv_fused.launches += 1
    return out


double_conv_fused.launches = 0
up_double_conv_fused.launches = 0
