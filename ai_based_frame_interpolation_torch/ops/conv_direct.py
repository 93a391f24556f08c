"""Direct convolutions on the CUDA cores: CUDA kernel wrappers and plain
versions.

The fused tensor-core kernels (``csrc/refine_head.cu``,
``csrc/double_conv.cu``) compute in bf16 at fixed head widths. What they do
not take, f32 compute and bf16 heads wider than 64, is composed from the two
kernels of ``csrc/conv_direct.cu``:

    conv_direct(x, w, b)      = act(T(T(conv(x, w)) + b))       3x3 or 1x1, SAME
    conv_direct(x, w, b, low) = the same over concat(x, up2(low))
    conv_direct(..., depthwise=True): a depthwise 3x3, no ReLU
    head_out_direct(z, w3, b3, pred) = T(pred + (conv1x1_f32(z, w3) + b3))

T is the input's dtype (f32 or bf16), with the plain versions' rounding
points. Weights are packed once (:func:`pack_conv`). The wrappers launch
the kernels for CUDA tensors and run the plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _lerp2x(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x2 half-pixel lerp along ``axis`` in f32, edges clamped:
    ``out[2i] = 0.25 x[i-1] + 0.75 x[i]``, ``out[2i+1] = 0.75 x[i] +
    0.25 x[i+1]``, rounded to the input's dtype."""
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


def pack_conv(weight: torch.Tensor, bias: torch.Tensor, dtype,
              depthwise: bool = False) -> dict:
    """A conv's weights in the kernel's layout, once per model: ``w`` as
    (tap, in, out) ``[k*k][in][out]`` (depthwise: ``[9][channels]``) and
    ``b``, both f32 holding the values rounded to ``dtype``, from PyTorch's
    ``[out, in/groups, k, k]``."""
    if dtype not in _DTYPES:
        raise ValueError(f"the direct conv computes in {_DTYPES}; got {dtype}")
    cout, k = int(weight.shape[0]), int(weight.shape[-1])
    w = weight.to(dtype).float()
    if depthwise:
        w = w.reshape(cout, 9).t()
    else:
        w = w.permute(2, 3, 1, 0).reshape(k * k, -1, cout)
    return {"w": w.contiguous(), "b": bias.to(dtype).float().contiguous()}


def _oihw(w: torch.Tensor, depthwise: bool) -> torch.Tensor:
    """The packed weights back in PyTorch's layout."""
    if depthwise:
        return w.t().reshape(-1, 1, 3, 3)
    k = int(round(w.shape[0] ** 0.5))
    return w.reshape(k, k, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)


def conv_direct_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          low: Optional[torch.Tensor] = None,
                          relu: bool = True, depthwise: bool = False
                          ) -> torch.Tensor:
    """The conv in plain PyTorch, in x's dtype: the conv rounded there,
    then the bias, then the ReLU (``relu``). x ``[B,H,W,c0]``, with ``low``
    ``[B,H/2,W/2,c1]`` the input is ``concat(x, up2(low))``; ``w``, ``b``
    from :func:`pack_conv`. Returns ``[B,H,W,cout]`` contiguous."""
    dt = x.dtype
    if low is not None:
        x = torch.cat([x, upsample2x_half_pixel_nhwc(low.to(dt))], -1)
    weight = _oihw(w, depthwise).to(dt)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None,
                 padding=weight.shape[-1] // 2,
                 groups=weight.shape[0] if depthwise else 1)
    y = y + b.to(dt).view(1, -1, 1, 1)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


def head_out_reference(z: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                       pred: torch.Tensor) -> torch.Tensor:
    """The head's out conv and residual in plain PyTorch: f32 sums over
    ``z [...,width]`` with ``w3 [width][C]``, plus ``b3``, plus the f32
    ``pred``, rounded to z's dtype."""
    return (pred.float() + (z.float() @ w3 + b3)).to(z.dtype)


def _lib():
    lib = _build.load("conv_direct")
    fn, out = lib.conv_direct, lib.head_out_direct
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 +
                       [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2 +
                       [ctypes.c_int] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        out.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 +
                        [ctypes.c_longlong] + [ctypes.c_int] * 2 +
                        [ctypes.c_void_p])
        out.restype = ctypes.c_int
    return fn, out


def _check_cuda(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on {dev}")
    return dev


def conv_direct(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                low: Optional[torch.Tensor] = None, relu: bool = True,
                depthwise: bool = False) -> torch.Tensor:
    """The conv: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (which raises on what it does not take). Arguments as
    :func:`conv_direct_reference`. ``conv_direct.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return conv_direct_reference(x, w, b, low, relu, depthwise)
    args = (x, w, b) if low is None else (x, w, b, low)
    dev = _check_cuda("conv_direct", *args)
    dt = x.dtype
    bsz, h, wd, c0 = x.shape
    c1 = 0 if low is None else int(low.shape[-1])
    if dt not in _DTYPES or (low is not None and low.dtype != dt):
        raise ValueError(f"conv_direct computes in {_DTYPES}; got {dt}")
    if depthwise:
        ks, cout = 3, c0
        ok = tuple(w.shape) == (9, c0) and low is None
    else:
        ks, cout = (3 if w.shape[0] == 9 else 1), int(w.shape[-1])
        ok = w.dim() == 3 and w.shape[0] in (1, 9) and w.shape[1] == c0 + c1
    if not ok or tuple(b.shape) != (cout,) or w.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise ValueError(f"conv_direct: weights {tuple(w.shape)} "
                         f"{w.dtype} do not fit {c0}+{c1} input channels "
                         f"(pack_conv)")
    if low is not None and tuple(low.shape) != (bsz, h // 2, wd // 2, c1):
        raise ValueError(f"conv_direct: low {tuple(low.shape)} is not half "
                         f"of x {tuple(x.shape)}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    low = None if low is None else low.contiguous()
    out = torch.empty((bsz, h, wd, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        err = _lib()[0](int(dt == torch.bfloat16), ks, int(depthwise),
                        x.data_ptr(), None if low is None else low.data_ptr(),
                        bsz, h, wd, c0, c1, cout, w.data_ptr(), b.data_ptr(),
                        int(relu), out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"conv_direct kernel launch failed: CUDA error {err}")
    conv_direct.launches += 1
    return out


def head_out_direct(z: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                    pred: torch.Tensor) -> torch.Tensor:
    """The head's out conv and residual: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors. z ``[B,H,W,width]`` (f32 or bf16),
    w3 ``[width][C]`` and b3 ``[C]`` f32, pred ``[B,H,W,C]`` f32; C in
    1..3. ``head_out_direct.launches`` counts kernel launches."""
    if z.device.type == "cpu":
        return head_out_reference(z, w3, b3, pred)
    dev = _check_cuda("head_out_direct", z, w3, b3, pred)
    width, c = int(z.shape[-1]), int(pred.shape[-1])
    if z.dtype not in _DTYPES or tuple(w3.shape) != (width, c) or \
            tuple(b3.shape) != (c,) or not 1 <= c <= 3 or \
            tuple(pred.shape[:-1]) != tuple(z.shape[:-1]) or \
            any(t.dtype != torch.float32 for t in (w3, b3, pred)):
        raise ValueError(f"head_out_direct: z {tuple(z.shape)} {z.dtype}, "
                         f"w3 {tuple(w3.shape)}, pred {tuple(pred.shape)} "
                         "do not fit (f32 weights and pred, C in 1..3)")
    z, w3, b3, pred = (t.contiguous() for t in (z, w3, b3, pred))
    out = torch.empty(pred.shape, dtype=z.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib()[1](int(z.dtype == torch.bfloat16), z.data_ptr(),
                        w3.data_ptr(), b3.data_ptr(),
                        pred.data_ptr(), out.data_ptr(), pred.numel() // c,
                        width, c, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"head_out_direct kernel launch failed: CUDA "
                           f"error {err}")
    head_out_direct.launches += 1
    return out


conv_direct.launches = 0
head_out_direct.launches = 0
