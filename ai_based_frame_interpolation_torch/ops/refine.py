"""The full-resolution refinement head: CUDA kernel and plain version.

Counterpart of the JAX package's ``ops/pallas/refine_fused.py``. With
``z = concat(pred, *planes)`` on the channel axis::

    z1  = relu(conv3x3(z  -> w) + b1)      # bf16, f32 accumulation
    z2  = relu(conv3x3(z1 -> w) + b2)      # or depthwise 3x3 + pointwise 1x1
    out = pred + conv1x1_f32(z2 -> C)      # f32, then the compute dtype

:func:`refine_head` launches ``csrc/refine_head.cu`` (dense head, width 16
or 64; depthwise head, width 64) for CUDA tensors and runs
:func:`refine_head_reference` for CPU tensors. Both take the JAX function's
NHWC layout.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build


def _conv(x, p, dtype, padding=0, groups=1):
    """Conv in ``dtype``, bias added after it (Flax ``Conv(dtype=...)``)."""
    y = F.conv2d(x, p["weight"].to(dtype), None, padding=padding,
                 groups=groups)
    return y + p["bias"].to(dtype).view(1, -1, 1, 1)


def refine_head_reference(y_full: torch.Tensor, planes: Sequence[torch.Tensor],
                          params: dict, compute_dtype=torch.bfloat16
                          ) -> torch.Tensor:
    """The head in plain PyTorch with the Flax head's rounding points.

    y_full : [B,H,W,C] pre-refine prediction (residual base, first plane)
    planes : [B,H,W,C] tensors concatenated after it (unet: (f1, f2))
    params : ``{"refine1", "refine2", "refine_out"}`` (or ``refine2_dw`` and
        ``refine2_pw`` for the depthwise head), each ``{"weight", "bias"}``
        in PyTorch's OIHW layout
    returns: [B,H,W,C] in ``compute_dtype``
    """
    cdt = compute_dtype
    pred = y_full.permute(0, 3, 1, 2).float()
    z = torch.cat([pred.to(cdt)] +
                  [p.permute(0, 3, 1, 2).to(cdt) for p in planes], 1)
    z = F.relu(_conv(z, params["refine1"], cdt, padding=1))
    if "refine2" in params:
        z = F.relu(_conv(z, params["refine2"], cdt, padding=1))
    else:
        z = _conv(z, params["refine2_dw"], cdt, padding=1, groups=z.shape[1])
        z = F.relu(_conv(z, params["refine2_pw"], cdt))
    out = params["refine_out"]
    delta = F.conv2d(z.float(), out["weight"].float(), out["bias"].float())
    return (pred + delta).to(cdt).permute(0, 2, 3, 1)


_WIDTHS = (16, 64)    # the kernel's head widths (flow, U-Net production)
_DW_WIDTH = 64       # the depthwise head's width (U-Net, refine_depthwise)
_MAX_PLANES = 4      # planes besides the prediction (flow: g0, g1, f1, f2)


def pack_head_weights(params: dict) -> dict:
    """The head's weights in the kernel's layouts: w1 as (out, tap, plane)
    in bf16 with a bf16 bias; w3 as (in, C) and b3 in f32. The dense head's
    w2 as (tap, out, in) in bf16 with a bf16 bias; the depthwise head's
    wdw as (tap, channel), rounded to bf16 and kept in f32 (the TPU kernel
    applies bf16 weights with f32 multiply-adds), and wpw as (out, in),
    each with a bf16 bias. A model builds them once when its weights are
    loaded (``pack_head``) and passes them to every :func:`refine_head`
    call."""
    w1 = params["refine1"]["weight"]
    width, nplanes = int(w1.shape[0]), int(w1.shape[1])
    c = int(params["refine_out"]["weight"].shape[0])
    bf16 = torch.bfloat16
    packed = {
        "w1": w1.permute(0, 2, 3, 1).reshape(width, 9 * nplanes).to(bf16)
        .contiguous(),
        "b1": params["refine1"]["bias"].to(bf16).contiguous(),
        "w3": params["refine_out"]["weight"].reshape(c, width).t()
        .to(torch.float32).contiguous(),
        "b3": params["refine_out"]["bias"].to(torch.float32).contiguous(),
    }
    if "refine2" in params:
        packed["w2"] = params["refine2"]["weight"].permute(2, 3, 0, 1) \
            .reshape(9, width, width).to(bf16).contiguous()
        packed["b2"] = params["refine2"]["bias"].to(bf16).contiguous()
    else:
        dw, pw = params["refine2_dw"], params["refine2_pw"]
        packed["wdw"] = dw["weight"].reshape(width, 9).t().to(bf16) \
            .to(torch.float32).contiguous()
        packed["bdw"] = dw["bias"].to(bf16).contiguous()
        packed["wpw"] = pw["weight"].reshape(width, width).to(bf16) \
            .contiguous()
        packed["bpw"] = pw["bias"].to(bf16).contiguous()
    return packed


def _lib():
    lib = _build.load("refine_head")
    fn = lib.refine_head_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 +
                       [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 +
                       [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def refine_head(y_full: torch.Tensor, planes: Sequence[torch.Tensor],
                params: dict, compute_dtype=torch.bfloat16,
                packed: Optional[dict] = None) -> torch.Tensor:
    """The refinement head: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (which raises on what the kernel does not
    take). Arguments as :func:`refine_head_reference`; planes may be bf16
    or f32 (the kernel rounds f32 planes to bf16 as it reads them).
    ``packed`` is :func:`pack_head_weights` of ``params``, built here when
    not given. ``refine_head.launches`` counts kernel launches."""
    if y_full.device.type == "cpu":
        return refine_head_reference(y_full, planes, params, compute_dtype)
    if y_full.device.type != "cuda":
        raise ValueError(f"refine_head: unsupported device {y_full.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("the refine_head kernel computes in bf16; got "
                         f"compute_dtype={compute_dtype}")
    b, h, w, c = y_full.shape
    nplanes = (1 + len(planes)) * c
    kw = packed if packed is not None else pack_head_weights(params)
    width = int(kw["w1"].shape[0])
    if c not in (1, 3) or not 1 <= len(planes) <= _MAX_PLANES:
        raise ValueError(f"refine_head kernel: C={c} with {len(planes)} "
                         "planes is not supported (C in {1, 3}, 1-4 planes)")
    depthwise = "wdw" in kw
    if width not in _WIDTHS or tuple(kw["w1"].shape) != (width, 9 * nplanes) \
            or tuple(kw["w3"].shape) != (width, c) \
            or depthwise != ("refine2" not in params):
        raise ValueError(f"refine_head kernel: weights {tuple(kw['w1'].shape)}"
                         f" do not match a width in {_WIDTHS} with {nplanes} "
                         f"planes and C={c}")
    if depthwise and width != _DW_WIDTH:
        raise ValueError(f"the depthwise refine_head kernel has width "
                         f"{_DW_WIDTH}; got {width}")
    dev = y_full.device
    extra, f32_bits = [], 0
    for k, p in enumerate(planes):
        if tuple(p.shape) != (b, h, w, c) or p.device != dev:
            raise ValueError("refine_head: every plane must match y_full's "
                             "shape and device")
        if p.dtype == torch.float32:
            f32_bits |= 1 << k
        elif p.dtype != torch.bfloat16:
            p = p.to(torch.bfloat16)
        extra.append(p.contiguous())
    if any(t.device != dev for t in kw.values()):
        raise ValueError("refine_head: weights must be on y_full's device")
    pred = y_full.to(torch.float32).contiguous()
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=dev)
    ptrs = [p.data_ptr() for p in extra] + [None] * (_MAX_PLANES - len(extra))
    # the depthwise head passes its pointwise conv in the w2 slot
    w2, b2 = (kw["wpw"], kw["bpw"]) if depthwise else (kw["w2"], kw["b2"])
    wdw, bdw = (kw["wdw"].data_ptr(), kw["bdw"].data_ptr()) if depthwise \
        else (None, None)
    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(pred.data_ptr(), *ptrs, f32_bits, nplanes, c,
                 kw["w1"].data_ptr(), kw["b1"].data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), wdw, bdw, kw["w3"].data_ptr(),
                 kw["b3"].data_ptr(), out.data_ptr(), b, h, w, width,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"refine_head kernel launch failed: CUDA error {err}")
    refine_head.launches += 1
    return out


refine_head.launches = 0
