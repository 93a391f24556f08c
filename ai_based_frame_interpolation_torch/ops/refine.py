"""The full-resolution refinement head: CUDA kernel and plain version.

Counterpart of the JAX package's ``ops/pallas/refine_fused.py``. With
``z = concat(pred, *planes)`` on the channel axis::

    z1  = relu(conv3x3(z  -> w) + b1)      # bf16, f32 accumulation
    z2  = relu(conv3x3(z1 -> w) + b2)      # or depthwise 3x3 + pointwise 1x1
    out = pred + conv1x1_f32(z2 -> C)      # f32, then the compute dtype

:func:`refine_head` launches ``csrc/refine_head.cu`` (bf16: dense heads
of width up to 16 or 64, depthwise heads up to 64, zero-padded to the
instance's width), the tensor-core double conv of ``ops/dconv_fused.py``
and the out conv (dense bf16 heads of width 65-256), or the direct convs
of ``ops/conv_direct.py`` (f32, and the other bf16 heads)
(:func:`head_route`) for CUDA tensors, and runs
:func:`refine_head_reference` for CPU tensors. All take the JAX function's
NHWC layout.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build
from .conv_direct import conv_direct, head_out_direct, pack_conv
from .dconv_fused import double_conv_fused, pack_dconv_weights


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


_MAX_PLANES = 4      # planes besides the prediction (flow: g0, g1, f1, f2)
# the fused kernel's instances (csrc/refine_head.cu): route -> packed width
_FUSED = {"w16": 16, "w64": 64, "dw64": 64}
# the widest conv pair csrc/double_conv.cu runs for the option core (down2:
# 128 -> 256 -> 256), the widest dense bf16 head the "dconv" route takes
_DCONV_MAX = 256


def head_route(width: int, compute_dtype, depthwise: bool) -> str:
    """Which kernel takes a head on the card: a fused bf16 instance, its
    width padded up with zeros at pack time (``"w16"`` for dense widths
    1-16, ``"w64"`` for 17-64, ``"dw64"`` for depthwise widths 1-64);
    ``"dconv"`` for dense bf16 widths 65-256 (the tensor-core double conv
    of ``ops/dconv_fused.py``, then the out conv); or ``"direct"``
    (``ops/conv_direct.py``: f32 at any width, bf16 depthwise above 64 and
    dense above 256). Raises for another compute dtype."""
    if width < 1:
        raise ValueError(f"refine_head: width {width}")
    if compute_dtype == torch.float32:
        return "direct"
    if compute_dtype != torch.bfloat16:
        raise ValueError("the refine_head kernels compute in bf16 or f32; "
                         f"got compute_dtype={compute_dtype}")
    if width > 64:
        return "dconv" if not depthwise and width <= _DCONV_MAX else "direct"
    if depthwise:
        return "dw64"
    return "w16" if width <= 16 else "w64"


def _ceil8(n: int) -> int:
    return (n + 7) // 8 * 8


def dconv_pair(params: dict) -> tuple:
    """The dense head's conv pair (w1, b1, w2, b2, OIHW) zero-padded to
    what ``csrc/double_conv.cu`` takes: the input planes and the width up
    to multiples of 8. A padded plane has zero weights, a padded channel
    zero weights and bias, so it carries relu(0) = 0 and the padded pair
    computes the narrow one."""
    w1 = params["refine1"]["weight"]
    width, nplanes = int(w1.shape[0]), int(w1.shape[1])
    wd = _ceil8(width)
    return (_pad_to(_pad_to(w1, wd, (0,)), _ceil8(nplanes), (1,)),
            _pad_to(params["refine1"]["bias"], wd, (0,)),
            _pad_to(params["refine2"]["weight"], wd, (0, 1)),
            _pad_to(params["refine2"]["bias"], wd, (0,)))


def _pad_to(t: torch.Tensor, n: int, dims) -> torch.Tensor:
    """Zero-pad each of ``dims`` of t up to n."""
    pad = [0] * (2 * t.dim())
    for d in dims:
        pad[2 * (t.dim() - 1 - d) + 1] = n - t.shape[d]
    return F.pad(t, pad)


def pack_head_weights(params: dict, compute_dtype=torch.bfloat16) -> dict:
    """The head's weights in the layouts of the kernel that
    :func:`head_route` picks, built once when a model's weights are loaded
    (``pack_head``) and passed to every :func:`refine_head` call.

    Fused instances: w1 as (out, tap, plane) in bf16 with a bf16 bias; w3
    as (in, C) and b3 in f32. The dense head's w2 as (tap, out, in) in bf16
    with a bf16 bias; the depthwise head's wdw as (tap, channel), rounded
    to bf16 and kept in f32 (the TPU kernel applies bf16 weights with f32
    multiply-adds), and wpw as (out, in), each with a bf16 bias. The width
    is padded with zeros up to the instance's: a padded channel has zero
    weights and bias, so it carries relu(0) = 0 and adds exact zeros, and
    the padded head computes the narrow one bit for bit.

    Direct route: :func:`pack_direct_head`. ``"dconv"`` route: the conv
    pair padded by :func:`dconv_pair` as
    :func:`~.dconv_fused.pack_dconv_weights` packs it (w1, b1, w2, b2,
    split), w3 with zero rows for the padded channels, b3."""
    w1 = params["refine1"]["weight"]
    width, nplanes = int(w1.shape[0]), int(w1.shape[1])
    c = int(params["refine_out"]["weight"].shape[0])
    depthwise = "refine2" not in params
    route = head_route(width, compute_dtype, depthwise)
    if route == "direct":
        return pack_direct_head(params, compute_dtype)
    w3 = params["refine_out"]["weight"].reshape(c, width).t() \
        .to(torch.float32)
    b3 = params["refine_out"]["bias"].to(torch.float32).contiguous()
    if route == "dconv":
        return dict(pack_dconv_weights(*dconv_pair(params)),
                    w3=_pad_to(w3, _ceil8(width), (0,)).contiguous(), b3=b3)
    wd = _FUSED[route]
    bf16 = torch.bfloat16
    packed = {
        "w1": _pad_to(w1.permute(0, 2, 3, 1).reshape(width, 9 * nplanes),
                      wd, (0,)).to(bf16).contiguous(),
        "b1": _pad_to(params["refine1"]["bias"], wd, (0,)).to(bf16)
        .contiguous(),
        "w3": _pad_to(w3, wd, (0,)).contiguous(),
        "b3": b3,
    }
    if not depthwise:
        packed["w2"] = _pad_to(params["refine2"]["weight"].permute(2, 3, 0, 1)
                               .reshape(9, width, width), wd, (1, 2)) \
            .to(bf16).contiguous()
        packed["b2"] = _pad_to(params["refine2"]["bias"], wd, (0,)).to(bf16) \
            .contiguous()
    else:
        dw, pw = params["refine2_dw"], params["refine2_pw"]
        packed["wdw"] = _pad_to(dw["weight"].reshape(width, 9).t(), wd, (1,)) \
            .to(bf16).to(torch.float32).contiguous()
        packed["bdw"] = _pad_to(dw["bias"], wd, (0,)).to(bf16).contiguous()
        packed["wpw"] = _pad_to(pw["weight"].reshape(width, width), wd,
                                (0, 1)).to(bf16).contiguous()
        packed["bpw"] = _pad_to(pw["bias"], wd, (0,)).to(bf16).contiguous()
    return packed


def pack_direct_head(params: dict, compute_dtype) -> dict:
    """The direct route's weights (:func:`refine_head_direct`): each conv
    as :func:`~.conv_direct.pack_conv` packs it (w1, w2 or wdw and the 1x1
    wpw, each with its bias), w3 as (in, C) and b3 in f32."""
    packed = {}
    for key, name, dw in (("1", "refine1", False), ("2", "refine2", False),
                          ("dw", "refine2_dw", True),
                          ("pw", "refine2_pw", False)):
        if name in params:
            p = pack_conv(params[name]["weight"], params[name]["bias"],
                          compute_dtype, depthwise=dw)
            packed["w" + key], packed["b" + key] = p["w"], p["b"]
    out = params["refine_out"]
    c = int(out["weight"].shape[0])
    packed["w3"] = out["weight"].reshape(c, -1).t().to(torch.float32) \
        .contiguous()
    packed["b3"] = out["bias"].to(torch.float32).contiguous()
    return packed


def refine_head_direct(y_full: torch.Tensor, planes: Sequence[torch.Tensor],
                       packed: dict, compute_dtype) -> torch.Tensor:
    """The head composed from the direct-conv kernels (the ``"direct"``
    route; their plain versions for CPU tensors): conv1, then conv2 or the
    depthwise 3x3 and the pointwise 1x1, each in ``compute_dtype`` with
    its output in device memory, then the f32 out conv and residual.
    ``packed`` is :func:`pack_direct_head` in ``compute_dtype``."""
    cdt = compute_dtype
    pred = y_full.to(torch.float32).contiguous()
    z = torch.cat([pred.to(cdt)] + [p.to(cdt) for p in planes], -1)
    z = conv_direct(z, packed["w1"], packed["b1"])
    if "wdw" in packed:
        z = conv_direct(z, packed["wdw"], packed["bdw"], relu=False,
                        depthwise=True)
        z = conv_direct(z, packed["wpw"], packed["bpw"])
    else:
        z = conv_direct(z, packed["w2"], packed["b2"])
    return head_out_direct(z, packed["w3"], packed["b3"], pred)


def refine_head_dconv(y_full: torch.Tensor, planes: Sequence[torch.Tensor],
                      params: dict, packed: dict) -> torch.Tensor:
    """A dense bf16 head as the double conv of ``z = concat(pred, *planes)``
    (the ``"dconv"`` route: :func:`~.dconv_fused.double_conv_fused` on the
    conv pair :func:`dconv_pair` pads, z zero-padded to its planes), then
    the f32 out conv and residual; their plain versions for CPU tensors.
    ``packed`` is :func:`pack_head_weights` of ``params`` in bf16."""
    bf16 = torch.bfloat16
    pair = dconv_pair(params)
    pred = y_full.to(torch.float32).contiguous()
    z = torch.cat([pred.to(bf16)] + [p.to(bf16) for p in planes], -1)
    z = F.pad(z, (0, int(pair[0].shape[1]) - int(z.shape[-1])))
    z = double_conv_fused(z, *pair, bf16, packed)
    return head_out_direct(z, packed["w3"], packed["b3"], pred)


def _lib():
    lib = _build.load("refine_head")
    fn = lib.refine_head_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 +
                       [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 +
                       [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_variant(route: str, nplanes: int, c: int, f32_planes: int = 0
                  ) -> dict:
    """What ``csrc/refine_head.cu`` launches on the current CUDA device for
    a fused route (``"w16"``, ``"w64"`` or ``"dw64"``) with ``nplanes``
    planes of ``c`` channels, ``f32_planes`` the bit mask of the f32
    planes after the prediction: ``groups``, the tiles in flight per block
    (two, or one where two do not fit in shared memory), ``smem``, its
    bytes per block, and ``blocks_per_sm``. Needs the card; launches
    nothing."""
    fn = _build.load("refine_head").refine_head_variant
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(nplanes, c, f32_planes, _FUSED[route], route == "dw64",
             ctypes.addressof(out))
    if err:
        raise RuntimeError(f"refine_head_variant: CUDA error {err}")
    return {"groups": out[0], "smem": out[1], "blocks_per_sm": out[2]}


def refine_head(y_full: torch.Tensor, planes: Sequence[torch.Tensor],
                params: dict, compute_dtype=torch.bfloat16,
                packed: Optional[dict] = None) -> torch.Tensor:
    """The refinement head: the plain version for CPU tensors; for CUDA
    tensors the kernel :func:`head_route` picks (which raises on what it
    does not take). Arguments as :func:`refine_head_reference`; planes may
    be bf16 or f32 (the fused kernel rounds f32 planes to bf16 as it reads
    them). ``packed`` is :func:`pack_head_weights` of ``params`` in
    ``compute_dtype``, built here when not given. ``refine_head.launches``
    counts the fused kernel's launches; ``refine_head.routes`` counts every
    launch it makes, fused or direct, under ``"route/wWIDTH/dtype"``
    (``dwWIDTH`` for a depthwise head; the model's width, before padding),
    e.g. ``"w64/w32/bfloat16"``. The kernels have no backward: for CUDA
    tensors it raises under grad mode when any input or weight requires
    grad (``_build.refuse_grad``)."""
    if y_full.device.type == "cpu":
        return refine_head_reference(y_full, planes, params, compute_dtype)
    if y_full.device.type != "cuda":
        raise ValueError(f"refine_head: unsupported device {y_full.device}")
    _build.refuse_grad("refine_head", y_full, *planes,
                       *(t for p in params.values() for t in p.values()),
                       *(packed or {}).values())
    b, h, w, c = y_full.shape
    nplanes = (1 + len(planes)) * c
    width = int(params["refine1"]["weight"].shape[0])
    depthwise = "refine2" not in params
    route = head_route(width, compute_dtype, depthwise)
    key = (f"{route}/{'dw' if depthwise else 'w'}{width}/"
           f"{str(compute_dtype).removeprefix('torch.')}")
    kw = packed if packed is not None else \
        pack_head_weights(params, compute_dtype)
    if c not in (1, 3) or not 1 <= len(planes) <= _MAX_PLANES:
        raise ValueError(f"refine_head kernel: C={c} with {len(planes)} "
                         "planes is not supported (C in {1, 3}, 1-4 planes)")
    dev = y_full.device
    if any(tuple(p.shape) != (b, h, w, c) or p.device != dev for p in planes):
        raise ValueError("refine_head: every plane must match y_full's "
                         "shape and device")
    if any(t.device != dev for t in kw.values()
           if isinstance(t, torch.Tensor)):
        raise ValueError("refine_head: weights must be on y_full's device")
    if route == "dconv":
        if tuple(kw["w3"].shape) != (_ceil8(width), c):
            raise ValueError(f"refine_head (dconv): w3 {tuple(kw['w3'].shape)}"
                             f" is not pack_head_weights of a width-{width} "
                             f"head with C={c} in {compute_dtype}")
        # double_conv_fused checks the packed pair against the padded shapes
        out = refine_head_dconv(y_full, planes, params, kw)
        refine_head.routes[key] += 2            # the double conv; out
        return out
    if route == "direct":
        if tuple(kw["w1"].shape) != (9, nplanes, width) or \
                tuple(kw["w3"].shape) != (width, c) or \
                depthwise != ("wdw" in kw):
            raise ValueError(f"refine_head (direct): weights "
                             f"{tuple(kw['w1'].shape)} are not pack_head_"
                             f"weights of a width-{width} head with "
                             f"{nplanes} planes and C={c} in {compute_dtype}")
        out = refine_head_direct(y_full, planes, kw, compute_dtype)
        # conv1; conv2, or the depthwise 3x3 and the pointwise 1x1; out
        refine_head.routes[key] += 4 if depthwise else 3
        return out
    wd = _FUSED[route]
    if tuple(kw["w1"].shape) != (wd, 9 * nplanes) \
            or tuple(kw["w3"].shape) != (wd, c) \
            or depthwise != ("wdw" in kw):
        raise ValueError(f"refine_head kernel: weights {tuple(kw['w1'].shape)}"
                         f" are not a width-{width} head padded to the {wd} "
                         f"instance with {nplanes} planes and C={c}")
    extra, f32_bits = [], 0
    for k, p in enumerate(planes):
        if p.dtype == torch.float32:
            f32_bits |= 1 << k
        elif p.dtype != torch.bfloat16:
            p = p.to(torch.bfloat16)
        extra.append(p.contiguous())
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
                 kw["b3"].data_ptr(), out.data_ptr(), b, h, w, wd,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"refine_head kernel launch failed: CUDA error {err}")
    refine_head.launches += 1
    refine_head.routes[key] += 1
    return out


refine_head.launches = 0
refine_head.routes = Counter()
