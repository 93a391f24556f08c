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
``csrc/double_conv.cu`` for CUDA tensors in bf16, two launches of
``csrc/conv_direct.cu`` in f32 (:func:`dconv_route`), and run the plain
versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .conv_direct import conv_direct, pack_conv, upsample2x_half_pixel_nhwc


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


NC = 64      # output channels per N pass (csrc/double_conv.cu)
KC = 64      # input channels per weight chunk


def weight_chunks(n_total: int, k_ch: int):
    """The kernel's weight stream for one conv, in the order it reads it:
    (first output channel, rows nw, tap, first input channel, width kw) per
    chunk: N passes of up to NC channels, then taps, then K chunks of up to
    KC channels. Each chunk is stored as nw rows of kw + 8 bf16 (the
    ldmatrix padding), so one bulk copy lands it as the MMA loop reads it."""
    for nc in range(0, n_total, NC):
        nw = min(NC, n_total - nc)
        for tap in range(9):
            for kc in range(0, k_ch, KC):
                yield nc, nw, tap, kc, min(KC, k_ch - kc)


def chunked_size(n_total: int, k_ch: int) -> int:
    """Elements of one conv's chunk-contiguous weights."""
    return sum(nw * (kw + 8) for _, nw, _, _, kw in weight_chunks(n_total,
                                                                 k_ch))


def kernel_plan(c0: int, c1: int, mid: int, cout: int) -> dict:
    """What ``csrc/double_conv.cu``'s host code picks for these channel
    counts (builds the kernel; for reports): the tile height ``th``, the
    ring's ``stages`` (or the resident copy's chunks), whether the weights
    are ``resident``, and the weight chunks a tile streams (``chunks``)."""
    fn = _build.load("double_conv").double_conv_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    if fn(c0, c1, mid, cout, out):
        raise ValueError(f"double_conv: {c0}+{c1}->{mid}->{cout} channels do "
                         "not fit shared memory")
    return {"th": out[0], "stages": out[1], "resident": bool(out[2]),
            "chunks": out[3]}


def _chunked(t: torch.Tensor) -> torch.Tensor:
    """[9][n][k] -> the flat chunk stream of :func:`weight_chunks`."""
    n, k = int(t.shape[1]), int(t.shape[2])
    return torch.cat([F.pad(t[tap, nc:nc + nw, kc:kc + kw], (0, 8)).reshape(-1)
                      for nc, nw, tap, kc, kw in weight_chunks(n, k)])


def dconv_route(compute_dtype) -> str:
    """Which kernel takes the double conv and the up block on the card:
    ``"fused"`` (``csrc/double_conv.cu``, bf16) or ``"direct"`` (two
    launches of ``csrc/conv_direct.cu``, f32)."""
    if compute_dtype == torch.bfloat16:
        return "fused"
    if compute_dtype == torch.float32:
        return "direct"
    raise ValueError("the double_conv kernels compute in bf16 or f32; got "
                     f"compute_dtype={compute_dtype}")


def pack_dconv_weights(w1, b1, w2, b2, split: Optional[int] = None,
                       compute_dtype=torch.bfloat16) -> dict:
    """The kernels' weight layouts, built once per model. For the fused
    bf16 kernel: w1 (tap, out, in) over ``[9][midp][k]`` and w2 over
    ``[9][coutp][midp]``, every channel count rounded up to 16 with zeros,
    each stored as the chunk stream of :func:`weight_chunks` (flat bf16),
    with bf16 biases padded likewise. For the up block ``split`` is the
    skip's channel count: the skip and up parts of w1's input axis are
    padded each on its own, as the kernel lays them out in shared memory.
    For the f32 route (:func:`dconv_route`): each conv as
    :func:`~.conv_direct.pack_conv` gives it (w1 ``[9][cin][mid]``)."""
    if dconv_route(compute_dtype) == "direct":
        p1, p2 = (pack_conv(w, b, compute_dtype) for w, b in ((w1, b1),
                                                              (w2, b2)))
        return {"w1": p1["w"], "b1": p1["b"], "w2": p2["w"], "b2": p2["b"],
                "split": split}
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
    t2 = F.pad(taps(w2, cout, mid, coutp), (0, midp - mid))
    return {"w1": _chunked(w1p).contiguous(),
            "b1": F.pad(b1.to(bf16), (0, midp - mid)).contiguous(),
            "w2": _chunked(t2).contiguous(),
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
                 split: Optional[int], compute_dtype=torch.bfloat16) -> None:
    """Raise unless ``packed`` is :func:`pack_dconv_weights` of weights of
    w1's and w2's shapes, for ``c0`` (+ ``c1`` up) input channels split at
    ``split``, in ``compute_dtype``: what the kernel reads."""
    if packed is None:
        raise ValueError("double_conv: the kernel takes the weights packed "
                         "once per model (pack_dconv_weights); got none")
    mid, cout = int(w1.shape[0]), int(w2.shape[0])
    if dconv_route(compute_dtype) == "direct":
        want = ((9, c0 + c1, mid), (9, mid, cout))
    else:
        kin = _ceil16(c0) + (_ceil16(c1) if c1 else 0)
        want = ((chunked_size(_ceil16(mid), kin),),
                (chunked_size(_ceil16(cout), _ceil16(mid)),))
    if packed["split"] != split or (tuple(packed["w1"].shape),
                                    tuple(packed["w2"].shape)) != want:
        raise ValueError(f"double_conv: packed weights (split "
                         f"{packed['split']}, w1 {tuple(packed['w1'].shape)})"
                         f" do not match w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)} split at {split} in "
                         f"{compute_dtype}")


def _launch(x, low, w1, b1, w2, b2, packed, compute_dtype, split, counted):
    """Check the inputs, then launch the kernel on the current stream (the
    f32 route: two direct-conv launches), each launch counted on the
    wrapper ``counted`` under its route."""
    route = dconv_route(compute_dtype)
    dev = x.device
    b, h, w, c0 = x.shape
    c1 = 0 if low is None else int(low.shape[-1])
    mid, cout = int(w1.shape[0]), int(w2.shape[0])
    if int(w1.shape[1]) != c0 + c1 or int(w2.shape[1]) != mid:
        raise ValueError(f"double_conv: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit {c0}+{c1} input "
                         "channels")
    if route == "fused" and any(c % 8 for c in (c0, c1, mid, cout)):
        raise ValueError("the double_conv kernel takes channel counts that "
                         f"are multiples of 8; got {c0}, {c1}, {mid}, {cout}")
    if low is not None and (tuple(low.shape) != (b, h // 2, w // 2, c1)
                            or h % 2 or w % 2 or low.device != dev):
        raise ValueError(f"up_double_conv: low {tuple(low.shape)} is not "
                         f"half of skip {tuple(x.shape)} on {dev}")
    check_packed(packed, w1, w2, c0, c1, split, compute_dtype)
    if any(packed[k].device != dev for k in ("w1", "b1", "w2", "b2")):
        raise ValueError("double_conv: weights must be on the input's device")
    if route == "direct":
        lf = None if low is None else low.to(compute_dtype)
        z1 = conv_direct(x.to(compute_dtype), packed["w1"], packed["b1"], lf)
        counted.routes["direct"] += 1
        out = conv_direct(z1, packed["w2"], packed["b2"])
        counted.routes["direct"] += 1
        return out
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
    counted.launches += 1
    counted.routes["fused"] += 1
    return out


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def double_conv_fused(x: torch.Tensor, w1, b1, w2, b2,
                      compute_dtype=torch.bfloat16,
                      packed: Optional[dict] = None) -> torch.Tensor:
    """The double conv: the plain version for CPU tensors; for CUDA
    tensors the CUDA kernel in bf16, or in f32 two direct-conv launches
    (:func:`dconv_route`; either raises on what it does not take).
    Arguments as :func:`double_conv_reference`; ``packed`` is
    :func:`pack_dconv_weights` of the weights in ``compute_dtype``, which
    the kernels need (the plain version ignores it).
    ``double_conv_fused.launches`` counts the fused kernel's launches,
    ``double_conv_fused.routes`` every launch it makes by route."""
    if x.device.type == "cpu":
        return double_conv_reference(x, w1, b1, w2, b2, compute_dtype)
    _check_device(x, "double_conv_fused")
    return _launch(x, None, w1, b1, w2, b2, packed, compute_dtype, None,
                   double_conv_fused)


def up_double_conv_fused(skip: torch.Tensor, low: torch.Tensor, w1, b1, w2,
                         b2, compute_dtype=torch.bfloat16,
                         packed: Optional[dict] = None) -> torch.Tensor:
    """The decoder up block: the plain version for CPU tensors; for CUDA
    tensors the CUDA kernel in bf16, or in f32 two direct-conv launches,
    the first over ``concat(skip, up2(low))``. Arguments as
    :func:`up_double_conv_reference`; ``packed`` is
    :func:`pack_dconv_weights` with ``split`` the skip's channels, which
    the kernels need. ``up_double_conv_fused.launches`` counts the fused
    kernel's launches, ``up_double_conv_fused.routes`` every launch it makes
    by route."""
    if skip.device.type == "cpu":
        return up_double_conv_reference(skip, low, w1, b1, w2, b2,
                                        compute_dtype)
    _check_device(skip, "up_double_conv_fused")
    return _launch(skip, low, w1, b1, w2, b2, packed, compute_dtype,
                   int(skip.shape[-1]), up_double_conv_fused)


double_conv_fused.launches = 0
double_conv_fused.routes = Counter()
up_double_conv_fused.launches = 0
up_double_conv_fused.routes = Counter()
