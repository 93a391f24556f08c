"""Plain float32 pieces shared by the references: convolutions, BatchNorm,
the U-Net core, bilinear upsamples and the bounded shifts warp.

Written from the models' published equations (the U-Net of Ronneberger et
al. with a bilinear decoder, the Super SloMo warp-and-blend sampler) and
the layer names of the configurations' state dicts. Imports torch and
nothing of the program. Every function takes ``q``, the rounding applied
to both operands of each convolution: ``None`` for float32, or
:func:`fp8` for the control (``benchmark/control.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
# (name, shape, kind, fan_in): kind is "hidden", "out", "bias", "bn_weight",
# "bn_bias", "bn_mean" or "bn_var"
Leaf = Tuple[str, Tuple[int, ...], str, int]

FP8_MAX = 448.0          # the largest finite float8_e4m3fn


@contextlib.contextmanager
def no_tf32():
    """Full float32 convolutions and matmuls (PyTorch may run them in TF32
    on the card), restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32: what an fp8
    convolution would read."""
    amax = float(x.abs().max())
    if amax == 0.0:
        return x
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def conv(x: torch.Tensor, p: Params, name: str, padding: int,
         q: Quant = None) -> torch.Tensor:
    """``name``'s convolution (stride 1) in float32, its bias if it has
    one."""
    w = p[f"{name}.weight"].float()
    if q is not None:
        x, w = q(x), q(w)
    return F.conv2d(x, w, p.get(f"{name}.bias"), padding=padding)


def batch_norm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """Inference BatchNorm on the running statistics."""
    shape = (1, -1, 1, 1)
    scale = p[f"{name}.weight"].view(shape) / torch.sqrt(
        p[f"{name}.running_var"].view(shape) + BN_EPS)
    return (x - p[f"{name}.running_mean"].view(shape)) * scale \
        + p[f"{name}.bias"].view(shape)


def double_conv(x, p, name, q=None):
    """(3x3 conv, BatchNorm, ReLU) twice."""
    for i in (1, 2):
        x = F.relu(batch_norm(conv(x, p, f"{name}.conv{i}", 1, q), p,
                              f"{name}.bn{i}"))
    return x


def upsample2x(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Bilinear x2: ``half_pixel`` centres or ``align_corners``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=mode == "align_corners")


def unet_widths(base: int, depth: int) -> Tuple[List[int], List[Tuple]]:
    """The bilinear U-Net's encoder widths and, per decoder block, (low,
    skip, mid, out) widths: the bottleneck and every decoder block but the
    last halved."""
    enc = [base]
    for i in range(1, depth + 1):
        enc.append(base * 2 ** i // (2 if i == depth else 1))
    dec, low = [], enc[-1]
    for i in range(1, depth + 1):
        out = base * 2 ** (depth - i) // (2 if i < depth else 1)
        skip = enc[depth - i]
        dec.append((low, skip, (low + skip) // 2, out))
        low = out
    return enc, dec


def unet(x: torch.Tensor, p: Params, prefix: str, depth: int,
         upsample: str, q: Quant = None) -> torch.Tensor:
    """The U-Net core: max-pool encoder, bilinear decoder with zero-padded
    skips, float32 1x1 output conv."""
    skips = [double_conv(x, p, f"{prefix}.inc", q)]
    for i in range(1, depth + 1):
        skips.append(double_conv(F.max_pool2d(skips[-1], 2), p,
                                 f"{prefix}.down{i}.conv", q))
    y = skips[-1]
    for i in range(1, depth + 1):
        skip = skips[depth - i]
        up = upsample2x(y, upsample)
        dh, dw = skip.shape[-2] - up.shape[-2], skip.shape[-1] - up.shape[-1]
        up = F.pad(up, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        y = double_conv(torch.cat([skip, up], 1), p, f"{prefix}.up{i}.conv",
                        q)
    return conv(y, p, f"{prefix}.outc", 0, q)


def unet_leaves(prefix: str, cin: int, cout: int, base: int,
                depth: int) -> List[Leaf]:
    """The U-Net core's parameters and BatchNorm statistics."""
    leaves: List[Leaf] = []

    def dconv(name, c0, mid, c1):
        for i, (a, b) in enumerate(((c0, mid), (mid, c1)), 1):
            leaves.append((f"{name}.conv{i}.weight", (b, a, 3, 3), "hidden",
                           9 * a))
        for i, c in enumerate((mid, c1), 1):
            for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                               ("running_mean", "bn_mean"),
                               ("running_var", "bn_var")):
                leaves.append((f"{name}.bn{i}.{leaf}", (c,), kind, 0))

    enc, dec = unet_widths(base, depth)
    dconv(f"{prefix}.inc", cin, enc[0], enc[0])
    for i in range(1, depth + 1):
        dconv(f"{prefix}.down{i}.conv", enc[i - 1], enc[i], enc[i])
    for i, (low, skip, mid, out) in enumerate(dec, 1):
        dconv(f"{prefix}.up{i}.conv", low + skip, mid, out)
    last = dec[-1][3]
    leaves.append((f"{prefix}.outc.weight", (cout, last, 1, 1), "out", last))
    leaves.append((f"{prefix}.outc.bias", (cout,), "bias", 0))
    return leaves


def head_leaves(nplanes: int, width: int, cout: int) -> List[Leaf]:
    """The dense refinement head: 3x3 to ``width``, 3x3, 1x1 out."""
    return [("refine1.weight", (width, nplanes, 3, 3), "hidden", 9 * nplanes),
            ("refine1.bias", (width,), "bias", 0),
            ("refine2.weight", (width, width, 3, 3), "hidden", 9 * width),
            ("refine2.bias", (width,), "bias", 0),
            ("refine_out.weight", (cout, width, 1, 1), "out", width),
            ("refine_out.bias", (cout,), "bias", 0)]


def head(z: torch.Tensor, p: Params, q: Quant = None) -> torch.Tensor:
    """The head's correction of its first plane: ReLU(3x3), ReLU(3x3),
    float32 1x1."""
    z = F.relu(conv(z, p, "refine1", 1, q))
    z = F.relu(conv(z, p, "refine2", 1, q))
    return conv(z, p, "refine_out", 0, q)


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,C] -> float32 NCHW in [-1, 1]."""
    return frames_u8.permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float [B,C,H,W] in [-1, 1] -> uint8 [B,H,W,C], rounded half to
    even."""
    y = torch.clamp((x.float() + 1.0) * 0.5, 0.0, 1.0) * 255.0
    return torch.round(y).to(torch.uint8).permute(0, 2, 3, 1)


def pad_edge(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Replicate the last row and column up to a multiple."""
    ph, pw = (-x.shape[-2]) % multiple, (-x.shape[-1]) % multiple
    return F.pad(x, (0, pw, 0, ph), mode="replicate") if ph or pw else x


def pad_multiple(model: dict) -> int:
    return max(model["space_to_depth"], model["flow_scale"]) \
        * 2 ** model["depth"]


def warp_axis(img: torch.Tensor, disp: torch.Tensor, axis: int,
              bound: int) -> torch.Tensor:
    """Linear resampling of NCHW ``img`` along ``axis`` (2 rows, 3
    columns) at ``position + clip(disp, -bound, bound)``, the position
    clamped to the image (border replicate)."""
    n = img.shape[axis]
    shape = [1, 1, 1, 1]
    shape[axis] = n
    grid = torch.arange(n, dtype=torch.float32, device=img.device).view(shape)
    pos = torch.clamp(grid + torch.clamp(disp, -bound, bound), 0.0, n - 1)
    k0 = torch.floor(pos)
    frac = pos - k0
    i0 = k0.long().expand(img.shape)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return torch.gather(img, axis, i0) * (1.0 - frac) \
        + torch.gather(img, axis, i1) * frac


def shifts_warp(img: torch.Tensor, flow: torch.Tensor,
                bound: int) -> torch.Tensor:
    """Backward warp of NCHW ``img`` by ``flow`` [B,2,H,W] (x then y, in
    pixels), separable: along the columns by the x displacement, then
    along the rows of that result by the y displacement."""
    hx = warp_axis(img, flow[:, 0:1], 3, bound)
    return warp_axis(hx, flow[:, 1:2], 2, bound)


def he_std(fan_in: int, gain: float = math.sqrt(2.0)) -> float:
    return gain / math.sqrt(fan_in)
