"""The U-Net family in PyTorch (JAX ``models/unet.py``).

Layout is NCHW. Module names follow the Flax module paths (``unet.inc``,
``unet.down{i}.conv``, ``unet.up{i}.conv``, ``unet.outc``, ``refine1``,
``refine2``, ``refine_out``), so a Flax variables tree maps onto the
``state_dict`` key for key (``models/bridge.py``).

Precision mirrors the Flax model: weights are stored in f32; each 3x3 conv
casts its input and weights to the compute dtype and adds the bias (also
cast) after the conv, as ``flax.linen.Conv(dtype=...)`` does, so the
result rounds to the compute dtype before and after the bias. BatchNorm
(unfolded variant) runs in f32, ReLU then casts back. The 1x1 ``outc`` and
the refinement head's ``refine_out`` are f32, and so is the residual add.

Every ``forward`` takes ``train``. ``train=False`` (inference) normalizes
with the running statistics and runs the head through ``refine_head``
(the CUDA kernel on the card). ``train=True`` is the training forward of
the JAX package's ``train=True``: BatchNorm on the batch's statistics,
which also updates the running ones (:func:`batch_norm`), and the head
as the model's own convs under autograd (:meth:`RefineHead.head_train`),
since no kernel has a backward.

Importing this module turns TF32 off for cuDNN convolutions and CUDA
matmuls: PyTorch runs f32 convolutions in TF32 by default, and the f32
convs here (``outc``, ``refine_out``, the whole f32 engine) are meant to be
full f32, as on the JAX side.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.refine import (pack_head_weights, refine_head,
                          refine_head_reference)
from ..ops.resize import upsample2x_align_corners, upsample2x_half_pixel

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BN_EPS = 1e-5
# Flax's BatchNorm momentum: running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.9


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B,C,H,W] -> [B,r*r*C,H/r,W/r], channels in JAX's (dy, dx, c)
    order (``F.pixel_unshuffle`` uses (c, dy, dx), which agrees only for
    C=1)."""
    if r == 1:
        return x
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    if r == 1:
        return x
    b, cr, h, w = x.shape
    c = cr // (r * r)
    x = x.reshape(b, r, r, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c, h * r, w * r)


def conv(x: torch.Tensor, m: nn.Conv2d, dtype) -> torch.Tensor:
    """``m`` applied in ``dtype`` with the bias added after the conv."""
    y = F.conv2d(x.to(dtype), m.weight.to(dtype), None, m.stride, m.padding,
                 m.dilation, m.groups)
    if m.bias is not None:
        y = y + m.bias.to(dtype).view(1, -1, 1, 1)
    return y


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d,
               train: bool = False) -> torch.Tensor:
    """``bn`` applied to NCHW ``x`` in f32, as Flax's ``BatchNorm(dtype=f32,
    momentum=0.9)`` applies it. Inference: the running statistics. With
    ``train`` the batch's mean and biased variance over (N, H, W), computed
    as Flax computes them (``E[x^2] - E[x]^2``, clipped at 0) and
    differentiable; the running statistics then move by Flax's rule, in
    place, with the biased variance (``F.batch_norm(training=True)`` would
    take the unbiased one)."""
    x = x.float()
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    mean = torch.mean(x, (0, 2, 3))
    var = torch.clamp(torch.mean(x * x, (0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
        + bn.bias.view(1, -1, 1, 1)


class DoubleConv(nn.Module):
    """(3x3 conv -> BatchNorm -> ReLU) x 2; with ``folded`` the BatchNorm
    is pre-multiplied into each conv, which then has a bias."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: Optional[int] = None,
                 folded: bool = False):
        super().__init__()
        mid = mid_ch if mid_ch is not None else out_ch
        self.folded = folded
        self.conv1 = nn.Conv2d(in_ch, mid, 3, padding=1, bias=folded)
        self.conv2 = nn.Conv2d(mid, out_ch, 3, padding=1, bias=folded)
        if not folded:
            self.bn1 = nn.BatchNorm2d(mid, eps=BN_EPS)
            self.bn2 = nn.BatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor, cdt, train: bool = False
                ) -> torch.Tensor:
        if train and self.folded:
            raise ValueError("folded BatchNorm is inference-only; train the "
                             "unfolded model")
        for i in (1, 2):
            x = conv(x, getattr(self, f"conv{i}"), cdt)
            if not self.folded:
                x = batch_norm(x, getattr(self, f"bn{i}"), train)
            x = F.relu(x).to(cdt)
        return x


class Down(nn.Module):
    """2x2 max-pool then DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, folded: bool = False):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, folded=folded)

    def forward(self, x: torch.Tensor, cdt, train: bool = False
                ) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2), cdt, train)


class Up(nn.Module):
    """x2 upsample of the low-resolution input, zero pad to the skip's size
    (floor of the difference leading), concat ``[skip, up]``, DoubleConv."""

    def __init__(self, low_ch: int, skip_ch: int, out_ch: int,
                 bilinear: bool = True, upsample: str = "align_corners",
                 folded: bool = False):
        super().__init__()
        if upsample not in ("align_corners", "half_pixel"):
            raise ValueError(f"unknown upsample mode {upsample!r}")
        self.bilinear = bilinear
        self.upsample = upsample
        if bilinear:
            in_ch = low_ch + skip_ch
            self.conv = DoubleConv(in_ch, out_ch, in_ch // 2, folded=folded)
        else:
            self.up = nn.ConvTranspose2d(low_ch, low_ch // 2, 2, stride=2)
            self.conv = DoubleConv(low_ch // 2 + skip_ch, out_ch,
                                   folded=folded)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, cdt,
                train: bool = False) -> torch.Tensor:
        if not self.bilinear:
            x1 = F.conv_transpose2d(x1.to(cdt), self.up.weight.to(cdt),
                                    stride=2)
            x1 = x1 + self.up.bias.to(cdt).view(1, -1, 1, 1)
        elif self.upsample == "half_pixel":
            x1 = upsample2x_half_pixel(x1)
        else:
            x1 = upsample2x_align_corners(x1)
        dh = x2.shape[-2] - x1.shape[-2]
        dw = x2.shape[-1] - x1.shape[-1]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1.to(x2.dtype)], 1), cdt, train)


class UNet(nn.Module):
    """Encoder-decoder U-Net: widths ``base_width * 2**i``, the bottleneck
    and decoder halved when ``bilinear``, f32 1x1 output conv."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 base_width: int = 64, depth: int = 4, bilinear: bool = True,
                 folded: bool = False, upsample: str = "align_corners"):
        super().__init__()
        w = base_width
        factor = 2 if bilinear else 1
        self.depth = depth
        self.inc = DoubleConv(in_channels, w, folded=folded)
        skip_ch = [w]
        for i in range(1, depth + 1):
            ch = w * 2 ** i
            if i == depth:
                ch //= factor
            setattr(self, f"down{i}", Down(skip_ch[-1], ch, folded=folded))
            skip_ch.append(ch)
        y_ch = skip_ch[-1]
        for i in range(1, depth + 1):
            ch = w * 2 ** (depth - i)
            if i < depth:
                ch //= factor
            setattr(self, f"up{i}", Up(y_ch, skip_ch[depth - i], ch,
                                       bilinear=bilinear, upsample=upsample,
                                       folded=folded))
            y_ch = ch
        self.outc = nn.Conv2d(y_ch, out_channels, 1)

    def forward(self, x: torch.Tensor, cdt, train: bool = False
                ) -> torch.Tensor:
        skips = [self.inc(x.to(cdt), cdt, train)]
        for i in range(1, self.depth + 1):
            skips.append(getattr(self, f"down{i}")(skips[-1], cdt, train))
        y = skips[-1]
        for i in range(1, self.depth + 1):
            y = getattr(self, f"up{i}")(y, skips[self.depth - i], cdt, train)
        return conv(y, self.outc, torch.float32)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class RefineHead:
    """The full-resolution refinement head of the U-Net and tower families,
    as a mixin: ``refine1``, ``refine2`` (or ``refine2_dw`` and
    ``refine2_pw``) and ``refine_out`` on the module, named in
    ``head_names``, ``has_head`` set where the model has them."""

    def pack_head(self) -> None:
        """Build the head kernel's weight layouts once, from the weights as
        loaded and placed now (``ops.refine.pack_head_weights``); the
        engine calls it after loading. Forward passes them to every head
        call, so it must be called again after the weights change."""
        self.packed_head = pack_head_weights(
            self.head_params(), self.compute_dtype) if self.has_head else None

    def head_params(self) -> dict:
        """The refinement head's weights, ``{name: {"weight", "bias"}}``."""
        return {n: {"weight": getattr(self, n).weight,
                    "bias": getattr(self, n).bias} for n in self.head_names}

    def head(self, y: torch.Tensor, p1: torch.Tensor,
             p2: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The head on the f32 prediction ``y`` in the stem's
        space-to-depth layout, with planes ``p1``, ``p2`` at the head's
        factor ``g = refine_factor`` (each family lays them out its own
        way; the frames themselves at g = 1): at g = 1 through
        :meth:`refine` (the main path's kernel on the card); at a coarser
        factor, which has no kernel (nor has it in the JAX package),
        through the plain head. With ``train``: :meth:`head_train`."""
        r, g = self.cfg.space_to_depth, self.cfg.refine_factor
        yg = depth_to_space(y, r // g)
        if train:
            return self.head_train(yg, p1, p2)
        if g == 1:
            return self.refine(yg, p1, p2)
        out = refine_head_reference(_nhwc(yg), (_nhwc(p1), _nhwc(p2)),
                                    self.head_params(), self.compute_dtype)
        return depth_to_space(out.permute(0, 3, 1, 2), g)

    def head_train(self, yg: torch.Tensor, p1: torch.Tensor,
                   p2: torch.Tensor) -> torch.Tensor:
        """The training head, as the Flax model computes it under
        ``train=True``: the model's own convs under autograd with
        :func:`conv`'s rounding points, on the f32 prediction ``yg`` at the
        head's factor; NCHW out in the compute dtype."""
        cdt = self.compute_dtype
        z = torch.cat([yg.to(cdt), p1.to(cdt), p2.to(cdt)], 1)
        z = F.relu(conv(z, self.refine1, cdt))
        if "refine2_dw" in self.head_names:
            z = conv(z, self.refine2_dw, cdt)
            z = F.relu(conv(z, self.refine2_pw, cdt))
        else:
            z = F.relu(conv(z, self.refine2, cdt))
        delta = conv(z.float(), self.refine_out, torch.float32)
        return depth_to_space((yg + delta).to(cdt), self.cfg.refine_factor)

    def refine(self, pred: torch.Tensor, frame1: torch.Tensor,
               frame2: torch.Tensor) -> torch.Tensor:
        """The full-resolution head (``refine_factor=1``, dense or
        depthwise) on the f32 pre-refine prediction ``[B,C,H,W]``, with the
        frames as its planes; NCHW out in the compute dtype."""
        out = refine_head(_nhwc(pred), (_nhwc(frame1), _nhwc(frame2)),
                          self.head_params(), self.compute_dtype,
                          self.packed_head)
        return out.permute(0, 3, 1, 2)


class FrameInterpolationUNet(RefineHead, nn.Module):
    """Two frames in, the midpoint out (NCHW), with the optional
    space-to-depth stem, residual midpoint and refinement head."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 compute_dtype=torch.bfloat16, folded: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.folded = folded
        self.unet = UNet(cfg.in_channels, cfg.out_channels, cfg.base_width,
                         cfg.depth, cfg.bilinear, folded, cfg.upsample)
        r, g = cfg.space_to_depth, cfg.refine_factor
        self.has_head = cfg.refine_width > 0 and r > 1
        if self.has_head:
            if r % g:
                raise ValueError(
                    f"refine_factor {g} must divide space_to_depth {r}")
            w = cfg.refine_width
            cg = cfg.channels * g * g
            self.refine1 = nn.Conv2d(3 * cg, w, 3, padding=1)
            if cfg.refine_depthwise:
                self.refine2_dw = nn.Conv2d(w, w, 3, padding=1, groups=w)
                self.refine2_pw = nn.Conv2d(w, w, 1)
            else:
                self.refine2 = nn.Conv2d(w, w, 3, padding=1)
            self.refine_out = nn.Conv2d(w, cg, 1)
        self.head_names = ("refine1", "refine2_dw", "refine2_pw",
                           "refine_out") if cfg.refine_depthwise else \
            ("refine1", "refine2", "refine_out")
        self.packed_head: Optional[dict] = None
        self.packed_core: Optional[dict] = None

    def pack_core(self) -> None:
        """Build the core kernels' weight layouts once, as :meth:`pack_head`
        does for the head (``models.core_t.pack_core_weights``); the engine
        calls it after loading when it routes to the option core."""
        from .core_t import pack_core_weights

        self.packed_core = pack_core_weights(self)

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor,
                t: Optional[torch.Tensor] = None,
                skip_refine: bool = False, train: bool = False
                ) -> torch.Tensor:
        """``skip_refine=True`` returns the f32 pre-refine prediction at full
        resolution, for a caller that applies the head itself; ``train``
        as the module docstring says."""
        cfg, cdt = self.cfg, self.compute_dtype
        r = cfg.space_to_depth
        f1 = space_to_depth(frame1, r)
        f2 = space_to_depth(frame2, r)
        x = torch.cat([f1, f2], 1)
        if cfg.time_conditioned:
            b, _, h, w = x.shape
            if t is None:
                t = torch.full((b,), 0.5, dtype=x.dtype, device=x.device)
            tmap = t.to(x.dtype).view(b, 1, 1, 1).expand(b, 1, h, w)
            x = torch.cat([x, tmap], 1)
        y = self.unet(x, cdt, train)
        if cfg.residual:
            y = y + 0.5 * (f1 + f2).to(y.dtype)
        if not self.has_head or skip_refine:
            return depth_to_space(y, r)
        g = cfg.refine_factor
        return self.head(y, depth_to_space(f1, r // g),
                         depth_to_space(f2, r // g), train)


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count (BatchNorm running stats excluded)."""
    return sum(p.numel() for p in model.parameters())


def fold_batchnorm(state: dict) -> dict:
    """Fold eval-mode BatchNorm into the preceding convs of a state dict.

    ``bn(conv(x)) = conv(x) * s + b`` with ``s = weight / sqrt(var + eps)``
    and ``b = bias - mean * s``: each ``conv{n}`` paired with a ``bn{n}``
    takes ``s`` on its output-channel axis and gains bias ``b``. Returns
    the state dict of the ``folded=True`` model.
    """
    out = {}
    for key, val in state.items():
        mod, _, leaf = key.rpartition(".")
        name = mod.rpartition(".")[2]
        if name.startswith("bn"):
            continue
        bn = f"{mod[:-len(name)]}bn{name[-1]}" if name.startswith("conv") \
            else None
        if bn is not None and f"{bn}.running_var" in state:
            s = state[f"{bn}.weight"] / torch.sqrt(
                state[f"{bn}.running_var"] + BN_EPS)
            out[key] = val * s.view(-1, 1, 1, 1)
            out[f"{mod}.bias"] = (state[f"{bn}.bias"]
                                  - state[f"{bn}.running_mean"] * s)
        else:
            out[key] = val
    return out
