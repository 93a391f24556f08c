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

Two inference options of the JAX model are here too. ``pack = g > 1``
(the engine's ``core_pack``) folds g batch items into the channel axis
(:func:`pack_batch`) and runs every U-Net conv as a grouped conv
(``groups=g``) over weights repeated per group (:func:`tile_params_packed`):
the same per-item math, for folded weights and the bilinear decoder; the
residual is added packed and the head runs unpacked. ``UP_POLYPHASE``
(module-level, off as in JAX) fuses the half-pixel upsample into each Up
block's first conv (``ops/polyphase.py``) where the skip is exactly twice
the low map; the parameters and ``state_dict`` keys stay the same.

Importing this module turns TF32 off for cuDNN convolutions and CUDA
matmuls: PyTorch runs f32 convolutions in TF32 by default, and the f32
convs here (``outc``, ``refine_out``, the whole f32 engine) are meant to be
full f32, as on the JAX side.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.polyphase import up2_conv_half_pixel
from ..ops.refine import (pack_head_weights, refine_head,
                          refine_head_reference)
from ..ops.resize import (reach_align_corners, reach_half_pixel,
                          upsample2x_align_corners, upsample2x_half_pixel)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BN_EPS = 1e-5
# Flax's BatchNorm momentum: running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.9
# Fuse the half-pixel decoder upsample into the Up block's first conv
# (ops/polyphase.py). Off by default, as in the JAX package, where it
# measured slower; module-level so a run can flip it in-process.
UP_POLYPHASE = False


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


def pack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """[B,C,H,W] -> [B/g,g*C,H,W]: g batch items folded into the channel
    axis, item-major (JAX ``pack_batch``'s channel order)."""
    if g == 1:
        return x
    b, c, h, w = x.shape
    return x.reshape(b // g, g * c, h, w)


def unpack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of :func:`pack_batch`."""
    if g == 1:
        return x
    b, gc, h, w = x.shape
    return x.reshape(b * g, gc // g, h, w)


def grouped_concat(parts, g: int) -> torch.Tensor:
    """Channel concat per pack group: each part [B,g*c_i,H,W]; group i of
    the result holds ``[p0_i, p1_i, ...]``, what a ``groups=g`` conv
    takes. With g = 1 a plain concat (the unpacked model's, unchanged: a
    5-D concat measured 2% slower at b32 1080p on the card)."""
    if g == 1:
        return torch.cat(parts, 1)
    b, _, h, w = parts[0].shape
    return torch.cat([p.reshape(b, g, -1, h, w) for p in parts],
                     2).reshape(b, -1, h, w)


def _world() -> int:
    """The process group's size; 1 without one."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


# A height split's halo (parallel/sharding.py:halo_rows) from the layers
# themselves: each module's ``row_reach`` maps the rows ``(lo, hi)`` of its
# input that one input row of the frame reaches to the rows of its output
# they reach, at each map's own scale, every tap counted whatever its
# weight.

Reach = Tuple[int, int]


def reach_conv(iv: Reach, m: nn.Module) -> Reach:
    """Through the conv ``m`` (same padding, stride 1)."""
    k = (m.kernel_size[0] - 1) // 2
    return iv[0] - k, iv[1] + k


def reach_down(iv: Reach, s: int) -> Reach:
    """Through a max or average pool by ``s``, or space-to-depth by ``s``."""
    return iv[0] // s, iv[1] // s


def reach_up(iv: Reach, s: int) -> Reach:
    """Through depth-to-space by ``s``, or an s x s transposed conv of
    stride ``s``."""
    return iv[0] * s, iv[1] * s + s - 1


def hull(*ivs: Reach) -> Reach:
    """Where maps of one scale are concatenated or added."""
    return min(iv[0] for iv in ivs), max(iv[1] for iv in ivs)


class _SumOverRanks(torch.autograd.Function):
    """The sum over the process group's ranks (``all_reduce``); its
    backward is the sum of the ranks' gradients, what each rank's input
    contributes to every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d,
               train: bool = False) -> torch.Tensor:
    """``bn`` applied to NCHW ``x`` in f32, as Flax's ``BatchNorm(dtype=f32,
    momentum=0.9)`` applies it. Inference: the running statistics. With
    ``train`` the batch's mean and biased variance over (N, H, W), computed
    as Flax computes them (``E[x^2] - E[x]^2``, clipped at 0) and
    differentiable; the running statistics then move by Flax's rule, in
    place, with the biased variance (``F.batch_norm(training=True)`` would
    take the unbiased one).

    In a process group of more than one rank the statistics are the
    global batch's, as JAX's mean over a sharded batch is: the sums of x
    and x^2 and the count, all-reduced in f32 through a differentiable
    collective, whose backward sums each rank's gradient of them. An f64
    ``x`` stays f64 (a reference for the f32 arithmetic)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    if _world() > 1:
        count = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype,
                           device=x.device)
        sums = _SumOverRanks.apply(torch.cat([x.sum((0, 2, 3)),
                                              (x * x).sum((0, 2, 3)), count]))
        c = x.shape[1]
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    else:
        mean = torch.mean(x, (0, 2, 3))
        var = torch.clamp(torch.mean(x * x, (0, 2, 3)) - mean * mean,
                          min=0.0)
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
    is pre-multiplied into each conv, which then has a bias. With ``pack``
    g > 1 (folded only) each conv is grouped, over g packed items."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: Optional[int] = None,
                 folded: bool = False, pack: int = 1):
        super().__init__()
        if pack > 1 and not folded:
            raise ValueError("pack > 1 requires folded BatchNorm "
                             "(inference-only layout)")
        mid = mid_ch if mid_ch is not None else out_ch
        self.folded = folded
        self.pack = pack
        self.conv1 = nn.Conv2d(in_ch * pack, mid * pack, 3, padding=1,
                               bias=folded, groups=pack)
        self.conv2 = nn.Conv2d(mid * pack, out_ch * pack, 3, padding=1,
                               bias=folded, groups=pack)
        if not folded:
            self.bn1 = nn.BatchNorm2d(mid, eps=BN_EPS)
            self.bn2 = nn.BatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor, cdt, train: bool = False,
                poly_low: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``poly_low``: the Up block's low map, with ``x`` its skip; the
        first conv is then ``up2_conv_half_pixel`` (``UP_POLYPHASE``)."""
        if train and self.folded:
            raise ValueError("folded BatchNorm is inference-only; train the "
                             "unfolded model")
        if poly_low is not None and self.pack > 1:
            raise ValueError("poly_low (the fused up2 + conv) is "
                             "incompatible with pack > 1")
        for i in (1, 2):
            m = getattr(self, f"conv{i}")
            if i == 1 and poly_low is not None:
                x = up2_conv_half_pixel(poly_low, x, m.weight, m.bias,
                                        cdt).to(cdt)
            else:
                x = conv(x, m, cdt)
            if not self.folded:
                x = batch_norm(x, getattr(self, f"bn{i}"), train)
            x = F.relu(x).to(cdt)
        return x

    def row_reach(self, iv: Reach) -> Reach:
        return reach_conv(reach_conv(iv, self.conv1), self.conv2)


class Down(nn.Module):
    """2x2 max-pool then DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, folded: bool = False,
                 pack: int = 1):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, folded=folded, pack=pack)

    def forward(self, x: torch.Tensor, cdt, train: bool = False
                ) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2), cdt, train)

    def row_reach(self, iv: Reach) -> Reach:
        return self.conv.row_reach(reach_down(iv, 2))


class Up(nn.Module):
    """x2 upsample of the low-resolution input, zero pad to the skip's size
    (floor of the difference leading), concat ``[skip, up]`` (per pack
    group), DoubleConv. With ``UP_POLYPHASE``, the half-pixel decoder, no
    pack and a skip exactly twice the low map: the upsample fused into the
    first conv."""

    def __init__(self, low_ch: int, skip_ch: int, out_ch: int,
                 bilinear: bool = True, upsample: str = "align_corners",
                 folded: bool = False, pack: int = 1):
        super().__init__()
        if upsample not in ("align_corners", "half_pixel"):
            raise ValueError(f"unknown upsample mode {upsample!r}")
        self.bilinear = bilinear
        self.upsample = upsample
        self.pack = pack
        if bilinear:
            in_ch = low_ch + skip_ch
            self.conv = DoubleConv(in_ch, out_ch, in_ch // 2, folded=folded,
                                   pack=pack)
        else:
            if pack > 1:
                raise ValueError("pack > 1 supports the bilinear decoder "
                                 "only")
            self.up = nn.ConvTranspose2d(low_ch, low_ch // 2, 2, stride=2)
            self.conv = DoubleConv(low_ch // 2 + skip_ch, out_ch,
                                   folded=folded)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, cdt,
                train: bool = False, rows: Optional[tuple] = None
                ) -> torch.Tensor:
        """``rows=(first, total)``: ``x1`` is a height split's window, rows
        ``[first, first + H)`` of a low map of ``total`` rows, which the
        align-corners upsample needs (``ops/resize.py``)."""
        if not self.bilinear:
            x1 = F.conv_transpose2d(x1.to(cdt), self.up.weight.to(cdt),
                                    stride=2)
            x1 = x1 + self.up.bias.to(cdt).view(1, -1, 1, 1)
        elif self.upsample == "half_pixel":
            if (UP_POLYPHASE and self.pack == 1
                    and x2.shape[-2] == 2 * x1.shape[-2]
                    and x2.shape[-1] == 2 * x1.shape[-1]):
                return self.conv(x2, cdt, train, poly_low=x1)
            x1 = upsample2x_half_pixel(x1)
        else:
            x1 = upsample2x_align_corners(x1, rows)
        dh = x2.shape[-2] - x1.shape[-2]
        dw = x2.shape[-1] - x1.shape[-1]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(grouped_concat([x2, x1.to(x2.dtype)], self.pack),
                         cdt, train)

    def row_reach(self, low: Reach, skip: Reach) -> Reach:
        """From the reach into the low map and into the skip (the fused
        polyphase conv reads what the upsample and the conv read)."""
        if not self.bilinear:
            low = reach_up(low, self.up.stride[0])
        elif self.upsample == "half_pixel":
            low = reach_half_pixel(low, 2)
        else:
            low = reach_align_corners(low)
        return self.conv.row_reach(hull(skip, low))


class UNet(nn.Module):
    """Encoder-decoder U-Net: widths ``base_width * 2**i``, the bottleneck
    and decoder halved when ``bilinear``, f32 1x1 output conv; every conv
    grouped over ``pack`` items."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 base_width: int = 64, depth: int = 4, bilinear: bool = True,
                 folded: bool = False, upsample: str = "align_corners",
                 pack: int = 1):
        super().__init__()
        w = base_width
        factor = 2 if bilinear else 1
        self.depth = depth
        self.inc = DoubleConv(in_channels, w, folded=folded, pack=pack)
        skip_ch = [w]
        for i in range(1, depth + 1):
            ch = w * 2 ** i
            if i == depth:
                ch //= factor
            setattr(self, f"down{i}", Down(skip_ch[-1], ch, folded=folded,
                                           pack=pack))
            skip_ch.append(ch)
        y_ch = skip_ch[-1]
        for i in range(1, depth + 1):
            ch = w * 2 ** (depth - i)
            if i < depth:
                ch //= factor
            setattr(self, f"up{i}", Up(y_ch, skip_ch[depth - i], ch,
                                       bilinear=bilinear, upsample=upsample,
                                       folded=folded, pack=pack))
            y_ch = ch
        self.outc = nn.Conv2d(y_ch * pack, out_channels * pack, 1,
                              groups=pack)

    def forward(self, x: torch.Tensor, cdt, train: bool = False,
                rows: Optional[tuple] = None) -> torch.Tensor:
        """``rows=(first, total)``: ``x`` is rows ``[first, first + H)`` of
        a map of ``total`` rows, both multiples of ``2**depth`` (a height
        split's window; :func:`level_rows`)."""
        skips = [self.inc(x.to(cdt), cdt, train)]
        for i in range(1, self.depth + 1):
            skips.append(getattr(self, f"down{i}")(skips[-1], cdt, train))
        y = skips[-1]
        for i in range(1, self.depth + 1):
            y = getattr(self, f"up{i}")(y, skips[self.depth - i], cdt, train,
                                        level_rows(rows, 2 ** (self.depth
                                                               - i + 1)))
        return conv(y, self.outc, torch.float32)

    def row_reach(self, iv: Reach) -> Reach:
        skips = [self.inc.row_reach(iv)]
        for i in range(1, self.depth + 1):
            skips.append(getattr(self, f"down{i}").row_reach(skips[-1]))
        y = skips[-1]
        for i in range(1, self.depth + 1):
            y = getattr(self, f"up{i}").row_reach(y, skips[self.depth - i])
        return reach_conv(y, self.outc)


def level_rows(rows: Optional[tuple], scale: int) -> Optional[tuple]:
    """A height split's ``rows=(first, total)`` at a map ``scale`` times
    coarser (None stays None)."""
    return None if rows is None else (rows[0] // scale, rows[1] // scale)


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

    def head_reach(self, y: Reach, p: int) -> Reach:
        """The frame's rows that input row ``p`` reaches, from its reach
        ``y`` into the prediction in the stem's layout: :meth:`head`'s
        depth-to-space, its convs over the prediction and the planes, and
        the last depth-to-space."""
        r, g = self.cfg.space_to_depth, self.cfg.refine_factor
        if not self.has_head:
            return reach_up(y, r)
        z = hull(reach_up(y, r // g), reach_down((p, p), g))
        for n in self.head_names:
            z = reach_conv(z, getattr(self, n))
        return reach_up(z, g)

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
                 compute_dtype=torch.bfloat16, folded: bool = False,
                 pack: int = 1):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.folded = folded
        self.pack = pack
        self.unet = UNet(cfg.in_channels, cfg.out_channels, cfg.base_width,
                         cfg.depth, cfg.bilinear, folded, cfg.upsample, pack)
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
                skip_refine: bool = False, train: bool = False,
                rows: Optional[tuple] = None) -> torch.Tensor:
        """``skip_refine=True`` returns the f32 pre-refine prediction at full
        resolution, for a caller that applies the head itself; ``train``
        as the module docstring says. With ``pack`` g > 1 the batch must be
        a multiple of g. ``rows=(first, total)``: the frames are rows
        ``[first, first + H)`` of padded frames of ``total`` rows, both
        multiples of ``cfg.pad_multiple`` (a height split's window)."""
        cfg, cdt, g = self.cfg, self.compute_dtype, self.pack
        r = cfg.space_to_depth
        f1 = space_to_depth(frame1, r)
        f2 = space_to_depth(frame2, r)
        p1, p2 = pack_batch(f1, g), pack_batch(f2, g)
        x = grouped_concat([p1, p2], g)
        if cfg.time_conditioned:
            b, _, h, w = x.shape
            if t is None:
                t = torch.full((b * g,), 0.5, dtype=x.dtype, device=x.device)
            tmap = t.to(x.dtype).view(b, g, 1, 1).expand(b, g, h, w)
            x = grouped_concat([x, tmap], g)
        y = self.unet(x, cdt, train, level_rows(rows, r))
        if cfg.residual:
            y = y + 0.5 * (p1 + p2).to(y.dtype)
        y = unpack_batch(y, g)
        if not self.has_head or skip_refine:
            return depth_to_space(y, r)
        g = cfg.refine_factor
        return self.head(y, depth_to_space(f1, r // g),
                         depth_to_space(f2, r // g), train)

    def row_reach(self, p: int) -> Reach:
        """The padded frame's output rows that input row ``p`` of either
        frame reaches in one forward (the time plane is constant; the
        packed core and the option core compute the same layers)."""
        x = reach_down((p, p), self.cfg.space_to_depth)
        y = self.unet.row_reach(x)
        if self.cfg.residual:
            y = hull(y, x)
        return self.head_reach(y, p)


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count (BatchNorm running stats excluded)."""
    return sum(p.numel() for p in model.parameters())


def tile_params_packed(state: dict, g: int) -> dict:
    """The state dict of the ``pack=g`` model from a folded one (JAX
    ``tile_params_packed``): each ``unet.*`` weight repeated g times along
    its output channels and each bias g times, so group i of every grouped
    conv applies the per-item weights; the head stays as it is. The
    repeats are made where the tensors are (the card, for an engine)."""
    if any(k.endswith("running_var") for k in state):
        raise ValueError("tile_params_packed expects folded weights (run "
                         "fold_batchnorm first)")
    return {k: (v.repeat(g, *[1] * (v.dim() - 1)) if k.startswith("unet.")
                else v) for k, v in state.items()}


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
