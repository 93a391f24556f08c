"""Operations of the U-Net family's forward, counted from the
configuration's widths: two FLOPs a multiply-add of every convolution at
the padded frame size, the core's at 1/``space_to_depth`` of it. Pools,
upsamples, ReLUs, the residual add and uint8 conversion are left out (a
few FLOPs a pixel against tens of thousands)."""

import math

from benchmark.reference.nets import pad_multiple, unet_widths


def padded(model: dict, h: int, w: int):
    m = pad_multiple(model)
    return -(-h // m) * m, -(-w // m) * m


def core_flops(cin: int, cout: int, base: int, depth: int, h: int,
               w: int) -> float:
    """A U-Net core over ``h`` x ``w`` maps: 3x3 double convs at every
    level, the 1x1 output conv at the top."""
    enc, dec = unet_widths(base, depth)
    total = 0.0

    def dconv(level, c0, mid, c1):
        px = (h >> level) * (w >> level)
        return 2.0 * px * 9 * (c0 * mid + mid * c1)

    total += dconv(0, cin, enc[0], enc[0])
    for i in range(1, depth + 1):
        total += dconv(i, enc[i - 1], enc[i], enc[i])
    for i, (low, skip, mid, out) in enumerate(dec, 1):
        total += dconv(depth - i, low + skip, mid, out)
    return total + 2.0 * h * w * dec[-1][3] * cout


def head_flops(px: int, nplanes: int, width: int, c: int) -> float:
    """The dense head over ``px`` pixels."""
    return 2.0 * px * (9 * nplanes * width + 9 * width * width + width * c)


def forward_flops(model: dict, h: int, w: int) -> float:
    """One midpoint of an ``h`` x ``w`` pair."""
    hp, wp = padded(model, h, w)
    r, c = model["space_to_depth"], model["channels"]
    total = core_flops(2 * c * r * r, c * r * r, model["base_width"],
                       model["depth"], hp // r, wp // r)
    if model["refine_width"] > 0 and r > 1:
        total += head_flops(hp * wp, 3 * c, model["refine_width"], c)
    return total


def pair_flops(model: dict, h: int, w: int, n: int) -> float:
    """``n`` in-betweens of one pair: every forward of the bisection to the
    least depth that holds them."""
    depth = max(1, math.ceil(math.log2(n + 1)))
    return (2 ** depth - 1) * forward_flops(model, h, w)


def head_launch(model: dict, b: int, h: int, w: int):
    """The head kernel's (b, h, w, c, nplanes, width, nf32) for one launch
    over ``b`` pairs: the f32 prediction and both frames in bf16."""
    hp, wp = padded(model, h, w)
    c = model["channels"]
    return b, hp, wp, c, 3 * c, model["refine_width"], 0
