"""Operations of the flow family's forward, counted from the
configuration's widths: the motion U-Net at 1/``flow_scale`` of the padded
frame once a pair, then at each sample time the sampler (``counts/
sample_fused.py``) and the dense head over (blend, two warps, two
frames), two FLOPs a multiply-add."""

from benchmark.counts.unet import core_flops, head_flops, padded


def motion_flops(model: dict, h: int, w: int) -> float:
    """The motion U-Net, once a pair."""
    hp, wp = padded(model, h, w)
    s, c = model["flow_scale"], model["channels"]
    return core_flops(2 * c, 3, model["base_width"], model["depth"],
                      hp // s, wp // s)


def sample_flops(model: dict, h: int, w: int) -> float:
    """The sampler and the head, once a sample time."""
    hp, wp = padded(model, h, w)
    c = model["channels"]
    px = hp * wp
    total = px * (2 * (9 + 12 * c) + 6 + 4 * c)      # the sampler
    if model["refine_width"] > 0:
        total += head_flops(px, 5 * c, model["refine_width"], c)
    return total


def forward_flops(model: dict, h: int, w: int) -> float:
    """One midpoint of an ``h`` x ``w`` pair."""
    return pair_flops(model, h, w, 1)


def pair_flops(model: dict, h: int, w: int, n: int) -> float:
    """``n`` in-betweens of one pair: one motion pass, ``n`` samples."""
    return motion_flops(model, h, w) + n * sample_flops(model, h, w)


def head_launch(model: dict, b: int, h: int, w: int):
    """The head's launch over ``b`` pairs: the f32 blend, the two f32
    warps, both frames in bf16."""
    hp, wp = padded(model, h, w)
    c = model["channels"]
    return b, hp, wp, c, 5 * c, model["refine_width"], 2


def sampler_launch(model: dict, b: int, h: int, w: int):
    """The sampler's (b, h, w, c) for one launch over ``b`` pairs."""
    hp, wp = padded(model, h, w)
    return b, hp, wp, model["channels"]
