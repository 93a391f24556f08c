"""Operations and bytes of the flow sampler kernel
(``csrc/sample_fused.cu``) for one launch: the arithmetic of
``chip_smoke.sampler_flops_bytes``."""


def flops_bytes(b, h, w, c, img_bytes=2):
    """(FLOPs, device bytes): f1 and f2, the two field planes, the mask and
    t read once, out, g0 and g1 (f32) written once. Per pixel and warp,
    three taps (9) and three lerps per channel (4 each); the blend 6 + 4
    per channel."""
    px = b * h * w
    flops = px * (2 * (9 + 12 * c) + 6 + 4 * c)
    byts = px * (2 * img_bytes * c + 8 + 4 + 12 * c) + 4 * b
    return flops, byts
