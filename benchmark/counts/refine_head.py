"""Operations and bytes of the refinement-head kernel
(``csrc/refine_head.cu``) for one launch: the arithmetic of
``chip_smoke.head_flops_bytes``."""


def flops_bytes(b, h, w, c, nplanes, width=64, nf32=0, depthwise=False,
                elem=2):
    """(tensor-core FLOPs, f32 CUDA-core FLOPs, device bytes): every input
    read once (the f32 prediction; ``nf32`` of the other planes in f32,
    the rest bf16), the output (``elem`` bytes) written once, the weights
    read once. The depthwise head's 3x3 is its f32 work; its pointwise conv
    a width x width GEMM."""
    px = b * h * w
    conv2 = width * width if depthwise else 9 * width * width
    flops = 2 * px * (9 * nplanes * width + conv2 + width * c)
    f32_flops = 2 * px * 9 * width if depthwise else 0
    weights = 2 * (9 * nplanes * width + width + conv2 + width) \
        + 4 * (width * c + c) + (6 * 9 * width if depthwise else 0)
    byts = px * (4 * c + 4 * nf32 * c + 2 * (nplanes - c - nf32 * c)
                 + elem * c) + weights
    return flops, f32_flops, byts
