"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its full 700 W power limit) and the roofline bound of a kernel."""

BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16, FLOP/s
F32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12        # HBM3, bytes/s


def bound_ms(flops: float, byts: float, peak_flops: float = BF16_FLOPS,
             f32_flops: float = 0.0) -> float:
    """The least time the card could take, ms: the larger of the
    operations over their peak (``f32_flops`` on the CUDA cores beside
    ``flops`` at ``peak_flops``) and the bytes over the HBM bandwidth."""
    t_ops = max(flops / peak_flops, f32_flops / F32_FLOPS)
    return max(t_ops, byts / HBM_BYTES) * 1e3
