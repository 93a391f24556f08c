"""The refinement-head kernel's share of its roofline: the least time its
operations and bytes allow (``counts/refine_head.py`` at the cell's
launch shape, ``counts/peaks.py``) over its device time a launch in the
trace."""

from benchmark.counts.peaks import BF16_FLOPS, bound_ms
from benchmark.harness.trace import kernel_time


def read(ctx):
    launches, secs = kernel_time(ctx.trace, "refine_head_kernel")
    if not launches:
        return None
    t = ctx.cell.traffic
    shape = ctx.counts().head_launch(ctx.cell.model,
                                     ctx.record["launch_batch"],
                                     t["height"], t["width"])
    flops, f32_flops, byts = ctx.counts("refine_head").flops_bytes(*shape)
    return 100.0 * bound_ms(flops, byts, BF16_FLOPS, f32_flops) \
        / (secs * 1e3 / launches)
