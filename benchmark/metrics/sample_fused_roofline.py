"""The flow sampler kernel's share of its roofline (``counts/
sample_fused.py`` at the cell's launch shape, bf16 frames) over its device
time a launch in the trace."""

from benchmark.counts.peaks import bound_ms
from benchmark.harness.trace import kernel_time


def read(ctx):
    launches, secs = kernel_time(ctx.trace, "sample_tiled_kernel",
                                 "sample_fused_kernel")
    if not launches:
        return None
    t = ctx.cell.traffic
    shape = ctx.counts().sampler_launch(ctx.cell.model,
                                        ctx.record["launch_batch"],
                                        t["height"], t["width"])
    flops, byts = ctx.counts("sample_fused").flops_bytes(*shape)
    return 100.0 * bound_ms(flops, byts) / (secs * 1e3 / launches)
