"""The whole model step's share of the card's bf16 peak: the
configuration's FLOPs for a pair's in-betweens (``counts/<family>.py``)
times the pairs a second of the traced window, over 989 TFLOP/s."""

from benchmark.counts.peaks import BF16_FLOPS


def read(ctx):
    rec, t = ctx.record, ctx.cell.traffic
    if not rec.get("pairs"):
        return None
    flops = ctx.counts().pair_flops(ctx.cell.model, t["height"], t["width"],
                                    rec["n_out"])
    return 100.0 * flops * rec["pairs"] / ctx.trace["window_s"] \
        / BF16_FLOPS
