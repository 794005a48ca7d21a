"""A pass's FLOPs (the encode's, and 2 x padded test users x items x width
for the scoring) over the mean pass's wall time in the profiled window,
over the card's dense peak at the configuration's matmul precision."""


def read(ctx):
    ranges = ctx["trace"].ranges(ctx["pass_span"]) if ctx.get("pass_span") else []
    if not ranges or not ctx.get("peak_flops") or not ctx.get("unit_flops"):
        return None
    mean_s = sum(e - s for _, s, e, _ in ranges) / len(ranges)
    return 100.0 * ctx["unit_flops"] / mean_s / ctx["peak_flops"]
