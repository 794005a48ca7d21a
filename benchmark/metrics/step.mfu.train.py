"""A step's FLOPs times the steps of the profiled window, over its wall
time, over the card's dense peak at the configuration's matmul precision."""


def read(ctx):
    if not ctx.get("units") or not ctx.get("peak_flops") or not ctx.get("unit_flops"):
        return None
    return 100.0 * ctx["unit_flops"] * ctx["units"] / ctx["trace"].window_s / ctx["peak_flops"]
