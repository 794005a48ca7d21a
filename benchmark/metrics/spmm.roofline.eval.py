"""The public `spmm_pair`, forward only, on each adjacency an encode
multiplies: the sum of the products' bounds over their time between CUDA
events."""


def read(ctx):
    t = ctx.get("spmm")
    if ctx.get("kind") != "eval" or not t or not t.get("bound_s"):
        return None
    return 100.0 * t["bound_s"] / t["time_s"]
