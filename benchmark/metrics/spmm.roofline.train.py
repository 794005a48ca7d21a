"""The public `spmm_pair`, forward and backward, on each adjacency a step
multiplies: the sum of the products' bounds over their time between CUDA
events."""


def read(ctx):
    t = ctx.get("spmm")
    if ctx.get("kind") != "train" or not t or not t.get("bound_s"):
        return None
    return 100.0 * t["bound_s"] / t["time_s"]
