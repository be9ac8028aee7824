"""Shading and the rest of a sample (scene/, core/): device milliseconds per
sample launched outside the benchmark's intersect and any-hit ranges."""


def read(ctx):
    if ctx.trace_b is None or not ctx.trace_b["device_ns"]:
        return None
    return (ctx.trace_b["device_ns"] - ctx.trace_b["traversal_ns"]) / 1e6 / ctx.spp
