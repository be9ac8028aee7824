"""Traversal kernels: the least time of the frame's intersect and any-hit
calls, bytes-bound (perfbench/roofline.py), over their device time, in %."""

from perfbench.roofline import least_seconds


def read(ctx):
    if ctx.trace_b is None or not ctx.trace_b["traversal_ns"]:
        return None
    least = least_seconds(ctx.trace_b["calls"], ctx.scene_bytes)
    return 100.0 * least / (ctx.trace_b["traversal_ns"] / 1e9)
