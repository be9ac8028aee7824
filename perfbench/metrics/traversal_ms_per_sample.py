"""Traversal (accel/packet.py, accel/*_traverse.py, csrc/*.cu): device
milliseconds per sample launched inside the benchmark's ranges around the
compiled scene's intersect and any_hit."""


def read(ctx):
    if ctx.trace_b is None or not ctx.trace_b["traversal_ns"]:
        return None
    return ctx.trace_b["traversal_ns"] / 1e6 / ctx.spp
