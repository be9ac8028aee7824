"""Wavefront driver (integrators/path.py, integrators/ao.py): kernels,
copies and sets the card ran in the frame traced for the card alone, per
sample."""


def read(ctx):
    if ctx.trace_a is None or not ctx.trace_a["launches"]:
        return None
    return ctx.trace_a["launches"] / ctx.spp
