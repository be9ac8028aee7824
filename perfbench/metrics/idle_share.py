"""Device (H100): the share of a frame's wall in which the card ran nothing,
1 - the busy time of the frame traced for the card alone over the median
wall of the window's untraced frames (so the profiler's own host cost does
not count), in %."""

import statistics


def read(ctx):
    if ctx.trace_a is None or not ctx.trace_a["busy_s"]:
        return None
    return max(0.0, 100.0 * (1.0 - ctx.trace_a["busy_s"] / statistics.median(ctx.frame_walls)))
