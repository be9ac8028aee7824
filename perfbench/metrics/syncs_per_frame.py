"""Wavefront driver: the host-device synchronisations of one frame, the
program's ``syncs`` counter (pine_tpu_torch/core/profiler.py: every
synchronising call on the frame path sits in a ``sync.<site>`` span that adds
to it, the film's readback included) in the first frame it recorded."""


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from pine_tpu_torch.core import profiler

        rec = profiler.first_frame()
    except (ImportError, AttributeError):  # a program without the tracer
        return None
    if rec is None or not any(s["name"] == "sample" for s in rec["spans"]):
        return None
    return rec["counters"].get("syncs", 0)
