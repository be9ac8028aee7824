"""Wavefront driver (integrators/ao.py, integrators/path.py): the program's
host milliseconds per sample, from its own spans (pine_tpu_torch/core/profiler.py)
in the first frame it recorded (the frame traced for the card alone): the host
time inside the frame's ``sample`` spans, less the ``sync.*`` spans in them
(each holds one synchronising call: the wait for the card) and less the host
time the tracer spent on the spans in them (``own_ns``), over spp."""


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from pine_tpu_torch.core import profiler

        rec = profiler.first_frame()
    except (ImportError, AttributeError):  # a program without the tracer
        return None
    if rec is None:
        return None
    spans = {s["id"]: s for s in rec["spans"]}
    samples = [s for s in rec["spans"] if s["name"] == "sample"]
    if not samples:
        return None

    def under_sample(s):
        while s["parent"] in spans:
            s = spans[s["parent"]]
            if s["name"] == "sample":
                return True
        return False

    inner = [s for s in rec["spans"] if under_sample(s)]
    host = sum(s["t1_ns"] - s["t0_ns"] for s in samples)
    waits = sum(s["t1_ns"] - s["t0_ns"] for s in inner if s["name"].startswith("sync."))
    tracer = sum(s.get("own_ns", 0) for s in inner)
    return (host - waits - tracer) / 1e6 / ctx.spp
