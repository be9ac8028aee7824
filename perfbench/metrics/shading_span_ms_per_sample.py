"""Shading and the rest of a sample (core/, scene/ outside the traversal):
device milliseconds per sample between the CUDA events of the program's
``sample`` spans (pine_tpu_torch/core/profiler.py), less those of the outermost
``intersect`` and ``any_hit`` spans inside them, in the first frame it
recorded; it counts the card's idle time inside the samples too."""

TRAVERSAL = ("intersect", "any_hit")


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

    def outermost_in_sample(s):
        p, seen = s, False
        while p["parent"] in spans:
            p = spans[p["parent"]]
            if p["name"] in TRAVERSAL:
                return False
            seen = seen or p["name"] == "sample"
        return seen

    trav = [s for s in rec["spans"] if s["name"] in TRAVERSAL and outermost_in_sample(s)]
    if not samples or any(s["device_ms"] is None for s in samples + trav):
        return None
    return (sum(s["device_ms"] for s in samples) - sum(s["device_ms"] for s in trav)) / ctx.spp
