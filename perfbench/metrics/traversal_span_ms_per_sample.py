"""Traversal (scene/scene.py CompiledScene.intersect and any_hit, down to
csrc/*.cu): device milliseconds per sample between the CUDA events of the
program's own ``intersect`` and ``any_hit`` spans (pine_tpu_torch/core/profiler.py),
the outermost ones, in the first frame it recorded; it counts the card's idle
time inside the calls too."""

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

    def outermost(s):
        p = s
        while p["parent"] in spans:
            p = spans[p["parent"]]
            if p["name"] in TRAVERSAL:
                return False
        return True

    trav = [s for s in rec["spans"] if s["name"] in TRAVERSAL and outermost(s)]
    if not trav or any(s["device_ms"] is None for s in trav):
        return None
    return sum(s["device_ms"] for s in trav) / ctx.spp
