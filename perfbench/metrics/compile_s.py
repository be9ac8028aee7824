"""Scene build (Scene.compile, the accel builders, the native SAH builder):
host seconds of ``compile`` until the card has finished."""


def read(ctx):
    return ctx.spans.get("compile")
