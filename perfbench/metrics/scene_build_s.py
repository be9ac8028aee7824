"""PRL front end (prl/, scenes.py): host seconds of building the scene, the
script through the interpreter or the mesh through the Python API."""


def read(ctx):
    return ctx.spans.get("scene_build")
