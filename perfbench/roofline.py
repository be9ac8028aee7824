"""The benchmark's frozen roofline arithmetic for the traversal layer.

A closest-hit or any-hit call over N rays needs at least: every ray's
origin, direction, tmin and tmax read once (32 bytes), every result
written once (a closest hit's distance and primitive id, 8 bytes; an
any-hit's flag, 1 byte), and the scene's primitives read once, as the
configuration's plain description holds them (``prim_bytes``).  No
operation term is counted: an acceleration structure changes how many
primitives a ray tests, so the same bytes are the least of any
implementation.  The least time is those bytes at the card's peak
bandwidth."""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM5 80 GB HBM3, data sheet, at 700 W
RAY_BYTES = 32  # origin and direction float32x3, tmin and tmax float32
RESULT_BYTES = {"intersect": 8, "any_hit": 1}
# bytes of one primitive of each kind of the plain description
PRIM_BYTES = {
    "rect": 9 * 4,  # centre and two edge vectors
    "cone": 8 * 4,  # base point, axis, radius, height
    "box": 18 * 4,  # lower and upper corners, a 3x4 transform
}


def prim_bytes(scene):
    """The primitive bytes of a reference PlainScene: its analytic rows by
    kind, and a mesh as its float32 vertices and uint32 indices."""
    total = sum(PRIM_BYTES[k] * len(scene.tables[k]) for k in PRIM_BYTES)
    return total + getattr(scene, "mesh_bytes", 0)


def least_seconds(calls, scene_bytes):
    """The least time of traversal ``calls``: [(kind, rays)]."""
    total = sum(n * (RAY_BYTES + RESULT_BYTES[kind]) + scene_bytes for kind, n in calls)
    return total / PEAK_BYTES_PER_S
