"""CSG shapes.  Counterpart of pine_tpu/scene/csg.py (parity:
geometry.cpp:764-830; PRL's operators +, *, - on shapes, ``Shape.__add__``
and the others in scene/shapes.py).

A CSG shape is a tree of two children, each an analytic shape with an
interval test (sphere, AABB, OBB, cone, cylinder) or another CSG shape.  It
takes no prim row: the compiled scene intersects it through the interval
walk of scene/csg_intersect.py.
"""
from __future__ import annotations

import numpy as np

from pine_tpu_torch.scene.shapes import Shape


class CSGShape(Shape):
    type_id = -1  # no prim row: CompiledScene keeps these in a list of their own

    def __init__(self, a: Shape, b: Shape):
        self.a = a
        self.b = b

    def get_aabb(self):
        la, ua = self.a.get_aabb()
        lb, ub = self.b.get_aabb()
        return np.minimum(la, lb), np.maximum(ua, ub)


class CSGUnion(CSGShape):
    op = "union"


class CSGIntersection(CSGShape):
    op = "intersection"

    def get_aabb(self):
        la, ua = self.a.get_aabb()
        lb, ub = self.b.get_aabb()
        return np.maximum(la, lb), np.minimum(ua, ub)


class CSGDifference(CSGShape):
    op = "difference"

    def get_aabb(self):
        return self.a.get_aabb()
