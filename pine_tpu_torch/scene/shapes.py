"""Analytic shapes: host-side classes that flatten into per-type parameter rows.

Counterpart of pine_tpu/scene/shapes.py: the same type ids, the same
``params()`` layouts and the same ``get_aabb()``, plus lines, triangle
meshes, mesh instancing and heightmaps; signed-distance shapes
(``SDFShape``, whose distance function is a torch callable) and CSG trees
(``a + b``, ``a * b``, ``a - b``: scene/csg.py), neither of which takes a
prim row.
"""
from __future__ import annotations

import numpy as np

# Shape type ids (stable across both packages)
SPHERE = 0
RECT = 1
DISK = 2
PLANE = 3
BOX_AABB = 4
BOX_OBB = 5
TRIANGLE = 6
CONE = 7
CYLINDER = 8
LINE = 9
SDF_TYPE = 10
MESH_TYPE = 11

PARAM_WIDTH = {
    SPHERE: 4,
    RECT: 15,
    DISK: 13,
    PLANE: 12,
    BOX_AABB: 6,
    BOX_OBB: 30,
    TRIANGLE: 12,
    CONE: 12,
    CYLINDER: 10,
    LINE: 17,
}


def _np3(v):
    return np.asarray(v, np.float32).reshape(3)


def _normalize(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _coordinate_system(n):
    n = np.asarray(n, np.float32)
    if abs(n[0]) > abs(n[1]):
        t = np.cross(n, [0.0, 1.0, 0.0])
    else:
        t = np.cross(n, [1.0, 0.0, 0.0])
    t = _normalize(t)
    b = np.cross(n, t).astype(np.float32)
    return t, b


class Shape:
    type_id: int = -1

    def params(self) -> np.ndarray:
        raise NotImplementedError

    def get_aabb(self):
        raise NotImplementedError

    def area(self) -> float:
        """Surface area, pine_tpu's formula in its dtypes (the surfel draw of
        MicroRenderGI picks shapes by it); 0 for shapes it gives none."""
        return 0.0

    # CSG operator sugar (geometry.cpp:935-937): +, *, - build CSG shapes
    def __add__(self, other):
        from pine_tpu_torch.scene.csg import CSGUnion

        return CSGUnion(self, other)

    def __mul__(self, other):
        from pine_tpu_torch.scene.csg import CSGIntersection

        return CSGIntersection(self, other)

    def __sub__(self, other):
        from pine_tpu_torch.scene.csg import CSGDifference

        return CSGDifference(self, other)


class Sphere(Shape):
    """params: [cx, cy, cz, r]."""

    type_id = SPHERE

    def __init__(self, position, radius):
        self.c = _np3(position)
        self.r = float(radius)

    def params(self):
        return np.concatenate([self.c, [self.r]]).astype(np.float32)

    def get_aabb(self):
        return self.c - self.r, self.c + self.r

    def area(self):
        return float(4 * np.pi * self.r**2)


class Rect(Shape):
    """params: [position(3), ex_hat(3), ey_hat(3), n(3), lx, ly, flip]; a hit
    has |dot(p-pos, ex_hat)/lx| <= 1/2 and likewise for ey."""

    type_id = RECT

    def __init__(self, position, ex, ey, flip_normal=False):
        self.position = _np3(position)
        ex = np.asarray(ex, np.float64)
        ey = np.asarray(ey, np.float64)
        self.lx = float(np.linalg.norm(ex))
        self.ly = float(np.linalg.norm(ey))
        self.ex = (ex / self.lx).astype(np.float32)
        self.ey = (ey / self.ly).astype(np.float32)
        n = np.cross(self.ex, self.ey)
        self.n = (_normalize(n) * (-1.0 if flip_normal else 1.0)).astype(np.float32)
        self.flip = bool(flip_normal)

    def params(self):
        return np.concatenate(
            [self.position, self.ex, self.ey, self.n,
             [self.lx, self.ly, 1.0 if self.flip else 0.0]]
        ).astype(np.float32)

    def get_aabb(self):
        vs = np.stack([
            self.position + sx * self.ex * self.lx / 2 + sy * self.ey * self.ly / 2
            for sx in (-1, 1) for sy in (-1, 1)
        ])
        return vs.min(0), vs.max(0)

    def area(self):
        return self.lx * self.ly


class Disk(Shape):
    """params: [position(3), n(3), u(3), v(3), r]."""

    type_id = DISK

    def __init__(self, position, normal, r):
        self.position = _np3(position)
        self.n = _normalize(normal)
        self.u, self.v = _coordinate_system(self.n)
        self.r = float(r)

    def params(self):
        return np.concatenate([self.position, self.n, self.u, self.v, [self.r]]).astype(np.float32)

    def get_aabb(self):
        return self.position - self.r, self.position + self.r

    def area(self):
        return float(np.pi * self.r**2)


class Plane(Shape):
    """params: [position(3), n(3), u(3), v(3)]."""

    type_id = PLANE

    def __init__(self, position, normal):
        self.position = _np3(position)
        self.n = _normalize(normal)
        self.u, self.v = _coordinate_system(self.n)

    def params(self):
        return np.concatenate([self.position, self.n, self.u, self.v]).astype(np.float32)

    def get_aabb(self):
        return self.position - 100.0, self.position + 100.0

    def area(self):
        return float(np.finfo(np.float32).max)


class BoxAABB(Shape):
    """params: [lower(3), upper(3)]."""

    type_id = BOX_AABB

    def __init__(self, lower, upper):
        self.lower = _np3(lower)
        self.upper = _np3(upper)

    def params(self):
        return np.concatenate([self.lower, self.upper]).astype(np.float32)

    def get_aabb(self):
        return self.lower, self.upper

    def area(self):
        d = self.upper - self.lower
        return float(2 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]))


class BoxOBB(Shape):
    """Transformed AABB; params: [lower(3), upper(3), m (3x4 row-major),
    m_inv (3x4)]."""

    type_id = BOX_OBB

    def __init__(self, aabb: BoxAABB, m):
        self.base = aabb
        self.m = np.asarray(m, np.float32).reshape(4, 4)
        self.m_inv = np.linalg.inv(self.m).astype(np.float32)

    def params(self):
        return np.concatenate([
            self.base.lower, self.base.upper,
            self.m[:3, :].reshape(-1), self.m_inv[:3, :].reshape(-1),
        ]).astype(np.float32)

    def get_aabb(self):
        lo, up = self.base.lower, self.base.upper
        corners = np.array(
            [[lo[0] if i % 2 < 1 else up[0], lo[1] if i % 4 < 2 else up[1],
              lo[2] if i % 8 < 4 else up[2]] for i in range(8)],
            np.float32,
        )
        tc = corners @ self.m[:3, :3].T + self.m[:3, 3]
        return tc.min(0), tc.max(0)

    def area(self):
        return self.base.area()  # pine_tpu's: the untransformed box's


class Triangle(Shape):
    """params: [v0(3), v1(3), v2(3), n(3)]."""

    type_id = TRIANGLE

    def __init__(self, v0, v1, v2, n=None):
        self.v0, self.v1, self.v2 = _np3(v0), _np3(v1), _np3(v2)
        if n is None:
            n = np.cross(self.v0 - self.v1, self.v0 - self.v2)
            if np.linalg.norm(n) == 0:
                n = np.array([0.0, 0.0, 1.0])
        self.n = _normalize(n)

    def params(self):
        return np.concatenate([self.v0, self.v1, self.v2, self.n]).astype(np.float32)

    def get_aabb(self):
        vs = np.stack([self.v0, self.v1, self.v2])
        return vs.min(0), vs.max(0)

    def area(self):
        return float(np.linalg.norm(np.cross(self.v1 - self.v0, self.v2 - self.v0)) / 2)


class Cone(Shape):
    """params: [apex(3), n(3), A2, A, S, r, h, 0]; apex = base_p + n*h."""

    type_id = CONE

    def __init__(self, p, n, r, h):
        self.base_p = _np3(p)
        self.n = _normalize(n)
        self.apex = self.base_p + self.n * float(h)
        self.r, self.h = float(r), float(h)
        self.A2 = (self.r / self.h) ** 2 + 1.0
        self.A = float(np.sqrt(self.A2))
        self.S = self.r / float(np.sqrt(self.r ** 2 + self.h ** 2))

    def params(self):
        return np.concatenate(
            [self.apex, self.n, [self.A2, self.A, self.S, self.r, self.h, 0.0]]
        ).astype(np.float32)

    def get_aabb(self):
        lo = np.minimum(self.base_p - self.r, self.apex - self.r)
        up = np.maximum(self.base_p + self.r, self.apex + self.r)
        return lo, up

    def area(self):
        return float(np.pi * self.r * np.sqrt(self.r**2 + self.h**2))


class Cylinder(Shape):
    """params: [p0(3), p1(3), n(3), r]."""

    type_id = CYLINDER

    def __init__(self, p0, p1, r):
        self.p0, self.p1 = _np3(p0), _np3(p1)
        self.n = _normalize(self.p1 - self.p0)
        self.r = float(r)

    def params(self):
        return np.concatenate([self.p0, self.p1, self.n, [self.r]]).astype(np.float32)

    def get_aabb(self):
        return np.minimum(self.p0, self.p1) - self.r, np.maximum(self.p0, self.p1) + self.r

    def area(self):
        return float(2 * np.pi * self.r * np.linalg.norm(self.p1 - self.p0))


class Line(Shape):
    """A segment with a thickness (geometry.cpp:171-253).  params: [p0(3),
    p1(3), tbn_x(3), tbn_y(3), tbn_z(3), thickness, len], the frame's z along
    the segment."""

    type_id = LINE

    def __init__(self, p0, p1, thickness):
        self.p0, self.p1 = _np3(p0), _np3(p1)
        z = _normalize(self.p1 - self.p0)
        x, y = _coordinate_system(z)
        self.tbn = np.stack([x, y, z], axis=1).astype(np.float32)  # columns
        self.thickness = float(thickness)
        self.len = float(np.linalg.norm(self.p1 - self.p0))

    def params(self):
        return np.concatenate([self.p0, self.p1, self.tbn[:, 0], self.tbn[:, 1], self.tbn[:, 2],
                               [self.thickness, self.len]]).astype(np.float32)

    def get_aabb(self):
        return (np.minimum(self.p0, self.p1) - self.thickness,
                np.maximum(self.p0, self.p1) + self.thickness)

    def area(self):
        return float(2 * np.pi * self.thickness * self.len)


class SDFShape(Shape):
    """Signed-distance shape (geometry.cpp:730-762): a box (``center`` +-
    ``half_size``) that bounds the march, and ``fn``, a callable from an
    (N,3) float32 tensor of points to (N,) distances."""

    type_id = SDF_TYPE

    def __init__(self, center, half_size, fn):
        self.center = _np3(center)
        self.half = _np3(half_size)
        self.fn = fn

    def get_aabb(self):
        return self.center - self.half, self.center + self.half


class Mesh(Shape):
    """Triangle mesh: vertices (V,3), indices (F,3), optional per-vertex
    normals (V,3) and texcoords (V,2).  Its triangles join the scene's one
    triangle group at compile()."""

    type_id = MESH_TYPE

    def __init__(self, vertices, indices, texcoords=None, normals=None):
        self.vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self.indices = np.asarray(indices, np.uint32).reshape(-1, 3)
        self.texcoords = (
            None if texcoords is None else np.asarray(texcoords, np.float32).reshape(-1, 2)
        )
        self.normals = (
            None if normals is None else np.asarray(normals, np.float32).reshape(-1, 3)
        )

    def apply(self, m):
        """Transform in place by the 4x4 ``m``; normals through the inverse of
        its 3x3 part, renormalized."""
        m = np.asarray(m, np.float32)
        self.vertices = (self.vertices @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        if self.normals is not None:
            nrm = self.normals @ np.linalg.inv(m[:3, :3]).astype(np.float32)
            self.normals = (
                nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            ).astype(np.float32)
        return self

    def merge(self, other):
        """Append ``other``'s triangles in place; normals and texcoords are
        kept only where both meshes have them."""
        off = len(self.vertices)
        self.vertices = np.concatenate([self.vertices, other.vertices])
        self.indices = np.concatenate([self.indices, other.indices + off])
        both_n = self.normals is not None and other.normals is not None
        self.normals = np.concatenate([self.normals, other.normals]) if both_n else None
        both_t = self.texcoords is not None and other.texcoords is not None
        self.texcoords = np.concatenate([self.texcoords, other.texcoords]) if both_t else None
        return self

    def transformed(self, m):
        """A transformed copy (the flattened form of an instance)."""
        out = Mesh(
            self.vertices.copy(), self.indices.copy(),
            None if self.texcoords is None else self.texcoords.copy(),
            None if self.normals is None else self.normals.copy(),
        )
        return out.apply(m)

    def get_aabb(self):
        return self.vertices.min(0), self.vertices.max(0)

    def num_triangles(self):
        return len(self.indices)

    def triangles(self):
        """(F,9) float32 rows [v0, v1, v2]."""
        f = self.indices.astype(np.int64)
        return np.concatenate([self.vertices[f[:, k]] for k in range(3)], axis=1)

    def area(self):
        return mesh_area(self.triangles())

    def triangle_areas(self):
        return triangle_areas(self.triangles())


class InstancedShape:
    """Mesh instancing: one mesh plus per-instance (4x4 transform, material).
    ``Scene.add`` flattens small instancings into transformed meshes and keeps
    large ones lazy: the mesh stored once, traversed in each instance's frame
    (accel/inst_traverse.py)."""

    def __init__(self, mesh):
        self.shape = mesh
        self.instances = []

    def add(self, transform, material):
        transform = getattr(transform, "data", transform)
        self.instances.append((np.asarray(transform, np.float32), material))
        return self


def _cross_lengths(tris):
    e1 = tris[:, 3:6] - tris[:, 0:3]
    e2 = tris[:, 6:9] - tris[:, 0:3]
    return np.linalg.norm(np.cross(e1, e2), axis=-1)


def mesh_area(tris):
    """Total area of (F,9) triangle rows, summed as pine_tpu's Mesh.area()."""
    return float(_cross_lengths(tris).sum() / 2)


def triangle_areas(tris):
    """Per-triangle areas of (F,9) rows, as pine_tpu's Mesh.triangle_areas()."""
    return _cross_lengths(tris) / 2


def heightmap_from_array(height_map):
    """Mesh grid from a (W,H) height array: x, z in [-1, 1], y the 3x3
    box-smoothed height (pine_tpu's heightmap_from_array)."""
    hm = np.asarray(height_map, np.float32)
    w, h = hm.shape
    pad = np.pad(hm, 1, mode="edge")
    sm = sum(
        pad[1 + dx : 1 + dx + w, 1 + dy : 1 + dy + h] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
    ) / 9.0
    xs = np.linspace(-1, 1, w, dtype=np.float32)
    zs = np.linspace(-1, 1, h, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([X, sm, Z], axis=-1).reshape(-1, 3)
    x, y = np.meshgrid(np.arange(w - 1), np.arange(h - 1), indexing="ij")
    p00, p10 = x + y * w, x + 1 + y * w
    p11, p01 = x + 1 + (y + 1) * w, x + (y + 1) * w
    idx = np.stack([np.stack([p00, p10, p11], -1), np.stack([p00, p11, p01], -1)], axis=2)
    return Mesh(verts, idx.reshape(-1, 3).astype(np.uint32))
