"""A configuration's plain scene description -> the reference's primitive
tables (NumPy float32 on the host; ``on(device, dtype)`` moves them).

The description is the ``plain`` block of a configuration file:

- ``materials``: name -> {"type": "diffuse", "albedo"} | {"type": "metal",
  "albedo", "roughness"} | {"type": "emissive", "color", "scale"};
- ``shapes``: a list of {"type": "rect", "position", "ex", "ey"} (a
  parallelogram of full edge vectors ex, ey, centred on position, normal
  ex x ey), {"type": "cone_grid", "x": [begin, step, end], "z": [...],
  "y", "axis", "radius", "height"} (a cone on each point of the two loops,
  each ``v += step`` in double precision while ``v <= end``),
  {"type": "box", "lower", "upper", "transform": [[op, arg], ...]} (a box
  under the product of "translate", "rotate_y" and "scale" in order) and
  {"type": "heightfield", "grid", "size", "amp", "seed"} (the frozen
  generator's triangle mesh), each with a ``material``;
- ``camera``: {"from", "to", "fov", "tone_map"}, fov the tangent of half the
  vertical angle.

The one emissive shape is the scene's one light; it must be a rect.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.heightfield import make_heightfield

DIFFUSE, METAL, EMISSIVE = 0, 1, 2


def _f32(v):
    return np.asarray(v, np.float32).reshape(-1)


def _unit(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def loop_values(begin, step, end):
    """The values of ``for v in begin ~ step ~ end``."""
    out, v = [], float(begin)
    while v <= end:
        out.append(v)
        v += step
    return out


def _transform(ops):
    m = np.eye(4, dtype=np.float32)
    for op, arg in ops:
        t = np.eye(4, dtype=np.float32)
        if op == "translate":
            t[:3, 3] = _f32(arg)
        elif op == "scale":
            s = _f32(arg)
            t[0, 0], t[1, 1], t[2, 2] = s
        elif op == "rotate_y":
            c, s = np.cos(arg), np.sin(arg)
            t[0, 0], t[0, 2], t[2, 0], t[2, 2] = c, s, -s, c
        else:
            raise ValueError(f"unknown transform {op!r}")
        m = m @ t
    return m


class PlainScene:
    """Host tables: ``rect``, ``cone``, ``box``, ``tri`` (dicts of float32
    arrays, one row a prim, ``mat`` the material row), ``materials`` (rows of
    kind, albedo, roughness, emitted colour), ``light`` (the emissive
    rect's row), ``lo``/``up`` (the scene's box) and the ``camera``."""

    def __init__(self, plain):
        names = list(plain["materials"])
        self.materials = []
        for name in names:
            m = plain["materials"][name]
            kind = {"diffuse": DIFFUSE, "metal": METAL, "emissive": EMISSIVE}[m["type"]]
            albedo = _f32(m.get("albedo", [0, 0, 0]))
            color = np.float32(m.get("scale", 1.0)) * _f32(m.get("color", [0, 0, 0]))
            self.materials.append(dict(kind=kind, albedo=albedo,
                                       roughness=float(m.get("roughness", 0.0)), color=color))
        rects, cones, boxes, tris = [], [], [], []
        lo = np.full(3, np.inf, np.float32)
        up = np.full(3, -np.inf, np.float32)
        for sh in plain["shapes"]:
            mat = names.index(sh["material"])
            t = sh["type"]
            if t == "rect":
                pos = _f32(sh["position"])
                ex, ey = _f32(sh["ex"]).astype(np.float64), _f32(sh["ey"]).astype(np.float64)
                lx, ly = float(np.linalg.norm(ex)), float(np.linalg.norm(ey))
                exh, eyh = (ex / lx).astype(np.float32), (ey / ly).astype(np.float32)
                n = _unit(np.cross(exh, eyh))
                rects.append(np.concatenate([pos, exh, eyh, n, [lx, ly, mat]]))
                corners = np.stack([pos + sx * exh * lx / 2 + sy * eyh * ly / 2
                                    for sx in (-1, 1) for sy in (-1, 1)])
                lo, up = np.minimum(lo, corners.min(0)), np.maximum(up, corners.max(0))
            elif t == "cone_grid":
                axis = _unit(sh["axis"])
                r, h = float(sh["radius"]), float(sh["height"])
                a2 = (r / h) ** 2 + 1.0
                for x in loop_values(*sh["x"]):
                    for z in loop_values(*sh["z"]):
                        base = _f32([x, sh["y"], z])
                        apex = base + axis * np.float32(h)
                        cones.append(np.concatenate(
                            [apex, axis, [a2, np.sqrt(a2), r / np.sqrt(r * r + h * h), r, h,
                                          mat]]))
                        lo = np.minimum(lo, np.minimum(base - r, apex - r))
                        up = np.maximum(up, np.maximum(base + r, apex + r))
            elif t == "box":
                m = _transform(sh["transform"])
                mi = np.linalg.inv(m).astype(np.float32)
                blo, bup = _f32(sh["lower"]), _f32(sh["upper"])
                boxes.append(np.concatenate([blo, bup, m[:3].ravel(), mi[:3].ravel(), [mat]]))
                corners = np.array([[blo[0] if i % 2 < 1 else bup[0],
                                     blo[1] if i % 4 < 2 else bup[1],
                                     blo[2] if i % 8 < 4 else bup[2]] for i in range(8)],
                                   np.float32) @ m[:3, :3].T + m[:3, 3]
                lo, up = np.minimum(lo, corners.min(0)), np.maximum(up, corners.max(0))
            elif t == "heightfield":
                V, F = make_heightfield(sh["grid"], sh["size"], sh["amp"], sh["seed"])
                f = F.astype(np.int64)
                v0, v1, v2 = V[f[:, 0]], V[f[:, 1]], V[f[:, 2]]
                gn = np.cross(v0 - v1, v0 - v2)
                gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
                tris.append(np.concatenate(
                    [v0, v1, v2, gn.astype(np.float32), np.full((len(F), 1), mat)], 1))
                self.mesh_bytes = V.nbytes + F.nbytes
                lo, up = np.minimum(lo, V.min(0)), np.maximum(up, V.max(0))
            else:
                raise ValueError(f"unknown shape type {t!r}")
        widths = dict(rect=15, cone=12, box=31, tri=13)
        self.tables = {}
        for key, rows in (("rect", rects), ("cone", cones), ("box", boxes), ("tri", tris)):
            arr = (np.concatenate([np.atleast_2d(r) for r in rows]) if rows
                   else np.zeros((0, widths[key])))
            self.tables[key] = arr.astype(np.float32)
        self.lo, self.up = lo, up
        lights = [i for i, r in enumerate(self.tables["rect"])
                  if self.materials[int(r[14])]["kind"] == EMISSIVE]
        if len(lights) != 1 or any(m["kind"] == EMISSIVE for key in ("cone", "box", "tri")
                                   for m in (self.materials[int(r[-1])]
                                             for r in self.tables[key])):
            raise ValueError("the reference takes one emissive rect as the scene's light")
        self.light = lights[0]
        self.camera = plain["camera"]

    def ao_radius(self):
        """AOIntegrator's default radius: half the scene box's diagonal."""
        return float(np.linalg.norm(self.up - self.lo) / 2)

    def on(self, device, dtype):
        """The tables as tensors on ``device`` in ``dtype``; the material
        rows as (kind int64, albedo, roughness, color)."""
        t = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in self.tables.items()}
        mats = self.materials
        t["mat_kind"] = torch.tensor([m["kind"] for m in mats], device=device)
        t["mat_albedo"] = torch.as_tensor(np.stack([m["albedo"] for m in mats]),
                                          device=device).to(dtype)
        t["mat_rough"] = torch.tensor([m["roughness"] for m in mats], device=device).to(dtype)
        t["mat_color"] = torch.as_tensor(np.stack([m["color"] for m in mats]),
                                         device=device).to(dtype)
        return t
