"""Lights.  Counterpart of pine_tpu/scene/lights.py: point and directional
lights, and area lights on an analytic shape or a triangle mesh.

``sample(p, u2, u1)`` is batched: p (N,3), u2 (N,2), u1 (N,) ->
dict(le, wo, distance, pdf, valid).  Spot lights (ROADMAP.md, modules item
3) and environment lights (item 10) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core.vecmath import dot, length
from pine_tpu_torch.scene import intersect as I
from pine_tpu_torch.scene import shapes as S


class Light:
    is_delta = False


class PointLight(Light):
    is_delta = True

    def __init__(self, position, color):
        self.position = np.asarray(position, np.float32)
        self.color = np.asarray(color, np.float32)
        self._dev = {}

    def _on(self, device):
        if device not in self._dev:
            self._dev[device] = (torch.as_tensor(self.position, device=device),
                                 torch.as_tensor(self.color, device=device))
        return self._dev[device]

    def sample(self, p, u2, u1):
        pos, color = self._on(p.device)
        d = pos - p
        dist = length(d)
        return dict(
            le=color.expand(p.shape),
            wo=d / torch.clamp_min(dist[..., None], 1e-20),
            distance=dist,
            pdf=dist * dist,
            valid=torch.ones_like(dist, dtype=torch.bool),
        )


class DirectionalLight(Light):
    """A delta light from direction ``direction`` (toward the light),
    normalised in float64 and then cast, as pine_tpu's: its sample is that
    direction at distance 1e10 with pdf 1, always valid."""

    is_delta = True

    def __init__(self, direction, color):
        d = np.asarray(direction, np.float64)
        self.direction = (d / np.linalg.norm(d)).astype(np.float32)
        self.color = np.asarray(color, np.float32)
        self._dev = {}

    @classmethod
    def unit(cls, direction, color):
        """A light whose float32 ``direction`` is already normalised (a
        compiled scene's record), kept as it is."""
        light = cls.__new__(cls)
        light.direction = np.asarray(direction, np.float32)
        light.color = np.asarray(color, np.float32)
        light._dev = {}
        return light

    def sample(self, p, u2, u1):
        n, dev = p.shape[0], p.device
        if dev not in self._dev:
            self._dev[dev] = (torch.as_tensor(self.direction, device=dev),
                              torch.as_tensor(self.color, device=dev))
        direction, color = self._dev[dev]
        return dict(
            le=color.expand(n, 3),
            wo=direction.expand(n, 3),
            distance=torch.full((n,), 1e10, device=dev),
            pdf=torch.ones(n, device=dev),
            valid=torch.ones(n, dtype=torch.bool, device=dev),
        )


class AreaLight(Light):
    """Emissive analytic shape ``global_idx`` with constant color ``color``;
    ``params`` is the shape's parameter row (a tensor on the render device)."""

    def __init__(self, tid, params, global_idx, color):
        self.tid = int(tid)
        self.params = params
        self.global_idx = int(global_idx)
        self.color = color

    def sample(self, p, u2, u1):
        n = p.shape[0]
        ss = I.SAMPLE[self.tid](self.params.expand(n, -1), p, u2)
        le = self.color.expand(n, 3)
        # emissive only from the front face
        front = dot(-ss["w"], ss["n"]) >= 0.0
        valid = front & (ss["pdf"] > 0.0) & (le > 0.0).any(-1)
        return dict(le=le, wo=ss["w"], distance=ss["distance"], pdf=ss["pdf"], valid=valid)


class MeshLight(AreaLight):
    """Emissive triangle mesh ``global_idx``: a triangle picked with
    probability proportional to its area by u1, a uniform point on it by u2.
    ``tris`` are the mesh's (F,9) host rows [v0, v1, v2] in mesh order."""

    def __init__(self, tris, global_idx, color, device):
        tris = np.asarray(tris, np.float32)
        areas = S.triangle_areas(tris)
        super().__init__(S.MESH_TYPE, None, global_idx, color)
        self.area = S.mesh_area(tris)  # the pdf of a hit on the mesh
        self.total_area = float(areas.sum())
        self.cdf = torch.as_tensor((np.cumsum(areas) / max(areas.sum(), 1e-20)).astype(np.float32),
                                   device=device)
        self.tris = torch.as_tensor(tris, device=device)

    def sample(self, p, u2, u1):
        n = p.shape[0]
        tri = torch.searchsorted(self.cdf, u1.contiguous()).clamp(0, self.cdf.shape[0] - 1)
        rows = self.tris[tri]
        v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        flip = (u2[:, 0] + u2[:, 1]) > 1.0
        uu = torch.where(flip[:, None], 1.0 - u2, u2)
        sp = v0 + uu[:, 0:1] * (v1 - v0) + uu[:, 1:2] * (v2 - v0)
        nrm = torch.linalg.cross(v1 - v0, v2 - v0)
        nrm = nrm / torch.clamp_min(length(nrm)[:, None], 1e-20)
        dvec = sp - p
        dist = length(dvec)
        w = dvec / torch.clamp_min(dist[:, None], 1e-20)
        pdf = dist**2 / torch.clamp_min(dot(w, nrm).abs() * self.total_area, 1e-20)
        le = self.color.expand(n, 3)
        valid = (dot(-w, nrm) >= 0.0) & (pdf > 0.0) & (le > 0.0).any(-1)
        return dict(le=le, wo=w, distance=dist, pdf=pdf, valid=valid)
