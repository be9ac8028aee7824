"""Lights.  Counterpart of pine_tpu/scene/lights.py: point, spot and
directional lights, area lights on an analytic shape or a triangle mesh
(their color a node evaluated at the sampled point), and the gradient
``Sky``; the Atmosphere and ImageSky are in scene/env_lights.py.

``sample(p, u2, u1)`` is batched: p (N,3), u2 (N,2), u1 (N,) ->
dict(le, wo, distance, pdf, valid).  An environment light also has
``color(wo)`` and ``pdf(wo)`` for the rays that escape the scene.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core.sampling import uniform_sphere
from pine_tpu_torch.core.vecmath import Pi, dot, length
from pine_tpu_torch.scene import intersect as I
from pine_tpu_torch.scene import shapes as S
from pine_tpu_torch.scene.nodes import eval_vec3_node

FLOAT_MAX = float(np.finfo(np.float32).max)


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


class SpotLight(Light):
    """A delta light at ``position`` shining along ``direction`` (normalised
    in float64, then cast): full ``color`` within ``falloff_radian`` of the
    axis, falling linearly in the cosine to zero at ``falloff_radian +
    cutoff_additional_radian``, and no sample beyond (light.cpp)."""

    is_delta = True

    def __init__(self, position, direction, color, falloff_radian, cutoff_additional_radian=0.0):
        self.position = np.asarray(position, np.float32)
        d = np.asarray(direction, np.float64)
        self.direction = (d / np.linalg.norm(d)).astype(np.float32)
        self.color = np.asarray(color, np.float32)
        self.falloff_cos = float(np.cos(falloff_radian))
        self.cutoff_cos = float(np.cos(falloff_radian + cutoff_additional_radian))
        self._dev = {}

    @classmethod
    def of_record(cls, position, direction, color, falloff_cos, cutoff_cos):
        """A light from a compiled scene's record: the unit ``direction`` and
        the two cosines as they are."""
        light = cls.__new__(cls)
        light.position = np.asarray(position, np.float32)
        light.direction = np.asarray(direction, np.float32)
        light.color = np.asarray(color, np.float32)
        light.falloff_cos, light.cutoff_cos = float(falloff_cos), float(cutoff_cos)
        light._dev = {}
        return light

    def sample(self, p, u2, u1):
        dev = p.device
        if dev not in self._dev:
            self._dev[dev] = tuple(torch.as_tensor(x, device=dev)
                                   for x in (self.position, self.direction, self.color))
        pos, direction, color = self._dev[dev]
        d = pos - p
        dist = length(d)
        wo = d / torch.clamp_min(dist[..., None], 1e-20)
        cos = -dot(wo, direction)
        denom = max(self.falloff_cos - self.cutoff_cos, 1e-9)
        scale = torch.where(cos > self.falloff_cos, 1.0,
                            torch.where(cos > self.cutoff_cos, (cos - self.cutoff_cos) / denom,
                                        0.0))
        return dict(le=color * scale[..., None], wo=wo, distance=dist, pdf=dist * dist,
                    valid=cos > self.cutoff_cos)


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
    """Emissive analytic shape ``global_idx`` whose color is the node
    ``color``, evaluated at the sampled point; ``params`` is the shape's
    parameter row (a tensor on the render device)."""

    def __init__(self, tid, params, global_idx, color):
        self.tid = int(tid)
        self.params = params
        self.global_idx = int(global_idx)
        self.color = color

    def sample(self, p, u2, u1):
        n = p.shape[0]
        ss = I.SAMPLE[self.tid](self.params.expand(n, -1), p, u2)
        le = eval_vec3_node(self.color, dict(p=ss["p"], n=ss["n"], uv=torch.zeros_like(p[:, :2])),
                            n)
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
        le = eval_vec3_node(self.color, dict(p=sp, n=nrm, uv=torch.zeros_like(p[:, :2])), n)
        valid = (dot(-w, nrm) >= 0.0) & (pdf > 0.0) & (le > 0.0).any(-1)
        return dict(le=le, wo=w, distance=dist, pdf=pdf, valid=valid)


class EnvironmentLight(Light):
    """A light at infinity: ``color(wo)`` of an escaped ray and ``pdf(wo)``,
    the solid-angle density of ``sample``, for MIS.  Its samples lie at
    distance FLOAT_MAX."""


class Sky(EnvironmentLight):
    """Gradient sky (color.cpp sky_color; light.cpp:71-86), sampled uniformly
    over the sphere."""

    def __init__(self, sun_color):
        self.sun_color = np.asarray(sun_color, np.float32)
        self._dev = {}

    def _on(self, device):
        if device not in self._dev:
            self._dev[device] = tuple(torch.as_tensor(np.asarray(x, np.float32), device=device)
                                      for x in (self.sun_color, [1.0, 0.8, 0.6], [0.6, 0.8, 1.0]))
        return self._dev[device]

    def color(self, wo):
        sun, warm, cool = self._on(wo.device)
        t = wo[..., 1:2] / 2 + 0.7
        return sun * torch.square(warm + (cool - warm) * t)

    def pdf(self, wo):
        return torch.full(wo.shape[:-1], 1.0 / (4 * Pi), device=wo.device)

    def sample(self, p, u2, u1):
        wo = uniform_sphere(u2)
        n, dev = p.shape[0], p.device
        return dict(le=self.color(wo), wo=wo, distance=torch.full((n,), FLOAT_MAX, device=dev),
                    pdf=torch.full((n,), 1.0 / (4 * Pi), device=dev),
                    valid=torch.ones(n, dtype=torch.bool, device=dev))
