"""ThinLenCamera.  Counterpart of pine_tpu/core/camera.py.

p_film in [0,1]^2 maps to camera space as ``(p_film - 0.5) * 2 * fov2d`` with
fov2d = (fov * aspect, fov); thin-lens depth of field samples the lens disk
when len_radius > 0.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import profiler
from pine_tpu_torch.core.sampling import sample_disk_polar
from pine_tpu_torch.core.vecmath import look_at, safe_normalize


class ThinLenCamera:
    def __init__(self, film, from_p, to_p, fov, len_radius=0.0, focus_distance=1.0):
        self.film = film
        self.position = np.asarray(from_p, np.float32)
        self.c2w = look_at(from_p, to_p)
        self.fov = float(fov)
        self.fov2d = np.array([fov * film.aspect(), fov], np.float32)
        self.len_radius = float(len_radius)
        self.focus_distance = float(focus_distance)

    def params(self, device):
        return dict(
            position=profiler.to_device(self.position, device, "camera.params"),
            rot=profiler.to_device(self.c2w[:3, :3].copy(), device, "camera.params"),
            fov2d=profiler.to_device(self.fov2d, device, "camera.params"),
            len_radius=self.len_radius,
            focus_distance=self.focus_distance,
        )


def _rotate(v, rot):
    """v @ rot.T written out per column, so CPU and GPU sum in one order."""
    return v[..., 0:1] * rot[:, 0] + v[..., 1:2] * rot[:, 1] + v[..., 2:3] * rot[:, 2]


def gen_rays(cp, p_film, u_lens):
    """p_film (N,2) in [0,1]^2, u_lens (N,2) -> (origin, direction)."""
    pc = (p_film - 0.5) * 2.0 * cp["fov2d"]
    d_cam = torch.cat([pc, torch.ones_like(pc[..., :1])], -1)
    rot = cp["rot"]
    if cp["len_radius"] == 0.0:
        d = safe_normalize(_rotate(d_cam, rot))
        return cp["position"].expand(d.shape), d
    d_cam = safe_normalize(d_cam)
    p_focus = cp["focus_distance"] * d_cam / d_cam[..., 2:3]
    disk = cp["len_radius"] * sample_disk_polar(u_lens)
    p_len = torch.cat([disk, torch.zeros_like(disk[..., :1])], -1)
    d = _rotate(safe_normalize(p_focus - p_len), rot)
    o = cp["position"] + _rotate(p_len, rot)
    return o, safe_normalize(d)
