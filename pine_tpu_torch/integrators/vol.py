"""Single-scatter homogeneous-volume test integrator.  Counterpart of
pine_tpu/integrators/vol.py (parity: impl/integrator/vol.cpp:14-35).

An analytic check with no scene geometry: a point source at LP inside an
infinite medium of sigma_s = 1, sigma_a = 0; each pixel's camera ray (at the
pixel's centre, the lens's centre) takes the closed-form single-scatter
integral with the exponential-integral approximation E1 (vol.cpp:16-21),
evaluated as pine_tpu evaluates it.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core.vecmath import dot

LP = np.array([0.0, 1.0, 4.0], np.float32)  # vol.cpp:13
SIGMA_S = 1.0
SIGMA_A = 0.0
SIGMA_T = SIGMA_S + SIGMA_A


def _E1(x):
    """Swamee-Ohija-style E1 approximation (vol.cpp:16-21); x > 0."""
    x = torch.clamp_min(x, 1e-6)
    A = torch.log((0.56146 / x + 0.65) * (1.0 + x))
    B = x**4 * torch.exp(7.7 * x) * (2.0 + x) ** 3.7
    return (A ** -7.7 + B) ** -0.13


def vol_radiance(ro, rd):
    """Closed-form single scatter toward the point source (vol.cpp:23-35),
    on |t| with the positive orientation of the difference quotient, as
    pine_tpu takes it."""
    v = torch.as_tensor(LP, device=ro.device) - ro
    b = -2.0 * dot(v, rd)
    c = dot(v, v)
    delta = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp_min(-delta, 1e-12))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    I = ((torch.exp(-SIGMA_T * t0) * _E1(torch.clamp_min(SIGMA_S * t0.abs(), 1e-6))  # noqa: E741
          - torch.exp(-SIGMA_T * t1) * _E1(torch.clamp_min(SIGMA_T * t1.abs(), 1e-6)))
         / torch.clamp_min(t1 - t0, 1e-6))
    out = (SIGMA_S / SIGMA_T) * I
    return torch.clamp_min(out, 0.0)[:, None].expand(-1, 3)


class VolIntegrator:
    """VolIntegrator(sampler) (program_context.cpp:64-67); the sampler is
    not read."""

    def __init__(self, sampler):
        self.sampler = sampler

    def render(self, scene, device=None):
        """Render into the scene's camera's film on ``device`` (default: the card)."""
        from pine_tpu_torch.core.place import resolve_device

        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        dev = resolve_device(device)
        film = cam.film
        W, H = film.width, film.height
        idx = torch.arange(W * H, dtype=torch.int64, device=dev)
        pix = torch.stack([idx % W, idx // W], -1).to(torch.float32)
        pf = (pix + 0.5) / torch.tensor([W, H], dtype=torch.float32, device=dev)
        ro, rd = camera_mod.gen_rays(cam.params(dev), pf, torch.full((W * H, 2), 0.5, device=dev))
        film.set_rgb(vol_radiance(ro, rd).reshape(H, W, 3))
        return film
