"""Monte-Carlo sampling helpers, batched.  Counterpart of pine_tpu/core/sampling.py."""
from __future__ import annotations

import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core.vecmath import Pi


def sample_disk_polar(u):
    r = fm.sqrt(u[..., 0])
    theta = 2 * Pi * u[..., 1]
    return torch.stack([r * fm.cos(theta), r * fm.sin(theta)], -1)


def sample_disk_concentric(u):
    """Concentric disk mapping, branch-free."""
    ux = u[..., 0] * 2.0 - 1.0
    uy = u[..., 1] * 2.0 - 1.0
    use_x = ux.abs() > uy.abs()

    def safe(a, b):  # avoid 0/0 at the origin, where r is 0 anyway
        return a / torch.where(b == 0.0, 1.0, b)

    r = torch.where(use_x, ux, uy)
    theta = torch.where(
        use_x, (Pi / 4.0) * safe(uy, ux), Pi / 2.0 - (Pi / 4.0) * safe(ux, uy)
    )
    return torch.stack([r * fm.cos(theta), r * fm.sin(theta)], -1)


def cosine_weighted_hemisphere(u):
    d = sample_disk_concentric(u)
    z = fm.sqrt(torch.clamp_min(1.0 - d[..., 0] * d[..., 0] - d[..., 1] * d[..., 1], 0.0))
    return torch.cat([d, z[..., None]], -1)


def uniform_hemisphere(u):
    phi = u[..., 0] * Pi * 2
    cos_theta = u[..., 1]
    sin_theta = fm.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return torch.stack(
        [sin_theta * fm.cos(phi), sin_theta * fm.sin(phi), cos_theta], -1
    )


def uniform_sphere(u):
    phi = u[..., 0] * Pi * 2
    cos_theta = 1.0 - 2.0 * u[..., 1]
    sin_theta = fm.sqrt(torch.clamp_min(1.0 - cos_theta**2, 0.0))
    return torch.stack(
        [sin_theta * fm.cos(phi), sin_theta * fm.sin(phi), cos_theta], -1
    )


def balance_heuristic(pf, pg):
    """One-sample MIS balance heuristic."""
    return pf / torch.clamp_min(pf + pg, 1e-20)
