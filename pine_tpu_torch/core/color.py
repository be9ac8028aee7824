"""Tone mapping.  Counterpart of pine_tpu/core/color.py."""
from __future__ import annotations

import torch

from pine_tpu_torch.core import profiler


def uncharted2_filmic(v):
    """Uncharted2 filmic curve, batched over (..., 3)."""
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

    def mapping(x):
        return (x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F) - E / F

    white = mapping(profiler.to_device(11.2, v.device, "tonemap.white", torch.float32))
    return mapping(v * 2.0) / white


def aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    r = (x * (a * x + b)) / (x * (c * x + d) + e)
    return r.clamp(0.0, 1.0)


TONE_MAPPERS = {"uncharted2": uncharted2_filmic, "aces": aces, "none": lambda x: x}
