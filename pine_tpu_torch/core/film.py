"""Film: the radiance frame plus tone mapping.  Counterpart of pine_tpu/core/film.py.

The frame stays a tensor on its device until someone reads ``pixels`` or
saves it; ``y`` grows upward and the PNG write flips vertically.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import color as color_mod
from pine_tpu_torch.core import profiler
from pine_tpu_torch.io.image_io import save_image


class Film:
    def __init__(self, size, tone_mapper: str = "uncharted2"):
        # size is (width, height), as in PRL `Film([w, h])`
        self.width = int(size[0])
        self.height = int(size[1])
        self.tone_mapper = tone_mapper
        self.rgb = torch.zeros(self.height, self.width, 3)

    @property
    def size(self):
        return (self.width, self.height)

    def aspect(self):
        return self.width / self.height

    def set_rgb(self, rgb):
        """Store a full (H,W,3) radiance frame (tensor, kept on its device)."""
        rgb = torch.as_tensor(rgb, dtype=torch.float32)
        if tuple(rgb.shape) != (self.height, self.width, 3):
            raise ValueError(f"frame shape {tuple(rgb.shape)} != {(self.height, self.width, 3)}")
        self.rgb = rgb

    @property
    def pixels(self):
        """(H,W,4) float32 numpy with alpha 1."""
        out = np.ones((self.height, self.width, 4), np.float32)
        with profiler.span("film.readback"):
            with profiler.sync("readback"):
                rgb = self.rgb.detach().cpu()
            out[..., :3] = rgb.numpy()
        return out

    def finalized(self, scale=1.0):
        """Tone-mapped (H,W,3) numpy in [0,1]."""
        with profiler.span("film.readback"):
            mapped = color_mod.TONE_MAPPERS[self.tone_mapper](self.rgb * scale)
            with profiler.sync("readback"):
                mapped = mapped.detach().cpu()
            return mapped.numpy()

    def save(self, path, scale=1.0):
        save_image(path, self.finalized(scale), invert_y=True, encode_srgb=True)
