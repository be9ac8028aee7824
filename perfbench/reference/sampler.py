"""Blue-noise dithered Sobol values (Heitz and Belcour 2019), read from the
benchmark's own copy of the 16-spp tables (``bluesobol_16spp.npz``: the
Sobol sequence, the ranking tile and the scrambling tile, 128 x 128
pixels, 8 dimensions a pixel):

    ranked = index ^ ranking[(dim + (i + j*128)*8) % (128*128*8)]
    value  = sobol[dim + ranked*256] ^ scrambling[dim%8 + (i + j*128)*8]
    u      = (0.5 + value) / 256
"""
from __future__ import annotations

import os

import numpy as np
import torch

TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bluesobol_16spp.npz")


class BlueNoise:
    """u1(px, py, sample, dim) -> (N,) float32 on the pixels' device."""

    spp = 16

    def __init__(self, device):
        with np.load(TABLES) as d:
            self.sobol, self.rank, self.scram = (
                torch.as_tensor(d[k].astype(np.int64), device=device)
                for k in ("sobol", "ranking", "scrambling"))

    def u1(self, px, py, sample, dim):
        d = int(dim) & 255
        pix8 = ((px & 127) + (py & 127) * 128) * 8
        ranked = (int(sample) & 255) ^ self.rank[(d + pix8) % (128 * 128 * 8)]
        value = self.sobol[d + ranked * 256] ^ self.scram[(d % 8) + pix8]
        return (0.5 + value.to(torch.float32)) / 256.0

    def u2(self, px, py, sample, dim):
        return torch.stack([self.u1(px, py, sample, dim), self.u1(px, py, sample, dim + 1)], -1)
