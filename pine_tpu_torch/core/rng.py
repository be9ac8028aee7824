"""Counter-based (stateless) random hashing for wavefront rendering.

Counterpart of pine_tpu/core/rng.py: every lane derives its randomness from
``hash(pixel, sample_index, dimension)``.  The PCG arithmetic is uint32 in
the reference; ``torch.uint32`` lacks multiply and shift on many builds, so
the hash runs in int64 and masks to 32 bits after every multiply, add and
left shift.  Values are bit-equal to pine_tpu's.

``RNG`` is the sequential host generator of PRL scripts (``RNG``, ``srand``,
``randf``...), numpy's PCG64 as in pine_tpu.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _as_u32(x, like=None):
    """Integers (tensor or Python int) as int64 holding a uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64,
                        device=None if like is None else like.device)


def pcg_hash(x):
    """PCG output function on uint32 values held in int64."""
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def hash_combine(*xs):
    """Mix any number of uint32 streams into one."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    h = _as_u32(xs[0], like)
    for x in xs[1:]:
        mix = (_as_u32(x, like) + 0x9E3779B9 + ((h << 6) & _M32) + (h >> 2)) & _M32
        h = pcg_hash(h ^ mix)
    return pcg_hash(h)


def u32_to_uniform(bits):
    """uint32 -> float32 in [0,1) with 24-bit mantissa precision."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(*keys):
    return u32_to_uniform(hash_combine(*keys))


class RNG:
    """Sequential RNG for host-side PRL scripts (PRL ``RNG``); not used on the
    device path."""

    def __init__(self, seed: int = 0):
        self._g = np.random.Generator(np.random.PCG64(seed))

    def seed(self, s: int):
        self._g = np.random.Generator(np.random.PCG64(s))

    def uniformf(self):
        return np.float32(self._g.random())

    def uniform2f(self):
        return self._g.random(2).astype(np.float32)

    def uniform3f(self):
        return self._g.random(3).astype(np.float32)
