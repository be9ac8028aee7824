"""Perlin-style gradient noise and fbm, batched.  Counterpart of
pine_tpu/core/noise.py (parity: core/noise.cpp).

The gradient of a lattice corner comes from the port's stateless PCG hash of
the corner and a seed (core/rng.py), as pine_tpu's does, so the values are
pine_tpu's up to the rounding of fused multiply-adds.  pine_tpu evaluates
its corners, octaves and seeds one after another; here each is an axis of one
batch (a 3-D noise of one fbm octave sum is one evaluation over 8 octaves x
8 corners), and only the sums over them run one term at a time, in
pine_tpu's order.  The elementwise work is the same; the number of kernel
launches on the card falls about 64-fold.
"""
from __future__ import annotations

import torch

from pine_tpu_torch.core.rng import hash_combine, pcg_hash, u32_to_uniform
from pine_tpu_torch.core.sampling import sample_disk_concentric
from pine_tpu_torch.core.vecmath import Pi, dot

MAX_OCTAVES = 8


def _corners(dims, dtype, device):
    """The 2^dims corner offsets (2^dims, dims), the last axis fastest (the
    nesting of pine_tpu's corner loops)."""
    k = torch.arange(2**dims, device=device)
    return torch.stack([(k >> (dims - 1 - a)) & 1 for a in range(dims)], -1).to(dtype)


def _corner_u2(ix, iy, iz, seed):
    h = hash_combine(ix.to(torch.int32), iy.to(torch.int32), iz.to(torch.int32), seed)
    return u32_to_uniform(h), u32_to_uniform(pcg_hash(h))


def _seed(seed, p):
    """A seed as a tensor that broadcasts against the lanes of ``p`` (..., k)
    with a corner axis: an int, or a tensor broadcasting against p[..., 0]."""
    if isinstance(seed, torch.Tensor):
        return seed[..., None]
    return seed


def _corner_sum(terms):
    total = 0.0
    for k in range(terms.shape[-1]):  # pine_tpu's order over the corners
        total = total + terms[..., k]
    return 0.5 * (1.0 + total)


def _weights(w, c):
    """The corner weights: w along an axis where the corner's offset is 1,
    1 - w where it is 0, multiplied in axis order."""
    sel = torch.where(c.bool(), w[..., None, :], 1.0 - w[..., None, :])
    out = sel[..., 0]
    for a in range(1, sel.shape[-1]):
        out = out * sel[..., a]
    return out


def perlin_noise3(p, seed=0):
    """3-D gradient noise in [0, 1] (noise.cpp:29-41) over p (..., 3)."""
    pf = torch.floor(p)
    w = p - pf
    w = w * w * (3.0 - 2.0 * w)
    c = _corners(3, p.dtype, p.device)
    corner = pf[..., None, :] + c  # (..., 8, 3)
    u0, u1 = _corner_u2(corner[..., 0], corner[..., 1], corner[..., 2], _seed(seed, p))
    phi = u0 * 2 * Pi
    theta = u1 * Pi
    g = torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                     torch.cos(theta)], -1)
    d = p[..., None, :] - corner
    return _corner_sum(_weights(w, c) * dot(g, d))


def perlin_noise2(p, seed=0):
    """2-D gradient noise in [0, 1] (noise.cpp:17-28) over p (..., 2)."""
    pf = torch.floor(p)
    w = p - pf
    w = w * w * (3.0 - 2.0 * w)
    c = _corners(2, p.dtype, p.device)
    corner = pf[..., None, :] + c  # (..., 4, 2)
    u0, u1 = _corner_u2(corner[..., 0], corner[..., 1], torch.zeros_like(corner[..., 0]),
                        _seed(seed, p))
    g = sample_disk_concentric(torch.stack([u0, u1], -1))
    d = p[..., None, :] - corner
    return _corner_sum(_weights(w, c) * (g * d).sum(-1))


def perlin_noise1(x, seed=0):
    """1-D value noise in [0, 1] over x (...)."""
    xf = torch.floor(x)
    w = x - xf
    w = w * w * (3.0 - 2.0 * w)
    zeros = torch.zeros_like(xf).to(torch.int32)
    n0 = u32_to_uniform(hash_combine(xf.to(torch.int32), zeros, seed))
    n1 = u32_to_uniform(hash_combine((xf + 1).to(torch.int32), zeros, seed))
    return 0.5 * (1.0 + (n0 + (n1 - n0) * w))


def perlin_any(p, seed=0):
    """Noise of the dimension of p's last axis: 3-D for (..., 3), 2-D for
    (..., 2), else 1-D of every element."""
    p = torch.as_tensor(p, dtype=torch.float32)
    if p.ndim > 0 and p.shape[-1] == 3:
        return perlin_noise3(p, seed)
    if p.ndim > 0 and p.shape[-1] == 2:
        return perlin_noise2(p, seed)
    return perlin_noise1(p, seed)


def fbm_seeded(p, octaves, seeds=(0,), max_octaves=MAX_OCTAVES):
    """Octave sums for each of ``seeds`` -> (len(seeds), ...): the squared
    normalised accumulation of noise.cpp:66-78, octaves past ``octaves``
    (a number or a per-lane tensor) masked, as pine_tpu's fbm."""
    p = torch.as_tensor(p, dtype=torch.float32)
    octaves = torch.as_tensor(octaves, device=p.device)
    scale = 2.0 ** torch.arange(max_octaves, dtype=torch.float32, device=p.device)
    pp = p[None, None] * scale.reshape((1, max_octaves) + (1,) * p.ndim)  # doubled, exactly
    lanes = p.shape[:-1] if p.ndim > 0 and p.shape[-1] in (2, 3) else p.shape
    seed = torch.as_tensor(seeds, dtype=torch.int64, device=p.device)
    noise = perlin_any(pp, seed.reshape((len(seeds),) + (1,) * (1 + len(lanes))))
    accum, weight, final_weight = 0.0, 1.0, torch.ones((), device=p.device)
    for i in range(max_octaves):
        active = i < octaves
        accum = accum + torch.where(active, weight * noise[:, i], 0.0)
        final_weight = torch.where(active, weight * 0.5, final_weight)
        weight = weight * 0.5
    return torch.square(accum / (2.0 - final_weight * 2.0))


def fbm(p, octaves, max_octaves=MAX_OCTAVES):
    return fbm_seeded(p, octaves, (0,), max_octaves)[0]


def fbm2d(p, octaves, max_octaves=MAX_OCTAVES):
    return torch.movedim(fbm_seeded(p, octaves, (0, 1), max_octaves), 0, -1)


def fbm3d(p, octaves, max_octaves=MAX_OCTAVES):
    return torch.movedim(fbm_seeded(p, octaves, (0, 1, 2), max_octaves), 0, -1)
