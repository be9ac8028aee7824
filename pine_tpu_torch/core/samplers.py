"""Stateless wavefront samplers.  Counterpart of pine_tpu/core/samplers.py.

Every sampler exposes

    u1(px, py, sample_index, dim) -> (N,) float32 in [0,1)
    u2(px, py, sample_index, dim) -> (N,2)   (consumes dims dim, dim+1)

with px/py (N,) int32 pixel coordinates on the wavefront's device, an integer
sample index and a static integer dim.  Values are bit-equal to pine_tpu's.

- UniformSampler: the PCG hash of (pixel, sample, dim).
- HaltonSampler: the scrambled radical inverse of a per-pixel stream offset
  (sampler.h:41-81): dims 0 and 1 the in-pixel jitter in bases 2 and 3,
  dims >= 2 digit-permuted by tables shuffled in numpy from a fixed seed.
- SobolSampler: the global Sobol' sequence (assets/sobol_matrices.npy) with a
  per-(pixel, dim) Owen scramble.
- BlueSampler: the Heitz-Belcour blue-noise dithered Sobol tables
  (assets/bluesobol_<spp>spp.npz), read as a plain gather:

      ranked = index ^ rankingTile[(dim + (i + j*128)*8) % (128*128*8)]
      value  = sobol[dim + ranked*256] ^ scramblingTile[dim%8 + (i+j*128)*8]
      u      = (0.5 + value) / 256
"""
from __future__ import annotations

import os

import numpy as np
import torch

from pine_tpu_torch.core import profiler
from pine_tpu_torch.core import rng

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
_M32 = 0xFFFFFFFF
SOBOL_DIMS = 64
SOBOL_BITS = 32


class _Sampler:
    def u2(self, px, py, sample_index, dim):
        return torch.stack(
            [self.u1(px, py, sample_index, dim), self.u1(px, py, sample_index, dim + 1)], -1
        )


class UniformSampler(_Sampler):
    """Per-(pixel, sample, dim) PCG hash."""

    name = "uniform"

    def __init__(self, spp, seed=0):
        self.spp = int(spp)
        self.seed = int(seed)

    def u1(self, px, py, sample_index, dim):
        return rng.uniform(px, py, int(sample_index), int(dim) + self.seed)


# the first 64 primes: the Halton bases
_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83,
           89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151, 157, 163, 167, 173, 179,
           181, 191, 193, 197, 199, 211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271,
           277, 281, 283, 293, 307, 311)
_ONE_MINUS = 1.0 - 1e-7  # the largest value a sampler returns, as float32


class HaltonSampler(_Sampler):
    """Halton sequence with digit-permutation scrambling.  The pixel picks a
    stream offset by the inverse radical inverse of its coordinates in bases
    2 and 3 over a 128 x 243 tile (sampler.cpp:49-79); dims 0 and 1 give the
    in-pixel jitter; dims >= 2 cycle through the bases from 5 up, each digit
    mapped through its base's permutation.  The permutations are numpy
    shuffles from ``default_rng(0x9E3779B9 ^ (seed * 0x85EBCA6B + 1))``, one
    per prime in order, as pine_tpu's.  Integer work is int64 holding uint32
    values (no value reaches 2^32); float32 products run in pine_tpu's order."""

    name = "halton"
    MAX_RES = 128

    def __init__(self, spp, seed=0):
        self.spp = int(spp)
        self.seed = int(seed)
        r = np.random.default_rng(0x9E3779B9 ^ (seed * 0x85EBCA6B + 1))
        flat, offs, o = [], [], 0
        for p in _PRIMES:
            offs.append(o)
            perm = np.arange(p, dtype=np.int32)
            r.shuffle(perm)
            flat.append(perm)
            o += p
        self._offsets = offs
        self._perm_host = np.concatenate(flat)
        self._perm = {}  # device -> the permutation table
        self._mult_inv = (pow(128, -1, 243), pow(243, -1, 128))
        self._stride = 128 * 243

    def _index(self, px, py, sample_index):
        """The lane's stream index (start_pixel, sampler.cpp:66-79)."""
        pmx, pmy = px.to(torch.int64) % self.MAX_RES, py.to(torch.int64) % self.MAX_RES
        invx = torch.zeros_like(pmx)
        for _ in range(7):  # reversed base-2 digits of x mod 128
            invx = invx * 2 + pmx % 2
            pmx = pmx // 2
        invy = torch.zeros_like(pmy)
        for _ in range(5):  # reversed base-3 digits of y mod 243
            invy = invy * 3 + pmy % 3
            pmy = pmy // 3
        idx = (invx * (243 * self._mult_inv[1]) + invy * (128 * self._mult_inv[0])) % self._stride
        return (idx + (int(sample_index) & _M32) * self._stride) & _M32

    def u1(self, px, py, sample_index, dim):
        idx = self._index(px, py, sample_index)
        if dim < 2:
            v = _radical_inverse(idx, (2, 3)[dim]) * (128, 243)[dim]
            return torch.clamp_max(v - torch.floor(v), _ONE_MINUS)
        d = 2 + (dim - 2) % (len(_PRIMES) - 2)
        b, off = _PRIMES[d], self._offsets[d]
        dev = px.device
        if dev not in self._perm:
            self._perm[dev] = profiler.to_device(self._perm_host.astype(np.int64), dev,
                                                 "sampler.tables")
        perm = self._perm[dev]
        inv_base = np.float32(1.0 / b)
        reversed_d = torch.zeros_like(idx)
        inv_base_n = torch.ones(px.shape, device=dev)
        a = idx
        for _ in range(max(2, int(np.ceil(24 / np.log2(b))))):
            active = a > 0
            reversed_d = torch.where(active, reversed_d * b + perm[off + a % b], reversed_d)
            inv_base_n = torch.where(active, inv_base_n * inv_base, inv_base_n)
            a = a // b
        series = np.float32(self._perm_host[off]) / np.float32(b + 1.0)
        val = (reversed_d.to(torch.float32) + float(series)) * inv_base_n
        return torch.clamp_max(val, _ONE_MINUS)


def _radical_inverse(a, base, n_digits=24):
    """Plain radical inverse (lowdiscrepancy.h:11-24) of int64 ``a``."""
    inv = np.float32(1.0 / base)
    reversed_d = torch.zeros_like(a)
    inv_n = torch.ones(a.shape, device=a.device)
    for _ in range(max(2, int(np.ceil(n_digits / np.log2(base))))):
        active = a > 0
        reversed_d = torch.where(active, reversed_d * base + a % base, reversed_d)
        inv_n = torch.where(active, inv_n * inv, inv_n)
        a = a // base
    return torch.clamp_max(reversed_d.to(torch.float32) * inv_n, _ONE_MINUS)


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 ``x`` holding a uint32 and a 32-bit constant
    ``c``, in two 16-bit halves of ``c`` so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _reverse_bits32(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _M32) | (x >> 16)


def owen_scramble(bits, seed):
    """FastOwen scrambling (sampler.h SobolSampler): the Laine-Karras hash in
    reversed-bit space, on uint32 values held in int64."""
    x = (_reverse_bits32(bits) + seed) & _M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return _reverse_bits32(x)


class SobolSampler(_Sampler):
    """Owen-scrambled Sobol' (sampler.h:83-164): the global sequence indexed
    by the sample, decorrelated per (pixel, dim) by the scramble's seed.  The
    sample index is the same on every lane, so its raw Sobol' bits are formed
    once on the host."""

    name = "sobol"

    def __init__(self, spp, seed=0):
        self.spp = int(spp)
        self.seed = int(seed)
        self._mats = np.load(os.path.join(_ASSET_DIR, "sobol_matrices.npy"))  # (D, 32) uint32

    def _sobol_bits(self, index, dim):
        v = self._mats[dim % SOBOL_DIMS]
        bits = 0
        for j in range(SOBOL_BITS):
            if (index >> j) & 1:
                bits ^= int(v[j])
        return bits

    def u1(self, px, py, sample_index, dim):
        pix_seed = rng.hash_combine(px, py, self.seed, dim)
        bits = self._sobol_bits(int(sample_index) & _M32, dim)
        return rng.u32_to_uniform(owen_scramble(torch.full_like(pix_seed, bits), pix_seed))


def _roundup2(x):
    n = 1
    while n < x:
        n *= 2
    return n


class BlueSampler(_Sampler):
    """Blue-noise dithered Sobol from the exact Heitz-Belcour tables."""

    name = "blue"
    # the tables' layout (csrc/ao_dirs.cu draws from it too): 256 dims of
    # 256 samples, and a tile of 128x128 pixels x 8 dims for the ranking and
    # the scrambling
    TILE = 128 * 128 * 8
    TABLE_SIZES = (("sobol", 256 * 256), ("ranking", TILE), ("scrambling", TILE))

    def __init__(self, spp, seed=0):
        self.spp = int(spp)
        self.seed = int(seed)
        spp2 = min(_roundup2(self.spp), 256)
        path = os.path.join(_ASSET_DIR, f"bluesobol_{spp2}spp.npz")
        with np.load(path) as d:
            self._host = {k: torch.from_numpy(d[k].astype(np.int32)) for k, _ in self.TABLE_SIZES}
        for k, size in self.TABLE_SIZES:
            if self._host[k].shape != (size,):
                raise ValueError(f"{path}: {k} has shape {tuple(self._host[k].shape)}, "
                                 f"want ({size},)")
        self._tables = {}  # device -> (sobol, ranking, scrambling)

    def tables(self, device):
        """(sobol, ranking, scrambling) as int32 on ``device``, uploaded once;
        their sizes in that order are ``TABLE_SIZES``."""
        if device not in self._tables:
            self._tables[device] = tuple(
                profiler.to_device(self._host[k], device, "sampler.tables")
                for k, _ in self.TABLE_SIZES
            )
        return self._tables[device]

    def u1(self, px, py, sample_index, dim):
        sobol, rank, scram = self.tables(px.device)
        d = int(dim) & 255
        pix8 = ((px & 127) + (py & 127) * 128) * 8
        ranked = (int(sample_index) & 255) ^ rank[(d + pix8) % self.TILE]
        value = sobol[d + ranked * 256] ^ scram[(d % 8) + pix8]
        return (0.5 + value.to(torch.float32)) / 256.0


SAMPLERS = {"uniform": UniformSampler, "halton": HaltonSampler, "sobol": SobolSampler,
            "blue": BlueSampler}
