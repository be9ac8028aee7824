"""Environment lights with 2-D importance sampling: the Atmosphere and
ImageSky.  Counterpart of pine_tpu/scene/env_lights.py (parity:
src/pine/core/light.cpp:94-171); the gradient ``Sky`` is in scene/lights.py.

Directions map through ``uniform_sphere(sc)`` with y and z swapped, as the
reference's do (light.cpp:100-115), so a density over the unit square is a
solid-angle density divided by 4 pi.

``Distribution2D`` samples a density image by a marginal CDF over its rows
and a conditional CDF within each row.  pine_tpu picks the column by
gathering the whole CDF row of every lane and counting the entries below u;
at 409,600 lanes and a 1,024-wide map that gather is about 1.7 GB a call.
Here one ``torch.searchsorted`` runs over the rows laid end to end, each
row's entries offset by the row's index in float64 (exact for float32 CDF
values and fewer than 2^29 rows), so a lane's search stays in its row: the
first entry >= u, which on a nondecreasing row is the count of entries
< u, the same column bit for bit.

The Atmosphere's radiance map (its 1,024^2 importance density) is built on
the host in numpy (``atmosphere_color_np``, pine_tpu's code) once per
light; its color and samples evaluate the single-scatter sky per lane in
PyTorch on the scene's device (``atmosphere_color``).
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core.sampling import uniform_sphere
from pine_tpu_torch.core.vecmath import Pi, phi2pi, rotate_x, rotate_y
from pine_tpu_torch.scene.lights import FLOAT_MAX, EnvironmentLight


class Distribution2D:
    """A sampleable discrete 2-D density (distribution.h:40-62): ``pdf_img``
    the density over the unit square, ``cdf_marg`` (h,) over the rows,
    ``cdf_cond`` (h, w) within each row, all float32 host arrays built as
    pine_tpu's (``of_density``)."""

    def __init__(self, pdf_img, cdf_marg, cdf_cond):
        self.pdf_img = np.array(pdf_img, np.float32)
        self.cdf_marg = np.array(cdf_marg, np.float32)
        self.cdf_cond = np.array(cdf_cond, np.float32)
        self.h, self.w = self.cdf_cond.shape
        self._dev = {}

    @classmethod
    def of_density(cls, density):
        d = np.maximum(np.asarray(density, np.float64), 0.0)
        h, w = d.shape
        total = d.sum()
        if total <= 0:
            d = np.ones_like(d)
            total = d.sum()
        cond = np.cumsum(d, axis=1)
        cond = cond / np.maximum(cond[:, -1:], 1e-30)
        return cls((d / total * (h * w)).astype(np.float32),
                   (np.cumsum(d.sum(axis=1)) / total).astype(np.float32),
                   cond.astype(np.float32))

    def _on(self, device):
        if device not in self._dev:
            rows = np.arange(self.h, dtype=np.float64)[:, None]
            self._dev[device] = (
                torch.as_tensor(self.pdf_img, device=device),
                torch.as_tensor(self.cdf_marg, device=device),
                torch.as_tensor((self.cdf_cond.astype(np.float64) + rows).ravel(), device=device))
        return self._dev[device]

    def sample(self, u2):
        """u2 (N,2) -> (sc (N,2) in [0,1]^2, pdf (N,) over the unit square)."""
        pdf_img, cdf_marg, flat = self._on(u2.device)
        row = torch.searchsorted(cdf_marg, u2[:, 0].contiguous(), right=True).clamp(0, self.h - 1)
        key = row.to(torch.float64) + u2[:, 1].to(torch.float64)
        col = (torch.searchsorted(flat, key) - row * self.w).clamp(0, self.w - 1)
        sc = torch.stack([(col.to(torch.float32) + 0.5) / self.w,
                          (row.to(torch.float32) + 0.5) / self.h], -1)
        return sc, pdf_img[row, col]

    def pdf(self, sc):
        """sc (N,2) in [0,1]^2 -> the density over the unit square."""
        pdf_img = self._on(sc.device)[0]
        col = (sc[..., 0] * self.w).to(torch.int32).clamp(0, self.w - 1).long()
        row = (sc[..., 1] * self.h).to(torch.int32).clamp(0, self.h - 1).long()
        return pdf_img[row, col]


def _swap_yz(v):
    return torch.stack([v[..., 0], v[..., 2], v[..., 1]], -1)


def _sc_of_dir(wo):
    """The inverse of wo = swap_yz(uniform_sphere(sc))."""
    d = _swap_yz(wo)
    return torch.stack([phi2pi(d[..., 0], d[..., 1]) / (2 * Pi), (1.0 - d[..., 2]) / 2.0], -1)


ATMOSPHERE_RADIUS, PLANET_RADIUS = 6420e3, 6360e3
BETA_R = (3.8e-6, 13.5e-6, 33.1e-6)
BETA_M = (21e-6, 21e-6, 21e-6)
HR, HM = 1.0 / 7995.0, 1.0 / 1200.0
MIE_G = 0.76
SUN_DISK_TINT = (1.0, 0.9, 0.8)


def atmosphere_color_np(direction, sun_dir, n_samples=8, simulate_real_sun=False):
    """Single-scatter Rayleigh and Mie sky (color.cpp:41-104) of directions
    (..., 3), in numpy: pine_tpu's host-side form, which builds the
    Atmosphere's importance map, operation for operation.  Like pine_tpu's,
    the sun-ward march uses the height, where the reference squares the
    distance (color.cpp:76)."""
    xp = np
    beta_r = xp.asarray(BETA_R)
    beta_m = xp.asarray(BETA_M)
    atmosphere_radius, planet_radius = ATMOSPHERE_RADIUS, PLANET_RADIUS
    Hr, Hm = HR, HM
    n_light = n_samples // 2
    sun = xp.asarray(sun_dir, xp.float32)
    sun = sun / xp.linalg.norm(sun)

    mu = xp.sum(direction * sun, -1)
    phase_r = 3.0 / (16.0 * Pi) * (1.0 + mu * mu)
    g = MIE_G
    phase_m = (
        3.0
        / (8.0 * Pi)
        * (1.0 - g * g)
        * (1.0 + mu * mu)
        / ((2.0 + g * g) * xp.power(xp.maximum(1.0 + g * g - 2.0 * g * mu, 1e-6), 1.5))
    )

    o = xp.asarray([0.0, planet_radius, 0.0])
    b = xp.sum(xp.broadcast_to(o, direction.shape) * direction, -1)
    c = float(np.dot([0, planet_radius, 0], [0, planet_radius, 0])) - atmosphere_radius**2
    tmax = -b + xp.sqrt(xp.maximum(b * b - c, 0.0))
    seg = tmax / n_samples

    sum_r = xp.zeros(direction.shape[:-1] + (3,))
    sum_m = xp.zeros(direction.shape[:-1] + (3,))
    od_r = xp.zeros(direction.shape[:-1])
    od_m = xp.zeros(direction.shape[:-1])
    dead = xp.zeros(direction.shape[:-1], bool)
    t_cur = xp.zeros(direction.shape[:-1])

    for i in range(n_samples):
        sp = o + (t_cur + seg * 0.5)[..., None] * direction
        height = xp.linalg.norm(sp, axis=-1) - planet_radius
        dead = dead | (height <= 0)
        hr = xp.exp(xp.clip(-height * Hr, -60.0, 60.0)) * seg
        hm = xp.exp(xp.clip(-height * Hm, -60.0, 60.0)) * seg
        od_r = od_r + xp.where(dead, 0.0, hr)
        od_m = od_m + xp.where(dead, 0.0, hm)

        bl = xp.sum(sp * sun, -1)
        cl = xp.sum(sp * sp, -1) - atmosphere_radius**2
        lt_max = -bl + xp.sqrt(xp.maximum(bl * bl - cl, 0.0))
        seg_l = lt_max / max(n_light, 1)
        od_rl = xp.zeros_like(od_r)
        od_ml = xp.zeros_like(od_m)
        light_dead = xp.zeros_like(dead)
        lt = seg_l * 0.5
        for _ in range(n_light):
            lp = sp + lt[..., None] * sun
            hl = xp.linalg.norm(lp, axis=-1) - planet_radius
            light_dead = light_dead | (hl < 0)
            od_rl = od_rl + xp.where(
                light_dead, 0.0, xp.exp(xp.clip(-hl * Hr, -60.0, 60.0)) * seg_l
            )
            od_ml = od_ml + xp.where(
                light_dead, 0.0, xp.exp(xp.clip(-hl * Hm, -60.0, 60.0)) * seg_l
            )
            lt = lt + seg_l
        tau = beta_r * (od_r + od_rl)[..., None] + beta_m * (od_m + od_ml)[..., None]
        tr = xp.exp(-tau)
        ok = (~dead & ~light_dead)[..., None]
        sum_r = sum_r + xp.where(ok, tr * hr[..., None], 0.0)
        sum_m = sum_m + xp.where(ok, tr * hm[..., None], 0.0)
        t_cur = t_cur + seg

    color = sum_r * beta_r * phase_r[..., None] + sum_m * beta_m * phase_m[..., None]
    mult = xp.full(3, 5.0)
    if simulate_real_sun:
        sun_disk = (mu > 0.998)[..., None]
        color = color * xp.where(sun_disk, mult * 1000.0 * xp.asarray(SUN_DISK_TINT), mult)
    else:
        color = color * mult
    return color


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(v):
    return torch.sqrt(_dot(v, v))


def atmosphere_color(direction, sun, n_samples=8, simulate_real_sun=False):
    """``atmosphere_color_np`` in float32 PyTorch for directions (N,3) on
    their device; ``sun`` a unit (3,) tensor there.  pine_tpu evaluates it
    per lane at render time in float32 the same way.  Its dot products are
    summed in one written order (``_dot``), not by a reduction, whose order
    differs between the card and the CPU: the march's points lie 6.4e6 m
    from the planet's centre, where an ulp is 0.5 m, and a height that
    moves by one ulp moves exp(-h / 1200) by 4e-4."""
    dev = direction.device
    beta_r = torch.tensor(BETA_R, device=dev)
    beta_m = torch.tensor(BETA_M, device=dev)
    n_light = n_samples // 2
    mu = _dot(direction, sun)
    phase_r = 3.0 / (16.0 * Pi) * (1.0 + mu * mu)
    g = MIE_G
    phase_m = (3.0 / (8.0 * Pi) * (1.0 - g * g) * (1.0 + mu * mu)
               / ((2.0 + g * g) * torch.pow(torch.clamp_min(1.0 + g * g - 2.0 * g * mu, 1e-6),
                                            1.5)))
    o = torch.tensor([0.0, PLANET_RADIUS, 0.0], device=dev)
    b = _dot(o, direction)
    c = float(np.dot([0, PLANET_RADIUS, 0], [0, PLANET_RADIUS, 0])) - ATMOSPHERE_RADIUS**2
    seg = (-b + torch.sqrt(torch.clamp_min(b * b - c, 0.0))) / n_samples

    lanes = direction.shape[:-1]
    sum_r = torch.zeros(lanes + (3,), device=dev)
    sum_m = torch.zeros(lanes + (3,), device=dev)
    od_r = torch.zeros(lanes, device=dev)
    od_m = torch.zeros(lanes, device=dev)
    dead = torch.zeros(lanes, dtype=torch.bool, device=dev)
    t_cur = torch.zeros(lanes, device=dev)
    for _ in range(n_samples):
        sp = o + (t_cur + seg * 0.5)[..., None] * direction
        height = _norm(sp) - PLANET_RADIUS
        dead = dead | (height <= 0)
        hr = torch.exp(torch.clamp(-height * HR, -60.0, 60.0)) * seg
        hm = torch.exp(torch.clamp(-height * HM, -60.0, 60.0)) * seg
        od_r = od_r + torch.where(dead, 0.0, hr)
        od_m = od_m + torch.where(dead, 0.0, hm)

        bl = _dot(sp, sun)
        cl = _dot(sp, sp) - ATMOSPHERE_RADIUS**2
        seg_l = (-bl + torch.sqrt(torch.clamp_min(bl * bl - cl, 0.0))) / max(n_light, 1)
        od_rl = torch.zeros_like(od_r)
        od_ml = torch.zeros_like(od_m)
        light_dead = torch.zeros_like(dead)
        lt = seg_l * 0.5
        for _ in range(n_light):
            hl = _norm(sp + lt[..., None] * sun) - PLANET_RADIUS
            light_dead = light_dead | (hl < 0)
            od_rl = od_rl + torch.where(light_dead, 0.0,
                                        torch.exp(torch.clamp(-hl * HR, -60.0, 60.0)) * seg_l)
            od_ml = od_ml + torch.where(light_dead, 0.0,
                                        torch.exp(torch.clamp(-hl * HM, -60.0, 60.0)) * seg_l)
            lt = lt + seg_l
        tau = beta_r * (od_r + od_rl)[..., None] + beta_m * (od_m + od_ml)[..., None]
        tr = torch.exp(-tau)
        ok = (~dead & ~light_dead)[..., None]
        sum_r = sum_r + torch.where(ok, tr * hr[..., None], 0.0)
        sum_m = sum_m + torch.where(ok, tr * hm[..., None], 0.0)
        t_cur = t_cur + seg

    color = sum_r * beta_r * phase_r[..., None] + sum_m * beta_m * phase_m[..., None]
    if simulate_real_sun:
        sun_disk = (mu > 0.998)[..., None]
        return color * torch.where(sun_disk, torch.tensor(SUN_DISK_TINT, device=dev) * 5000.0,
                                   5.0)
    return color * 5.0


class _Tensors:
    """Host arrays of a light as tensors, uploaded once per device."""

    def __init__(self, **arrays):
        self._host = arrays
        self._dev = {}

    def on(self, device):
        if device not in self._dev:
            self._dev[device] = {k: torch.as_tensor(np.array(v, np.float32), device=device)
                                 for k, v in self._host.items()}
        return self._dev[device]


class Atmosphere(EnvironmentLight):
    """Procedural sky under a sun (light.cpp:94-125), importance-sampled by
    its radiance over a ``image_size`` map (1,024^2 as the reference's
    default, light.h:69), built on the host at construction."""

    def __init__(self, sun_direction, sun_color, image_size=(1024, 1024), distr=None):
        d = np.asarray(sun_direction, np.float64)
        self.sun_direction = (d / np.linalg.norm(d)).astype(np.float32)
        self.sun_color = np.asarray(sun_color, np.float32)
        self.distr = distr if distr is not None else Distribution2D.of_density(
            atmosphere_density(self.sun_direction, image_size))
        self._t = _Tensors(sun=self.sun_direction, color=self.sun_color)

    def color(self, wo):
        t = self._t.on(wo.device)
        return t["color"] * atmosphere_color(wo, t["sun"], 8)

    def pdf(self, wo):
        return self.distr.pdf(_sc_of_dir(wo)) / (4 * Pi)

    def sample(self, p, u2, u1):
        n = p.shape[0]
        t = self._t.on(p.device)
        sc, pdf = self.distr.sample(u2)
        wo = _swap_yz(uniform_sphere(sc))
        le = t["color"] * atmosphere_color(wo, t["sun"], 8, simulate_real_sun=True)
        return dict(le=le, wo=wo, distance=torch.full((n,), FLOAT_MAX, device=p.device),
                    pdf=pdf / (4 * Pi), valid=pdf > 0.0)


def atmosphere_density(sun_direction, image_size=(1024, 1024)):
    """The Atmosphere's importance density (h, w): the norm of the sky's
    color with the sun's disk at the centre of each texel of the unit
    square, pine_tpu's host-side build."""
    w, h = image_size
    ys, xs = np.meshgrid(
        (np.arange(h, dtype=np.float32) + 0.5) / h,
        (np.arange(w, dtype=np.float32) + 0.5) / w, indexing="ij",
    )
    phi = xs.reshape(-1) * (2 * np.pi)
    cos_t = 1.0 - 2.0 * ys.reshape(-1)
    sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
    wo = np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], axis=-1).astype(np.float32)
    col = atmosphere_color_np(wo, sun_direction, 8, simulate_real_sun=True)
    return np.linalg.norm(col, axis=-1).reshape(h, w)


class ImageSky(EnvironmentLight):
    """An environment image (H,W,3) times ``tint`` (light.cpp:127-171),
    looked up through the unit square as the reference maps it, rotated by
    ``elevation`` (x, in half turns) and ``rotation`` (y, in turns),
    importance-sampled by the norm of its texels."""

    def __init__(self, image, tint=(1.0, 1.0, 1.0), elevation=0.0, rotation=0.0, distr=None,
                 l2w=None):
        self.image = np.asarray(image, np.float32)
        self.tint = np.asarray(tint, np.float32)
        self.distr = distr if distr is not None else Distribution2D.of_density(
            np.linalg.norm(self.image, axis=-1))
        if l2w is None and (elevation != 0.0 or rotation != 0.0):
            l2w = (rotate_x(elevation * Pi) @ rotate_y(rotation * 2 * Pi))[:3, :3]
        self.l2w = None if l2w is None else np.asarray(l2w, np.float32)
        arrays = dict(image=self.image, tint=self.tint)
        if self.l2w is not None:
            arrays.update(l2w=self.l2w, w2l=np.linalg.inv(self.l2w).astype(np.float32))
        self._t = _Tensors(**arrays)

    def _lookup(self, t, sc):
        h, w = self.image.shape[:2]
        x = (sc[..., 0] * w).to(torch.int32).clamp(0, w - 1).long()
        y = (sc[..., 1] * h).to(torch.int32).clamp(0, h - 1).long()
        return t["tint"] * t["image"][y, x]

    def _local(self, t, wo):
        return wo if self.l2w is None else wo @ t["w2l"].T

    def color(self, wo):
        t = self._t.on(wo.device)
        return self._lookup(t, _sc_of_dir(self._local(t, wo)))

    def pdf(self, wo):
        t = self._t.on(wo.device)
        return self.distr.pdf(_sc_of_dir(self._local(t, wo))) / (4 * Pi)

    def sample(self, p, u2, u1):
        n = p.shape[0]
        t = self._t.on(p.device)
        sc, pdf = self.distr.sample(u2)
        wo = _swap_yz(uniform_sphere(sc))
        if self.l2w is not None:
            wo = wo @ t["l2w"].T
        return dict(le=self._lookup(t, sc), wo=wo,
                    distance=torch.full((n,), FLOAT_MAX, device=p.device),
                    pdf=pdf / (4 * Pi), valid=pdf > 0.0)
