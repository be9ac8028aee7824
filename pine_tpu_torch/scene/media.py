"""Participating media.  Counterpart of pine_tpu/scene/media.py (parity:
src/pine/core/medium.h/.cpp, phase_function.h).

Host-side containers: phase functions (Henyey-Greenstein, its two-lobe mix,
the cloud fit), a homogeneous medium bounded by any shape with an interval
test (CSG included), and density-grid media (``GridMedium``, and
``VDBMedium`` read from a ``.nvdb`` file), whose lookups run per lane on the
scene's device.  A grid medium keeps its grids as host arrays and uploads
each once per device (``scene.csg_intersect.on_device``).  The 4x4 transforms are
written out term by term (``csg_intersect.affine``), so that the card sums
in the CPU's order.  The tracking through grid media is
scene/media_track.py; the homogeneous media's closed forms are
``CompiledScene.transmittance`` and the path integrator's scatter terms.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core.blackbody import _N, _RGBS, _T_MAX, _T_MIN
from pine_tpu_torch.core.vecmath import Pi, coordinate_system, dot
from pine_tpu_torch.scene.csg_intersect import affine, on_device


class HgPhaseFunction:
    """Henyey-Greenstein (phase_function.h)."""

    def __init__(self, g=0.0):
        self.g = float(g)

    def p(self, cos_theta):
        g = self.g
        denom = 1 + g * g + 2 * g * cos_theta
        return (1 - g * g) / (4 * Pi * denom * fm.sqrt(torch.clamp_min(denom, 1e-8)))

    def sample(self, wi, u):
        """A direction around ``wi`` -> (wo, pdf)."""
        g = self.g
        if abs(g) < 1e-3:
            from pine_tpu_torch.core.sampling import uniform_sphere

            return uniform_sphere(u), torch.full(u.shape[:-1], 1 / (4 * Pi), device=u.device)
        sqr_term = (1 - g * g) / (1 + g - 2 * g * u[..., 0])
        cos_t = -(1 + g * g - sqr_term**2) / (2 * g)
        sin_t = fm.sqrt(torch.clamp_min(1 - cos_t**2, 0.0))
        phi = 2 * Pi * u[..., 1]
        t, b = coordinate_system(wi)
        wo = ((sin_t * fm.cos(phi))[..., None] * t + (sin_t * fm.sin(phi))[..., None] * b
              + cos_t[..., None] * wi)
        return wo, self.p(dot(wo, wi))


class TwoLobeHgPhaseFunction:
    def __init__(self, g0, g1, w):
        self.l0 = HgPhaseFunction(g0)
        self.l1 = HgPhaseFunction(g1)
        self.w = float(w)

    def p(self, cos_theta):
        return (1 - self.w) * self.l0.p(cos_theta) + self.w * self.l1.p(cos_theta)

    def sample(self, wi, u):
        wo0, _ = self.l0.sample(wi, u)
        wo1, _ = self.l1.sample(wi, u)
        wo = torch.where(u[..., 0:1] < self.w, wo1, wo0)
        return wo, self.p(dot(wo, wi))


class CloudPhaseFunction(TwoLobeHgPhaseFunction):
    """The cloud phase function ("CloudPF", phase_function.h:50-65) as
    pine_tpu fits it: a two-lobe HG whose forward lobe's g follows ``d``."""

    def __init__(self, d=0.5):
        g = float(np.exp(-0.990567 / (d + 1.67154)))
        super().__init__(g, -0.2, 0.3)
        self.d = d


class HomogeneousMedium:
    """A constant medium inside ``shape`` (medium.cpp:18-88)."""

    def __init__(self, shape, pf, sigma_a, sigma_s):
        self.shape = shape
        self.pf = pf
        self.sigma_a = np.asarray(sigma_a, np.float32)
        self.sigma_s = np.asarray(sigma_s, np.float32)
        self.sigma_t = self.sigma_a + self.sigma_s

    def get_aabb(self):
        return self.shape.get_aabb()


class GridMedium:
    """A dense (X,Y,Z) density grid placed in the world by ``transform``,
    the grid's index box spanning the unit cube before it (medium.cpp:90-290).
    The tracking runs against the global majorant sigma_z * max(density),
    with the channel means of sigma_a and sigma_s (medium.cpp:170-173).  An
    emissive grid (a ``flame`` grid and blackbody_intensity > 0) radiates
    intensity * flame(p), tinted by the Planck colour of temperature_scale *
    4000 * temperature(p) where a temperature grid is given."""

    is_grid = True

    def __init__(self, density, transform, pf, sigma_a, sigma_s, flame=None, temperature=None,
                 blackbody_intensity=0.0, temperature_scale=1.0):
        density = np.asarray(density, np.float32)
        if density.ndim != 3:
            raise ValueError(f"a density grid is (X, Y, Z), not {density.shape}")
        self.density = density
        self.res = np.asarray(density.shape, np.int32)
        self.res_f = self.res.astype(np.float32)
        m = np.asarray(getattr(transform, "data", transform), np.float32)
        if m.shape == (4, 4):
            self.m = m
        else:
            self.m = np.eye(4, dtype=np.float32)
            self.m[:3, : m.shape[1]] = m
        self.m_inv = np.linalg.inv(self.m).astype(np.float32)
        self.pf = pf
        self.sigma_a = np.broadcast_to(np.asarray(sigma_a, np.float32).reshape(-1), (3,)).copy()
        self.sigma_s = np.broadcast_to(np.asarray(sigma_s, np.float32).reshape(-1), (3,)).copy()
        self.sigma_t = self.sigma_a + self.sigma_s
        self.sigma_a_bar = float(self.sigma_a.mean())
        self.sigma_s_bar = float(self.sigma_s.mean())
        self.sigma_z_bar = self.sigma_a_bar + self.sigma_s_bar
        self.max_density = float(density.max())
        self.sigma_maj = self.sigma_z_bar * self.max_density
        self.blackbody_intensity = float(blackbody_intensity)
        self.temperature_scale = float(temperature_scale)
        self.emissive = flame is not None and self.blackbody_intensity > 0.0
        self.flame = self.temperature = None
        if self.emissive:
            self.flame = self._same_shape(flame, "flame")
            if temperature is not None:
                self.temperature = self._same_shape(temperature, "temperature")
                self.bb_table = _RGBS

    def _same_shape(self, grid, name):
        grid = np.asarray(grid, np.float32)
        if grid.shape != self.density.shape:
            raise ValueError(f"the {name} grid is {grid.shape}, the density grid "
                             f"{self.density.shape}")
        return grid

    def get_aabb(self):
        corners = np.stack([self.m[:3, :3] @ np.array([x, y, z], np.float32) + self.m[:3, 3]
                            for x in (0, 1) for y in (0, 1) for z in (0, 1)])
        return corners.min(0), corners.max(0)

    # ---- per-lane lookups on the points' device ------------------------------
    def local_of(self, p):
        return affine(on_device(self, "m_inv", p), p)

    def _cells(self, p):
        """-> (flat voxel index (N,), inside the unit cube (N,))."""
        q = self.local_of(p)
        idx = torch.floor(q * on_device(self, "res_f", p)).to(torch.int32)
        inside = ((q >= 0.0) & (q < 1.0)).all(-1)
        i, j, k = (idx[:, a].clamp(0, int(self.res[a]) - 1).long() for a in range(3))
        return (i * int(self.res[1]) + j) * int(self.res[2]) + k, inside

    def _grid(self, name, like):
        return on_device(self, name, like).reshape(-1)

    def density_at(self, p):
        """Nearest-voxel density at world points p (0 outside the grid)."""
        flat, inside = self._cells(p)
        return torch.where(inside, self._grid("density", p)[flat], 0.0)

    def emission_at(self, p):
        """Blackbody radiance (N,3) at world points p (medium.cpp:233-249);
        zeros when the medium is not emissive."""
        n = p.shape[0]
        if not self.emissive:
            return torch.zeros(n, 3, device=p.device)
        flat, inside = self._cells(p)
        fl = self._grid("flame", p)[flat]
        le = (self.blackbody_intensity * torch.where(inside, fl, 0.0))[:, None].expand(n, 3)
        if self.temperature is not None:
            T = self._grid("temperature", p)[flat]
            tk = torch.clamp(self.temperature_scale * 4000.0 * T, _T_MIN, _T_MAX)
            f = (tk - _T_MIN) / (_T_MAX - _T_MIN) * (_N - 1)
            i0 = torch.clamp(f.to(torch.int32), 0, _N - 2).long()
            w = (f - i0)[..., None]
            tbl = on_device(self, "bb_table", p)
            le = le * (tbl[i0] * (1 - w) + tbl[i0 + 1] * w)
        return le

    def bounds_interval(self, ro, rd):
        """Entry (at least 0) and exit t of the grid's transformed unit cube."""
        mi = on_device(self, "m_inv", ro)
        o_l = affine(mi, ro)
        d_l = affine(mi, rd, translate=False)
        inv = 1.0 / torch.where(d_l.abs() < 1e-9, torch.where(d_l < 0, -1e-9, 1e-9), d_l)
        t0 = (0.0 - o_l) * inv
        t1 = (1.0 - o_l) * inv
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        return torch.clamp_min(tn, 0.0), tf


class VDBMedium(GridMedium):
    """A grid medium read from a NanoVDB ``.nvdb`` file (medium.cpp:152-213):
    its "density" FloatGrid, and where the file has them its "flames" and
    "temperature" grids, resampled nearest onto the density grid's index box
    when their resolutions differ.  PRL: VDBMedium(filename, transform, pf,
    sigma_a, sigma_s[, blackbody_intensity, temperature_scale])."""

    def __init__(self, filename, transform, pf, sigma_a, sigma_s, blackbody_intensity=0.0,
                 temperature_scale=1.0):
        from pine_tpu_torch.io.nvdb import list_nvdb_grids, read_nvdb_density

        density, _ = read_nvdb_density(filename)
        names = set(list_nvdb_grids(filename))

        def aligned(name):
            if name not in names:
                return None
            g, _ = read_nvdb_density(filename, grid_name=name)
            if g.shape == density.shape:
                return g
            xs = [np.minimum((np.arange(density.shape[i]) * g.shape[i]) // density.shape[i],
                             g.shape[i] - 1) for i in range(3)]
            return g[np.ix_(xs[0], xs[1], xs[2])]

        super().__init__(density, transform, pf, sigma_a, sigma_s, flame=aligned("flames"),
                         temperature=aligned("temperature"),
                         blackbody_intensity=blackbody_intensity,
                         temperature_scale=temperature_scale)
