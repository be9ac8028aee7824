"""MicroRenderGI: surfel point-based global illumination.  Counterpart of
pine_tpu/integrators/micro_render.py (parity+: impl/integrator/
micro_render.cpp:12-298).

The reference is an interactive OpenGL experiment that never writes the
film; pine_tpu renders it, and so does the port:

1. area-weighted surfels over the scene's geometry (micro_render.cpp:96-97:
   the CDF, radius sqrt(total area / count) / pi), drawn on the host from
   one numpy stream: ``rng.choice`` over the areas, then per surfel
   ``rng.random(2)`` and ``rng.normal(3)`` on a sphere or a second
   ``choice`` on a mesh.  The port's shapes give pine_tpu's areas to the
   bit, so the draw is pine_tpu's;
2. the direct light at each surfel from the scene's first point or
   directional light (else its first area light's box centre), with a
   shadow ray and the reference's 1 / (0.5 + d^2) falloff
   (micro_render.cpp:124-127);
3. a camera G-buffer, one ray a pixel centre (micro_render.cpp:193-205);
4. per pixel, every surfel z-buffered into a HB x HB hemispherical
   microbuffer (the reference's project(): u = phi / 2 pi, v = 1 - sin
   theta, micro_render.cpp:80-88), the holes filled by push-pull
   (micro_render.cpp:12-42), and the cells integrated with their solid
   angles, in chunks of ``chunk`` pixels.

The microbuffer's depth test is a scatter minimum (no order); its colour
sum adds in float64 and rounds once, so the order of the card's atomic adds
does not show; the counts are exact.  Dot products are written out term by
term and the azimuth is core/fmath's atan2.  The final sum over a pixel's
HB^2 cells adds the float32 products in float64, rounded once.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core import progress
from pine_tpu_torch.core.ray import offset_ray_origin
from pine_tpu_torch.core.vecmath import Pi, coordinate_system, dot, face_forward
from pine_tpu_torch.integrators.guidedpath import film_lanes
from pine_tpu_torch.scene import material_eval

HB = 32  # the hemisphere microbuffer's edge (micro_render.cpp:108-110)
BIGF = 1e30
CHUNK = 16384  # pixels a gather


def _surfel_sample(scene, count, seed=0):
    """Host-side area-weighted surfels -> (positions (S,3), normals (S,3),
    geometry ids (S,), total area), float32 / int32 numpy."""
    rng = np.random.default_rng(seed)
    areas = np.asarray([float(shape.area()) for shape, _ in scene.geometries])
    areas[~np.isfinite(areas)] = 0.0
    if areas.sum() <= 0:
        raise RuntimeError("MicroRenderGI: no finite-area geometry")
    picks = rng.choice(len(areas), size=count, p=areas / areas.sum())
    P = np.zeros((count, 3), np.float32)
    N = np.zeros((count, 3), np.float32)
    G = np.zeros((count,), np.int32)
    for k, gi in enumerate(picks):
        shape, _ = scene.geometries[gi]
        p, nrm = _sample_on_shape(shape, rng)
        P[k], N[k], G[k] = p, nrm, gi
    return P, N, G, float(areas.sum())


def _sample_on_shape(shape, rng):
    """A point on ``shape`` and its normal from the stream ``rng``."""
    from pine_tpu_torch.scene import shapes as S

    u = rng.random(2).astype(np.float32)
    if isinstance(shape, S.Rect):
        p = (shape.position + (u[0] - 0.5) * shape.ex * shape.lx
             + (u[1] - 0.5) * shape.ey * shape.ly)
        return p.astype(np.float32), shape.n.astype(np.float32)
    if isinstance(shape, S.Sphere):
        v = rng.normal(size=3).astype(np.float32)
        v /= max(np.linalg.norm(v), 1e-8)
        return (shape.c + shape.r * v).astype(np.float32), v
    if isinstance(shape, S.Disk):
        r = shape.r * np.sqrt(u[0])
        phi = 2 * np.pi * u[1]
        t = np.cross(shape.n, [0.557, 0.707, 0.435])
        t /= max(np.linalg.norm(t), 1e-8)
        b = np.cross(shape.n, t)
        p = shape.position + r * (np.cos(phi) * t + np.sin(phi) * b)
        return p.astype(np.float32), shape.n.astype(np.float32)
    if isinstance(shape, S.Mesh):
        areas = shape.triangle_areas()
        tri = rng.choice(len(areas), p=areas / areas.sum())
        f = shape.indices[tri].astype(np.int64)
        a, b, c = shape.vertices[f[0]], shape.vertices[f[1]], shape.vertices[f[2]]
        if u.sum() > 1:
            u = 1 - u
        p = a + u[0] * (b - a) + u[1] * (c - a)
        nrm = np.cross(b - a, c - a)
        nrm /= max(np.linalg.norm(nrm), 1e-8)
        return p.astype(np.float32), nrm.astype(np.float32)
    # other shapes: a point on the top face of their box
    lo, hi = shape.get_aabb()
    p = np.array([lo[0] + u[0] * (hi[0] - lo[0]), hi[1], lo[2] + u[1] * (hi[2] - lo[2])],
                 np.float32)
    return p, np.array([0, 1, 0], np.float32)


def _pick_light(cscene, scene):
    """(position or direction, colour, is_directional) of the light the
    surfels are lit by: the first point or directional light of the compiled
    scene's list, else its first area light (the emissive geometry of
    ``scene`` it stands for): the centre of its box, its Emissive colour."""
    from pine_tpu_torch.scene import lights as L
    from pine_tpu_torch.scene import nodes as Nn

    for light in cscene.lights:
        if isinstance(light, L.PointLight):
            return (np.asarray(light.position, np.float32), np.asarray(light.color, np.float32),
                    False)
        if isinstance(light, L.DirectionalLight):
            return (np.asarray(light.direction, np.float32), np.asarray(light.color, np.float32),
                    True)
    for light in cscene.lights:
        if isinstance(light, L.AreaLight):
            shape, mat = scene.geometries[light.global_idx]
            lo, hi = shape.get_aabb()
            c = np.asarray(Nn.constant_value(mat.color), np.float32)
            return (((np.asarray(lo) + np.asarray(hi)) / 2).astype(np.float32), c.reshape(-1)[:3],
                    False)
    raise RuntimeError("MicroRenderGI needs at least one light")


def _push_pull(color, occupied, hb=HB):
    """Fill the microbuffers' holes from coarser mips (push_pop,
    micro_render.cpp:12-42): push takes the largest of four children, halved
    a level, down to hb/4; pull gives a black texel its parent's value.
    color (m,hb,hb,3); occupied (m,hb,hb) bool."""
    mips = [torch.where(occupied[..., None], color, 0.0)]
    falloff = 2.0
    size = hb // 2
    while size >= hb // 4:
        c = mips[-1]
        mips.append(torch.maximum(torch.maximum(c[:, 0::2, 0::2], c[:, 1::2, 0::2]),
                                  torch.maximum(c[:, 0::2, 1::2], c[:, 1::2, 1::2])) / falloff)
        falloff *= 2.0
        size //= 2
    filled = mips[-1]
    for c in reversed(mips[:-1]):  # coarsest to finest
        up = filled.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        black = c.amax(-1, keepdim=True) <= 0.0
        filled = torch.where(black, up, c)
    return filled


def _microbuffer_gather(p_s, ns, Pd, Nd, cd, radius, hb=HB):
    """Point-based GI with visibility (m receivers, S surfels) -> (m,3): each
    surfel above a receiver's horizon that faces it and lies farther than
    ``radius`` lands in the cell of its direction; the nearest surfels of a
    cell give it their mean colour; push-pull fills the holes; the result
    is sum over cells of colour * 2 rho / hb^2 (the cos / z factors cancel
    against the map's Jacobian dOmega = 2 pi rho / z du dv)."""
    m, S, dev = p_s.shape[0], Pd.shape[0], p_s.device
    t, b = coordinate_system(ns)
    dvec = Pd[None, :, :] - p_s[:, None, :]  # (m,S,3)
    dx, dy, dz = dvec[..., 0], dvec[..., 1], dvec[..., 2]
    dist = fm.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-12))
    wx, wy, wz = dx / dist, dy / dist, dz / dist

    def along(v):  # the (m,S) dot products of the directions with per-receiver v (m,3)
        return wx * v[:, None, 0] + wy * v[:, None, 1] + wz * v[:, None, 2]

    px, py, pz = along(t), along(b), along(ns)
    facing = (-wx * Nd[None, :, 0] + -wy * Nd[None, :, 1] + -wz * Nd[None, :, 2]) > 0.0
    valid = (pz > 1e-4) & facing & (dist > radius)
    rho = fm.sqrt(torch.clamp_min(px * px + py * py, 1e-12))
    phi = fm.atan2(py, px)
    u = torch.where(phi < 0.0, 2 * Pi + phi, phi) / (2 * Pi)
    v = 1.0 - rho
    cx = (u * hb).to(torch.int32).clamp(0, hb - 1)
    cy = (v * hb).to(torch.int32).clamp(0, hb - 1)
    flat = (torch.arange(m, device=dev)[:, None] * (hb * hb) + (cy * hb + cx)).reshape(-1)
    cells = m * hb * hb
    depth = torch.where(valid, dist, BIGF).reshape(-1)
    zbuf = torch.full((cells,), BIGF, device=dev).scatter_reduce_(0, flat, depth, "amin")
    # the surfels at a cell's least depth take it
    win = valid.reshape(-1) & (depth <= zbuf[flat] * 1.0001)
    csum = torch.zeros(cells, 3, dtype=torch.float64, device=dev).index_add_(
        0, flat, torch.where(win.view(m, S, 1), cd.double()[None], 0.0).reshape(-1, 3))
    cnt = torch.zeros(cells, device=dev).index_add_(0, flat, win.to(torch.float32))
    cell_color = (csum.float() / torch.clamp_min(cnt, 1.0)[:, None]).reshape(m, hb, hb, 3)
    filled = _push_pull(cell_color, (cnt > 0).reshape(m, hb, hb), hb)
    # the solid angle of a row: rho at the cell centre, 1 - (cy + 0.5) / hb
    rho_c = 1.0 - (torch.arange(hb, dtype=torch.float32, device=dev) + 0.5) / hb
    w_row = 2.0 * rho_c / (hb * hb)
    return (filled * w_row[None, :, None, None]).double().sum((1, 2)).float()


class MicroRenderIntegrator:
    """PRL: MicroRenderGI(point_count) (program_context.cpp:54-56)."""

    def __init__(self, point_count=2048, microbuffer=HB):
        self.point_count = int(point_count)
        self.microbuffer = int(microbuffer)

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        cscene = scene.compile(device)
        film = cam.film
        img = render_micro(cscene, scene, cam, film.width, film.height, self.point_count,
                           hb=self.microbuffer)
        film.set_rgb(img)
        return film


def render_micro(cscene, scene, cam, W, H, point_count=2048, chunk=CHUNK, hb=HB,
                 return_stats=False):
    """Render and return the (H,W,3) radiance on the compiled scene's
    device: ``scene`` is the Scene ``cscene`` was compiled from (its
    geometries carry the surfels), ``cam`` the camera (None: the compiled
    scene's).  With return_stats=True also returns {"traced_rays": the
    surfels' shadow rays, the camera rays and the pixels' shadow rays cast}."""
    dev = cscene.device
    P, Nrm, G, total_area = _surfel_sample(scene, point_count)
    radius = float(np.sqrt(total_area / point_count) / np.pi)  # :97
    lp, cl, is_dir = _pick_light(cscene, scene)
    cp = cam.params(dev) if cam is not None else cscene.camera
    Pd, Nd = torch.as_tensor(P, device=dev), torch.as_tensor(Nrm, device=dev)
    Gd = torch.as_tensor(G, device=dev)
    lp_d, cl_d = torch.as_tensor(lp, device=dev), torch.as_tensor(cl, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    def direct_at(p, nrm, albedo, cast):
        """cl * albedo * cos / (0.5 + d^2), zero where the shadow ray from p
        is blocked (:124-127); lanes outside ``cast`` cast no ray."""
        m = p.shape[0]
        if is_dir:
            wo = (lp_d / fm.sqrt(dot(lp_d, lp_d))).expand(m, 3)
            dist = torch.full((m,), 1e6, device=dev)
            fall = torch.ones(m, device=dev)
        else:
            dvec = lp_d[None, :] - p
            dist = fm.sqrt(dot(dvec, dvec))
            wo = dvec / torch.clamp_min(dist[:, None], 1e-8)
            fall = 1.0 / (0.5 + dist * dist)
        so = offset_ray_origin(p, face_forward(nrm, wo))
        occ = cscene.any_hit(so, wo.contiguous(), torch.zeros(m, device=dev),
                             torch.where(cast, dist * (1.0 - 1e-3), -1.0))
        out = cl_d[None, :] * albedo * (dot(nrm, wo).abs() * fall)[:, None]
        return torch.where(occ[:, None], 0.0, out), cast.sum()

    # ---- the surfels' outgoing radiance
    ctx = dict(p=Pd, n=Nd, uv=torch.zeros(point_count, 2, device=dev))
    half = torch.full((point_count,), 0.5, device=dev)
    mat_idx = cscene.g_mat[Gd.clamp(0, cscene.n_global - 1).long()]
    st = material_eval.eval_bxdf_state(cscene, mat_idx, ctx, Nd, half, half, 0.0,
                                       torch.zeros(point_count, dtype=torch.bool, device=dev))
    cd, r = direct_at(Pd, Nd, st["albedo"], torch.ones(point_count, dtype=torch.bool, device=dev))
    rays = rays + r

    # ---- the pixels, in chunks of ``chunk`` (pine_tpu pads the last one to a
    # whole chunk for its jit's fixed shapes; each pixel's result is its own)
    n = W * H
    xs_all, ys_all = film_lanes(W, H, dev)
    wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
    out = []
    for c0 in range(0, n, chunk):
        xs, ys = xs_all[c0:c0 + chunk], ys_all[c0:c0 + chunk]
        m = xs.shape[0]
        pf = (torch.stack([xs, ys], -1).to(torch.float32) + 0.5) / wh
        ro, rd = camera_mod.gen_rays(cp, pf, torch.full((m, 2), 0.5, device=dev))
        ro, rd = ro.contiguous(), rd.contiguous()
        t, gidx, hit, mesh_tri = cscene.intersect(ro, rd, torch.zeros(m, device=dev),
                                                  torch.full((m,), 3.0e38, device=dev))
        rays = rays + m
        t_hit = torch.where(hit, t, 1.0)
        p_s, ns, uv = cscene.surface_info(gidx, ro + t_hit[:, None] * rd, mesh_tri)
        ctx = dict(p=p_s, n=ns, uv=uv)
        mat_idx = cscene.g_mat[gidx.clamp(0, cscene.n_global - 1).long()]
        half = torch.full((m,), 0.5, device=dev)
        st = material_eval.eval_bxdf_state(cscene, mat_idx, ctx, -rd, half, half, 0.0,
                                           torch.zeros(m, dtype=torch.bool, device=dev))
        albedo, sig = st["albedo"], st["sigma_s"]
        # a subsurface material's surface albedo is often black (its look is
        # sigma_s): its scattering colour stands in as the apparent diffuse
        # colour (classic.pine's middle sphere)
        sig_max = sig.amax(-1, keepdim=True)
        apparent = torch.where((albedo.amax(-1, keepdim=True) < 1e-3) & (sig_max > 0),
                               sig / torch.clamp_min(sig_max, 1e-6) * 0.8, albedo)
        emis = cscene.is_emissive_lane(gidx) & hit
        direct, r = direct_at(p_s, ns, apparent, hit & ~emis)
        rays = rays + r
        L = direct + apparent * _microbuffer_gather(p_s, ns, Pd, Nd, cd, radius, hb)
        if cscene.emissive_globals:
            L = torch.where(emis[:, None], cscene.emissive_le(gidx, ctx, -rd), L)
        out.append(torch.where(hit[:, None], L, 0.0))
        progress.set_progress(min(c0 + chunk, n) / n)
    img = torch.cat(out).reshape(H, W, 3)
    return (img, {"traced_rays": int(rays)}) if return_stats else img
