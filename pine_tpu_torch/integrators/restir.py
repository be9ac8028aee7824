"""ReSTIR direct illumination.  Counterpart of pine_tpu/integrators/restir.py
(parity+: impl/integrator/restir.cpp:36-127).

The reference builds initial samples, a temporal reservoir grid and a
spatial reuse pass, and leaves its radiance body and final gather commented
out; pine_tpu runs the whole pipeline densely on the wavefront, and so does
the port:

1. a first-hit G-buffer from the camera rays;
2. M_CANDIDATES light samples a pixel into a weighted reservoir, the target
   p_hat the luminance of the unshadowed contribution (ReSample::target_pdf,
   restir.cpp:39);
3. the winner's visibility (biased-visibility reuse, restir.cpp:113-117);
4. SPATIAL_ROUNDS rounds of SPATIAL_TAPS random neighbours within
   SPATIAL_RADIUS pixels, merged where normal and depth agree
   (restir.cpp:103-105): each tap reads the neighbour's reservoir as the
   previous tap left it, W recomputed after each round;
5. shading with W = w_sum / (M p_hat), plus emission and the environment on
   the camera rays.

The neighbours are gathered by row-major pixel index, so a sample runs the
whole film at once in row-major order (not render_wavefront's tile-order
chunks).  Media: the camera segment's transmittance and in-scatter, the
grid media's ratio tracked and single-scattered
(``path.segment_medium_terms`` with include_grid, dims 40..71); the
winner's contribution takes its shadow ray's transmittance.

Sampler dims, pine_tpu's: 0,1 the pixel jitter, 2,3 the lens, 4,5 the lobe
choices; candidate m at 8 + 4m (+0 light selection, +1,+2 the light
sample, +3 the reservoir's draw).  The spatial taps draw from the hash
(pixel, sample, 3000 + 97 round + tap) (+1 for y, +7 for the merge).
"""
from __future__ import annotations

import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import progress
from pine_tpu_torch.core import rng
from pine_tpu_torch.core.ray import offset_ray_origin
from pine_tpu_torch.core.vecmath import dot, face_forward, to_local
from pine_tpu_torch.integrators.guidedpath import _div, film_lanes
from pine_tpu_torch.integrators.mlt import luminance
from pine_tpu_torch.integrators.path import sample_one_light, segment_medium_terms
from pine_tpu_torch.scene import bxdf as bxdf_mod
from pine_tpu_torch.scene import material_eval

M_CANDIDATES = 8
SPATIAL_ROUNDS = 2
SPATIAL_TAPS = 4
SPATIAL_RADIUS = 16
T_MAX = 3.0e38  # the camera rays' tmax, pine_tpu's


class RestirIntegrator:
    """PRL: RestirIntegrator(sampler, max_path_length)
    (program_context.cpp:108-113); direct light only, like the reference
    skeleton: ``max_path_length`` is kept and not used."""

    def __init__(self, sampler, max_path_length=2):
        self.sampler = sampler
        self.max_path_length = int(max_path_length)

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        cscene = scene.compile(device)
        film = cam.film
        img = render_restir(cscene, cam, film.width, film.height, self.sampler, self.sampler.spp)
        film.set_rgb(img)
        return film


def render_restir(cscene, cam, W, H, sampler, spp, return_stats=False):
    """Render and return the (H,W,3) mean radiance on the scene's device, seen
    by ``cam`` (None: the compiled scene's camera).  With return_stats=True
    also returns {"traced_rays": n}: the camera rays and the visibility rays
    cast."""
    if cscene.grid_media:
        from pine_tpu_torch.core.log import WARNING

        WARNING("RestirIntegrator renders grid (VDB) media with a single-scatter approximation "
                "(multiple in-medium scattering truncated); PathIntegrator traces them fully.")
    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    xs, ys = film_lanes(W, H, dev)
    total = torch.zeros(W * H, 3, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for si in range(spp):
        L, r = restir_sample(cscene, cp, xs, ys, W, H, sampler, si)
        total = total + L
        rays = rays + r
        progress.set_progress((si + 1) / spp)
    img = _div(total, float(spp)).reshape(H, W, 3)
    return (img, {"traced_rays": int(rays)}) if return_stats else img


def restir_sample(cscene, cp, xs, ys, W, H, sampler, si):
    """One sample of every pixel of the film (xs, ys: row-major, the whole
    film) -> (L (N,3), traced rays)."""
    n, dev = xs.shape[0], xs.device
    n_lights = len(cscene.lights)
    wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
    p_film = (torch.stack([xs, ys], -1).to(torch.float32) + sampler.u2(xs, ys, si, 0)) / wh
    ro, rd = camera_mod.gen_rays(cp, p_film, sampler.u2(xs, ys, si, 2))
    ro, rd = ro.contiguous(), rd.contiguous()
    t, gidx, hit, mesh_tri = cscene.intersect(ro, rd, torch.zeros(n, device=dev),
                                              torch.full((n,), T_MAX, device=dev))
    rays = torch.full((), n, dtype=torch.int64, device=dev)
    t_hit = torch.where(hit, t, 1.0)
    p_s, ns, uv = cscene.surface_info(gidx, ro + t_hit[:, None] * rd, mesh_tri)
    ctx = dict(p=p_s, n=ns, uv=uv)
    wi_world = -rd

    # the camera segment's media terms: its transmittance applies to all that
    # arrives through it; its in-scatter adds unconditionally
    seg_tr0, L = segment_medium_terms(cscene, ro, rd, torch.where(hit, t, 1e8),
                                      torch.ones(n, dtype=torch.bool, device=dev), xs, ys,
                                      sampler, si, 8 + M_CANDIDATES * 4, include_grid=True)
    emis = cscene.is_emissive_lane(gidx) & hit
    if cscene.emissive_globals:
        le = cscene.emissive_le(gidx, ctx, wi_world)
        L = L + torch.where(emis[:, None], le * seg_tr0, 0.0)
    if cscene.env_light is not None:
        L = L + torch.where((~hit)[:, None], cscene.env_light.color(rd) * seg_tr0, 0.0)
    shade = hit & ~emis
    if n_lights == 0:
        return L, rays

    mat_idx = cscene.g_mat[gidx.clamp(0, cscene.n_global - 1).long()]
    u_mat = sampler.u2(xs, ys, si, 4)
    state = material_eval.eval_bxdf_state(cscene, mat_idx, ctx, wi_world, u_mat[:, 0],
                                          u_mat[:, 1], 0.0,
                                          torch.zeros(n, dtype=torch.bool, device=dev))
    wi = to_local(ns, wi_world)

    def raw_contrib(ls):
        """The unshadowed contribution without the sampling pdf (ReSample::Lo)."""
        f_l, _ = bxdf_mod.f_and_pdf(state, wi, to_local(ns, ls["wo"]))
        contrib = ls["le"] * f_l * dot(ls["wo"], ns).abs()[:, None]
        return torch.where(ls["valid"][:, None], contrib, 0.0)

    # ---- weighted reservoir sampling over the candidates (restir.cpp:48-65):
    # w_i = p_hat(x_i) / p(x_i), the winner kept with probability w_i / w_sum
    r_wsum = torch.zeros(n, device=dev)
    r_C = torch.zeros(n, 3, device=dev)  # the winner's raw contribution
    r_wo = torch.zeros(n, 3, device=dev)
    r_dist = torch.ones(n, device=dev)
    for m in range(M_CANDIDATES):
        dim = 8 + m * 4
        ls = sample_one_light(cscene, p_s, sampler.u1(xs, ys, si, dim),
                              sampler.u2(xs, ys, si, dim + 1))
        C_i = raw_contrib(ls)
        w_i = luminance(C_i) / torch.clamp_min(ls["pdf"], 1e-20)
        w_i = torch.where(ls["valid"] & (ls["pdf"] > 0), w_i, 0.0)
        r_wsum = r_wsum + w_i
        take = sampler.u1(xs, ys, si, dim + 3) < w_i / torch.clamp_min(r_wsum, 1e-20)
        r_C = torch.where(take[:, None], C_i, r_C)
        r_wo = torch.where(take[:, None], ls["wo"], r_wo)
        r_dist = torch.where(take, ls["distance"], r_dist)
    r_phat = luminance(r_C)
    r_M = torch.full((n,), float(M_CANDIDATES), device=dev)

    # the winner's visibility (restir.cpp:113-117): a lane that shades nothing
    # or kept no candidate casts no ray (tmax -1); its result is never read
    vis = shade & (r_phat > 0.0)
    so = offset_ray_origin(p_s, face_forward(ns, r_wo))
    r_wo = r_wo.contiguous()
    occ = cscene.any_hit(so, r_wo, torch.zeros(n, device=dev),
                         torch.where(vis, r_dist * (1.0 - 1e-3), -1.0))
    rays = rays + vis.sum()
    if cscene.media or cscene.grid_media:
        # media attenuate the realized contribution, not the target p_hat
        # (unshadowed, like the occlusion convention)
        r_C = r_C * cscene.transmittance(so, r_wo, torch.where(vis, r_dist, -1.0))
    r_phat = torch.where(occ, 0.0, r_phat)
    r_W = torch.where(r_phat > 0.0, r_wsum / torch.clamp_min(r_M * r_phat, 1e-20), 0.0)

    # ---- spatial reuse (restir.cpp:98-126): merge w_in = p_hat W_n M_n
    for rnd in range(SPATIAL_ROUNDS):
        for tap in range(SPATIAL_TAPS):
            salt = 3000 + rnd * 97 + tap
            ox = (rng.uniform(xs, ys, si, salt) - 0.5) * (2 * SPATIAL_RADIUS)
            oy = (rng.uniform(xs, ys, si, salt + 1) - 0.5) * (2 * SPATIAL_RADIUS)
            qx = (xs + ox.to(torch.int32)).clamp(0, W - 1)
            qy = (ys + oy.to(torch.int32)).clamp(0, H - 1)
            q = (qy * W + qx).long()
            ok = ((dot(ns, ns[q]) > 0.995) & ((t_hit - t_hit[q]).abs() < 0.1)
                  & shade & shade[q])
            w_in = torch.where(ok, r_phat[q] * r_W[q] * r_M[q], 0.0)
            new_wsum = r_wsum + w_in
            u_keep = rng.uniform(xs, ys, si, salt + 7)
            take = (u_keep < w_in / torch.clamp_min(new_wsum, 1e-20)) & ok
            r_C = torch.where(take[:, None], r_C[q], r_C)
            r_wsum = new_wsum
            r_M = r_M + torch.where(ok, r_M[q], 0.0)
            r_phat = torch.where(take, r_phat[q], r_phat)
        r_W = torch.where(r_phat > 0.0, r_wsum / torch.clamp_min(r_M * r_phat, 1e-20), 0.0)

    L_di = r_C * r_W[:, None]
    return L + seg_tr0 * torch.where(shade[:, None], L_di, 0.0), rays
