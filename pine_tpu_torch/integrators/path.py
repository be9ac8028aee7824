"""Wavefront path integrator.  Counterpart of pine_tpu/integrators/path.py.

Every depth step runs ray intersection, emissive hits with MIS, material
evaluation, BSDF sampling and NEE with a shadow ray, dense over the whole
wavefront with per-lane alive masks.  The MIS bookkeeping and the firefly
clamp are pine_tpu's: everything but the depth-0 direct hit is clamped to 8
at the path level.

Sampler dimension schedule: dims 0-3 = pixel jitter + lens; per depth d
(base = 4 + d*16):
    +0   light selection          +1,+2  light-sample u2
    +3,+4 material lobe choices   +5,+6  bxdf wm u2
    +7   bxdf fresnel u1          +8,+9  bxdf cosine u2

Where the scene sorts on the card (CompiledScene.sort_mode: heavy scenes;
instanced ones with ``origin_sort`` set), each bounce's continuation rays are
put in coherence-sort order once (CompiledScene.sort_perm); the permutation
serves that depth's NEE shadow rays and the next depth's intersect.  Depth 0
is not sorted: the tile-major primary rays are coherent already.

Media, subsurface walks and environment lights are not ported yet (their
scenes are refused at compile()).
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import progress
from pine_tpu_torch.core.ray import offset_ray_origin
from pine_tpu_torch.core.sampling import balance_heuristic
from pine_tpu_torch.core.vecmath import dot, face_forward, to_local, to_world
from pine_tpu_torch.scene import bxdf as bxdf_mod
from pine_tpu_torch.scene import material_eval

FLOAT_MAX = float(np.finfo(np.float32).max)
CLAMP = 8.0
MIN_ROUGHNESS = 0.6
TILE = 16  # pixel-tile edge for coherent lane order
DEFAULT_CHUNK = 1 << 20  # lanes per wavefront: a 1024x1024 film in one chunk


class PathIntegrator:
    """PathIntegrator(sampler, max_path_length)."""

    def __init__(self, sampler, max_path_length):
        if max_path_length <= 0:
            raise ValueError(
                f"`PathIntegrator` expect `max_path_length` to be positive, got {max_path_length}"
            )
        self.sampler = sampler
        self.max_path_length = int(max_path_length)

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        cscene = scene.compile(device)
        film = cam.film
        img = render_wavefront(cscene, cam, film.width, film.height, self.sampler,
                               self.sampler.spp, self.max_path_length)
        film.set_rgb(img)
        return film


def tile_order(W, H, tile=TILE):
    """Pixel permutation: tile-major scan, so a run of lanes covers a compact
    film region.  perm[k] = flat pixel index of lane k."""
    xs, ys = np.meshgrid(np.arange(W, dtype=np.int64), np.arange(H, dtype=np.int64))
    tx, ty = xs // tile, ys // tile
    key = (((ty * ((W + tile - 1) // tile)) + tx) << 16) | ((ys % tile) * tile + (xs % tile))
    return np.argsort(key.ravel(), kind="stable").astype(np.int32)


def render_wavefront(cscene, cam, W, H, sampler, spp, max_depth, nee=True, chunk=None,
                     return_stats=False, sample_offset=0):
    """Render and return the (H,W,3) mean radiance on the scene's device.

    The film runs in chunks of ``chunk`` lanes (default: the whole film) in
    tile-major pixel order; core/progress gets the share done after each.  With return_stats=True also returns
    {"traced_rays": n}: extension rays of lanes alive at each depth plus the
    NEE shadow rays actually cast."""
    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    n = W * H
    chunk = min(n, DEFAULT_CHUNK) if chunk is None else int(chunk)
    perm = tile_order(W, H)
    ys_all, xs_all = np.divmod(perm, W)
    flat = torch.empty(n, 3, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        xs = torch.as_tensor(xs_all[c0:c0 + chunk], device=dev)
        ys = torch.as_tensor(ys_all[c0:c0 + chunk], device=dev)
        acc = torch.zeros(xs.shape[0], 3, device=dev)
        for i in range(spp):
            L, r = path_trace_sample(cscene, cp, xs, ys, W, H, sampler,
                                     sample_offset + i, max_depth, nee)
            acc = acc + L
            total = total + r
        flat[c0:c0 + chunk] = acc / spp
        progress.set_progress(min(c0 + chunk, n) / n)
    img = flat[torch.as_tensor(np.argsort(perm), device=dev)].reshape(H, W, 3)
    if return_stats:
        return img, {"traced_rays": int(total)}
    return img


def sample_one_light(cscene, p_s, u_sel, u_light):
    """Uniform light-list sampling, one light per lane -> dict(le, wo,
    distance, pdf, valid, is_delta), pdf already divided by the light count."""
    n = p_s.shape[0]
    dev = p_s.device
    n_lights = len(cscene.lights)
    pick = (u_sel * n_lights).to(torch.int32).clamp(0, n_lights - 1)
    u1_rem = u_sel * n_lights - pick.to(torch.float32)
    ls = dict(
        le=torch.zeros(n, 3, device=dev), wo=torch.zeros(n, 3, device=dev),
        distance=torch.ones(n, device=dev), pdf=torch.ones(n, device=dev),
        valid=torch.zeros(n, dtype=torch.bool, device=dev),
        is_delta=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    for li, light in enumerate(cscene.lights):
        s = light.sample(p_s, u_light, u1_rem)
        m = pick == li
        ls["le"] = torch.where(m[:, None], s["le"], ls["le"])
        ls["wo"] = torch.where(m[:, None], s["wo"], ls["wo"])
        ls["distance"] = torch.where(m, s["distance"], ls["distance"])
        ls["pdf"] = torch.where(m, s["pdf"] * (1.0 / n_lights), ls["pdf"])
        ls["valid"] = torch.where(m, s["valid"], ls["valid"])
        ls["is_delta"] = ls["is_delta"] | (m & light.is_delta)
    return ls


def nee_contribution(cscene, p_s, ns, state, wi, ls, alive, sort_perm=None):
    """Shadow-tested NEE contribution at a surface vertex -> (contrib (N,3)
    without beta, did_cast (N,) bool).  ``sort_perm``: the bounce's coherence
    sort, shared with the next depth's intersect (shadow rays start at the
    same hit points)."""
    n = p_s.shape[0]
    do_nee = alive & ls["valid"] & ~bxdf_mod.is_delta(state) & (ls["pdf"] > 0.0)
    so = offset_ray_origin(p_s, face_forward(ns, ls["wo"]))
    # lanes that cast no shadow ray get tmax = -1: every group culls them
    occluded = cscene.any_hit(
        so, ls["wo"].contiguous(), torch.zeros(n, device=p_s.device),
        torch.where(do_nee, ls["distance"] * (1.0 - 1e-3), -1.0), sort_perm=sort_perm,
    )
    f_l, pdf_l = bxdf_mod.f_and_pdf(state, wi, to_local(ns, ls["wo"]))
    cosine = dot(ls["wo"], ns).abs()
    mis_l = torch.where(ls["is_delta"], 1.0, balance_heuristic(ls["pdf"], pdf_l))
    contrib = ls["le"] * f_l * (cosine / torch.clamp_min(ls["pdf"], 1e-20) * mis_l)[:, None]
    return torch.where((do_nee & ~occluded)[:, None], contrib, 0.0), do_nee


def path_trace_sample(cscene, cp, xs, ys, W, H, sampler, sample_index, max_depth, nee=True):
    """One sample per pixel through the depth loop -> (L (N,3), traced rays)."""
    n = xs.shape[0]
    dev = xs.device
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)

    jitter = sampler.u2(xs, ys, sample_index, 0)
    u_lens = sampler.u2(xs, ys, sample_index, 2)
    wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
    p_film = (torch.stack([xs, ys], -1).to(torch.float32) + jitter) / wh
    ro, rd = camera_mod.gen_rays(cp, p_film, u_lens)
    ro, rd = ro.contiguous(), rd.contiguous()

    L_direct = torch.zeros(n, 3, device=dev)  # depth-0 emissive (unclamped)
    L_indirect = torch.zeros(n, 3, device=dev)  # everything else (clamped)
    beta = torch.ones(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)  # the camera vertex
    diffused = torch.zeros(n, dtype=torch.bool, device=dev)
    tmin = torch.zeros(n, device=dev)
    n_lights = len(cscene.lights)
    carry_perm = None  # depth 0 is not sorted: tile-major primaries are coherent

    for depth in range(max_depth):
        dim = 4 + depth * 16
        n_rays = n_rays + alive.sum()

        # dead lanes get tmax = -1 and miss every group box up front
        t, gidx, hitm, mesh_tri = cscene.intersect(
            ro, rd, tmin, torch.where(alive, FLOAT_MAX, -1.0), sort_perm=carry_perm)
        hitm = hitm & alive

        # clamp miss-lane t before forming hit points (t = BIG overflows)
        t_hit = torch.where(hitm, t, 1.0)
        hp = ro + t_hit[:, None] * rd
        p_s, ns, _uv = cscene.surface_info(gidx, hp, mesh_tri)
        wi_world = -rd

        # ---- emissive hit ----
        emis = cscene.is_emissive_lane(gidx) & hitm
        if cscene.emissive_globals:
            le = cscene.emissive_le(gidx, ns, wi_world)
            light_pdf = cscene.light_pdf_at_hit(gidx, ro, rd, t_hit, ns)
            mis = torch.where(prev_delta, 1.0, balance_heuristic(prev_pdf, light_pdf))
            contrib = torch.where(emis[:, None], beta * le * mis[:, None], 0.0)
            if depth == 0:
                L_direct = L_direct + contrib
            else:
                L_indirect = L_indirect + contrib

        alive = hitm & ~emis
        if depth + 1 >= max_depth:
            break

        # ---- material -> per-lane bxdf state ----
        mat_idx = cscene.g_mat[gidx.clamp(0, cscene.n_global - 1).long()]
        state = material_eval.eval_bxdf_state(cscene, mat_idx, MIN_ROUGHNESS, diffused)
        wi = to_local(ns, wi_world)

        # ---- BSDF sampling ----
        u_wm = sampler.u2(xs, ys, sample_index, dim + 5)
        u_fr = sampler.u1(xs, ys, sample_index, dim + 7)
        u_cos = sampler.u2(xs, ys, sample_index, dim + 8)
        bs = bxdf_mod.sample(state, wi, u_wm, u_fr, u_cos)
        wo_world = to_world(ns, bs["wo"])
        cosine = dot(wo_world, ns).abs()
        thr = bs["f"] * (cosine / torch.clamp_min(bs["pdf"], 1e-20))[:, None]
        surf_next = alive & bs["valid"]
        ro_next = offset_ray_origin(p_s, face_forward(ns, wo_world))
        carry_perm = cscene.sort_perm(ro_next, wo_world, ~surf_next)

        # ---- NEE ----
        if n_lights > 0 and nee:
            u_sel = sampler.u1(xs, ys, sample_index, dim + 0)
            u_light = sampler.u2(xs, ys, sample_index, dim + 1)
            ls = sample_one_light(cscene, p_s, u_sel, u_light)
            contrib, do_nee = nee_contribution(cscene, p_s, ns, state, wi, ls, alive,
                                               sort_perm=carry_perm)
            n_rays = n_rays + do_nee.sum()
            L_indirect = L_indirect + beta * contrib

        # ---- continuation ----
        alive = surf_next
        beta = torch.where(alive[:, None], beta * thr, beta)
        prev_pdf = bs["pdf"]
        prev_delta = bs["is_delta_sample"]
        diffused = diffused | (alive & ~bs["is_delta_sample"])
        ro, rd = ro_next.contiguous(), wo_world.contiguous()

    return L_direct + torch.clamp_max(L_indirect, CLAMP), n_rays
