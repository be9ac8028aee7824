"""MltIntegrator: primary-sample-space MLT with Kelemen mutations.
Counterpart of pine_tpu/integrators/mlt.py (parity: impl/integrator/
mlt.cpp:33-200, MltSampler sampler.h:203-273).

Chains are lanes: a (C, D) matrix of primary samples mutates in lockstep
(a large-step restart with probability P_LARGE, else a wrapped Gaussian
perturbation of every dim, the dense form of MltSampler's lazy per-dim
updates).  Each step evaluates every chain's path in one wavefront
(``mlt_radiance``) and splats both states into the film with Veach's
expected-value weights.  As in the reference, the chains carry only
indirect light (emission counted from path length 2, NEE from the second
vertex); a separate depth-2 pass of the path integrator adds the direct
light (mlt.cpp:102-113), and the chains' image is scaled by the bootstrap's
mean luminance over the mutations a pixel (mlt.cpp:100).

Media (mlt.cpp:118-141): homogeneous media give each segment its
transmittance and equiangular single scatter (``path.segment_medium_terms``,
dims from 4 + 16 max_depth + 24 depth - 10; the camera segment's in-scatter
belongs to the direct pass); grid media make first-class medium vertices
(``path.grid_vertices``), their tracking keyed by (chain, 0, 7000 + depth),
their NEE and phase draws in the same 24-dim block, so mutations perturb
them.

Sampler dims, pine_tpu's: 0,1 the film position, 2,3 the lens; per depth d
(base 4 + 16 d) +0 light selection, +1,+2 the light sample, +3,+4 the lobe
choices, +5..+9 the BSDF sample.  ``ArraySampler`` reads dim ``dim % D``.

The render loops over the steps in Python and reads nothing back inside the
loop.  The splats add into a float64 image, rounded to float32 once at the
end, and the bootstrap sums its luminance in float64: the order of the
card's atomic adds does not show.  The mutation's Box-Muller draw takes
core/fmath's log and cos (float64, rounded), so a mutated coordinate has
the same bits on the card and the CPU; a chain whose radiance differs in
the last bit between them can still decide its acceptance (u < a) the other
way, and from then on the two chains differ.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core import progress
from pine_tpu_torch.core import rng
from pine_tpu_torch.core.ray import offset_ray_origin
from pine_tpu_torch.core.sampling import balance_heuristic
from pine_tpu_torch.core.vecmath import dot, face_forward, to_local, to_world
from pine_tpu_torch.integrators.path import (FLOAT_MAX, MIN_ROUGHNESS, grid_vertices,
                                             nee_contribution, render_wavefront, sample_one_light,
                                             segment_medium_terms)
from pine_tpu_torch.scene import bxdf as bxdf_mod
from pine_tpu_torch.scene import material_eval

SIGMA = 0.02  # MltSampler(0.02, 0.02, 0) (mlt.cpp:10)
P_LARGE = 0.02
BOOTSTRAP_SAMPLES = 100_000


class ArraySampler:
    """Primary-sample-space sampler: u's come from the (N, D) matrix X."""

    def __init__(self, X):
        self.X = X
        self.spp = 1
        self.seed = 0

    def u1(self, px, py, sample_index, dim):
        return self.X[:, dim % self.X.shape[1]]

    def u2(self, px, py, sample_index, dim):
        D = self.X.shape[1]
        return torch.stack([self.X[:, dim % D], self.X[:, (dim + 1) % D]], -1)


def luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def sample_dims(cscene, max_depth):
    """D, the primary samples of a chain: 16 a depth past the camera's 4, and
    24 a depth more for the media terms in a scene with media."""
    has_media = bool(cscene.media or cscene.grid_media)
    return 4 + 16 * max_depth + (24 * max_depth if has_media else 0)


def mlt_radiance(cscene, cp, X, max_depth, omit_direct=True):
    """The path contribution of the primary-sample rows X (N, D) -> (L (N,3),
    the film positions (N,2), traced rays: the extension rays of the lanes
    alive at each depth and the NEE shadow rays cast, as path.py counts
    them)."""
    n, dev = X.shape[0], X.device
    sampler = ArraySampler(X)
    pfilm = X[:, 0:2]
    ro, rd = camera_mod.gen_rays(cp, pfilm, X[:, 2:4])
    ro, rd = ro.contiguous(), rd.contiguous()
    # the sampler ignores (xs, ys); the grid media's tracking keys do not: a
    # chain's index keeps its frozen tracking randomness its own
    xs = torch.arange(n, dtype=torch.int32, device=dev)
    ys = torch.zeros(n, dtype=torch.int32, device=dev)
    L = torch.zeros(n, 3, device=dev)
    beta = torch.ones(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    diffused = torch.zeros(n, dtype=torch.bool, device=dev)
    tmin = torch.zeros(n, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    has_media = bool(cscene.media or cscene.grid_media)
    n_lights = len(cscene.lights)
    for depth in range(max_depth):
        dim = 4 + depth * 16
        transports = (not omit_direct) or depth > 0  # NEE and in-scatter from this vertex
        count_emit = (not omit_direct) or depth > 1  # mlt.cpp:150,158
        n_rays = n_rays + alive.sum()
        t, gidx, hitm, mesh_tri = cscene.intersect(ro, rd, tmin,
                                                   torch.where(alive, FLOAT_MAX, -1.0))
        hitm = hitm & alive
        t_hit = torch.where(hitm, t, 1.0)
        mdim = 4 + max_depth * 16 + depth * 24
        if cscene.media:
            seg = torch.where(hitm, t, 1e8)
            if transports:
                seg_tr, seg_sc = segment_medium_terms(cscene, ro, rd, seg, alive, xs, ys, sampler,
                                                      0, mdim - 10, scatter_mask=alive & ~diffused)
                L = L + beta * seg_sc
            else:  # the camera segment's in-scatter is the direct pass's
                seg_tr = torch.where(alive[:, None],
                                     cscene.transmittance(ro, rd, seg, grid=False), 1.0)
            beta = beta * seg_tr

        med_scatter = torch.zeros(n, dtype=torch.bool, device=dev)
        med = None
        if cscene.grid_media and depth + 1 < max_depth:
            walk = SimpleNamespace(ro=ro, rd=rd, alive=alive)
            beta, L_med, med = grid_vertices(cscene, walk, t, hitm, beta, xs, ys, sampler, 0,
                                             7000 + depth, mdim + 15,
                                             mdim + 12 if transports else None)
            if transports:  # emission along the camera segment is direct light
                L = L + L_med
            alive, med_scatter = walk.alive, med["scatter"]

        if cscene.env_light is not None and count_emit:
            env = cscene.env_light
            mis = torch.where(prev_delta, 1.0, balance_heuristic(prev_pdf, env.pdf(rd)))
            L = L + torch.where((alive & ~hitm & ~med_scatter)[:, None],
                                beta * env.color(rd) * mis[:, None], 0.0)

        p_s, ns, uv = cscene.surface_info(gidx, ro + t_hit[:, None] * rd, mesh_tri)
        ctx = dict(p=p_s, n=ns, uv=uv)
        wi_world = -rd
        emis = cscene.is_emissive_lane(gidx) & hitm & ~med_scatter
        if cscene.emissive_globals and count_emit:
            le = cscene.emissive_le(gidx, ctx, wi_world)
            light_pdf = cscene.light_pdf_at_hit(gidx, ro, rd, t_hit, ns)
            mis = torch.where(prev_delta, 1.0, balance_heuristic(prev_pdf, light_pdf))
            L = L + torch.where(emis[:, None], beta * le * mis[:, None], 0.0)
        alive = (hitm & ~emis & ~med_scatter) | med_scatter
        surf = alive & ~med_scatter
        if depth + 1 >= max_depth:
            break

        mat_idx = cscene.g_mat[gidx.clamp(0, cscene.n_global - 1).long()]
        u_mat = sampler.u2(xs, ys, 0, dim + 3)
        state = material_eval.eval_bxdf_state(cscene, mat_idx, ctx, wi_world, u_mat[:, 0],
                                              u_mat[:, 1], MIN_ROUGHNESS, diffused)
        wi = to_local(ns, wi_world)
        if n_lights > 0 and transports:  # mlt.cpp:171 `!omit_direct || pv.length > 0`
            ls = sample_one_light(cscene, p_s, sampler.u1(xs, ys, 0, dim),
                                  sampler.u2(xs, ys, 0, dim + 1))
            contrib, do_nee = nee_contribution(cscene, p_s, ns, state, wi, ls, surf)
            L = L + beta * contrib
            n_rays = n_rays + do_nee.sum()
        bs = bxdf_mod.sample(state, wi, sampler.u2(xs, ys, 0, dim + 5),
                             sampler.u1(xs, ys, 0, dim + 7), sampler.u2(xs, ys, 0, dim + 8))
        wo_world = to_world(ns, bs["wo"])
        cosine = dot(wo_world, ns).abs()
        thr = bs["f"] * (cosine / torch.clamp_min(bs["pdf"], 1e-20))[:, None]
        surf = surf & bs["valid"]
        alive = surf | med_scatter
        beta = torch.where(surf[:, None], beta * thr, beta)
        prev_pdf = bs["pdf"]
        prev_delta = bs["is_delta_sample"]
        diffused = diffused | (surf & ~bs["is_delta_sample"])
        ro = offset_ray_origin(p_s, face_forward(ns, wo_world))
        rd = wo_world
        if med is not None:
            sc = med["scatter"]
            prev_pdf = torch.where(sc, med["pdf"], prev_pdf)
            prev_delta = prev_delta & ~sc
            ro = torch.where(sc[:, None], med["ro"], ro)
            rd = torch.where(sc[:, None], med["rd"], rd)
        tmin = torch.where(med_scatter, 1e-4, 0.0)
        ro, rd = ro.contiguous(), rd.contiguous()
    return L, pfilm, n_rays


def mutate(X, chain_ids, step, seed=0):
    """Kelemen mutation: a large-step restart with probability P_LARGE, else
    a wrapped Gaussian perturbation of every dim (sampler.h:218-222 and
    ensure_ready) -> (X', large (C,))."""
    C, D = X.shape
    u_large = rng.uniform(chain_ids, step, seed + 7919)
    large = u_large < P_LARGE
    ids = chain_ids[:, None]
    dims = torch.arange(D, device=X.device)[None, :]
    u1 = rng.uniform(ids, dims, step, seed + 104729)
    u2 = rng.uniform(ids, dims, step, seed + 1299709)
    r = fm.sqrt(-2.0 * fm.log(torch.clamp_min(u1, 1e-7)))  # Box-Muller
    g = r * fm.cos(2.0 * np.pi * u2)
    Xs = X + SIGMA * g
    Xs = Xs - torch.floor(Xs)  # torus wrap
    Xl = rng.uniform(ids, dims, step, seed + 15485863)
    return torch.where(large[:, None], Xl, Xs), large


def accept_prob(lum_new, lum_old):
    """Kelemen acceptance min(1, l'/l) with the reference's guards."""
    return torch.clamp_max(
        torch.where(lum_old > 0.0, lum_new / torch.clamp_min(lum_old, 1e-20), 1.0), 1.0)


def film_pixel(pfilm, W, H):
    """Row-major pixel index (N,) of film positions (N,2) in [0,1)^2."""
    px = (pfilm[:, 0] * W).to(torch.int32).clamp(0, W - 1)
    py = (pfilm[:, 1] * H).to(torch.int32).clamp(0, H - 1)
    return (py * W + px).long()


def mlt_step(cscene, cp, X, Lp, chain_ids, step, W, H, max_depth, seed=0):
    """One mutation step of every chain -> (X, Lp after it, the splats' pixel
    indices (2C,) and weights (2C,3): the current states weighted 1 - a, the
    proposals a, each over its luminance; accepted (C,), traced rays)."""
    Xn, _ = mutate(X, chain_ids, step, seed)
    Ln, pfn, rays = mlt_radiance(cscene, cp, Xn, max_depth, True)
    lp, ln = luminance(Lp), luminance(Ln)
    a = accept_prob(ln, lp)
    w_old = torch.where((lp > 1e-6)[:, None],
                        Lp / torch.clamp_min(lp, 1e-20)[:, None] * (1.0 - a)[:, None], 0.0)
    w_new = torch.where((ln > 1e-6)[:, None],
                        Ln / torch.clamp_min(ln, 1e-20)[:, None] * a[:, None], 0.0)
    pix = torch.cat([film_pixel(X[:, 0:2], W, H), film_pixel(pfn, W, H)])
    acc = rng.uniform(chain_ids, step, seed + 999331) < a
    X = torch.where(acc[:, None], Xn, X)
    Lp = torch.where(acc[:, None], Ln, Lp)
    return X, Lp, pix, torch.cat([w_old, w_new]), acc, rays


class MltIntegrator:
    """PRL: MltIntegrator(avg_spp, max_path_length) (program_context.cpp:103);
    ``n_chains`` chains (4,096 by default)."""

    def __init__(self, avg_spp, max_path_length, n_chains=4096):
        if max_path_length <= 0:
            raise ValueError(
                f"`MltIntegrator` expect `max_path_length` to be positive, got {max_path_length}"
            )
        self.avg_spp = int(avg_spp)
        self.max_path_length = int(max_path_length)
        self.n_chains = int(n_chains)

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        cscene = scene.compile(device)
        film = cam.film
        img = render_mlt(cscene, cam, film.width, film.height, self.avg_spp,
                         self.max_path_length, self.n_chains)
        film.set_rgb(img)
        return film


def render_mlt(cscene, cam, W, H, avg_spp, max_depth, n_chains=4096, seed=0, return_stats=False):
    """Render and return the (H,W,3) radiance on the scene's device, seen by
    ``cam`` (None: the compiled scene's camera): the bootstrap over
    max(BOOTSTRAP_SAMPLES // C, 1) rounds of C uniform primary samples,
    max(W H avg_spp // C, 1) mutation steps of C chains, and the depth-2
    direct pass at BlueSampler(avg_spp).  With return_stats=True also
    returns {"traced_rays", "steps", "boot_rounds", "accepted": (steps, C)
    bool on the device, "seconds": bootstrap, chains and direct pass, each
    ending in a device synchronize}."""
    import time

    from pine_tpu_torch.core.samplers import BlueSampler

    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    D = sample_dims(cscene, max_depth)
    C = int(n_chains)
    steps = max(W * H * avg_spp // C, 1)
    boot_rounds = max(BOOTSTRAP_SAMPLES // C, 1)
    chain_ids = torch.arange(C, device=dev)
    ids, dims = chain_ids[:, None], torch.arange(D, device=dev)[None, :]
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync()
    # ---- bootstrap: I = E[lum(L(U))] over uniform primary samples
    I_sum = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(boot_rounds):
        L, _, r = mlt_radiance(cscene, cp, rng.uniform(ids, dims, i, seed + 31), max_depth, True)
        I_sum = I_sum + luminance(L).double().sum()
        rays = rays + r
    I_mean = (I_sum / (boot_rounds * C)).float()
    t1 = sync()

    # ---- chains
    X = rng.uniform(ids, dims, 0xC0FFEE, seed + 57)
    Lp, _, r = mlt_radiance(cscene, cp, X, max_depth, True)
    rays = rays + r
    img = torch.zeros(H * W, 3, dtype=torch.float64, device=dev)
    accepted = torch.empty(steps, C, dtype=torch.bool, device=dev) if return_stats else None
    for step in range(steps):
        X, Lp, pix, w, acc, r = mlt_step(cscene, cp, X, Lp, chain_ids, step, W, H, max_depth,
                                         seed)
        img.index_add_(0, pix, w.double())
        rays = rays + r
        if accepted is not None:
            accepted[step] = acc
        progress.set_progress((step + 1) / (steps + 1))
    # film.scale(I / avg_spp) with the actual mutation count
    actual_avg_spp = steps * C / (W * H)
    scale = (I_mean.double() / actual_avg_spp).float()
    img = img.float().reshape(H, W, 3) * scale
    t2 = sync()

    # ---- the separate direct-light pass (mlt.cpp:102-113): depth-2 plain path
    direct, st = render_wavefront(cscene, cam, W, H, BlueSampler(avg_spp), avg_spp, 2,
                                  return_stats=True)
    img = img + direct
    progress.set_progress(1.0)
    if not return_stats:
        return img
    t3 = sync()
    return img, dict(traced_rays=int(rays) + st["traced_rays"], steps=steps,
                     boot_rounds=boot_rounds, accepted=accepted,
                     seconds=dict(bootstrap=t1 - t0, chains=t2 - t1, direct=t3 - t2))
