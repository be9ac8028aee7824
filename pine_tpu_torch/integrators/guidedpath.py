"""GuidedPathIntegrator: "Practical Path Guiding".  Counterpart of
pine_tpu/integrators/guidedpath.py (parity: impl/integrator/guidedpath.cpp:
21-301, spatial_tree.h:30-355).

Per vertex (guidedpath.cpp:190-255): NEE, a dedicated BSDF ray for emissive
hits (MIS against the light's pdf), and a one-sample-MIS continuation that
picks the learned distribution (probability 0.5 after the first iteration)
or BSDF sampling.  The iterations double their spp (``iterative_scheme``);
each but the last trains the guide on its own samples, and the film blends
them by sample count, as pine_tpu does.

Two structures (``struct``, pine_tpu's PINE_GUIDE_STRUCT): "tree", the
reference's spatial octree of directional quadtrees (integrators/
guiding_tree.py), trained by adding flux along the quadtree path at a
footprint-jittered position, each iteration sampling the previous one's
frozen snapshot; the host refines it between iterations (one readback an
iteration).  "grid": the cached integrator's dense spatial grid, every cell
a DIR_RES x DIR_RES histogram over the equal-area square, trained within
the iteration.  Both mix in a uniform sphere (DEFENSIVE) and apply the
reference's uncompensated Russian roulette on low-pdf guided samples past
the second vertex (guidedpath.cpp:141-143), as pine_tpu does.

Media: homogeneous media give each segment its transmittance and
equiangular in-scatter (``path.segment_medium_terms``); a grid medium's
delta tracking (``path.grid_vertices``) makes first-class medium vertices
(guidedpath.cpp:126-165): NEE from them at weight 1, a guided-vs-phase
continuation from the guide at the medium point, whose flux trains it
there; an emissive grid adds its radiance to the segment.

Sampler dims, pine_tpu's: per depth d (base 4 + d*DIM_STRIDE) +0 light
selection, +1,+2 the light sample, +3,+4 the lobe choices, +5..+9 the
dedicated BSDF ray, +10 the branch pick, +11,+12 the guided sample, +13 the
defensive pick, +14..+18 the continuation's BSDF (or phase) sample, +19
the roulette, +20..+22 the training jitter; the homogeneous media's from
4 + depths*DIM_STRIDE + d*24; the grid media's tracking keyed by (pixel,
sample, 7300 + d), plus the medium's index.

Every sum whose order differs between the devices (the training adds, the
histograms' marginals and CDFs) is made in float64 and rounded to float32
(guiding_tree.scatter_sum), and every division by a constant divides by a
tensor (``_div``), so that the order of the card's atomic adds does not
show in the guide.  The card's guide still differs from the CPU's where a
lane's shading does in the last bit, and a tree whose quadrant that moves
across the 1 % split differs from then on.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core import progress
from pine_tpu_torch.core.ray import offset_ray_origin
from pine_tpu_torch.core.sampling import balance_heuristic
from pine_tpu_torch.core.vecmath import Pi, dot, face_forward, to_local, to_world
from pine_tpu_torch.integrators import guiding_tree as GT
from pine_tpu_torch.integrators.cachedpath import SpatialGrid
from pine_tpu_torch.integrators.path import (FLOAT_MAX, MIN_ROUGHNESS, grid_vertices,
                                             sample_one_light, segment_medium_terms)
from pine_tpu_torch.scene import bxdf as bxdf_mod
from pine_tpu_torch.scene import material_eval
from pine_tpu_torch.scene.materials import BX_REFR_DIELECTRIC, BX_REFRACTIVE

DIR_RES = 16  # the "grid" structure's histogram is DIR_RES x DIR_RES (phi x cos-theta)
DEFENSIVE = 0.125  # uniform-sphere mixture weight in the learned distribution
DIM_STRIDE = 24  # per-depth sampler dims (guided needs two BSDF draws)
STRUCTS = ("tree", "grid")


_DIVISORS = {}  # (constant, device) -> 0-d float32 tensor


def _div(x, c):
    """x / c with the constant c as a tensor on x's device: torch's CUDA
    division by a host scalar multiplies by its reciprocal, where the CPU
    divides."""
    d = _DIVISORS.get((c, x.device))
    if d is None:
        d = _DIVISORS[(c, x.device)] = torch.full((), c, dtype=torch.float32, device=x.device)
    return torch.div(x, d)


def dir_to_square(w):
    """Equal-area sphere -> unit square (sampling.h uniform_sphere inverse)."""
    phi = fm.atan2(w[:, 1], w[:, 0])
    u = _div(torch.where(phi < 0, phi + 2 * Pi, phi), 2 * Pi)
    v = (1.0 - w[:, 2]) * 0.5
    return torch.stack([torch.clamp(u, 0.0, 1.0 - 1e-6), torch.clamp(v, 0.0, 1.0 - 1e-6)], -1)


def square_to_dir(sq):
    phi = 2 * Pi * sq[..., 0]
    z = 1.0 - 2.0 * sq[..., 1]
    r = fm.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * fm.cos(phi), r * fm.sin(phi), z], -1)


def dir_bin(w):
    ij = torch.clamp((dir_to_square(w) * DIR_RES).long(), 0, DIR_RES - 1)
    return ij[:, 0] * DIR_RES + ij[:, 1]


def _rows(a, i):
    """a[k, i[k]] for each row k of a (N, M)."""
    return a.gather(1, i[:, None])[:, 0]


class DirectionalGuide:
    """(cells, D*D) flux histogram with two-level inverse-CDF sampling."""

    def __init__(self, grid: SpatialGrid):
        self.grid = grid

    def sample(self, hist_rows, u2, u_def):
        """hist_rows (N, D*D) per-lane cell histograms -> (wo, pdf, valid).
        With probability DEFENSIVE the direction is drawn uniformly over the
        sphere (pdf() mixes accordingly), so a badly trained histogram never
        makes unbounded weights."""
        n = hist_rows.shape[0]
        uniform_dir = square_to_dir(u2)
        h = hist_rows.reshape(n, DIR_RES, DIR_RES)
        marg64 = h.double().sum(2)  # (N, D) over phi rows
        total = marg64.sum(1).float()
        marg = marg64.float()
        valid = total > 0.0
        cdf_r = marg64.cumsum(1).float() / torch.clamp_min(total, 1e-20)[:, None]
        r = torch.clamp((u2[:, 0:1] > cdf_r).sum(1), 0, DIR_RES - 1)
        row = h.gather(1, r[:, None, None].expand(n, 1, DIR_RES))[:, 0, :]  # (N, D)
        row_sum = _rows(marg, r)
        cdf_c = row.double().cumsum(1).float() / torch.clamp_min(row_sum, 1e-20)[:, None]
        c = torch.clamp((u2[:, 1:2] > cdf_c).sum(1), 0, DIR_RES - 1)
        # jitter inside the bin from the CDF residuals
        cdf_r_lo = torch.where(r > 0, _rows(cdf_r, torch.clamp_min(r - 1, 0)), 0.0)
        cdf_r_hi = _rows(cdf_r, r)
        ju = (u2[:, 0] - cdf_r_lo) / torch.clamp_min(cdf_r_hi - cdf_r_lo, 1e-12)
        cdf_c_lo = torch.where(c > 0, _rows(cdf_c, torch.clamp_min(c - 1, 0)), 0.0)
        cdf_c_hi = _rows(cdf_c, c)
        jv = (u2[:, 1] - cdf_c_lo) / torch.clamp_min(cdf_c_hi - cdf_c_lo, 1e-12)
        sq = torch.stack([(r.float() + torch.clamp(ju, 0.0, 1.0 - 1e-6)) / DIR_RES,
                          (c.float() + torch.clamp(jv, 0.0, 1.0 - 1e-6)) / DIR_RES], -1)
        wo = torch.where((u_def < DEFENSIVE)[:, None], uniform_dir, square_to_dir(sq))
        pdf = self.pdf(hist_rows, wo)
        return wo, pdf, valid & (pdf > 0.0)

    def pdf(self, hist_rows, w):
        total = hist_rows.double().sum(1).float()
        p_bin = _rows(hist_rows, dir_bin(w))
        hist_pdf = torch.where(
            total > 0.0, _div(p_bin / torch.clamp_min(total, 1e-20) * (DIR_RES * DIR_RES), 4 * Pi),
            0.0)
        return (1.0 - DEFENSIVE) * hist_pdf + DEFENSIVE / (4 * Pi)


class TreeGuide:
    """The lookups over the adaptive arenas (guiding_tree.py); the arenas and
    both trees' depths travel in ``gstate`` (convert.guide_state), the
    bounds live here, on the device."""

    def __init__(self, gt, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.lo = torch.as_tensor(gt.lo, **f32)
        self.inv_diag = torch.as_tensor(gt.inv_diag, **f32)
        self.foot0 = float(gt.footprint0)
        self.clamp_lo = torch.as_tensor(gt.tight_lo, **f32)
        self.clamp_hi = torch.as_tensor(gt.tight_hi, **f32)

    def lookup(self, gstate, p):
        """-> (dtree root, spatial leaf, footprint) per lane."""
        return GT.stree_lookup(gstate["schild"], gstate["sdroot"], self.lo, self.inv_diag,
                               self.foot0, p, gstate["sdepth"])

    def lookup_train(self, gstate, p, foot, u3):
        """Footprint-jittered training lookup (spatial_tree.h add_sample)."""
        pj = torch.minimum(torch.maximum(p + foot[:, None] * (u3 - 0.5), self.clamp_lo),
                           self.clamp_hi)
        return self.lookup(gstate, pj)

    def sample(self, gstate, droot, u2, u_def):
        sq, _, tree_valid = GT.dtree_sample(gstate["dchild"], gstate["dflux"], droot, u2,
                                            gstate["ddepth"])
        use_uniform = u_def < DEFENSIVE
        wo = torch.where(use_uniform[:, None], square_to_dir(u2), square_to_dir(sq))
        pdf = self.pdf(gstate, droot, wo)
        return wo, pdf, (use_uniform | tree_valid) & (pdf > 0.0)

    def pdf(self, gstate, droot, w):
        pdf_sq = GT.dtree_pdf(gstate["dchild"], gstate["dflux"], droot, dir_to_square(w),
                              gstate["ddepth"])
        return _div((1.0 - DEFENSIVE) * pdf_sq, 4 * Pi) + DEFENSIVE / (4 * Pi)

    def add(self, gstate, droot, leaf, sq, flux, mask):
        gstate = dict(gstate)
        gstate["dcoll"] = GT.dtree_add(gstate["dcoll"], gstate["dchild"], droot, sq, flux, mask,
                                       gstate["ddepth"])
        gstate["scount"] = GT.scatter_sum(gstate["scount"], leaf, torch.ones_like(flux), mask)
        return gstate


class GuidedPathIntegrator:
    """PRL: GuidedPathIntegrator(sampler, max_path_length)
    (program_context.cpp:95-100).  ``struct`` "tree" (the default) or "grid"
    picks the guiding structure."""

    def __init__(self, sampler, max_path_length, max_axis_resolution=32, struct="tree"):
        if max_path_length <= 0:
            raise ValueError("`GuidedPathIntegrator` expect `max_path_length` to be positive, "
                             f"got {max_path_length}")
        if struct not in STRUCTS:
            raise ValueError(f"unknown guiding structure {struct!r}: one of {STRUCTS}")
        self.sampler = sampler
        self.max_path_length = int(max_path_length)
        self.max_axis_resolution = int(max_axis_resolution)
        self.struct = struct

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        cscene = scene.compile(device)
        film = cam.film
        img = render_guided(cscene, cam, film.width, film.height, self.sampler, self.sampler.spp,
                            self.max_path_length, scene.get_aabb(), self.max_axis_resolution,
                            self.struct)
        film.set_rgb(img)
        return film


def iterative_scheme(spp, batch_size=1):
    """spp-doubling iteration plan (guidedpath.cpp IterativeScheme)."""
    iters = []
    current, iter_spp, i = 0, 2, 0
    while True:
        next_spp = iter_spp * 2 if (i + 1) % batch_size == 0 else iter_spp
        remaining = spp - current
        final = iter_spp + next_spp // 4 > remaining
        if final:
            iter_spp = max(remaining, 1)
        iters.append(dict(number=i, sample_index=current, spp=iter_spp, is_final=final))
        if final:
            break
        current += iter_spp
        iter_spp = next_spp
        i += 1
    return iters


def render_guided(cscene, cam, W, H, sampler, spp, max_depth, bounds, max_axis_resolution=32,
                  struct="tree", return_stats=False):
    """Render and return the (H,W,3) radiance on the scene's device, seen by
    ``cam`` (None: the compiled scene's camera).  ``bounds`` (lo, hi) is the
    scene's box; the guide covers it and every medium's.  With
    return_stats=True also returns ``_render_guided``'s stats."""
    img, stats, _ = _render_guided(cscene, cam, W, H, sampler, spp, max_depth, bounds,
                                   max_axis_resolution, struct)
    return (img, stats) if return_stats else img


def new_guide(cscene, bounds, n, struct="tree", max_axis_resolution=32):
    """A fresh guide for a film of ``n`` pixels on the scene's device ->
    (the host GuidingTree, or None for the grid; the guide; its state).
    ``bounds`` (lo, hi) is the scene's box; the guide covers it and every
    medium's (medium vertices are guided too, guidedpath.cpp:136, and a
    medium can reach past the geometry)."""
    if struct not in STRUCTS:
        raise ValueError(f"unknown guiding structure {struct!r}: one of {STRUCTS}")
    dev = cscene.device
    lo, hi = (np.asarray(b, np.float32) for b in bounds)
    for med in list(cscene.grid_media) + list(cscene.media):
        mlo, mhi = med.get_aabb()
        lo = np.minimum(lo, np.asarray(mlo, np.float32))
        hi = np.maximum(hi, np.asarray(mhi, np.float32))
    if struct == "tree":
        # guidedpath.cpp:72-75: initial_samples = n_pixels, spatial_k = 4000
        gt = GT.GuidingTree(lo, hi, n_initial_samples=n, spatial_k=4000)
        return gt, TreeGuide(gt, dev), gt.device_state(dev)
    guide = DirectionalGuide(SpatialGrid(lo, hi, max_axis_resolution, dev))
    return None, guide, {"hist": torch.zeros(guide.grid.n_cells(), DIR_RES * DIR_RES,
                                             device=dev)}


def refine_threshold(n, iter_spp):
    """The spatial split threshold after an iteration of ``iter_spp`` samples
    of ``n`` pixels (guidedpath.cpp:113: spatial_ratio * sqrt(spp * n))."""
    return max(4000.0 / float(np.sqrt(n)), 1.0) * float(np.sqrt(iter_spp * n))


def film_lanes(W, H, device):
    """(xs, ys) int32 of every pixel in row order."""
    ys, xs = np.divmod(np.arange(W * H, dtype=np.int64), W)
    return (torch.as_tensor(xs, dtype=torch.int32, device=device),
            torch.as_tensor(ys, dtype=torch.int32, device=device))


def run_iteration(cscene, cp, xs, ys, W, H, sampler, it, max_depth, guide, gstate,
                  on_sample=None):
    """One iteration of ``iterative_scheme`` -> (its mean radiance (N,3), its
    outlier-rejected variance, the guide state with its training, traced
    rays).  ``on_sample()`` runs after each sample."""
    n = xs.shape[0]
    prob_a = 0.5 if it["number"] > 0 else 0.0
    iter_spp = it["spp"]
    acc = torch.zeros(n, 3, device=xs.device)
    acc2 = torch.zeros(n, 3, device=xs.device)
    rays = torch.zeros((), dtype=torch.int64, device=xs.device)
    for i in range(iter_spp):
        L, gstate, r = _trace_guided(cscene, cp, xs, ys, W, H, sampler, it["sample_index"] + i,
                                     max_depth, guide, gstate, prob_a, not it["is_final"])
        acc = acc + L
        acc2 = acc2 + L * L
        rays = rays + r
        if on_sample is not None:
            on_sample()
    inv = 1.0 / iter_spp
    var = _div(acc2 - acc * acc * inv, max(iter_spp - 1, 1)) * inv
    # outlier-rejected variance (guidedpath.cpp:292-298)
    v = _div(var[:, 0] + var[:, 1] + var[:, 2], 3.0)
    var_mean = torch.sort(v).values[:int(n * (1.0 - 1e-5))].double().mean().float()
    return acc * inv, var_mean, gstate, rays


def _render_guided(cscene, cam, W, H, sampler, spp, max_depth, bounds, max_axis_resolution=32,
                   struct="tree", keep_arenas=False):
    """render_guided -> (image, stats, the trained guide: the GuidingTree, or
    the "grid" structure's histogram).  stats: ``traced_rays`` (extension
    rays of the lanes alive at each depth, the dedicated BSDF rays and the
    NEE shadow rays cast) and per iteration its spp, ``seconds`` (ending in
    a device synchronize), and for the tree the host ms of the readback,
    ``absorb``, the refinement, ``_export`` and the upload, and the spatial
    leaves, quadtree nodes and depths after it; with ``keep_arenas``, under
    ``arenas``, the guide's arrays (numpy) after each training iteration:
    the collector and sample counts as the iteration left them, then the
    refined tree's arenas (tree), or the histogram (grid)."""
    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    n = W * H
    gt, guide, gstate = new_guide(cscene, bounds, n, struct, max_axis_resolution)
    xs, ys = film_lanes(W, H, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def step():
        step.done += 1
        progress.set_progress(step.done / max(spp, 1))

    step.done = 0
    stats = dict(traced_rays=0, iterations=[])
    if keep_arenas:
        stats["arenas"] = []
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    acc_I = torch.zeros(n, 3, device=dev)
    acc_w = torch.zeros((), device=dev)
    t_start = sync()
    for it in iterative_scheme(spp):
        t0 = time.perf_counter()
        train = not it["is_final"]
        I, var_mean, gstate, r = run_iteration(cscene, cp, xs, ys, W, H, sampler, it, max_depth,
                                               guide, gstate, step)
        rays = rays + r
        rec = dict(spp=it["spp"], seconds=sync() - t0)
        if train and keep_arenas:
            stats["arenas"].append({k: v.cpu().numpy() for k, v in gstate.items()
                                    if torch.is_tensor(v) and k in ("dcoll", "scount", "hist")})
        if gt is not None and train:
            # one readback an iteration, then the host's refinement and a
            # fresh export and upload
            t = [time.perf_counter()]
            dcoll, scount = gstate["dcoll"].cpu().numpy(), gstate["scount"].cpu().numpy()
            t.append(time.perf_counter())
            gt.absorb(dcoll, scount)
            t.append(time.perf_counter())
            gt._refine_node(gt.root, refine_threshold(n, it["spp"]))
            t.append(time.perf_counter())
            gt._export()
            t.append(time.perf_counter())
            gstate = gt.device_state(dev)
            t.append(sync())
            rec.update({f"{k}_ms": (b - a) * 1e3 for k, a, b in zip(
                ("readback", "absorb", "refine", "export", "upload"), t, t[1:])},
                spatial_leaves=gt.n_spatial_leaves(), quadtree_nodes=gt.n_quadtree_nodes(),
                sdepth=gt.sdepth, ddepth=gt.ddepth)
            if keep_arenas:
                stats["arenas"][-1].update(
                    {f"refined.{k}": v for k, v in gt.arrays().items() if k in GT.TREE_KEYS})
        stats["iterations"].append(rec)
        # Deviation from guidedpath.cpp:105-110 (pine_tpu's): the iterations
        # blend by sample count, not inverse variance; the variance only
        # carries a non-finite value into the weight, as in pine_tpu
        w = it["spp"] + 0.0 * var_mean
        acc_I = (acc_I * acc_w + I * w) / torch.clamp_min(acc_w + w, 1e-20)
        acc_w = acc_w + w
    stats["traced_rays"] = int(rays)
    stats["seconds"] = sync() - t_start
    return acc_I.reshape(H, W, 3), stats, gt if gt is not None else gstate["hist"]


def _trace_guided(cscene, cp, xs, ys, W, H, sampler, sample_index, max_depth, guide, gstate,
                  prob_a, train):
    """One sample per lane -> (L (N,3), the guide state with this sample's
    training added when ``train``, traced rays)."""
    tree_mode = isinstance(guide, TreeGuide)
    n, dev = xs.shape[0], xs.device
    jitter = sampler.u2(xs, ys, sample_index, 0)
    u_lens = sampler.u2(xs, ys, sample_index, 2)
    wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
    p_film = (torch.stack([xs, ys], -1).to(torch.float32) + jitter) / wh
    ro, rd = camera_mod.gen_rays(cp, p_film, u_lens)
    ro, rd = ro.contiguous(), rd.contiguous()  # the kernels take contiguous rays

    alive = torch.ones(n, dtype=torch.bool, device=dev)
    diffused = torch.zeros(n, dtype=torch.bool, device=dev)
    tmin = torch.zeros(n, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    n_lights = len(cscene.lights)
    env = cscene.env_light
    has_media = bool(cscene.media or cscene.grid_media)

    depths = max_depth - 1
    zero3, one3 = torch.zeros(n, 3, device=dev), torch.ones(n, 3, device=dev)
    rec_nee, rec_bsemis, rec_thr = [zero3] * depths, [zero3] * depths, [zero3] * depths
    rec_cell, rec_bin, rec_leaf, rec_sq = [None] * depths, [None] * depths, [None] * depths, \
        [None] * depths
    rec_w, rec_valid = [None] * depths, [None] * depths
    # the homogeneous media's terms of the segment INTO vertex d (d = 0: the
    # camera ray): transmittance and equiangular in-scatter
    seg_tr, seg_sc = [one3] * depths, [zero3] * depths
    L0 = zero3

    for depth in range(depths):
        dim = 4 + depth * DIM_STRIDE
        n_rays = n_rays + alive.sum()
        t, gidx, hitm, mesh_tri = cscene.intersect(ro, rd, tmin,
                                                   torch.where(alive, FLOAT_MAX, -1.0))
        hitm = hitm & alive
        t_hit = torch.where(hitm, t, 1.0)
        if cscene.media:
            seg_tr[depth], seg_sc[depth] = segment_medium_terms(
                cscene, ro, rd, torch.where(hitm, t, 1e8), alive, xs, ys, sampler, sample_index,
                4 + depths * DIM_STRIDE + depth * 24 - 10, scatter_mask=alive & ~diffused)

        # grid media: delta-tracked first-class medium vertices
        # (guidedpath.cpp:126-165); the continuation's phase sample takes the
        # BSDF continuation's dims (the events exclude each other)
        med = None
        med_scatter = torch.zeros(n, dtype=torch.bool, device=dev)
        if cscene.grid_media:
            seg = SimpleNamespace(ro=ro, rd=rd, alive=alive)
            _, le_m, med = grid_vertices(cscene, seg, t, hitm, None, xs, ys, sampler,
                                         sample_index, 7300 + depth, dim + 14)
            alive = seg.alive  # less the absorbed lanes
            seg_sc[depth] = seg_sc[depth] + le_m
            med_scatter = med["scatter"]

        # env / emissive only on the camera ray (guidedpath.cpp:168-176),
        # through the camera segment's media
        if depth == 0 and env is not None:
            L0 = L0 + torch.where((alive & ~hitm & ~med_scatter)[:, None],
                                  env.color(rd) * seg_tr[0], 0.0)
        p_s, ns, uv = cscene.surface_info(gidx, ro + t_hit[:, None] * rd, mesh_tri)
        ctx = dict(p=p_s, n=ns, uv=uv)
        wi_world = -rd
        emis = cscene.is_emissive_lane(gidx) & hitm & ~med_scatter
        if depth == 0 and cscene.emissive_globals:
            le = cscene.emissive_le(gidx, ctx, wi_world)
            L0 = L0 + torch.where(emis[:, None], le * seg_tr[0], 0.0)

        alive = (hitm & ~emis & ~med_scatter) | med_scatter
        surf = alive & ~med_scatter
        at_med = med_scatter[:, None]
        pv = p_s if med is None else torch.where(at_med, med["ro"], p_s)  # the vertex

        mat_idx = cscene.g_mat[gidx.clamp(0, cscene.n_global - 1).long()]
        u_mat = sampler.u2(xs, ys, sample_index, dim + 3)
        state = material_eval.eval_bxdf_state(cscene, mat_idx, ctx, wi_world, u_mat[:, 0],
                                              u_mat[:, 1], MIN_ROUGHNESS, diffused)
        wi = to_local(ns, wi_world)
        bxdf_delta = bxdf_mod.is_delta(state)

        # NEE: one light sample and one shadow ray for both vertex kinds
        if n_lights > 0:
            ls = sample_one_light(cscene, pv, sampler.u1(xs, ys, sample_index, dim + 0),
                                  sampler.u2(xs, ys, sample_index, dim + 1))
            do_s = surf & ls["valid"] & ~bxdf_delta & (ls["pdf"] > 0.0)
            do_m = med_scatter & ls["valid"] & (ls["pdf"] > 0.0)
            go = do_s | do_m
            wo_l = ls["wo"].contiguous()
            so = torch.where(at_med, pv, offset_ray_origin(p_s, face_forward(ns, wo_l)))
            occluded = cscene.any_hit(so.contiguous(), wo_l, torch.where(med_scatter, 1e-4, 0.0),
                                      torch.where(go, ls["distance"] * (1.0 - 1e-3), -1.0))
            n_rays = n_rays + go.sum()
            f_l, pdf_l = bxdf_mod.f_and_pdf(state, wi, to_local(ns, wo_l))
            mis_l = torch.where(ls["is_delta"], 1.0, balance_heuristic(ls["pdf"], pdf_l))
            pdf_safe = torch.clamp_min(ls["pdf"], 1e-20)
            contrib = ls["le"] * f_l * (dot(wo_l, ns).abs() / pdf_safe * mis_l)[:, None]
            if med is not None:
                # a medium vertex: the phase function, weight 1 (no MIS: its
                # continuation gathers no le, guidedpath.cpp:129-134)
                cos_pm = dot(-rd, wo_l)
                f_pm = torch.zeros(n, device=dev)
                for m, pf in med["masks"]:
                    f_pm = torch.where(m, pf.p(cos_pm), f_pm)
                contrib = torch.where(at_med, med["w"] * ls["le"] * (f_pm / pdf_safe)[:, None],
                                      contrib)
            if has_media:
                contrib = contrib * cscene.transmittance(so, wo_l,
                                                         torch.where(go, ls["distance"], -1.0))
            rec_nee[depth] = torch.where((go & ~occluded)[:, None], contrib, 0.0)

        # the dedicated BSDF ray for emissive hits (guidedpath.cpp:212-239)
        bs = bxdf_mod.sample(state, wi, sampler.u2(xs, ys, sample_index, dim + 5),
                             sampler.u1(xs, ys, sample_index, dim + 7),
                             sampler.u2(xs, ys, sample_index, dim + 8))
        bs_wo = to_world(ns, bs["wo"]).contiguous()
        bs_o = offset_ray_origin(p_s, face_forward(ns, bs_wo)).contiguous()
        b_go = surf & bs["valid"]
        n_rays = n_rays + b_go.sum()
        bt, bgidx, bhit, bmesh = cscene.intersect(bs_o, bs_wo, torch.zeros(n, device=dev),
                                                  torch.where(b_go, FLOAT_MAX, -1.0))
        bt_hit = torch.where(bhit, bt, 1.0)
        bs_cos, bs_pdf = dot(bs_wo, ns).abs(), torch.clamp_min(bs["pdf"], 1e-20)
        b_tr = (cscene.transmittance(bs_o, bs_wo, torch.where(b_go, torch.where(bhit, bt, 1e8),
                                                             -1.0))
                if has_media else one3)
        bsemis = zero3
        if cscene.emissive_globals:
            bp, bn, buv = cscene.surface_info(bgidx, bs_o + bt_hit[:, None] * bs_wo, bmesh)
            b_emis = cscene.is_emissive_lane(bgidx) & bhit
            ble = cscene.emissive_le(bgidx, dict(p=bp, n=bn, uv=buv), -bs_wo)
            blpdf = cscene.light_pdf_at_hit(bgidx, bs_o, bs_wo, bt_hit, bn)
            bmis = torch.where(bxdf_delta, 1.0, balance_heuristic(bs["pdf"], blpdf))
            bsemis = bsemis + torch.where(
                b_emis[:, None], ble * b_tr * (bs_cos * bmis / bs_pdf)[:, None] * bs["f"], 0.0)
        if env is not None:
            emis_env = torch.where(bxdf_delta, 1.0, balance_heuristic(bs["pdf"], env.pdf(bs_wo)))
            bsemis = bsemis + torch.where((~bhit)[:, None], env.color(bs_wo) * b_tr
                                          * (bs_cos * emis_env / bs_pdf)[:, None] * bs["f"], 0.0)
        rec_bsemis[depth] = torch.where(b_go[:, None], bsemis, 0.0)

        # the one-sample-MIS continuation: guided against BSDF (or phase)
        u_pick = sampler.u1(xs, ys, sample_index, dim + 10)
        u_guide = sampler.u2(xs, ys, sample_index, dim + 11)
        u_def = sampler.u1(xs, ys, sample_index, dim + 13)
        # the guide at the VERTEX: the medium point for medium lanes
        # (guidedpath.cpp:136 guide.traverse(mit->p))
        if tree_mode:
            droot, _, foot = guide.lookup(gstate, pv)
            g_wo, g_pdf, g_valid = guide.sample(gstate, droot, u_guide, u_def)
        else:
            cell = guide.grid.cell_of(pv).long()
            hist_rows = gstate["hist"][cell]
            g_wo, g_pdf, g_valid = guide.sample(hist_rows, u_guide, u_def)
        if depth > 1:
            # the reference's uncompensated roulette on low-pdf guided samples
            u_rr = sampler.u1(xs, ys, sample_index, dim + 19)
            rr = torch.clamp_min(g_pdf, 0.05)
            g_valid = g_valid & ((rr >= 1.0) | (u_rr < rr))
        # guide only lobes whose f stays bounded at arbitrary directions
        # (rough transmission has a 1/(cos_i cos_t) singularity); medium
        # lanes always mix guided with phase sampling
        transmissive = (state["tag"] == BX_REFRACTIVE) | (state["tag"] == BX_REFR_DIELECTRIC)
        pa = torch.where((bxdf_delta | transmissive) & ~med_scatter, 0.0, prob_a)
        chose_guided = u_pick < pa  # a failed guided sample wastes the path
        use_guide = chose_guided & g_valid

        # the second, independent BSDF sample for the continuation
        bs2 = bxdf_mod.sample(state, wi, sampler.u2(xs, ys, sample_index, dim + 14),
                              sampler.u1(xs, ys, sample_index, dim + 16),
                              sampler.u2(xs, ys, sample_index, dim + 17))
        alt_wo, alt_pdf, alt_valid = to_world(ns, bs2["wo"]), bs2["pdf"], bs2["valid"]
        if med is not None:  # the medium's alternative: its phase sample
            alt_wo = torch.where(at_med, med["rd"], alt_wo)
            alt_pdf = torch.where(med_scatter, med["pdf"], alt_pdf)
            alt_valid = torch.where(med_scatter, med["pdf"] > 0.0, alt_valid)

        wo_world = torch.where(use_guide[:, None], g_wo, alt_wo).contiguous()
        f_g, pdf_b_at = bxdf_mod.f_and_pdf(state, wi, to_local(ns, wo_world))
        cosine = dot(wo_world, ns).abs()
        alt_pdf_at = pdf_b_at
        if med is not None:
            # the phase value equals its pdf at the chosen direction
            cos_ph = dot(-rd, wo_world)
            f_ph = torch.zeros(n, device=dev)
            for m, pf in med["masks"]:
                f_ph = torch.where(m, pf.p(cos_ph), f_ph)
            cosine = torch.where(med_scatter, 1.0, cosine)
            alt_pdf_at = torch.where(med_scatter, f_ph, pdf_b_at)
        if tree_mode:
            guide_pdf_at = guide.pdf(gstate, droot, wo_world)
        else:
            guide_pdf_at = guide.pdf(hist_rows, wo_world)

        # guided branch weight: f cos / g_pdf * mis / pa
        mis_g = balance_heuristic(pa * g_pdf, (1 - pa) * alt_pdf_at)
        w_g = cosine * mis_g / torch.clamp_min(g_pdf, 1e-20) / torch.clamp_min(pa, 1e-6)
        # alternative (BSDF or phase) branch weight
        mis_b = torch.where(bxdf_delta & ~med_scatter, 1.0,
                            balance_heuristic((1 - pa) * alt_pdf, pa * guide_pdf_at))
        w_b = cosine * mis_b / torch.clamp_min(alt_pdf, 1e-20) / torch.clamp_min(1 - pa, 1e-6)
        thr_g, thr_b = f_g * w_g[:, None], bs2["f"] * w_b[:, None]
        if med is not None:
            # the chromatic tracking weight scales the medium vertex's
            # contribution, not its training flux (guidedpath.cpp:148,161)
            thr_g = torch.where(at_med, f_ph[:, None] * w_g[:, None], thr_g)
            thr_b = torch.where(at_med, f_ph[:, None] * w_b[:, None], thr_b)
        thr = torch.where(use_guide[:, None], thr_g, thr_b)
        if med is not None:
            thr = torch.where(at_med, med["w"] * thr, thr)
        cont_valid = torch.where(chose_guided, g_valid, alt_valid) & alive
        rec_thr[depth] = torch.where(cont_valid[:, None], thr, 0.0)
        if train:
            w_train = torch.where(use_guide, w_g, w_b) / torch.clamp_min(cosine, 1e-6)
            if tree_mode:
                # the training flux lands at a footprint-jittered position
                # (spatial_tree.h:331-336 add_sample)
                u3 = torch.cat([sampler.u2(xs, ys, sample_index, dim + 20),
                                sampler.u1(xs, ys, sample_index, dim + 22)[:, None]], 1)
                rec_cell[depth], rec_leaf[depth], _ = guide.lookup_train(gstate, pv, foot, u3)
                rec_sq[depth] = dir_to_square(wo_world)
            else:
                rec_cell[depth], rec_bin[depth] = cell, dir_bin(wo_world)
            rec_w[depth] = torch.where(cont_valid & ~(bxdf_delta & ~med_scatter & ~use_guide),
                                       w_train, 0.0)
        rec_valid[depth] = alive

        alive = cont_valid
        diffused = diffused | (alive & ~med_scatter & ~bs2["is_delta_sample"])
        ro = torch.where(at_med, pv, offset_ray_origin(p_s, face_forward(ns, wo_world)))
        ro = ro.contiguous()
        rd = wo_world
        tmin = torch.where(med_scatter, 1e-4, 0.0)

    # the reverse sweep: each vertex's incident radiance and training flux
    Li_next = zero3  # radiance leaving vertex d+1
    gstate = dict(gstate)
    for d in range(depths - 1, -1, -1):
        # what arrives at vertex d along its continuation: the next segment's
        # in-scatter plus its transmittance times the next vertex's radiance
        lo_next = seg_sc[d + 1] + seg_tr[d + 1] * Li_next if d + 1 < depths else Li_next
        if train:  # flux: avg(Li_{d+1}) * w (guidedpath.cpp:238,251)
            flux = _div(lo_next[:, 0] + lo_next[:, 1] + lo_next[:, 2], 3.0) * rec_w[d]
            if tree_mode:
                # every recorded sample counts (spatial_tree.h:335 n_samples)
                gstate = guide.add(gstate, rec_cell[d], rec_leaf[d], rec_sq[d], flux,
                                   rec_valid[d] & (rec_w[d] > 0.0))
            else:
                hist = gstate["hist"]
                gstate["hist"] = GT.scatter_sum(
                    hist.reshape(-1), rec_cell[d] * (DIR_RES * DIR_RES) + rec_bin[d], flux,
                    rec_valid[d] & (flux > 0.0)).reshape(hist.shape)
        Li_next = rec_nee[d] + rec_bsemis[d] + rec_thr[d] * lo_next
    if depths > 0:
        # the camera segment: its in-scatter reaches the film unconditionally;
        # the first vertex's radiance arrives through its transmittance
        L = L0 + seg_sc[0] + seg_tr[0] * torch.where(rec_valid[0][:, None], Li_next, 0.0)
    else:
        L = L0
    return L, gstate, n_rays
