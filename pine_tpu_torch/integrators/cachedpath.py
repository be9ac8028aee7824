"""CachedPathIntegrator: path tracing that ends in a radiance cache on a dense
spatial grid.  Counterpart of pine_tpu/integrators/cachedpath.py (parity:
impl/integrator/cachedpath.cpp).

Two phases over the whole film (cachedpath.cpp:105-133):

- **learning** (spp/4 samples): plain path tracing; the outgoing radiance
  ``lo`` of every surface vertex is added into the grid cell of its hit.
  Each vertex's ``lo`` comes from a reverse sweep over per-depth records:
  lo_v = nee_v + thr_v * (emit_{v+1} + lo_{v+1});
- **render** (spp samples): the same walk, but at a vertex of depth >=
  ``starting_depth`` reached by a non-delta bounce the path ends in a
  lookup of the cache at a jittered cell (cachedpath.cpp:168-170).  No
  firefly clamp, as in the reference.

The sums into the cache are ``index_add_``: on the card they are atomic
adds, so their order, and the last bits of a cell's mean, vary from run to
run; the card's render is held to the CPU's by the render-parity rule (97 %
of pixels), like every other render, whose transcendental functions differ
between the two devices anyway.  The walk's sampler dims are pine_tpu's
(``integrators/path.py`` schedule; +10..+12 the cache lookup's jitter).
Lanes run in the path integrator's tile order (per-pixel values do not
depend on it), in chunks of DEFAULT_CHUNK; on the card, heavy scenes sort
each bounce's rays as the path integrator does.  A ray that escapes takes
the environment light's radiance, MIS-weighted, as it arrives along the
segment (cachedpath.cpp; pine_tpu's cachedpath.py:332-336, 464-468).  As
pine_tpu's, this integrator takes no subsurface walk: a Subsurface lane
keeps its BSSRDF lobe at the entry vertex.

Media, pine_tpu's branches: each segment takes the homogeneous media's
transmittance and single scatter (``path.segment_medium_terms``, before the
first diffuse bounce), and the grid media make medium vertices of their own
(``path.grid_vertices``): NEE from them, MIS against the phase function, and
a phase-sampled continuation.  Medium vertices are never binned into the
cache and never end in it.  Their sampler dims lie past every depth's
(base 4 + max_depth*16 + d*24).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from pine_tpu_torch.core import progress
from pine_tpu_torch.integrators.path import (DEFAULT_CHUNK, PathWalk, _medium_nee,
                                             grid_vertices, segment_medium_terms, tile_order)


class SpatialGrid:
    """Dense (X,Y,Z) grid of cells over the box (lo, hi), ``max_axis_resolution``
    cells along its longest axis (cachedpath.cpp SpatialTree)."""

    def __init__(self, lo, hi, max_axis_resolution, device):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        diag = np.maximum(hi - lo, 1e-6)
        res = np.maximum((max_axis_resolution * diag / diag.max()).astype(np.int32), 1)
        self.res = tuple(int(r) for r in res)
        f32 = dict(dtype=torch.float32, device=device)
        self.lo = torch.as_tensor(lo - 1e-4, **f32)
        self.inv_diag = torch.as_tensor(1.0 / (diag + 2e-4), **f32)
        self.res_f = torch.as_tensor(res.astype(np.float32), **f32)
        self.res_max = torch.as_tensor(res - 1, dtype=torch.int32, device=device)
        self.tight_lo = torch.as_tensor(lo, **f32)
        self.tight_hi = torch.as_tensor(hi, **f32)
        self.cell_size = torch.as_tensor((diag / res).astype(np.float32), **f32)

    def n_cells(self):
        return self.res[0] * self.res[1] * self.res[2]

    def cell_of(self, p):
        rel = (p - self.lo) * self.inv_diag
        ijk = torch.minimum(torch.clamp_min((rel * self.res_f).to(torch.int32), 0), self.res_max)
        return (ijk[:, 0] * self.res[1] + ijk[:, 1]) * self.res[2] + ijk[:, 2]

    def jittered_cell_of(self, p, u3):
        """flux_estimate's jittered lookup (cachedpath.cpp:37-41)."""
        p = p + (u3 - 0.5) * self.cell_size
        return self.cell_of(torch.minimum(torch.maximum(p, self.tight_lo), self.tight_hi))


class CachedPathIntegrator:
    """PRL: CachedPathIntegrator(sampler, max_path_length[, max_axis_resolution
    [, starting_depth]]) (program_context.cpp:83-93)."""

    def __init__(self, sampler, max_path_length, max_axis_resolution=128, starting_depth=1):
        if max_path_length <= 0:
            raise ValueError("`CachedPathIntegrator` expect `max_path_length` to be positive, "
                             f"got {max_path_length}")
        if max_axis_resolution <= 0:
            raise ValueError("`CachedPathIntegrator` expect `max_axis_resolution` to be "
                             f"positive, got {max_axis_resolution}")
        if starting_depth < 0:
            raise ValueError("`CachedPathIntegrator` expect `starting_depth` to be "
                             f"non-negative, got {starting_depth}")
        self.sampler = sampler
        self.max_path_length = int(max_path_length)
        self.max_axis_resolution = int(max_axis_resolution)
        self.starting_depth = int(starting_depth)

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        cscene = scene.compile(device)
        film = cam.film
        img = render_cached(cscene, cam, film.width, film.height, self.sampler,
                            self.sampler.spp, self.max_path_length, scene.get_aabb(),
                            self.max_axis_resolution, self.starting_depth)
        film.set_rgb(img)
        return film


def render_cached(cscene, cam, W, H, sampler, spp, max_depth, bounds, max_axis_resolution=128,
                  starting_depth=1, chunk=None, return_stats=False):
    """Render and return the (H,W,3) mean radiance on the scene's device,
    seen by ``cam`` (None: the compiled scene's camera).  ``bounds`` (lo, hi)
    is the scene's box, which the cache's grid covers.
    With return_stats=True also returns {"traced_rays", "learn_s",
    "render_s"}: the extension and NEE shadow rays of both phases, and each
    phase's wall (ending in a device synchronize)."""
    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    grid = SpatialGrid(*bounds, max_axis_resolution, dev)
    n = W * H
    chunk = min(n, DEFAULT_CHUNK) if chunk is None else int(chunk)
    perm = tile_order(W, H)
    ys_all, xs_all = np.divmod(perm, W)
    chunks = [(torch.as_tensor(xs_all[c0:c0 + chunk], device=dev),
               torch.as_tensor(ys_all[c0:c0 + chunk], device=dev)) for c0 in range(0, n, chunk)]
    learning_spp, render_spp = max(spp // 4, 1), max(spp, 1)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    done, steps = 0, len(chunks) * (learning_spp + render_spp)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync()
    flux = torch.zeros(grid.n_cells(), 3, device=dev)
    count = torch.zeros(grid.n_cells(), device=dev)
    for xs, ys in chunks:
        for i in range(learning_spp):
            recs, r = _trace_recorded(cscene, cp, xs, ys, W, H, sampler, i, max_depth, grid)
            total = total + r
            lo_next = torch.zeros(xs.shape[0], 3, device=dev)
            for d in range(max_depth - 2, -1, -1):
                # what arrives through segment d+1: its in-scatter, plus its
                # transmittance times its emission and the far vertex's lo
                lo_v = recs["nee"][d] + recs["thr"][d] * (
                    recs["seg_sc"][d + 1] + recs["seg_tr"][d + 1] * (recs["emit"][d + 1] + lo_next))
                m = recs["valid"][d]
                flux.index_add_(0, recs["cell"][d], torch.where(m[:, None], lo_v, 0.0))
                count.index_add_(0, recs["cell"][d], m.to(torch.float32))
                lo_next = lo_v
            done += 1
            progress.set_progress(done / steps)
    cache = flux / torch.clamp_min(count, 1.0)[:, None]
    t1 = sync()

    flat = torch.empty(n, 3, device=dev)
    for c, (xs, ys) in enumerate(chunks):
        acc = torch.zeros(xs.shape[0], 3, device=dev)
        for i in range(render_spp):
            L, r = _trace_with_cache(cscene, cp, xs, ys, W, H, sampler, i, max_depth, grid,
                                     cache, starting_depth)
            acc = acc + L
            total = total + r
            done += 1
            progress.set_progress(done / steps)
        flat[c * chunk:c * chunk + xs.shape[0]] = acc / render_spp
    img = flat[torch.as_tensor(np.argsort(perm), device=dev)].reshape(H, W, 3)
    if return_stats:
        t2 = sync()
        return img, {"traced_rays": int(total), "learn_s": t1 - t0, "render_s": t2 - t1}
    return img


def _segment_media(cscene, walk, t, hitm, xs, ys, sampler, sample_index, depth, max_depth):
    """The media of the depth's segment -> (transmittance, in-scatter and
    emission without beta, the grid media's vertices or None)."""
    n, dev = xs.shape[0], xs.device
    mdim = 4 + max_depth * 16 + depth * 24
    seg_tr, seg_sc = segment_medium_terms(cscene, walk.ro, walk.rd, torch.where(hitm, t, 1e8),
                                          walk.alive, xs, ys, sampler, sample_index, mdim - 10,
                                          scatter_mask=walk.alive & ~walk.diffused)
    med = None
    if cscene.grid_media and depth + 1 < max_depth:
        _, le, med = grid_vertices(cscene, walk, t, hitm, None, xs, ys, sampler, sample_index,
                                   7600 + depth, mdim + 15)
        med["nee_dim"] = mdim + 12
        seg_sc = seg_sc + le
    return seg_tr, seg_sc, med


def _medium_vertex_nee(cscene, med, rd, xs, ys, sampler, sample_index):
    """NEE at the depth's medium vertices, times their weight, without beta."""
    return med["w"] * _medium_nee(cscene, med["ro"], rd, med["scatter"], med["masks"], xs, ys,
                                  sampler, sample_index, med["nee_dim"])


def _trace_recorded(cscene, cp, xs, ys, W, H, sampler, sample_index, max_depth, grid):
    """Learning-phase walk -> (per-depth records for the reverse sweep,
    traced rays)."""
    n, dev = xs.shape[0], xs.device
    walk = PathWalk(cp, xs, ys, W, H, sampler, sample_index)
    zero3, one3 = torch.zeros(n, 3, device=dev), torch.ones(n, 3, device=dev)
    recs = dict(nee=[zero3] * max_depth, thr=[zero3] * max_depth, emit=[zero3] * max_depth,
                cell=[torch.zeros(n, dtype=torch.int64, device=dev)] * max_depth,
                valid=[torch.zeros(n, dtype=torch.bool, device=dev)] * max_depth,
                # the media terms of the segment into vertex d
                seg_tr=[one3] * max_depth, seg_sc=[zero3] * max_depth)
    has_media = bool(cscene.media or cscene.grid_media)
    for depth in range(max_depth):
        t, gidx, hitm, mesh_tri = walk.trace(cscene)
        med = None
        if has_media:
            recs["seg_tr"][depth], recs["seg_sc"][depth], med = _segment_media(
                cscene, walk, t, hitm, xs, ys, sampler, sample_index, depth, max_depth)
        gidx, p_s, ns, ctx, wi_world, emis, le, mis, env = walk.arrive(cscene, t, gidx, hitm,
                                                                       mesh_tri, med)
        emit = zero3 if env is None else env[0] * env[1]  # arriving along this segment
        if mis is not None:
            emit = emit + torch.where(emis[:, None], le * mis[:, None], 0.0)
        recs["emit"][depth] = emit
        if depth + 1 >= max_depth:
            break
        surf, rd = walk.surf, walk.rd
        recs["nee"][depth], thr, valid, _ = walk.scatter(
            cscene, xs, ys, sampler, sample_index, 4 + depth * 16, gidx, p_s, ns, ctx, wi_world,
            surf)
        recs["thr"][depth] = torch.where((surf & valid)[:, None], thr, 0.0)
        if med is not None:
            sc = med["scatter"][:, None]
            if cscene.lights:
                recs["nee"][depth] = torch.where(
                    sc, _medium_vertex_nee(cscene, med, rd, xs, ys, sampler, sample_index),
                    recs["nee"][depth])
            recs["thr"][depth] = torch.where(sc, med["w"], recs["thr"][depth])
        recs["cell"][depth] = grid.cell_of(p_s).long()
        recs["valid"][depth] = surf
    return recs, walk.n_rays


def _trace_with_cache(cscene, cp, xs, ys, W, H, sampler, sample_index, max_depth, grid, cache,
                      starting_depth):
    """Render-phase walk, ending in the cache at eligible vertices
    (cachedpath.cpp:168-170) -> (radiance (N,3), traced rays)."""
    n, dev = xs.shape[0], xs.device
    walk = PathWalk(cp, xs, ys, W, H, sampler, sample_index)
    L = torch.zeros(n, 3, device=dev)
    beta = torch.ones(n, 3, device=dev)
    has_media = bool(cscene.media or cscene.grid_media)
    for depth in range(max_depth):
        dim = 4 + depth * 16
        t, gidx, hitm, mesh_tri = walk.trace(cscene)
        med = None
        if has_media:
            seg_tr, seg_sc, med = _segment_media(cscene, walk, t, hitm, xs, ys, sampler,
                                                 sample_index, depth, max_depth)
            L = L + beta * seg_sc
            beta = beta * seg_tr
        gidx, p_s, ns, ctx, wi_world, emis, le, mis, env = walk.arrive(cscene, t, gidx, hitm,
                                                                       mesh_tri, med)
        if env is not None:
            L = L + beta * env[0] * env[1]
        if mis is not None:
            L = L + torch.where(emis[:, None], beta * le * mis[:, None], 0.0)
        if depth + 1 >= max_depth:
            break
        surf, rd = walk.surf, walk.rd
        if depth >= starting_depth:
            # a surface vertex reached by a non-delta bounce ends in the cache
            use_cache = surf & ~walk.prev_delta
            u3 = torch.stack([sampler.u1(xs, ys, sample_index, dim + 10 + k) for k in range(3)],
                             -1)
            cell = grid.jittered_cell_of(p_s, u3)
            L = L + torch.where(use_cache[:, None], beta * cache[cell.long()], 0.0)
            surf = surf & ~use_cache
        contrib, thr, valid, _ = walk.scatter(cscene, xs, ys, sampler, sample_index, dim, gidx,
                                              p_s, ns, ctx, wi_world, surf)
        L = L + beta * contrib
        if med is not None and cscene.lights:
            L = L + torch.where(med["scatter"][:, None], beta * _medium_vertex_nee(
                cscene, med, rd, xs, ys, sampler, sample_index), 0.0)
        beta = torch.where((surf & valid)[:, None], beta * thr, beta)
        if med is not None:
            beta = torch.where(med["scatter"][:, None], beta * med["w"], beta)
    return L, walk.n_rays
