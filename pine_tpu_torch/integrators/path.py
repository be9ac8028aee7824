"""Wavefront path integrator.  Counterpart of pine_tpu/integrators/path.py.

Every depth step runs ray intersection, emissive hits and escaped rays (the
environment light) with MIS, material evaluation, the subsurface walk, BSDF
sampling and NEE with a shadow ray, dense over the whole wavefront with
per-lane alive masks.  The MIS bookkeeping and the firefly
clamp are pine_tpu's: everything but the depth-0 direct hit is clamped to 8
at the path level.

Sampler dimension schedule: dims 0-3 = pixel jitter + lens; per depth d
(base = 4 + d*16):
    +0   light selection          +1,+2  light-sample u2
    +3,+4 material lobe choices   +5,+6  bxdf wm u2
    +7   bxdf fresnel u1          +8,+9  bxdf cosine u2
    +10,+11 grid medium: phase-function sample u2
    +12  grid medium: light selection  +13,+14 its light-sample u2
and, in a scene with a Subsurface material, the walk's own block past every
depth's (base = 4 + max_depth*16 + d*32):
    +0   color channel            then per step i of 8:
    +1+3i medium distance u1      +2+3i,+3+3i scattering direction u2
and, in a scene with a homogeneous medium, the scatter's block past those
(base = 4 + max_depth*48 + d*12), as ``_medium_scatter`` reads it.

Participating media, pine_tpu's terms (path.cpp:50-73, medium.cpp:204-290):
at each depth but the last, homogeneous media add an equiangular single
scatter (NEE from the scatter point and a one-bounce phase-sampled gather)
on the lanes before their first diffuse bounce, and every segment's beta
takes their closed-form transmittance; grid media are delta-tracked, and a
lane that scatters in one becomes a medium vertex: NEE from it (MIS
against the phase function), and its next ray a phase-sampled direction
from it; a lane absorbed in one that does not hit a surface ends; an
emissive grid adds its blackbody radiance along the walk.  Every shadow ray
takes the transmittance of all media.  The tracking's random numbers are
counter based (scene/media_track.py), keyed by pixel, sample and depth.

Where the scene sorts on the card (CompiledScene.sort_mode: heavy scenes;
instanced ones with ``origin_sort`` set), each bounce's continuation rays are
put in coherence-sort order once (CompiledScene.sort_perm); the permutation
serves that depth's NEE shadow rays and the next depth's intersect.  Depth 0
is not sorted: the tile-major primary rays are coherent already.

Material parameters are evaluated per lane at the hit (its ``p``, ``n`` and
``uv``, so textures and procedural nodes look up there), and Uber's lobe
choice reads dims +3 and +4.  NEE samples one light of the list uniformly:
point, spot and directional lights (delta, no MIS), the emissive shapes and
the environment light, last, whose shadow rays run to FLOAT_MAX * (1 -
1e-3).  A ray that escapes the scene takes the environment light's color,
weighted by MIS against its pdf unless the bounce was a delta one.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core import profiler
from pine_tpu_torch.core import progress
from pine_tpu_torch.core import rng
from pine_tpu_torch.core.ray import offset_ray_origin
from pine_tpu_torch.core.sampling import balance_heuristic, uniform_sphere
from pine_tpu_torch.core.scattering import refract
from pine_tpu_torch.core.vecmath import dot, face_forward, to_local, to_world
from pine_tpu_torch.scene import bxdf as bxdf_mod
from pine_tpu_torch.scene import csg_intersect as CI
from pine_tpu_torch.scene import material_eval
from pine_tpu_torch.scene import media_track as MT
from pine_tpu_torch.scene.materials import BX_BSSRDF

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
        """Render ``scene`` into its camera's film on ``device`` (default: the card).

        With ``options.progressive_every`` set below the sampler's spp, the
        samples run in batches of that many, and the running mean is written
        to ``options.progressive_dir`` after each batch (``render_progressive``).
        With ``options.interactive`` set, the fly-cam loop (interactive.py)
        starts from the finished frame."""
        from pine_tpu_torch.core import options

        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        film = cam.film
        spp = self.sampler.spp
        every = options.progressive_every
        with profiler.frame(device, integrator="path"):
            cscene = scene.compile(device)
            if not every or every >= spp:
                film.set_rgb(render_wavefront(cscene, cam, film.width, film.height, self.sampler,
                                              spp, self.max_path_length))
            else:
                render_progressive(cscene, cam, self.sampler, self.max_path_length, every,
                                   options.progressive_dir)
        if options.interactive:
            from pine_tpu_torch.interactive import run_loop

            run_loop(self, scene, cscene)
        return film


def render_progressive(cscene, cam, sampler, max_depth, every, out_dir):
    """Render in batches of ``every`` samples (the last one smaller), the
    running mean set on the film after each batch and saved as
    ``snap_<spp>spp.png`` and ``latest.png`` in ``out_dir`` beside a viewer
    page (``index.html``, which reloads latest.png).  All of it runs on the
    scene's device; a snapshot's save is the one readback.  pine_tpu's
    progressive branch (path_opengl.cpp:11-127's accumulating viewer): the
    same batches, sample offsets and running mean."""
    import os

    from pine_tpu_torch.io.term_preview import preview_enabled, print_frame

    film = cam.film
    W, H, spp = film.width, film.height, sampler.spp
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(VIEWER_HTML)
    acc = None
    done = 0
    while done < spp:
        b = min(every, spp - done)
        img = render_wavefront(cscene, cam, W, H, sampler, b, max_depth, sample_offset=done)
        acc = img if acc is None else (acc * done + img * b) / (done + b)
        done += b
        film.set_rgb(acc)
        film.save(os.path.join(out_dir, f"snap_{done:05d}spp.png"))
        film.save(os.path.join(out_dir, "latest.png"))
        if preview_enabled(True):
            print(f"[progressive] {done}/{spp} spp")
            print_frame(film.finalized())
    return film


VIEWER_HTML = """<!doctype html>
<title>pine-tpu progressive render</title>
<body style="margin:0;background:#111;display:grid;place-items:center;height:100vh">
<img id=v style="image-rendering:pixelated;max-width:96vw;max-height:96vh">
<script>
const img = document.getElementById('v');
function tick(){ img.src = 'latest.png?' + Date.now(); }
img.onerror = () => setTimeout(tick, 500);
img.onload = () => setTimeout(tick, 500);
tick();
</script>
"""


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
    NEE shadow rays actually cast.  Spans: ``tile_order`` around each of
    the two host argsorts, ``sample_sums``' between them."""
    with profiler.span("tile_order"):
        perm = tile_order(W, H)
    flat, total = sample_sums(cscene, cam, W, H, sampler, range(sample_offset, sample_offset + spp),
                              max_depth, perm, nee, chunk)
    with profiler.span("tile_order"):
        inv = np.argsort(perm)
    inv = profiler.to_device(inv, cscene.device, "tile_order.inverse")
    img = (flat / spp)[inv].reshape(H, W, 3)
    if return_stats:
        with profiler.sync("stats"):
            total = int(total)
        return img, {"traced_rays": total}
    return img


def sample_sums(cscene, cam, W, H, sampler, samples, max_depth, pixels, nee=True, chunk=None):
    """The radiance of samples ``samples`` (a range of sample indices) summed
    per pixel, for the flat pixel indices ``pixels`` (numpy, in lane order),
    in chunks of ``chunk`` lanes -> ((len(pixels), 3) sums in that order,
    traced rays as a 0-d tensor), on the scene's device.  render_wavefront's
    loop, which the sharded renders (parallel/distributed.py) run on a share
    of the samples or of the pixels.  Spans: ``chunk`` (attrs ``c0``,
    ``lanes``) holding ``sample`` (attr ``i``), each ``path_trace_sample``'s."""
    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    n = len(pixels)
    chunk = min(n, DEFAULT_CHUNK) if chunk is None else int(chunk)
    ys_all, xs_all = np.divmod(pixels, W)
    flat = torch.empty(n, 3, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        with profiler.span("chunk", c0=c0, lanes=min(chunk, n - c0)):
            xs = profiler.to_device(xs_all[c0:c0 + chunk], dev, "chunk.pixels")
            ys = profiler.to_device(ys_all[c0:c0 + chunk], dev, "chunk.pixels")
            acc = torch.zeros(xs.shape[0], 3, device=dev)
            for i in samples:
                with profiler.span("sample", i=i):
                    L, r = path_trace_sample(cscene, cp, xs, ys, W, H, sampler, i, max_depth, nee)
                    acc = acc + L
                    total = total + r
            flat[c0:c0 + chunk] = acc
        progress.set_progress(min(c0 + chunk, n) / n)
    return flat, total


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
    if cscene.media or cscene.grid_media:  # through every medium (integrator.cpp:75-81)
        contrib = contrib * cscene.transmittance(so, ls["wo"],
                                                 torch.where(do_nee, ls["distance"], -1.0))
    return torch.where((do_nee & ~occluded)[:, None], contrib, 0.0), do_nee


def bssrdf_walk(cscene, state, p_s, ns, wi_world, xs, ys, sampler, sample_index, dim_base,
                steps=8):
    """Random-walk exit-point search of the subsurface lobe (bxdf.cpp:329-352),
    pine_tpu's bounded form: on lanes whose lobe is BSSRDF, refract into the
    surface, pick a color channel (beta 3 e_c), and walk ``steps``
    exponential steps of mean 1 / sigma_s[c] with uniform-sphere scattering;
    the first step whose ray leaves through a surface before its medium
    distance moves the vertex to that surface point.  A walk that does not
    leave keeps the entry vertex.  Each step is one closest-hit query of the
    whole scene from tmin 1e-4; the lanes that walk no more get tmax = -1 and
    are culled.  -> (p, n, wi_world, beta multiplier (N,3))."""
    n, dev = p_s.shape[0], p_s.device
    wi_local = to_local(ns, wi_world)
    z_up = torch.zeros_like(wi_local)
    z_up[:, 2] = 1.0
    ok_r, wt, _ = refract(wi_local, z_up, state["ior"])
    w = to_world(ns, wt)  # into the surface
    walking = (state["tag"] == BX_BSSRDF) & ok_r

    u_c = sampler.u1(xs, ys, sample_index, dim_base)
    chan = (u_c * 3).to(torch.int32).clamp(0, 2)
    beta_mask = 3.0 * (torch.arange(3, device=dev)[None, :] == chan[:, None]).to(torch.float32)
    sig = state["sigma_s"].gather(1, chan[:, None].long())[:, 0]
    sigma_t_inv = 1.0 / torch.clamp_min(sig, 1e-6)

    p = offset_ray_origin(p_s, face_forward(ns, w))
    exit_p, exit_n, exit_wi = p_s, ns, wi_world
    exited = torch.zeros(n, dtype=torch.bool, device=dev)
    tmin = torch.full((n,), 1e-4, device=dev)
    for i in range(steps):
        t_surf, gidx, hit, mesh_tri = cscene.intersect(
            p, w.contiguous(), tmin, torch.where(walking, FLOAT_MAX, -1.0))
        u_t = sampler.u1(xs, ys, sample_index, dim_base + 1 + 3 * i)
        u_dir = sampler.u2(xs, ys, sample_index, dim_base + 2 + 3 * i)
        t_med = -fm.log(torch.clamp_min(1.0 - u_t, 1e-7)) * sigma_t_inv
        t_hit = torch.where(hit, t_surf, 1.0)
        pc, nn, _ = cscene.surface_info(gidx, p + t_hit[:, None] * w, mesh_tri)
        exit_now = walking & hit & (t_surf < t_med)
        exit_p = torch.where(exit_now[:, None], pc, exit_p)
        exit_n = torch.where(exit_now[:, None], nn, exit_n)
        exit_wi = torch.where(exit_now[:, None], -w, exit_wi)
        exited = exited | exit_now
        walking = walking & ~exit_now & hit  # on from the tentative medium point
        p = torch.where(walking[:, None], p + t_med[:, None] * w, p).contiguous()
        w = torch.where(walking[:, None], uniform_sphere(u_dir), w)
    m = exited[:, None]
    return (torch.where(m, exit_p, p_s), torch.where(m, exit_n, ns),
            torch.where(m, exit_wi, wi_world), torch.where(m, beta_mask, 1.0))


class PathWalk:
    """One sample's walk through the depth loop: the state carried from depth
    to depth, moved by ``trace`` (the intersect), ``arrive`` (the emissive
    hit, and the medium vertices of a grid medium) and ``scatter``
    (material, BSDF sample, NEE).  The path integrator and both
    phases of the cached one (integrators/cachedpath.py) walk it."""

    def __init__(self, cp, xs, ys, W, H, sampler, sample_index):
        n, dev = xs.shape[0], xs.device
        with profiler.span("camera"):
            jitter = sampler.u2(xs, ys, sample_index, 0)
            u_lens = sampler.u2(xs, ys, sample_index, 2)
            wh = profiler.to_device([W, H], dev, "walk.wh", torch.float32)
            p_film = (torch.stack([xs, ys], -1).to(torch.float32) + jitter) / wh
            ro, rd = camera_mod.gen_rays(cp, p_film, u_lens)
            self.ro, self.rd = ro.contiguous(), rd.contiguous()
            profiler.count("rays.camera", n)
        self.alive = torch.ones(n, dtype=torch.bool, device=dev)
        self.prev_pdf = torch.zeros(n, device=dev)
        self.prev_delta = torch.ones(n, dtype=torch.bool, device=dev)  # the camera vertex
        self.diffused = torch.zeros(n, dtype=torch.bool, device=dev)
        self.tmin = torch.zeros(n, device=dev)
        self.surf = self.alive  # the lanes at a surface vertex
        self.med = None  # the depth's medium vertices (``grid_vertices``), or None
        self.perm = None  # depth 0 is not sorted: tile-major primaries are coherent
        self.n_rays = torch.zeros((), dtype=torch.int64, device=dev)
        self.depth = -1  # of the last ``trace``: the name of its lane counters

    def escaped(self, cscene, hitm, gone):
        """(The environment light's radiance on the lanes alive at the depth
        whose ray escapes, ``hitm`` false, else 0; its MIS weight (N, 1)), or
        None in a scene without an environment light.  ``gone``: lanes that
        became medium vertices on the way, or None."""
        env = cscene.env_light
        if env is None:
            return None
        mis = torch.where(self.prev_delta, 1.0, balance_heuristic(self.prev_pdf, env.pdf(self.rd)))
        m = self.alive & ~hitm if gone is None else self.alive & ~hitm & ~gone
        return torch.where(m[:, None], env.color(self.rd), 0.0), mis[:, None]

    def trace(self, cscene):
        """Intersect the depth's rays -> (t, gidx, hit (of the lanes alive),
        mesh_tri).  Counts the live lanes (``lanes.live.d<depth>``)."""
        self.depth += 1
        live = self.alive.sum()
        self.n_rays = self.n_rays + live
        profiler.count("lanes.live.d", live, self.depth)
        # dead lanes get tmax = -1 and miss every group box up front
        t, gidx, hitm, mesh_tri = cscene.intersect(
            self.ro, self.rd, self.tmin, torch.where(self.alive, FLOAT_MAX, -1.0),
            sort_perm=self.perm)
        return t, gidx, hitm & self.alive, mesh_tri

    def arrive(self, cscene, t, gidx, hitm, mesh_tri, med=None):
        """The walk's lanes become the surface hits of ``trace``'s results,
        or, where ``med`` (``grid_vertices``) says, medium vertices -> (gidx,
        p, n, ctx, wi_world, emissive mask, their Le and MIS weight (None in
        a scene without emissive shapes), the escaped lanes' environment
        radiance (``escaped``))."""
        self.med = med
        gone = None if med is None else med["scatter"]
        env = self.escaped(cscene, hitm, gone)
        t_hit = torch.where(hitm, t, 1.0)  # miss lanes: t = BIG would overflow
        p_s, ns, uv = cscene.surface_info(gidx, self.ro + t_hit[:, None] * self.rd, mesh_tri)
        ctx = dict(p=p_s, n=ns, uv=uv)
        wi_world = -self.rd
        emis = cscene.is_emissive_lane(gidx) & hitm
        if gone is not None:
            emis = emis & ~gone
        le = mis = None
        if cscene.emissive_globals:
            le = cscene.emissive_le(gidx, ctx, wi_world)
            light_pdf = cscene.light_pdf_at_hit(gidx, self.ro, self.rd, t_hit, ns)
            mis = torch.where(self.prev_delta, 1.0, balance_heuristic(self.prev_pdf, light_pdf))
        # as pine_tpu's: a lane absorbed in a grid medium that hits a surface goes on
        self.surf = hitm & ~emis if gone is None else hitm & ~emis & ~gone
        self.alive = self.surf if gone is None else self.surf | gone
        return gidx, p_s, ns, ctx, wi_world, emis, le, mis, env

    def scatter(self, cscene, xs, ys, sampler, sample_index, dim, gidx, p_s, ns, ctx, wi_world,
                surf, nee=True, walk_dim=None):
        """Material eval, the subsurface walk (in a scene with a Subsurface
        material, given ``walk_dim``, its first sampler dim), BSDF sample and
        (with ``nee``) NEE at the surface lanes ``surf``, sampler dims from
        ``dim`` -> (NEE contribution without beta, throughput f cos / pdf,
        the sample's validity, the walk's beta multiplier or None), and the
        walk moved to the continuation rays.  The caller multiplies beta by
        the walk's multiplier before it weighs the NEE contribution.  Spans
        ``material``, ``bsdf`` (the subsurface walk in it), ``sort`` and
        ``nee``; counter ``lanes.shadow.d<depth>``, the shadow rays cast."""
        with profiler.span("material"):
            mat_idx = cscene.g_mat[gidx.clamp(0, cscene.n_global - 1).long()]
            u_mat = sampler.u2(xs, ys, sample_index, dim + 3)
            state = material_eval.eval_bxdf_state(cscene, mat_idx, ctx, wi_world, u_mat[:, 0],
                                                  u_mat[:, 1], MIN_ROUGHNESS, self.diffused)
        with profiler.span("bsdf"):
            sss_mult = None
            if walk_dim is not None and cscene.has_subsurface:
                p_s, ns, wi_world, sss_mult = bssrdf_walk(cscene, state, p_s, ns, wi_world, xs,
                                                          ys, sampler, sample_index, walk_dim)
            wi = to_local(ns, wi_world)
            u_wm = sampler.u2(xs, ys, sample_index, dim + 5)
            u_fr = sampler.u1(xs, ys, sample_index, dim + 7)
            u_cos = sampler.u2(xs, ys, sample_index, dim + 8)
            bs = bxdf_mod.sample(state, wi, u_wm, u_fr, u_cos)
            wo_world = to_world(ns, bs["wo"])
            cosine = dot(wo_world, ns).abs()
            thr = bs["f"] * (cosine / torch.clamp_min(bs["pdf"], 1e-20))[:, None]
            surf_next = surf & bs["valid"]
            ro_next = offset_ray_origin(p_s, face_forward(ns, wo_world))
            rd_next, alive_next, med = wo_world, surf_next, self.med
            if med is not None:  # medium vertices go on along their phase-sampled rays
                sc = med["scatter"]
                ro_next = torch.where(sc[:, None], med["ro"], ro_next)
                rd_next = torch.where(sc[:, None], med["rd"], wo_world)
                alive_next = surf_next | sc
        # the bounce's coherence sort serves its shadow rays and the next intersect
        with profiler.span("sort"):
            self.perm = cscene.sort_perm(ro_next, rd_next, ~alive_next)
        contrib = torch.zeros_like(p_s)
        if len(cscene.lights) > 0 and nee:
            with profiler.span("nee"):
                u_sel = sampler.u1(xs, ys, sample_index, dim + 0)
                u_light = sampler.u2(xs, ys, sample_index, dim + 1)
                ls = sample_one_light(cscene, p_s, u_sel, u_light)
                contrib, do_nee = nee_contribution(cscene, p_s, ns, state, wi, ls, surf,
                                                   sort_perm=self.perm)
                cast = do_nee.sum()
                self.n_rays = self.n_rays + cast
                profiler.count("lanes.shadow.d", cast, self.depth)
        self.surf, self.alive = surf_next, alive_next
        self.prev_pdf = bs["pdf"]
        self.prev_delta = bs["is_delta_sample"]
        self.diffused = self.diffused | (surf_next & ~bs["is_delta_sample"])
        if med is not None:
            sc = med["scatter"]
            self.prev_pdf = torch.where(sc, med["pdf"], self.prev_pdf)
            self.prev_delta = self.prev_delta & ~sc
            self.tmin = torch.where(sc, 1e-4, 0.0)
        self.ro, self.rd = ro_next.contiguous(), rd_next.contiguous()
        return contrib, thr, bs["valid"], sss_mult


def path_trace_sample(cscene, cp, xs, ys, W, H, sampler, sample_index, max_depth, nee=True):
    """One sample per pixel through the depth loop -> (L (N,3), traced rays).
    Spans: ``camera``, then ``depth`` (attr ``d``) holding ``intersect``,
    ``media``, ``arrive`` and ``PathWalk.scatter``'s."""
    n, dev = xs.shape[0], xs.device
    walk = PathWalk(cp, xs, ys, W, H, sampler, sample_index)
    L_direct = torch.zeros(n, 3, device=dev)  # depth-0 emissive (unclamped)
    L_indirect = torch.zeros(n, 3, device=dev)  # everything else (clamped)
    beta = torch.ones(n, 3, device=dev)
    n_lights = len(cscene.lights)
    for depth in range(max_depth):
        with profiler.span("depth", d=depth):
            t, gidx, hitm, mesh_tri = walk.trace(cscene)
            med = None
            if cscene.media:
                with profiler.span("media"):
                    seg = torch.where(hitm, t, 1e8)
                    if depth + 1 < max_depth and n_lights > 0:
                        L_indirect = L_indirect + _medium_scatter(
                            cscene, walk.ro, walk.rd, seg, beta, walk.alive & ~walk.diffused,
                            xs, ys, sampler, sample_index, 4 + max_depth * 48 + depth * 12 - 10)
                    # homogeneous only: the grid media's tracking below carries theirs
                    beta = beta * cscene.transmittance(walk.ro, walk.rd, seg, grid=False)
            if cscene.grid_media and depth + 1 < max_depth:
                with profiler.span("media"):
                    dim = 4 + depth * 16
                    beta, L_med, med = grid_vertices(cscene, walk, t, hitm, beta, xs, ys, sampler,
                                                     sample_index, 7000 + depth, dim + 10,
                                                     dim + 12)
                    L_indirect = L_indirect + L_med
            with profiler.span("arrive"):
                gidx, p_s, ns, ctx, wi_world, emis, le, mis, env = walk.arrive(
                    cscene, t, gidx, hitm, mesh_tri, med)
                for contrib in (None if env is None else beta * env[0] * env[1],
                                None if mis is None else torch.where(
                                    emis[:, None], beta * le * mis[:, None], 0.0)):
                    if contrib is None:
                        continue
                    if depth == 0:
                        L_direct = L_direct + contrib
                    else:
                        L_indirect = L_indirect + contrib
            if depth + 1 >= max_depth:
                break
            contrib, thr, _, sss_mult = walk.scatter(
                cscene, xs, ys, sampler, sample_index, 4 + depth * 16, gidx, p_s, ns, ctx,
                wi_world, walk.surf, nee, walk_dim=4 + max_depth * 16 + depth * 32)
            if sss_mult is not None:
                beta = beta * sss_mult
            L_indirect = L_indirect + beta * contrib
            beta = torch.where(walk.surf[:, None], beta * thr, beta)
    return L_direct + torch.clamp_max(L_indirect, CLAMP), walk.n_rays


def grid_vertices(cscene, walk, t, hitm, beta, xs, ys, sampler, sample_index, salt, phase_dim,
                  nee_dim=None):
    """Delta tracking through each grid medium along the walk's segments
    (medium.cpp:204-251): a lane scatters at most once a segment (a later
    medium does not take a lane an earlier one took), an absorbed lane
    leaves ``walk.alive``, an emissive medium adds its radiance.  The
    tracking's key is (pixel, sample, ``salt``), plus the medium's index;
    the scatter lanes' continuation is phase-sampled at dims phase_dim,
    +1.  Given ``nee_dim``, NEE from the scatter points (``_medium_nee``).
    -> (beta times the scattering lanes' weight, the radiance added with
    beta, the medium vertices: dict(scatter, ro, rd, pdf, w (the weight),
    masks ((lanes, phase function) of each medium))); with ``beta`` None,
    (None, the radiance added without beta, the vertices)."""
    n, dev = xs.shape[0], xs.device
    ro, rd = walk.ro, walk.rd
    L = torch.zeros(n, 3, device=dev)
    scatter = torch.zeros(n, dtype=torch.bool, device=dev)
    med_ro, med_rd = ro, rd
    med_pdf = torch.zeros(n, device=dev)
    med_w = torch.ones(n, 3, device=dev)
    masks = []
    seg_limit = torch.where(hitm, t, FLOAT_MAX)
    key = rng.hash_combine(xs, ys, sample_index, salt)
    u_ph = sampler.u2(xs, ys, sample_index, phase_dim)
    alive = walk.alive
    for gi, med in enumerate(cscene.grid_media):
        gate = alive & ~scatter
        # lanes outside the gate do not walk: their results would be masked
        sc_m, ts_m, w_m, abs_m, le_m = MT.grid_sample_scatter(
            med, ro, rd, torch.where(gate, seg_limit, -1.0), (key + gi) & 0xFFFFFFFF)
        sc_m = sc_m & gate
        abs_m = abs_m & gate & ~sc_m
        if med.emissive:
            L = L + torch.where(gate[:, None], le_m if beta is None else beta * le_m, 0.0)
        alive = alive & ~abs_m
        p_m = ro + ts_m[:, None] * rd
        if nee_dim is not None and cscene.lights:
            L = L + beta * w_m * _medium_nee(cscene, p_m, rd, sc_m, [(sc_m, med.pf)], xs, ys,
                                             sampler, sample_index, nee_dim)
        wo_m, pdf_m = med.pf.sample(-rd, u_ph)
        med_ro = torch.where(sc_m[:, None], p_m, med_ro)
        med_rd = torch.where(sc_m[:, None], wo_m, med_rd)
        med_pdf = torch.where(sc_m, pdf_m, med_pdf)
        med_w = torch.where(sc_m[:, None], w_m, med_w)
        if beta is not None:
            beta = torch.where(sc_m[:, None], beta * w_m, beta)
        scatter = scatter | sc_m
        masks.append((sc_m, med.pf))
    walk.alive = alive
    return beta, L, dict(scatter=scatter, ro=med_ro, rd=med_rd, pdf=med_pdf, w=med_w, masks=masks)


def _medium_nee(cscene, p_m, rd, lanes, masks, xs, ys, sampler, sample_index, dim):
    """Shadow-tested NEE at medium vertices ``p_m`` of the lanes ``lanes``
    (light selection dim ``dim``, the light sample dim+1, +2), weighed by
    the phase function of each vertex's medium (``masks``: (lanes, phase
    function) pairs) with MIS against it -> (N,3) without the tracking
    weight or beta."""
    n = p_m.shape[0]
    ls = sample_one_light(cscene, p_m, sampler.u1(xs, ys, sample_index, dim),
                          sampler.u2(xs, ys, sample_index, dim + 1))
    go = lanes & ls["valid"] & (ls["pdf"] > 0.0)
    occ = cscene.any_hit(p_m, ls["wo"].contiguous(), torch.full((n,), 1e-4, device=p_m.device),
                         torch.where(go, ls["distance"] * (1.0 - 1e-3), -1.0))
    tr_l = cscene.transmittance(p_m, ls["wo"], torch.where(go, ls["distance"], -1.0))
    cos_m = dot(-rd, ls["wo"])
    f_p = torch.zeros(n, device=p_m.device)
    for m, pf in masks:
        f_p = torch.where(m, pf.p(cos_m), f_p)
    mis_m = torch.where(ls["is_delta"], 1.0, balance_heuristic(ls["pdf"], f_p))
    contrib = ls["le"] * tr_l * (f_p * mis_m / torch.clamp_min(ls["pdf"], 1e-20))[:, None]
    return torch.where((go & ~occ)[:, None], contrib, 0.0)


def segment_medium_terms(cscene, ro, rd, seg_tmax, active, xs, ys, sampler, sample_index, dim,
                         scatter_mask=None, include_grid=False):
    """The media's terms of one path segment -> (tr (N,3), sc (N,3)): tr the
    segment's transmittance on the ``active`` lanes (1 elsewhere), sc the
    in-segment scatter on ``scatter_mask`` (default ``active``) without the
    caller's throughput.  The homogeneous media give their closed-form
    transmittance and the equiangular single scatter (``_medium_scatter``,
    dims dim+10..+21).  With ``include_grid``, the grid media are ratio
    tracked into tr and add a delta-tracked single scatter (NEE at dims
    dim+22..+24, weight 1 against the phase function by MIS, and the
    one-bounce phase continuation, dims dim+25..+31) and their emission
    along the walk, keyed by (pixel, sample, 9200 + dim), plus the medium's
    index; a lane scatters in at most one of them.  Multiple scattering in
    the medium is truncated, as pine_tpu's.  The cached integrator's
    segments take the homogeneous terms alone (its grid media make medium
    vertices of their own, ``grid_vertices``); ReSTIR's camera segment
    takes both."""
    n = ro.shape[0]
    ones = torch.ones(n, 3, device=ro.device)
    gm = cscene.grid_media if include_grid else []
    if not cscene.media and not gm:
        return ones, torch.zeros_like(ones)
    smask = active if scatter_mask is None else scatter_mask
    tr = torch.where(active[:, None], cscene.transmittance(ro, rd, seg_tmax, grid=bool(gm)), 1.0)
    sc = torch.zeros_like(ones)
    if cscene.media and cscene.lights:
        sc = _medium_scatter(cscene, ro, rd, seg_tmax, ones, smask, xs, ys, sampler,
                             sample_index, dim)
    if not gm:
        return tr, sc
    key = rng.hash_combine(xs, ys, sample_index, 9200 + dim)
    taken = torch.zeros(n, dtype=torch.bool, device=ro.device)
    for gi, med in enumerate(gm):
        gate = smask & ~taken
        # lanes outside the gate do not walk: their results would be masked
        sc_m, ts_m, w_m, _abs, le_m = MT.grid_sample_scatter(
            med, ro, rd, torch.where(gate, seg_tmax, -1.0), (key + gi) & 0xFFFFFFFF)
        sc_m = sc_m & gate
        if med.emissive:  # extinction rides tr: the absorbed lanes go on
            sc = sc + torch.where(gate[:, None], le_m, 0.0)
        p_m = ro + ts_m[:, None] * rd
        if cscene.lights:
            sc = sc + w_m * _medium_nee(cscene, p_m, rd, sc_m, [(sc_m, med.pf)], xs, ys, sampler,
                                        sample_index, dim + 22)
        sc = sc + torch.where(sc_m[:, None], w_m * _phase_continuation_gather(
            cscene, p_m, rd, med.pf, sc_m, xs, ys, sampler, sample_index, dim + 10), 0.0)
        taken = taken | sc_m
    return tr, sc


def _medium_scatter(cscene, ro, rd, seg_tmax, beta, active, xs, ys, sampler, sample_index, dim):
    """The homogeneous media's single scatter at an equiangular point toward
    a sampled light (integrator.cpp:49-74, path.cpp:52-70): NEE from the
    point, MIS against the phase function, plus one phase-sampled
    continuation (``_phase_continuation_gather``), each medium by the
    coverage of its intervals, with beta.  As pine_tpu's, the equiangular
    pdf is kept in the weight.  Sampler dims dim+10..+21."""
    n, dv = ro.shape[0], ro.device
    out = torch.zeros(n, 3, device=dv)
    t_tent = -fm.log(torch.clamp_min(1.0 - sampler.u1(xs, ys, sample_index, dim + 10), 1e-7))
    u_eq = sampler.u1(xs, ys, sample_index, dim + 11)
    p_tent = ro + t_tent[:, None] * rd
    ls = sample_one_light(cscene, p_tent, sampler.u1(xs, ys, sample_index, dim + 12),
                          sampler.u2(xs, ys, sample_index, dim + 13))
    # equiangular sampling of the scatter point toward the light point
    ps = p_tent + torch.clamp_max(ls["distance"], 1e7)[:, None] * ls["wo"]
    a = dot(ps - ro, rd)
    b = seg_tmax - a
    D = torch.clamp_min(CI.norm3(ps - (ro + a[:, None] * rd)), 1e-4)
    theta_a = -fm.atan(a / D)
    theta_b = fm.atan(b / D)
    theta = theta_b + (theta_a - theta_b) * u_eq
    dt = D * fm.tan(theta)
    ts = a + dt
    pdf_eq = D / torch.clamp_min((theta_b - theta_a).abs() * (D * D + dt * dt), 1e-12)
    p_scat = ro + ts[:, None] * rd
    d2 = ps - p_scat
    dist2 = CI.norm3(d2)
    wo2 = (d2 / torch.clamp_min(dist2[:, None], 1e-20)).contiguous()
    cos_sc = dot(-rd, wo2)
    for med in cscene.media:
        s_iv, e_iv = CI.intervals_of(med.shape, ro, rd)
        inside = ((ts[:, None] > s_iv) & (ts[:, None] < e_iv)).any(1)
        scat = active & ls["valid"] & inside & (ts > 0.0) & (ts < seg_tmax)
        tr_to_scat = cscene.transmittance(ro, rd, torch.where(scat, torch.clamp_min(ts, 0.0), -1.0))
        W = (CI.on_device(med, "sigma_s", ro) * tr_to_scat
             / torch.clamp_min(pdf_eq, 1e-12)[:, None])
        # NEE from the scatter point; lanes that do not scatter cast no ray
        occluded = cscene.any_hit(p_scat, wo2, torch.full((n,), 1e-4, device=dv),
                                  torch.where(scat, dist2 * (1.0 - 1e-3), -1.0))
        tr_light = cscene.transmittance(p_scat, wo2, torch.where(scat, dist2, -1.0))
        f_phase = med.pf.p(cos_sc)
        mis_nee = torch.where(ls["is_delta"], 1.0, balance_heuristic(ls["pdf"], f_phase))
        contrib = (beta * W * ls["le"] * tr_light
                   * (f_phase * mis_nee / torch.clamp_min(ls["pdf"], 1e-20))[:, None])
        out = out + torch.where((scat & ~occluded)[:, None], contrib, 0.0)
        out = out + torch.where(scat[:, None], beta * W * _phase_continuation_gather(
            cscene, p_scat, rd, med.pf, scat, xs, ys, sampler, sample_index, dim), 0.0)
    return out


def _phase_continuation_gather(cscene, p_scat, rd, pf, scat, xs, ys, sampler, sample_index,
                               dim):
    """One phase-sampled continuation from the medium vertices of the lanes
    ``scat`` (path.cpp:63-69), pine_tpu's one-bounce truncation: the
    emissive or environment light it arrives at (MIS against the light's
    pdf) plus NEE at the surface it hits, times its transmittance; no f/pdf
    factor (phase sampling is exact).  Dims dim+15..+21."""
    n, dv = p_scat.shape[0], p_scat.device
    wo_c, pdf_c = pf.sample(-rd, sampler.u2(xs, ys, sample_index, dim + 15))
    wo_c = wo_c.contiguous()
    tc, gc, hitc, meshc = cscene.intersect(p_scat, wo_c, torch.full((n,), 1e-4, device=dv),
                                           torch.where(scat, FLOAT_MAX, -1.0))
    tc_hit = torch.where(hitc, tc, 1.0)
    tr_c = cscene.transmittance(p_scat, wo_c, torch.where(scat, torch.where(hitc, tc, 1e8), -1.0))
    gather = torch.zeros(n, 3, device=dv)
    pc, nc, uvc = cscene.surface_info(gc, p_scat + tc_hit[:, None] * wo_c, meshc)
    cctx = dict(p=pc, n=nc, uv=uvc)
    emis_c = cscene.is_emissive_lane(gc) & hitc
    if cscene.emissive_globals:
        le_c = cscene.emissive_le(gc, cctx, -wo_c)
        lpdf_c = cscene.light_pdf_at_hit(gc, p_scat, wo_c, tc_hit, nc)
        gather = gather + torch.where(emis_c[:, None],
                                      le_c * balance_heuristic(pdf_c, lpdf_c)[:, None], 0.0)
    if cscene.env_light is not None:
        mis_e = balance_heuristic(pdf_c, cscene.env_light.pdf(wo_c))
        gather = gather + torch.where((~hitc)[:, None],
                                      cscene.env_light.color(wo_c) * mis_e[:, None], 0.0)
    if cscene.lights:  # NEE at the continuation's surface hit
        shade_c = hitc & ~emis_c & scat
        mat_c = cscene.g_mat[gc.clamp(0, cscene.n_global - 1).long()]
        u_mat_c = sampler.u2(xs, ys, sample_index, dim + 17)
        state_c = material_eval.eval_bxdf_state(cscene, mat_c, cctx, -wo_c, u_mat_c[:, 0],
                                                u_mat_c[:, 1], MIN_ROUGHNESS,
                                                torch.ones(n, dtype=torch.bool, device=dv))
        ls_c = sample_one_light(cscene, pc, sampler.u1(xs, ys, sample_index, dim + 19),
                                sampler.u2(xs, ys, sample_index, dim + 20))
        nee_c, _ = nee_contribution(cscene, pc, nc, state_c, to_local(nc, -wo_c), ls_c, shade_c)
        gather = gather + nee_c
    return tr_c * gather
