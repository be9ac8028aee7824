"""Ambient-occlusion integrator.  Counterpart of pine_tpu/integrators/ao.py
(parity: impl/integrator/ao.cpp).

Each (pixel, sample) lane traces its camera ray, then eight hemisphere
directions around the hit's normal, each an occlusion query of length
``radius`` (default: half the scene box's diagonal): the unoccluded share
is the pixel's grey value, 1 on a miss.  Sampler dims: 0-1 the pixel
jitter, 2-3 the lens, 4 + 2k the k-th direction.  Its rays go through
``CompiledScene.intersect`` and ``any_hit``, so the traversal kernels run
on the card.  On the card each direction is one launch of
csrc/ao_dirs.cu (``occlusion_dirs``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pine_tpu_torch.accel.dense_traverse import _check
from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import profiler
from pine_tpu_torch.core.ray import offset_ray_origin
from pine_tpu_torch.core.samplers import BlueSampler
from pine_tpu_torch.core.sampling import uniform_hemisphere
from pine_tpu_torch.core.vecmath import face_forward, to_world

FLOAT_MAX = float(np.finfo(np.float32).max)
DIRECTIONS = 8

# launches of csrc/ao_dirs.cu: "blue" draws BlueSampler's values itself, "u"
# takes another sampler's
LAUNCHES = {"ao_dirs.blue": 0, "ao_dirs.u": 0}
profiler.launch_counter(LAUNCHES)


class AOIntegrator:
    """AOIntegrator(sampler[, radius])."""

    def __init__(self, sampler, radius=None):
        self.sampler = sampler
        self.radius = radius

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        with profiler.frame(device, integrator="ao"):
            cscene = scene.compile(device)
            lo, up = scene.get_aabb()
            radius = self.radius or float(np.linalg.norm(up - lo) / 2)
            film = cam.film
            film.set_rgb(render_ao(cscene, cam, film.width, film.height, self.sampler,
                                   self.sampler.spp, radius))
        return film


def _library():
    from pine_tpu_torch import cuda_build

    lib = cuda_build.load("ao_dirs")
    if lib.pine_ao_dirs_u.argtypes is None:
        lib.pine_ao_dirs_blue.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        lib.pine_ao_dirs_u.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.pine_ao_dirs_blue.restype = lib.pine_ao_dirs_u.restype = ctypes.c_int
    return lib


def _out(ns):
    """The (n, 3) directions' buffer, once ``ns`` is a CUDA normal buffer."""
    _check(ns, torch.float32, (ns.shape[0], 3), ns.device, "ns")
    if not ns.is_cuda:
        raise ValueError(f"ns: the ao_dirs kernel wants a CUDA tensor, got one on {ns.device}")
    return torch.empty_like(ns)


def _launched(err, form):
    if err != 0:
        raise RuntimeError(f"ao_dirs kernel launch failed: CUDA error {err}")
    LAUNCHES["ao_dirs." + form] += 1


def ao_dirs_blue(ns, tables, W, sample_index, dim):
    """``to_world(ns, uniform_hemisphere(BlueSampler.u2(xs, ys, sample_index,
    dim)))`` for lanes in row order over a film ``W`` wide, bit for bit, in
    one launch of csrc/ao_dirs.cu on the current stream.  ``tables``:
    ``BlueSampler.tables(ns.device)``."""
    out = _out(ns)
    for t, (name, size) in zip(tables, BlueSampler.TABLE_SIZES):
        _check(t, torch.int32, (size,), ns.device, name)
    _launched(_library().pine_ao_dirs_blue(
        ns.data_ptr(), *(t.data_ptr() for t in tables), int(sample_index) & 255, int(dim) & 255,
        W, out.data_ptr(), ns.shape[0], torch.cuda.current_stream(ns.device).cuda_stream,
    ), "blue")
    return out


def ao_dirs_u(ns, u):
    """``to_world(ns, uniform_hemisphere(u))`` bit for bit, in one launch of
    csrc/ao_dirs.cu on the current stream; ``u`` (n, 2) float32."""
    out = _out(ns)
    _check(u, torch.float32, (ns.shape[0], 2), ns.device, "u")
    _launched(_library().pine_ao_dirs_u(
        ns.data_ptr(), u.data_ptr(), out.data_ptr(), ns.shape[0],
        torch.cuda.current_stream(ns.device).cuda_stream,
    ), "u")
    return out


def occlusion_dirs_plain(ns, sampler, xs, ys, i, k):
    """The k-th occlusion direction of sample i around the normals ``ns``,
    as PyTorch operations."""
    return to_world(ns, uniform_hemisphere(sampler.u2(xs, ys, i, 4 + 2 * k)))


def occlusion_dirs(ns, sampler, xs, ys, W, i, k):
    """``occlusion_dirs_plain``: on the CPU that chain itself; on the card
    one kernel launch, with BlueSampler's draw in the kernel
    (``ao_dirs_blue``), or after any other sampler's ``u2`` (``ao_dirs_u``)."""
    if not ns.is_cuda:
        return occlusion_dirs_plain(ns, sampler, xs, ys, i, k)
    if isinstance(sampler, BlueSampler):
        return ao_dirs_blue(ns, sampler.tables(ns.device), W, i, 4 + 2 * k)
    return ao_dirs_u(ns, sampler.u2(xs, ys, i, 4 + 2 * k))


def render_ao(cscene, cam, W, H, sampler, spp, radius, return_stats=False):
    """-> the (H,W,3) ambient occlusion on the scene's device; lanes in row
    order, one per pixel.  With return_stats=True also {"traced_rays": n}:
    the camera rays and the occlusion rays cast (eight from each hit).
    The occlusion directions come from ``occlusion_dirs``: on a CUDA device
    one launch of csrc/ao_dirs.cu each (the sampler's draw, the hemisphere
    and the frame around the normal; BlueSampler's draw inside the kernel,
    any other sampler's ``u2`` before it), counted as
    ``launches.ao_dirs.blue`` / ``launches.ao_dirs.u``; on the CPU the
    PyTorch chain ``occlusion_dirs_plain``, bit for bit the same.
    Spans: ``sample`` (attr ``i``) holding ``camera``, ``intersect``,
    ``surface``, ``occlusion`` (attr ``k``) and ``film``; counters
    ``rays.camera`` and ``lanes.hit`` (core/profiler.py)."""
    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    n = W * H
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    ys, xs = (idx // W).to(torch.int32), (idx % W).to(torch.int32)
    wh = profiler.to_device([W, H], dev, "ao.wh", torch.float32)
    zero = torch.zeros(n, device=dev)
    total = torch.zeros(n, 3, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(spp):
        with profiler.span("sample", i=i):
            with profiler.span("camera"):
                p_film = ((torch.stack([xs, ys], -1).to(torch.float32) + sampler.u2(xs, ys, i, 0))
                          / wh)
                ro, rd = camera_mod.gen_rays(cp, p_film, sampler.u2(xs, ys, i, 2))
                ro, rd = ro.contiguous(), rd.contiguous()
                profiler.count("rays.camera", n)
            t, gidx, hitm, mesh_tri = cscene.intersect(ro, rd, zero,
                                                       torch.full_like(zero, FLOAT_MAX))
            with profiler.span("surface"):
                t_hit = torch.where(hitm, t, 1.0)  # miss lanes: t = BIG would overflow
                p_s, ns, _ = cscene.surface_info(gidx, ro + t_hit[:, None] * rd, mesh_tri)
                ns = face_forward(ns, -rd)
                so = offset_ray_origin(p_s, ns)
                tmax = torch.where(hitm, radius, -1.0)  # a missed lane casts no occlusion ray
                occ = torch.zeros(n, device=dev)
            for k in range(DIRECTIONS):
                with profiler.span("occlusion", k=k):
                    d = occlusion_dirs(ns, sampler, xs, ys, W, i, k)
                    blocked = cscene.any_hit(so, d.contiguous(), zero, tmax)
                    occ = occ + torch.where(blocked, 0.0, 1.0)
            with profiler.span("film"):
                ao = torch.where(hitm, occ / DIRECTIONS, 1.0)
                total = total + ao[:, None].expand(n, 3)
                hits = hitm.sum()
                rays = rays + n + DIRECTIONS * hits
                profiler.count("lanes.hit", hits)
    img = (total / spp).reshape(H, W, 3)
    if not return_stats:
        return img
    with profiler.sync("stats"):
        rays = int(rays)
    return img, {"traced_rays": rays}
