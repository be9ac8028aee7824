"""Denoiser.  Counterpart of pine_tpu/integrators/denoiser.py (parity+:
impl/integrator/denoiser.cpp + core/denoise.cpp).

The reference renders albedo/normal aux buffers and calls OIDN, whose body
is entirely commented out (denoise.cpp:8-45), so the reference `denoise()`
is a no-op.  pine_tpu renders the same aux buffers and applies an
edge-aware à-trous wavelet filter (an SVGF-style single-frame variant)
guided by albedo and normal, and so does the port: the aux buffers through
``CompiledScene.intersect`` (the traversal kernels on the card), the filter
in PyTorch (pine_tpu's is jnp, no Pallas kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import camera as camera_mod
from pine_tpu_torch.core import fmath as fm

# the filter's 5x5 B3-spline taps: (dy, dx, weight)
_K1 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
TAPS = [(i - 2, j - 2, float(_K1[i] * _K1[j])) for i in range(5) for j in range(5)]


def render_aux(cscene, cam, W, H):
    """First-hit albedo and shading normal (H,W,3) each at pixel centres
    (denoiser.cpp:16-23), on the scene's device; zero where the ray misses.
    ``cam`` None takes the compiled scene's camera."""
    from pine_tpu_torch.scene import material_eval

    dev = cscene.device
    cp = cam.params(dev) if cam is not None else cscene.camera
    n = W * H
    ys, xs = np.divmod(np.arange(n, dtype=np.int64), W)
    pf = (torch.as_tensor(np.stack([xs, ys], -1), dtype=torch.float32, device=dev) + 0.5) \
        / torch.tensor([W, H], dtype=torch.float32, device=dev)
    ro, rd = camera_mod.gen_rays(cp, pf, torch.full((n, 2), 0.5, device=dev))
    ro, rd = ro.contiguous(), rd.contiguous()
    t, gidx, hit, mesh_tri = cscene.intersect(ro, rd, torch.zeros(n, device=dev),
                                              torch.full((n,), 3.0e38, device=dev))
    t_hit = torch.where(hit, t, 1.0)
    p_s, ns, uv = cscene.surface_info(gidx, ro + t_hit[:, None] * rd, mesh_tri)
    mat_idx = cscene.g_mat[gidx.clamp(0, cscene.n_global - 1).long()]
    half = torch.full((n,), 0.5, device=dev)
    state = material_eval.eval_bxdf_state(cscene, mat_idx, dict(p=p_s, n=ns, uv=uv), -rd,
                                          half, half, 0.0, torch.zeros(n, dtype=torch.bool,
                                                                       device=dev))
    albedo = torch.where(hit[:, None], state["albedo"], 0.0)
    normal = torch.where(hit[:, None], ns, 0.0)
    return albedo.reshape(H, W, 3), normal.reshape(H, W, 3)


def _sum3(x):
    return x[..., 0:1] + x[..., 1:2] + x[..., 2:3]


def atrous_denoise(color, albedo, normal, iterations=4, sigma_c=0.5, sigma_a=0.25,
                   sigma_n=0.3):
    """Edge-aware à-trous wavelet filtering of color (H,W,3), guided by
    albedo and normal (H,W,3): ``iterations`` passes of the 5x5 B3 kernel at
    steps 1, 2, 4, ..., each tap weighted by the color, albedo and normal
    differences (pine_tpu's weights; its ``sigma_n`` is unused there too:
    the normal weight is max(n.n', 0)^8)."""
    out = color.to(torch.float32)
    # the divisors as tensors: torch's CUDA division by a host scalar
    # multiplies by its reciprocal, where the CPU divides
    s_c, s_a = (torch.full((), s * s, device=out.device) for s in (sigma_c, sigma_a))
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), device=out.device)
        for dy, dx, k in TAPS:
            sh = (dy * step, dx * step)
            c = torch.roll(out, sh, (0, 1))
            a = torch.roll(albedo, sh, (0, 1))
            nn = torch.roll(normal, sh, (0, 1))
            dc, da = c - out, a - albedo
            w_c = fm.exp(-_sum3(dc * dc) / s_c)
            w_a = fm.exp(-_sum3(da * da) / s_a)
            w_n = torch.clamp_min(_sum3(nn * normal), 0.0)
            w_n = w_n * w_n
            w_n = w_n * w_n
            w_n = w_n * w_n  # ^8 by squaring, as XLA's integer power
            w = k * w_c * w_a * (w_n + 1e-3)
            acc = acc + w * c
            wsum = wsum + w
        out = acc / torch.clamp_min(wsum, 1e-8)
    return out


def denoise_scene(scene, device=None):
    """PRL ``denoise(scene)`` (program_context.cpp:117-119): filters the film
    in place with freshly rendered aux buffers, on ``device`` (default: the
    card)."""
    cscene = scene.compile(device)
    film = scene.camera.film
    albedo, normal = render_aux(cscene, scene.camera, film.width, film.height)
    color = film.rgb.to(cscene.device)
    film.set_rgb(atrous_denoise(color, albedo, normal))
    return film
