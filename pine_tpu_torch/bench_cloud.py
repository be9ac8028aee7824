"""The chromatic cloud benchmark: the repository's ``bench_cloud.py`` on the card.

    python -m pine_tpu_torch.bench_cloud [--spp N]

Builds bench_cloud.py's scene (``scenes.cloud``: a 96^3 cumulus VDB with
per-channel sigma_a and sigma_s and CloudPhaseFunction(0.65) in the Cornell
box, 1920x1080), compiles it, renders one batch of BATCH samples to warm up
(``compile_s``, kernel builds included), then the full render of ``--spp``
samples (256 by default) in batches of BATCH at depth 6, BlueSampler, and
prints one JSON line with bench_cloud.py's fields: ``metric``, ``value``
(the render's wall in s), ``unit``, ``vs_baseline``, ``msamples_per_s``
(camera samples over the wall), ``compile_s``, ``finite``, ``source``; and
the card's name and power limit.  ``build_scene`` and ``render`` are what
chip_smoke.py calls at a lower spp.  Without a card it exits with status 1.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

W, H = 1920, 1080
SPP = 256
DEPTH = 6
BATCH = 16


def build_scene(size=(W, H), n=96):
    from pine_tpu_torch import scenes

    return scenes.cloud(size, n)


def render(cs, scene, sampler, spp, depth=DEPTH, size=(W, H), return_stats=False):
    """The mean of ``spp`` samples in batches of BATCH (sample offsets 0,
    BATCH, ...), as bench_cloud.py batches them, each batch one wavefront
    of the whole film (its per-pixel values do not depend on the chunk) ->
    (H, W, 3) on the compiled scene's device; with return_stats=True also
    {"traced_rays": n} of all batches."""
    from pine_tpu_torch.integrators.path import render_wavefront

    acc, done, rays = None, 0, 0
    for off in range(0, spp, BATCH):
        b = min(BATCH, spp - off)
        img, st = render_wavefront(cs, scene.camera, size[0], size[1], sampler, b, depth,
                                   chunk=size[0] * size[1], sample_offset=off,
                                   return_stats=True)
        acc = img * b if acc is None else acc + img * b
        done += b
        rays += st["traced_rays"]
    img = acc / done
    return (img, {"traced_rays": rays}) if return_stats else img


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m pine_tpu_torch.bench_cloud")
    ap.add_argument("--spp", type=int, default=SPP, help="samples per pixel (256)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pine_tpu_torch.core.place import resolve_device
    from pine_tpu_torch.core.samplers import BlueSampler

    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"[Error] {e}")
        return 1
    scene = build_scene()
    sampler = BlueSampler(args.spp)
    t0 = time.perf_counter()
    cs = scene.compile(dev)
    render(cs, scene, sampler, min(BATCH, args.spp))
    torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = render(cs, scene, sampler, args.spp)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "metric": f"chromatic cloud {W}x{H}x{args.spp}spp depth{DEPTH} wall",
        "value": round(wall, 3),
        "unit": "s",
        "vs_baseline": None,
        "msamples_per_s": round(W * H * args.spp / wall / 1e6, 3),
        "compile_s": round(compile_s, 1),
        "finite": bool(np.isfinite(img.cpu().numpy()).all()),
        "source": "python -m pine_tpu_torch.bench_cloud",
        "device": card.splitlines()[0] if card else torch.cuda.get_device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
