"""The port's benchmark: the repository's ``bench.py`` on the card.

    python -m pine_tpu_torch.bench [--small-kernel ROUTE]

Builds the README Cornell box (``scenes.CBOX_PRL``, bench.py's script)
through the port's PRL interpreter, compiles it (with ``--small-kernel``
forcing the route of its groups, the counterpart of bench.py honouring
PINE_SMALL_KERNEL: "dense", "scdense", "lattice", "grid", "sctree", "mxu" or
"mxup"), renders it once at 640x640, BlueSampler(16), depth 4 to warm up,
then five times, and prints one JSON line as bench.py does: ``metric``,
``value`` (traced rays over the fastest render's wall, in Mray/s),
``unit``, ``wall_s``, ``compile_s`` (the scene compile and the first
render, kernel builds included), ``traced_rays``, ``finite`` and the
route.  Traced rays are the extension rays of lanes alive at each depth plus
the NEE shadow rays cast.  Without a card it exits with status 1.
"""
from __future__ import annotations

import json
import sys
import time

W = H = 640
SPP = 16
DEPTH = 4
REPS = 5


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m pine_tpu_torch.bench")
    ap.add_argument("--small-kernel", default=None,
                    help="force the route of the box's groups (PINE_SMALL_KERNEL's values)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.place import resolve_device
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"[Error] {e}")
        return 1

    scene = scenes.prl_scene(scenes.CBOX_PRL, "<bench:cbox>")
    cam = scene.camera
    sampler = BlueSampler(SPP)
    t0 = time.perf_counter()
    cs = scene.compile(dev, small_kernel=args.small_kernel)
    render_wavefront(cs, cam, W, H, sampler, SPP, DEPTH)
    torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        img, stats = render_wavefront(cs, cam, W, H, sampler, SPP, DEPTH, return_stats=True)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    traced = int(stats["traced_rays"])
    print(json.dumps({
        "metric": "cbox 640x640x16spp path-depth4 throughput",
        "value": round(traced / wall / 1e6, 2),
        "unit": "Mray/s",
        "wall_s": round(wall, 4),
        "compile_s": round(compile_s, 1),
        "traced_rays": traced,
        "finite": bool(np.isfinite(img.cpu().numpy()).all()),
        "small_kernel": args.small_kernel,
        "device": torch.cuda.get_device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
