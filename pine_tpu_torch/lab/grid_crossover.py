"""The grid kernel's leaf crossover, measured on the card.

    python -m pine_tpu_torch.lab.grid_crossover [k ...]

csrc/grid_traverse.cu runs a taken cell lanes over prims when at most
``GRID_PRIMS_MAX_K`` rays of the warp test it, else lanes over rays, in
both its forms.  This builds the source once per candidate k
(-DGRID_PRIMS_MAX_K=k; 0: always lanes over rays, 32: always lanes over
prims; nvcc processes all at once) and times both forms on the
mesh benchmark's 99,458-triangle group, closest-hit and any-hit, on four
ray sets of 65,536: ``chip_smoke.py`` phase 2b's terrain rays (seed 5:
dead lanes, far-away lanes, a prepared running best or flag) and the kernel
lab's coherent, incoherent and local sets (``kernel_lab.synth_rays``;
tmin 1e-3, open windows).  Each time is the mean of REPS back-to-back
launches by CUDA events after a warm-up.  Every variant's outputs must
equal the shipped build's (the schedules compute the same function),
or the run fails.  Prints the card, one JSON line per (k, form, query, ray
set), then per form the crossover: the k whose worst excess over the best
k of each (query, ray set) pair is least (``pick``).  Needs the card;
without one it exits with status 1.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

CANDIDATES = (0, 4, 8, 12, 16, 20, 24, 32)
REPS = 20
N_RAYS = 65536


def terrain_rays(g, dev, n=N_RAYS, seed=5):
    """chip_smoke.py's random_rays(default_rng(seed), ...) moved around the
    terrain's box, as its phase 2b draws them."""
    rng = np.random.default_rng(seed)
    n_prims = len(g["prim_aabbs"])
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[: n // 4] = [500.0, 0.0, 0.0]
    rd[: n // 4] = [1.0, 0.0, 0.0]
    tmin = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, 0.3, n)).astype(np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.3, rng.uniform(1, 6, n),
                    np.finfo(np.float32).max).astype(np.float32)
    tmax[::7] = -1.0
    held = rng.uniform(size=n) < 0.3
    bt = np.where(held, np.minimum(rng.uniform(0.5, 4, n), tmax), tmax).astype(np.float32)
    be = np.where(held, rng.integers(0, max(n_prims, 1), n), -1).astype(np.int32)
    occ = (rng.uniform(size=n) < 0.2).astype(np.int32)
    ro = ro * np.float32([1.3, 0.6, 1.3]) + np.float32([0.0, 0.5, 4.0])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return {False: tuple(map(t, (ro, rd, tmin, tmax, bt, be))),
            True: tuple(map(t, (ro, rd, tmin, tmax, tmax, occ)))}


def lab_rays(name, lo, hi, dev):
    from pine_tpu_torch.lab.kernel_lab import BIG, synth_rays

    o, d = (torch.from_numpy(x).to(dev) for x in synth_rays(N_RAYS, name, lo, hi))
    tmin = torch.full((N_RAYS,), 1e-3, device=dev)
    tmax = torch.full((N_RAYS,), BIG, device=dev)
    zero = torch.zeros(N_RAYS, dtype=torch.int32, device=dev)
    return {False: (o, d, tmin, tmax, tmax, zero), True: (o, d, tmin, tmax, tmax, zero)}


def timed(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def pick(times, kind, ks):
    """The crossover of form ``kind`` from times {(kind, any_hit, ray set,
    k): ms}: the k whose worst excess over the best k of each (query, ray
    set) pair is least; beside it each k's summed ms and worst excess."""
    pairs = {key[1:3] for key in times if key[0] == kind}
    best = {p: min(times[(kind, *p, k)] for k in ks) for p in pairs}
    worst = {k: max(times[(kind, *p, k)] / best[p] - 1 for p in pairs) for k in ks}
    summed = {k: sum(times[(kind, *p, k)] for p in pairs) for k in ks}
    return dict(summed_ms=summed, worst_excess=worst, best_k=min(ks, key=worst.get))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    from pine_tpu_torch import cuda_build
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.lab.kernel_lab import RAYSETS, build_terrain_group

    if not torch.cuda.is_available():
        print("[Error] the crossover is measured on the card: no CUDA device is available")
        return 1
    dev = torch.device("cuda")
    ks = [int(k) for k in argv] or list(CANDIDATES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
                      "rays": N_RAYS, "reps": REPS, "candidates": ks}), flush=True)
    variants = [("grid_traverse", (f"GRID_PRIMS_MAX_K={k}",)) for k in ks]
    cuda_build.build(["grid_traverse", *variants])
    g, lo, hi = build_terrain_group(dev)
    for kind in ("grid", "grid_mxu"):
        DT.prepare(g, kind)
    raysets = {"phase2b_terrain": terrain_rays(g, dev),
               **{name: lab_rays(name, lo, hi, dev) for name in RAYSETS}}

    def query(kind, args, any_hit):
        return GT.grid_cuda(g["tid"], g["rows"], g[kind], *args, any_hit, mxu=kind == "grid_mxu")

    want = {(kind, any_hit, rs): query(kind, args[any_hit], any_hit)
            for kind in ("grid", "grid_mxu") for any_hit in (False, True)
            for rs, args in raysets.items()}
    times = {}
    real = GT._library
    try:
        for k, (name, defines) in zip(ks, variants):
            fn = GT.bind(cuda_build.load(name, defines).pine_grid_traverse)
            GT._library = lambda fn=fn: fn
            for (kind, any_hit, rs), out in want.items():
                args = raysets[rs][any_hit]
                got = query(kind, args, any_hit)
                if not (torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])):
                    raise SystemExit(f"crossover {k}: {kind} differs from the shipped build "
                                     f"on {rs}")
                ms = times[(kind, any_hit, rs, k)] = timed(lambda: query(kind, args, any_hit))
                print(json.dumps({"k": k, "form": kind, "any_hit": any_hit, "rays": rs,
                                  "ms": ms}), flush=True)
    finally:
        GT._library = real
    for kind in ("grid", "grid_mxu"):
        print(json.dumps({"form": kind, **pick(times, kind, ks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
