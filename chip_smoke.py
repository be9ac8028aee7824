#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of pine-tpu on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The card (``nvidia-smi`` name and power limit) and the build of every
   source: the CUDA kernels (csrc/*.cu, one nvcc each, all at once) and the
   host SAH builder (csrc/bvh_builder.cpp, g++) into build/pine_tpu_torch/.
2. Kernel against its plain PyTorch version on the card, 65,536 rays with dead
   lanes, far-away lanes and a prepared running best:
   a. the dense traversal for each of the nine prim types, closest-hit and
      any-hit, groups of 1, 16 and 424 prims, plus the benchmark Cornell
      box's own three groups;
   b. the grid traversal on triangle soups of 300 (no coarse level), 3,000
      and 20,000 triangles and on the 99,458-triangle terrain's own group;
   c. the two-level instanced traversal on the instancing benchmark's rock
      (4,802 triangles) in fields of 2x2, 32x32 (the benchmark's 1,024
      instances) and 101x101 (its --big 10,201), rays aimed into the field
      from above and started inside it.
   In b and c lanes may differ where a cull decides at a box face; at most
   GRID_MISMATCH_SHARE of them, and the counts are printed.
3. Render parity, card (kernels) against CPU (plain versions): the reduced
   Cornell box (36 cones), the reduced terrain (grid 40, 3,042 triangles,
   the card also with the coherence sort forced on) and a reduced rock
   field (3x3 instances of a 242-triangle rock, the card with its origin
   sort), 64x64, 4 spp, depth 4.
4. The main paths at full width through ``Scene.compile`` and
   ``render_wavefront`` on the card: the benchmark Cornell box (420 cones)
   and the mesh benchmark's terrain (99,458 triangles, one rect light) at
   640x640, BlueSampler(16), depth 4; the instancing benchmark's field
   (1,024 rocks, a plane, one rect light) at 512x512, BlueSampler(4), depth
   3.  For each, the launch counts are zeroed just before one render and
   read just after, and every kernel of that path must have run; then a
   profile of a 2-spp render.  The kernel line times each kernel form on
   every launch the main path gives it in a 1-spp render.  The
   ``coherence_sort`` record times the launches of a 1-spp render with the
   sort on (terrain: the octant key, on by default; rock field: the origin
   key, off by default and forced on here) and with its permutation undone,
   beside the device time of the sort itself.

Per-case records and the full-width images go to build/chip_smoke/.  The
last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the rest of the repository beside this file, it exits with code 2
and prints no result.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")  # per-case records, the images

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# FP32 operations of one prim test as csrc/prim_tests.cuh writes it (add,
# sub, mul, div, sqrt, min, max; compares and selects not counted), and of
# the dense kernel's per-ray group-box cull.
TEST_OPS = {0: 23, 1: 35, 2: 29, 3: 14, 4: 30, 5: 106, 6: 52, 7: 56, 8: 68}
CULL_OPS = 30
TYPE_NAMES = {0: "sphere", 1: "rect", 2: "disk", 3: "plane", 4: "aabb", 5: "obb",
              6: "triangle", 7: "cone", 8: "cylinder"}

T_RTOL, T_ATOL = 1e-5, 1e-6  # as tests/test_torch_dense_kernel.py
N_RAYS = 65536
MAIN_SIZE, MAIN_SPP, MAIN_DEPTH = 640, 16, 4  # bench.py's and bench_mesh.py's configuration
INST_SIZE, INST_SPP, INST_DEPTH = 512, 4, 3  # bench_instanced.py's configuration
GRID_MISMATCH_SHARE = 1e-4  # lanes where a culling kernel may differ from its plain version

# kind -> (module under pine_tpu_torch.accel, kernel wrapper, plain version,
# the group's table for it, kernel source, the TPU kernel it replaces).  The
# dense and grid wrappers take (tid, rows, table, rays...); with no table
# (None) a wrapper takes the whole group (g, rays...).
KERNELS = {
    "dense": ("dense_traverse", "dense_cuda", "dense_plain", "gbox",
              "pine_tpu_torch/csrc/dense_traverse.cu", "pine_tpu/accel/pallas_traverse.py:389"),
    "grid": ("grid_traverse", "grid_cuda", "grid_plain", "grid",
             "pine_tpu_torch/csrc/grid_traverse.cu", "pine_tpu/accel/pallas_traverse.py:791"),
    "inst": ("inst_traverse", "inst_cuda", "inst_plain", None,
             "pine_tpu_torch/csrc/inst_traverse.cu", "pine_tpu/accel/instanced_kernel.py:56"),
}
# lanes that may differ
ALLOWED_SHARE = {"dense": 0.0, "grid": GRID_MISMATCH_SHARE, "inst": GRID_MISMATCH_SHARE}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def module(kind):
    return importlib.import_module("pine_tpu_torch.accel." + KERNELS[kind][0])


def group_args(kind, g):
    """The leading arguments a wrapper of ``kind`` takes for group ``g``."""
    table = KERNELS[kind][3]
    return (g,) if table is None else (g["tid"], g["rows"], g[table])


def launch(kind, g, args, any_hit, plain=False, **kw):
    """One group's query through the kernel (or its plain version)."""
    _, wrapper, plain_fn = KERNELS[kind][:3]
    fn = getattr(module(kind), plain_fn if plain else wrapper)
    return fn(*group_args(kind, g), *args, any_hit, **kw)


def all_groups(cs):
    return cs.unified["groups"] + cs.unified.get("inst_groups", [])


def group_sig(g):
    """(kernel kind, prim type, prims or instances) of one compiled group."""
    if g["kind"] == "instanced":
        return ("inst", g["tid"], g["n_inst"])
    if "grid" in g:
        return ("grid", g["tid"], g["grid"]["n_prims"])
    return ("dense", g["tid"], int(g["rows"].shape[0]))


def group_desc(g):
    if g["kind"] == "instanced":
        return f"{TYPE_NAMES[g['tid']]}[{g['n_tris']}] x {g['n_inst']} instances"
    return f"{TYPE_NAMES[g['tid']]}[{group_sig(g)[2]}]"


def check_outputs(kind, out_k, out_p):
    """Kernel vs plain outputs -> (max |t error|, t mismatches, id mismatches,
    lanes that differ, lanes allowed to differ)."""
    import torch

    (t_k, e_k), (t_p, e_p) = out_k, out_p
    close = torch.isclose(t_k, t_p, rtol=T_RTOL, atol=T_ATOL) | (t_k == t_p)
    return (float((t_k - t_p).abs().max()), int((~close).sum()), int((e_k != e_p).sum()),
            int((~close | (e_k != e_p)).sum()), ALLOWED_SHARE[kind] * t_k.shape[0])


def timed_plain(kind, g, args, any_hit, counts=None):
    """The plain version once, under CUDA events -> (outputs, ms)."""
    import torch

    kw = {"counts": counts} if counts is not None else {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = launch(kind, g, args, any_hit, plain=True, **kw)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ---------------------------------------------------------------- phase 2 ----

def random_shape(S, V, tid, rng):
    import numpy as np

    def unit():
        v = rng.normal(size=3)
        return v / np.linalg.norm(v)

    c = rng.uniform(-1, 1, 3)
    if tid == S.SPHERE:
        return S.Sphere(c, rng.uniform(0.05, 0.2))
    if tid == S.RECT:
        ex = unit() * rng.uniform(0.2, 0.5)
        ey = np.cross(ex, unit())
        return S.Rect(c, ex, ey / np.linalg.norm(ey) * rng.uniform(0.2, 0.5))
    if tid == S.DISK:
        return S.Disk(c, unit(), rng.uniform(0.05, 0.3))
    if tid == S.PLANE:
        return S.Plane(c, unit())
    if tid == S.BOX_AABB:
        return S.BoxAABB(c - rng.uniform(0.02, 0.2, 3), c + rng.uniform(0.02, 0.2, 3))
    if tid == S.BOX_OBB:
        a = rng.uniform(-1, 1, 3)
        m = (V.translate(c) @ V.rotate_z(a[2]) @ V.rotate_y(a[1]) @ V.rotate_x(a[0])
             @ V.scale(rng.uniform(0.1, 0.4, 3)))
        return S.BoxOBB(S.BoxAABB([0, 0, 0], [1, 1, 1]), m)
    if tid == S.TRIANGLE:
        return S.Triangle(c, c + rng.uniform(-0.3, 0.3, 3), c + rng.uniform(-0.3, 0.3, 3))
    if tid == S.CONE:
        return S.Cone(c, unit(), rng.uniform(0.05, 0.2), rng.uniform(0.1, 0.4))
    return S.Cylinder(c, c + unit() * rng.uniform(0.1, 0.5), rng.uniform(0.03, 0.15))


def random_rays(rng, dev, n_prims):
    """Rays around the unit cube: a quarter start far out and point away,
    every 7th lane is dead (tmax = -1), some carry a prepared best."""
    import numpy as np
    import torch

    n = N_RAYS
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
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return dict(ro=t(ro), rd=t(rd), tmin=t(tmin), tmax=t(tmax), bt=t(bt), be=t(be), occ=t(occ))


def ray_args(r, any_hit):
    state = (r["tmax"], r["occ"]) if any_hit else (r["bt"], r["be"])
    return (r["ro"], r["rd"], r["tmin"], r["tmax"], *state)


def compare(kind, g, args, any_hit, time_it, what):
    """Kernel vs plain on one group and one set of inputs -> record."""
    out_k = launch(kind, g, args, any_hit)
    out_p, plain_ms = timed_plain(kind, g, args, any_hit)
    err, t_bad, e_bad, differ, allowed = check_outputs(kind, out_k, out_p)
    t_k, e_k = out_k
    rec = dict(
        group=what, type=TYPE_NAMES[g["tid"]], rows=int(g["rows"].shape[0]),
        form="any_hit" if any_hit else "closest", rays=int(t_k.shape[0]),
        max_abs_err=err, t_mismatch=t_bad, id_mismatch=e_bad, lanes_differ=differ,
        hits=int((e_k > 0).sum()) if any_hit else int((t_k < 1e30).sum()),
    )
    if kind == "grid":
        rec["coarse"] = bool(g["grid"]["use_coarse"])
    if kind == "inst":
        rec["instances"] = g["n_inst"]
    if time_it:
        rec["ms"] = cuda_ms(lambda: launch(kind, g, args, any_hit), 20)
        rec["plain_ms"] = plain_ms
    if differ > allowed:
        fail(f"{kind} kernel disagrees with its plain version beyond {allowed:g} lanes: {rec}")
    return rec


def phase_dense_vs_plain(dev):
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel.packet import build_packet_accel
    from pine_tpu_torch.convert import scene_arrays, upload_group
    from pine_tpu_torch.core import vecmath as V
    from pine_tpu_torch.scene import shapes as S

    recs = []
    for tid in sorted(TYPE_NAMES):
        for n in (1, 16, 424):
            rng = np.random.default_rng(1000 * tid + n)
            prims = []
            for i in range(n):
                s = random_shape(S, V, tid, rng)
                prims.append((tid, s.params(), i, s.get_aabb()))
            (g,) = build_packet_accel(prims)["groups"]
            g = upload_group(g, dev)
            r = random_rays(rng, dev, n)
            for any_hit in (False, True):
                recs.append(compare("dense", g, ray_args(r, any_hit), any_hit,
                                    time_it=(n == 424), what=f"{TYPE_NAMES[tid]}[{n}]"))
    # the benchmark box's own groups, fed rays from inside the box
    a = scene_arrays(scenes.cbox())
    rng = np.random.default_rng(7)
    r = random_rays(rng, dev, 424)
    r["ro"] = (r["ro"] * 0.3 + r["ro"].new_tensor([0.0, 1.0, 1.0])).contiguous()
    for i in range(int(a["n_groups"])):
        keys = ("tid", "kind", "base", "rows", "prim_aabbs", "lattice")
        g = upload_group({k: a[f"group.{i}.{k}"] for k in keys}, dev)
        for any_hit in (False, True):
            recs.append(compare("dense", g, ray_args(r, any_hit), any_hit, time_it=True,
                                what=f"cbox.{i}"))
    return recs


def triangle_soup(n_tri, seed):
    """A random triangle soup in the unit cube, as one Mesh: smaller
    triangles for larger soups, so a ray meets a few dozen either way."""
    import numpy as np

    from pine_tpu_torch.scene import shapes as S

    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    half = 2.0 / n_tri ** (1 / 3)
    tris = c[:, None, :] + rng.uniform(-half, half, (n_tri, 3, 3)).astype(np.float32)
    return S.Mesh(tris.reshape(-1, 3), np.arange(3 * n_tri).reshape(-1, 3))


def phase_grid_vs_plain(dev):
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.accel.packet import build_packet_accel
    from pine_tpu_torch.convert import upload_group

    cases = []
    for n_tri in (300, 3000, 20000):
        (g,) = build_packet_accel([], [(triangle_soup(n_tri, n_tri), 0)])["groups"]
        g = upload_group(g, dev)
        # a soup of 300 takes the dense kernel in a scene; test the grid anyway
        g["grid"] = GT.upload_layout(GT.grid_layout(g["prim_aabbs"]), dev)
        cases.append((f"soup{n_tri}", g, np.random.default_rng(n_tri + 1), None))
    cs = scenes.terrain().compile(dev)
    (g,) = [g for g in cs.unified["groups"] if "grid" in g]
    # rays around the terrain's box: x in [-4, 4], y about [-2, 2], z in [0, 8]
    cases.append(("terrain", g, np.random.default_rng(5), ((1.3, 0.6, 1.3), (0.0, 0.5, 4.0))))
    recs = []
    for what, g, rng, remap in cases:
        r = random_rays(rng, dev, g["grid"]["n_prims"])
        if remap:
            r["ro"] = (r["ro"] * r["ro"].new_tensor(remap[0]) + r["ro"].new_tensor(remap[1]))
            r["ro"] = r["ro"].contiguous()
        for any_hit in (False, True):
            recs.append(compare("grid", g, ray_args(r, any_hit), any_hit,
                                time_it=what in ("soup20000", "terrain"), what=what))
    return recs


def inst_group(n_side, dev):
    """The instancing benchmark's rock in an n_side x n_side field, as one
    instanced group on ``dev`` (its record built as Scene.compile builds it)."""
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import inst_traverse as IT
    from pine_tpu_torch.accel.packet import build_packet_accel, instancing_record
    from pine_tpu_torch.scene import shapes as S

    rec = instancing_record(S.Mesh(*scenes.make_rock()), scenes.rock_transforms(n_side),
                            np.arange(n_side * n_side))
    (g,) = build_packet_accel([], [], [rec])["inst_groups"]
    return IT.upload_inst_group(g, dev)


def field_rays(rng, dev, n_side, vbase):
    """random_rays' lanes (far, dead, windows, prepared best with regular
    ids below vbase); past the far quarter, half aimed from above at points
    of the field, half started inside its box in random directions."""
    import numpy as np
    import torch

    r = random_rays(rng, dev, vbase)
    n, q = N_RAYS, N_RAYS // 4
    lo = np.array([-0.8 * n_side - 0.5, 0.0, 1.5])
    hi = np.array([0.8 * n_side - 1.0, 1.2, 1.6 * n_side + 2.5])
    h = (n - q) // 2
    above = rng.uniform(lo, hi, (h, 3))
    above[:, 1] = rng.uniform(3.0, 8.0, h)
    inside = rng.uniform(lo, hi, (n - q - h, 3))
    ro = np.concatenate([above, inside])
    rd = np.concatenate([rng.uniform(lo, hi * [1, 0.8, 1], (h, 3)) - above,
                         rng.normal(size=(n - q - h, 3))])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    r["ro"][q:] = torch.from_numpy(ro.astype(np.float32)).to(dev)
    r["rd"][q:] = torch.from_numpy(rd.astype(np.float32)).to(dev)
    return r


def phase_inst_vs_plain(dev):
    import numpy as np

    recs = []
    for n_side in (2, 32, 101):
        g = inst_group(n_side, dev)
        r = field_rays(np.random.default_rng(n_side), dev, n_side, g["vbase"])
        for any_hit in (False, True):
            recs.append(compare("inst", g, ray_args(r, any_hit), any_hit, time_it=n_side == 32,
                                what=f"rock field {n_side}x{n_side}"))
    return recs


# ---------------------------------------------------------------- phase 3 ----

def force_sort(cs, mode):
    """Turn the coherence sort on with key ``mode`` ("octant" or "origin")."""
    if mode == "octant":
        cs.heavy_traversal = True  # as on the full terrain
    elif mode == "origin":
        cs.origin_sort = True


def render_parity(what, make_scene, sort=None):
    """Render ``make_scene()`` at 64x64x4spp depth 4 on the card (with the
    coherence sort forced on with key ``sort``) and on the CPU and hold them
    to the port's render criteria."""
    import numpy as np

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    out = {}
    for dev in ("cuda", "cpu"):
        sc = make_scene()
        cs = sc.compile(dev)
        if dev == "cuda":
            force_sort(cs, sort)
            if cs.sort_mode(64 * 64, True) != sort:
                fail(f"{what}: the card's sort key is {cs.sort_mode(64 * 64, True)}, not {sort}")
        img, st = render_wavefront(cs, sc.camera, 64, 64, BlueSampler(4), 4, 4, return_stats=True)
        out[dev] = (img.cpu().numpy(), st["traced_rays"])
    (g, rg), (c, rc) = out["cuda"], out["cpu"]
    d = np.abs(g - c)
    agree = ((d <= 1e-3 * np.abs(c)) | (d <= 1e-4)).all(-1).mean()
    rec = dict(phase="render_parity", scene=what, sort=sort,
               size="64x64x4spp depth 4", pixels_agree=float(agree),
               mean_cuda=float(g.mean()), mean_cpu=float(c.mean()),
               rays_cuda=int(rg), rays_cpu=int(rc), finite=bool(np.isfinite(g).all()))
    emit(rec)
    if not (rec["finite"] and agree >= 0.97 and abs(g.mean() - c.mean()) <= 0.01 * abs(c.mean())
            and abs(rg - rc) <= 0.005 * rc):
        fail(f"card render disagrees with the CPU render: {rec}")


def lazy_field(size, n_side, rock_grid):
    """scenes.instanced with its instancing kept lazy however small."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.scene import scene as scene_mod

    limit, scene_mod.FLATTEN_LIMIT = scene_mod.FLATTEN_LIMIT, 0
    try:
        return scenes.instanced(size, n_side, rock_grid)
    finally:
        scene_mod.FLATTEN_LIMIT = limit


def phase_render_parity():
    from pine_tpu_torch import scenes

    render_parity("reduced cbox, 36 cones",
                  lambda: scenes.cbox((64, 64), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0)))
    for sort in (None, "octant"):
        render_parity("reduced terrain, grid 40", lambda: scenes.terrain((64, 64), 40), sort)
    render_parity("reduced rock field, 3x3 x 242 triangles", lambda: lazy_field((64, 64), 3, 12),
                  "origin")


# ---------------------------------------------------------------- phase 4 ----

def dense_work(g, args, any_hit):
    """(FP32 operations, bytes, counts) of one dense call on these inputs."""
    import torch

    DT = module("dense")
    ro, rd, tmin, tmax, bt, be = args
    n = ro.shape[0]
    o = (ro[:, 0], ro[:, 1], ro[:, 2])
    d = (rd[:, 0], rd[:, 1], rd[:, 2])
    live = DT.cull_window(g["gbox"], o, d, tmin, tmax, bt, be, any_hit)
    rows = g["rows"]
    n_rows = rows.shape[0]
    if any_hit:
        # tests run until the first hit: count them row by row
        test = DT.PRIM_TESTS[g["tid"]]
        done = ~live
        tests = torch.zeros(n, dtype=torch.int64, device=ro.device)
        for e in range(n_rows):
            tests += (~done).to(torch.int64)
            done = done | (test(rows[e].__getitem__, o, d, tmin, tmax) < DT.BIG)
        n_tests = int(tests.sum())
        words_in = 10  # ro, rd, tmin, tmax, bt, be
    else:
        n_tests = int(live.sum()) * n_rows  # a dense sweep tests every row
        words_in = 9  # ro, rd, tmin, bt, be
    ops = n * CULL_OPS + n_tests * TEST_OPS[g["tid"]]
    nbytes = n * (words_in + 2) * 4 + rows.numel() * 4 + 24
    return ops, nbytes, dict(live_rays=int(live.sum()), prim_tests=n_tests)


def grid_work(g, args, any_hit, out_p, counts):
    """(FP32 operations, bytes, counts) of one grid call on these inputs.
    ``counts`` are grid_plain's, in row order.  Closest-hit: the bound takes
    the order-free minimum instead, the culls rerun with each lane's final t
    as the window, which no visit order can undercut.  Any-hit: the tests up
    to each lane's first hit in row order."""
    GT = module("grid")
    grid = g["grid"]
    n = args[0].shape[0]
    need = counts
    if not any_hit:
        need = {}
        GT.grid_plain(g["tid"], g["rows"], grid, *args[:4], *out_p, False, counts=need)
    ops = n * 3 + need["slabs"] * GT.SLAB_OPS + need["tests"] * TEST_OPS[g["tid"]]
    table_bytes = g["rows"].numel() * 4 + sum(grid[k].numel() * 4 for k in (
        "coarse_boxes", "sc_boxes", "cell_boxes", "c_order8", "s_order8"))
    nbytes = n * ((10 if any_hit else 9) + 2) * 4 + table_bytes
    return ops, nbytes, dict(slab_tests=counts["slabs"], prim_tests=counts["tests"],
                             min_slab_tests=need["slabs"], min_prim_tests=need["tests"])


def inst_work(g, args, any_hit, out_p, counts):
    """(FP32 operations, bytes, counts) of one instanced call on these
    inputs.  ``counts`` are inst_plain's (instances entered, slab and cell
    tests, triangle tests).  The bound counts what any correct walk must do:
    enter each instance whose world box the ray reaches within its window
    (slab and transform), test the cells of each supercell whose box it
    reaches, and test the triangles of each cell it reaches; top-tree,
    supercell-tree and supercell-box slabs are not counted.  Closest-hit:
    the window is each lane's final t (inst_plain rerun), which no visit
    order can undercut; any-hit: the work up to each lane's first hit in
    inst_plain's order."""
    IT = module("inst")
    sct = g["sctree"]
    n = args[0].shape[0]
    need = counts
    if not any_hit:
        need = {}
        IT.inst_plain(g, *args[:4], *out_p, False, counts=need)
    ops = (n * 3 + need["entries"] * IT.ENTER_OPS + need["cells"] * module("grid").SLAB_OPS
           + need["tests"] * TEST_OPS[g["tid"]])
    table_bytes = g["rows"].numel() * 4 + sum(
        sct[k].numel() * 4 for k in ("sc_boxes", "cell_boxes", "boxes", "cnode", "cstart",
                                     "ccount", "sc_order")) + sum(
        g[k].numel() * 4 for k in ("tboxes", "tnode", "tstart", "tcount", "iboxes", "minv"))
    nbytes = n * ((10 if any_hit else 9) + 2) * 4 + table_bytes
    return ops, nbytes, dict(instance_entries=counts["entries"], slab_tests=counts["slabs"],
                             prim_tests=counts["tests"], min_instance_entries=need["entries"],
                             min_cell_slabs=need["cells"], min_prim_tests=need["tests"])


def kernel_line_entry(kind, form, calls, launches):
    """Time one kernel form on the recorded main-path launches (every launch
    of one 1-spp render).  ms, plain_ms and bound_ms are means per launch;
    the work counts are sums over the launches."""
    any_hit = form == "any_hit"
    ms_each = []
    plain_ms = bound = err = 0.0
    ops = nbytes = differ = 0
    sums = {}
    for g, args, _ in calls:
        ms_each.append(cuda_ms(lambda: launch(kind, g, args, any_hit), 10))
        counts = None if kind == "dense" else {}
        out_p, p_ms = timed_plain(kind, g, args, any_hit, counts)
        plain_ms += p_ms
        c_err, _, _, c_differ, allowed = check_outputs(kind, launch(kind, g, args, any_hit), out_p)
        if c_differ > allowed:
            fail(f"{kind}.{form}: {c_differ} lanes disagree with the plain version "
                 "on main-path inputs")
        err, differ = max(err, c_err), differ + c_differ
        if kind == "grid":
            c_ops, c_bytes, c = grid_work(g, args, any_hit, out_p, counts)
        elif kind == "inst":
            c_ops, c_bytes, c = inst_work(g, args, any_hit, out_p, counts)
        else:
            c_ops, c_bytes, c = dense_work(g, args, any_hit)
        for key, v in c.items():
            sums[key] = sums.get(key, 0) + v
        ops += c_ops
        nbytes += c_bytes
        bound += max(c_bytes / HBM_BYTES_PER_S, c_ops / FP32_OPS_PER_S) * 1e3
    k = len(calls)
    groups = sorted({group_desc(g) for g, _, _ in calls})
    entry = dict(
        name=f"{KERNELS[kind][0]}.{form}", route="cuda", source=KERNELS[kind][4],
        replaces=KERNELS[kind][5], launches=launches, max_abs_err=err,
        ms=sum(ms_each) / k, plain_ms=plain_ms / k, bound_ms=bound / k,
        bound_by="operations" if ops / FP32_OPS_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None,
        inputs=" + ".join(groups)
        + f" x {calls[0][1][0].shape[0]} rays; means per launch over the {k} launches "
          "of one 1-spp render, work counts summed over them",
        ms_each=ms_each, lanes_differ=differ, **{f"{key}_sum": v for key, v in sums.items()},
    )
    return entry


def coherence_sort_record(cs, tag, kinds, render, n):
    """The coherence sort on the device: the kernels' launches of one 1-spp
    render with the sort on (forced for an instanced scene, where it is off
    by default), each timed as it ran and with the permutation undone,
    beside the device time of the sorts themselves (key, stable argsort,
    inverse)."""
    origin = cs.origin_sort
    cs.origin_sort = True
    try:
        mode = cs.sort_mode(n, True)
        recorded, sorts = record_launches(cs, kinds, render)
        sort_ms = sum(cuda_ms(lambda: cs.sort_perm(*s), 10) for s in sorts)
    finally:
        cs.origin_sort = origin
    sorted_each, unsorted_each = [], []
    for (kind, any_hit), calls in sorted(recorded.items()):
        for g, args, inv in calls:
            unsorted = args if inv is None else tuple(x[inv] for x in args)
            sorted_each.append(cuda_ms(lambda: launch(kind, g, args, any_hit), 10))
            unsorted_each.append(cuda_ms(lambda: launch(kind, g, unsorted, any_hit), 10))
    return dict(phase="coherence_sort", scene=tag, mode=mode,
                on_by_default=cs.sort_mode(n, True) is not None, per="one 1-spp render",
                sorts=len(sorts), sort_ms=sort_ms, kernel_ms_sorted=sum(sorted_each),
                kernel_ms_unsorted=sum(unsorted_each),
                net_saving_ms=sum(unsorted_each) - sum(sorted_each) - sort_ms,
                ms_sorted_each=sorted_each, ms_unsorted_each=unsorted_each)


def profile_render(what, render):
    """Where a render's device time goes: torch.profiler over one render,
    kernel time by name, and the device's busy share of the host wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit(dict(
        phase="profile", scene=what,
        what="one 2-spp render of the main path under torch.profiler",
        wall_ms=wall * 1e3, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / (wall * 1e3) if busy_ms else "not measured",
        launches=sum(e.count for e in kernels),
        **{f"{k}_ms": sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3
           for k in ("dense_kernel", "grid_kernel", "inst_kernel")},
        top=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3, count=e.count)
             for e in top],
    ))


def record_launches(cs, kinds, render):
    """Run ``render()`` with the wrappers of ``kinds`` recording every launch
    -> ({(kind, any_hit): [(group, inputs, inv)]}, [sort_perm inputs]);
    ``inv`` is the inverse of the coherence-sort permutation the launch ran
    under (None when unsorted), so inputs[inv] are the rays unsorted."""
    groups = all_groups(cs)
    recorded = {(kind, any_hit): [] for kind in kinds for any_hit in (False, True)}
    sorts = []
    current = {"inv": None}
    real_sort = cs.sort_perm

    def sort_recorder(ro, rd, dead):
        perm = real_sort(ro, rd, dead)
        if perm is not None:
            sorts.append((ro.clone(), rd.clone(), dead.clone()))
        current["inv"] = None if perm is None else perm[1]
        return perm

    reals = {kind: getattr(module(kind), KERNELS[kind][1]) for kind in kinds}

    def recorder(kind):
        n_lead = 3 if KERNELS[kind][3] else 1

        def rec(*a):
            lead, rays, any_hit = a[:n_lead], a[n_lead:n_lead + 6], a[n_lead + 6]
            g = lead[0] if n_lead == 1 else next(g for g in groups if g["rows"] is lead[1])
            recorded[(kind, any_hit)].append(
                (g, tuple(x.clone() for x in rays), current["inv"]))
            return reals[kind](*a)
        return rec

    cs.sort_perm = sort_recorder
    for kind in kinds:
        setattr(module(kind), KERNELS[kind][1], recorder(kind))
    try:
        render()
    finally:
        for kind in kinds:
            setattr(module(kind), KERNELS[kind][1], reals[kind])
        del cs.sort_perm
    return recorded, sorts


def phase_main_path(dev_name, tag, what, scene, groups_want, heavy_want, kinds,
                    size=MAIN_SIZE, spp=MAIN_SPP, depth=MAIN_DEPTH):
    """One main path at full width: compile on the card, record the kernels'
    inputs, warm up, three timed renders (launch counts zeroed just before the
    first, read just after), the image checked and saved, a profile, and the
    kernel line's entries for ``kinds``."""
    import numpy as np
    import torch

    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    W = H = size
    t0 = time.perf_counter()
    cs = scene.compile()  # the card, by default; the C++ SAH builder
    compile_s = time.perf_counter() - t0
    groups = [group_sig(g) for g in all_groups(cs)]
    if groups != groups_want or cs.heavy_traversal != heavy_want:
        fail(f"unexpected {tag} groups {groups} (heavy: {cs.heavy_traversal})")
    sampler = BlueSampler(spp)
    render = lambda s: render_wavefront(cs, scene.camera, W, H, sampler, s, depth)  # noqa: E731

    recorded, _ = record_launches(cs, kinds, lambda: render(1))
    torch.cuda.synchronize()

    render(spp)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for k in range(3):
        if k == 0:
            DT.reset_launches()
        t0 = time.perf_counter()
        img, stats = render_wavefront(cs, scene.camera, W, H, sampler, spp, depth,
                                      return_stats=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if k == 0:
            launches = dict(DT.LAUNCHES)
    want = {f"{kind}.{form}" for kind, _, _ in groups_want for form in ("closest", "any_hit")}
    for form in sorted(want):
        if launches[form] <= 0:
            fail(f"the {tag} main path never launched {form}: {launches}")
    img = img.cpu().numpy()
    finite = bool(np.isfinite(img).all())
    rays = int(stats["traced_rays"])
    rec = dict(phase="main_path", scene=what, size=f"{W}x{H}", spp=spp, depth=depth,
               device=dev_name, compile_s=compile_s, wall_s=min(walls), walls_s=walls,
               traced_rays=rays, mrays_per_s=rays / min(walls) / 1e6, finite=finite,
               mean=float(img.mean()), launches=launches)
    emit(rec)
    if not finite or img.shape != (H, W, 3) or not img.mean() > 0:
        fail(f"full-width {tag} render is not a finite, lit image: {rec}")
    os.makedirs(OUT_DIR, exist_ok=True)
    scene.camera.film.set_rgb(torch.from_numpy(img))
    scene.camera.film.save(os.path.join(OUT_DIR, f"chip_smoke_{tag}.png"))

    profile_render(tag, lambda: render(2))

    entries = [kernel_line_entry(kind, form, recorded[(kind, any_hit)],
                                 launches[f"{kind}.{form}"])
               for kind in kinds for form, any_hit in (("closest", False), ("any_hit", True))]
    if cs.heavy_traversal or cs.inst_traversal:
        emit(coherence_sort_record(cs, tag, kinds, lambda: render(1), W * H))
    return entries


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pine_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(dict(python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda))

    from pine_tpu_torch import cuda_build, scenes
    from pine_tpu_torch.accel import native_build

    sources = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    native_build.load()
    native_s = time.perf_counter() - t0
    logs = cuda_build.build(sources)
    emit(dict(phase="build", sources=sources + ["bvh_builder.cpp"], bvh_builder_s=native_s,
              seconds=time.perf_counter() - t0,
              ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                     for k, v in logs.items()}))

    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    for kind, phase in (("dense", phase_dense_vs_plain), ("grid", phase_grid_vs_plain),
                        ("inst", phase_inst_vs_plain)):
        recs = phase(dev)
        with open(os.path.join(OUT_DIR, f"chip_smoke_{kind}.json"), "w") as f:
            json.dump(recs, f, indent=1)
        emit(dict(phase="kernel_vs_plain", kernel=kind, cases=len(recs),
                  max_abs_err=max(r["max_abs_err"] for r in recs),
                  lanes_differ=sum(r["lanes_differ"] for r in recs),
                  timed=[{k: r[k] for k in ("group", "form", "ms", "plain_ms")}
                         for r in recs if "ms" in r]))

    phase_render_parity()
    name = torch.cuda.get_device_name(0)
    W = H = MAIN_SIZE
    kernels = phase_main_path(
        name, "cbox", "bench cbox, 420 cones", scenes.cbox((W, H)),
        [("dense", 1, 6), ("dense", 5, 2), ("dense", 7, 424)], False, ["dense"])
    kernels += phase_main_path(
        name, "terrain", "bench_mesh terrain, 99,458 triangles + 1 rect", scenes.terrain((W, H)),
        [("dense", 1, 1), ("grid", 6, 99458)], True, ["grid"])
    kernels += phase_main_path(
        name, "instanced", "bench_instanced rock field, 1,024 x 4,802 triangles + plane + rect",
        scenes.instanced((INST_SIZE, INST_SIZE)),
        [("dense", 1, 1), ("dense", 3, 1), ("inst", 6, 1024)], False, ["inst"],
        INST_SIZE, INST_SPP, INST_DEPTH)
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
