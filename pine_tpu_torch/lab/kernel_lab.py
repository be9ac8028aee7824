"""Per-route traversal microbenchmark on the card.  Counterpart of the
repository's ``scripts_kernel_lab.py``.

    python -m pine_tpu_torch.lab.kernel_lab [cone420|terrain ...]

Times ``dense_traverse.group_query`` with each route forced (``variant=``)
on one group, over CHAIN dependent calls (each call's running best mixes in
the previous call's output at 1e-30 scale: numerically a fresh query, but
data-dependent), by CUDA events, min of 3 after a warm-up.  Workloads:

- ``cone420``: the benchmark box's cone group (``scenes.CBOX_PRL`` through
  the port's interpreter and ``compile()``, its largest group: 420 cones,
  424 rows), through the dense, grid, BVH and scdense routes;
- ``terrain``: the mesh benchmark's 99,458-triangle group
  (``scenes.terrain()``), through the grid and supercell-tree routes.

Ray sets (``synth_rays``, bit for bit the script's): coherent (a pinhole
fan from outside the group's box), incoherent (random origins and
directions) and local (1,024-ray blocks sharing an origin cell and a
direction octant).  ``random_rays`` / ``ray_args``, ``lattice_field`` and
``lattice_rays`` make the query state, lattice groups and aimed rays that
``chip_smoke.py``'s kernel checks and ``lab.redesign_ab`` share.  Prints one
JSON line per (workload, route, ray set);
a route the group cannot take (``dense_traverse.RouteRefused``) prints an
error record instead; any other failure ends the run.  LAB_RAYS
(65,536), LAB_CHAIN (8) and LAB_VARIANTS (a comma list of routes) as the
script reads them.  Needs the card; without one it exits with status 1.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

N_RAYS = int(os.environ.get("LAB_RAYS", 65536))
CHAIN = int(os.environ.get("LAB_CHAIN", 8))
BIG = 1e30
WORKLOADS = {"cone420": ("grid", "dense", "bvh", "scdense"), "terrain": ("grid", "sctree")}
RAYSETS = ("coherent", "incoherent", "local")


def synth_rays(n, mode, lo, hi, seed=0):
    """(o, d) float32 (n, 3) rays of ray set ``mode`` over the box (lo, hi)."""
    rng = np.random.default_rng(seed)
    c = (lo + hi) * 0.5
    ext = (hi - lo) * 0.5
    if mode == "coherent":
        # pinhole fan from outside the scene towards a grid on the far face
        eye = c + np.array([0.0, 0.3, -2.2]) * ext
        side = int(np.ceil(np.sqrt(n)))
        u = (np.arange(side, dtype=np.float32) + 0.5) / side * 2 - 1
        X, Y = np.meshgrid(u, u, indexing="xy")
        tgt = np.stack(
            [c[0] + X.ravel() * ext[0], c[1] + Y.ravel() * ext[1],
             np.full(side * side, hi[2], np.float32)], -1
        )[:n]
        o = np.tile(eye.astype(np.float32), (n, 1))
        d = tgt - o
    elif mode == "local":
        # a post-coherence-sort block: each 1024-ray block shares an origin
        # cell (1/16 of the scene span) and a direction octant
        blocks = (n + 1023) // 1024
        centers = rng.uniform(lo, hi, (blocks, 3)).astype(np.float32)
        octs = rng.integers(0, 2, (blocks, 3)).astype(np.float32) * 2 - 1
        o = np.repeat(centers, 1024, axis=0)[:n]
        o = o + rng.uniform(-1, 1, (n, 3)).astype(np.float32) * ext / 16
        d = np.abs(rng.normal(size=(n, 3)).astype(np.float32))
        d = d * np.repeat(octs, 1024, axis=0)[:n]
    else:
        o = rng.uniform(lo - 0.1 * ext, hi + 0.1 * ext, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    return o.astype(np.float32), d.astype(np.float32)


def _largest_group(scene, device):
    groups = scene.compile(device).unified["groups"]
    g = max(groups, key=lambda g: g["rows"].shape[0])
    return g, g["prim_aabbs"][:, 0:3].min(0), g["prim_aabbs"][:, 3:6].max(0)


def build_cone_group(device=None, src=None):
    """The benchmark box's largest group (its 424-row cone group), compiled
    on ``device`` (default: the card) from ``src`` (default
    ``scenes.CBOX_PRL``) -> (group, lo, hi) of its prims' boxes."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(out=lambda s: None)
    itp.run(scenes.CBOX_PRL if src is None else src, "<lab:cbox>")
    return _largest_group(itp.get_var("scene"), device)


def build_terrain_group(device=None, grid=None):
    """The mesh benchmark's triangle group (``scenes.terrain``; ``grid`` cuts
    it) -> (group, lo, hi)."""
    from pine_tpu_torch import scenes

    scene = scenes.terrain() if grid is None else scenes.terrain(grid=grid)
    return _largest_group(scene, device)


def random_rays(rng, dev, n_prims, n=65536):
    """``n`` rays on ``dev`` around the unit cube, as a dict of query state:
    a quarter start far out and point away, every 7th lane is dead
    (tmax = -1), some carry a prepared best (an id below ``n_prims``)."""
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
    """A group query's ray arguments (ro, rd, tmin, tmax, best_t, best_e)
    from ``random_rays``' state; any-hit takes the occlusion flags."""
    state = (r["tmax"], r["occ"]) if any_hit else (r["bt"], r["be"])
    return (r["ro"], r["rd"], r["tmin"], r["tmax"], *state)


def lattice_field(dev, tid, ni, nj, spacing, size):
    """An ni x nj field of cones (radius ``size``, height 0.05) or spheres
    (radius ``size``) on the floor plane y = 0, from x = -1.25 and z = 0.25,
    as one compiled lattice group on ``dev``; raises ValueError where the
    field is not detected as a lattice."""
    from pine_tpu_torch.accel.packet import build_packet_accel
    from pine_tpu_torch.convert import upload_group
    from pine_tpu_torch.scene import shapes as S

    prims = []
    for i in range(ni):
        for j in range(nj):
            p = [-1.25 + spacing * j, 0.0, 0.25 + spacing * i]
            shape = (S.Cone(p, [0, 1, 0], size, 0.05) if tid == S.CONE
                     else S.Sphere([p[0], size, p[2]], size))
            prims.append((tid, shape.params(), 0, shape.get_aabb()))
    (g,) = build_packet_accel(prims)["groups"]
    if g["lattice"] is None:
        raise ValueError(f"the {ni}x{nj} field of shape type {tid} is not detected as a lattice")
    return upload_group(g, dev)


def lattice_rays(rng, dev, g, n=65536):
    """random_rays' lanes (far, dead, windows, prepared best); past the far
    quarter, half aimed from above at points of the group's box, of which
    every 7th starts just above the floor and grazes it."""
    r = random_rays(rng, dev, int(g["rows"].shape[0]), n)
    q = n // 4
    box = g["gbox"].cpu().numpy().astype(np.float64)
    h = (n - q) // 2
    tgt = rng.uniform(box[:3], box[3:], (h, 3))
    ro = tgt + rng.uniform([-1.5, 0.3, -1.5], [1.5, 2.5, 1.5], (h, 3))
    ro[::7, 1] = rng.uniform(0.0, 0.06, len(ro[::7]))
    rd = tgt - ro
    rd[::7, 1] = rng.normal(scale=0.02, size=len(rd[::7]))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    r["ro"][q:q + h] = torch.from_numpy(ro.astype(np.float32)).to(dev)
    r["rd"][q:q + h] = torch.from_numpy(rd.astype(np.float32)).to(dev)
    return r


def chain_query(g, variant, ro, rd, tmin, tmax, chain=CHAIN):
    """``chain`` dependent closest-hit queries of group ``g`` by route
    ``variant`` -> the last (best_t, best_e)."""
    from pine_tpu_torch.accel import dense_traverse as DT

    bt, be = tmax, torch.zeros_like(tmax, dtype=torch.int32)
    for _ in range(chain):
        bt, be = DT.group_query(g, ro, rd, tmin, tmax, tmax + bt * 1e-30, be * 0,
                                any_hit=False, variant=variant)
    return bt, be


def run_variant(g, variant, raysets, label):
    """Time route ``variant`` on group ``g`` for each (name, o, d) ray set on
    the card and print one JSON line each."""
    from pine_tpu_torch.accel import dense_traverse as DT

    dev = g["rows"].device
    DT.prepare(g, variant)  # the route's tables, built once, outside the timing
    n = raysets[0][1].shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), BIG, device=dev)
    build_s = None
    for rayset, o, d in raysets:
        ro, rd = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
        t0 = time.perf_counter()
        out = chain_query(g, variant, ro, rd, tmin, tmax)
        torch.cuda.synchronize(dev)
        if build_s is None:
            build_s = time.perf_counter() - t0  # the first call builds the kernel
        walls = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain_query(g, variant, ro, rd, tmin, tmax)
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end) / 1e3)
        wall = min(walls)
        print(json.dumps({
            "workload": label, "variant": variant, "rays": rayset, "any_hit": False,
            "n_prims": int(g["rows"].shape[0]), "per_call_ms": wall / CHAIN * 1e3,
            "mrays": n * CHAIN / wall / 1e6, "wall_s": wall, "first_call_s": build_s,
            "hit_frac": float((out[0] < BIG * 0.5).float().mean()),
        }), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    from pine_tpu_torch.core.place import resolve_device

    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"[Error] {e}")
        return 1
    sel = argv or list(WORKLOADS)
    unknown = [w for w in sel if w not in WORKLOADS]
    if unknown:
        print(f"[Error] unknown workload {unknown}: one of {list(WORKLOADS)}")
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "rays": N_RAYS,
                      "chain": CHAIN}), flush=True)
    for label in sel:
        run_workload(label, dev, os.environ.get("LAB_VARIANTS"))
    return 0


def run_workload(label, dev, only=None):
    """Every route of workload ``label`` (or those in the comma list
    ``only``) on its group, compiled on ``dev``: one JSON line per route and
    ray set, or one error record for a route the group cannot take."""
    from pine_tpu_torch.accel.dense_traverse import RouteRefused

    build = {"cone420": build_cone_group, "terrain": build_terrain_group}[label]
    g, lo, hi = build(dev)
    raysets = [(name,) + synth_rays(N_RAYS, name, lo, hi) for name in RAYSETS]
    for variant in WORKLOADS[label]:
        if only and variant not in only.split(","):
            continue
        try:
            run_variant(g, variant, raysets, label)
        except RouteRefused as e:
            print(json.dumps({"workload": label, "variant": variant,
                              "error": repr(e)[:300]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
