"""A redesigned kernel against an earlier version of its source, measured on
the card.

    python -m pine_tpu_torch.lab.redesign_ab PARENT [sctree] [mxup] [grid]

PARENT is a checkout of an earlier version of the repository (for example
``git archive`` of the parent commit unpacked under ``build/``).  For each
kernel named (all three by default) its earlier build (PARENT's
csrc/sctree_traverse.cu, mxu_sweep.cu or grid_traverse.cu, built by
PARENT's own cuda_build into PARENT/build) and this checkout's are timed in
the order earlier, this, this, earlier on the same inputs, through the same
C signature, and each is held to the kernel's plain version:

- ``sctree`` and ``grid``: the mesh benchmark's 99,458-triangle group,
  closest-hit and any-hit, on ``grid_crossover``'s four ray sets of 65,536
  (``chip_smoke.py`` phase 2b's terrain rays and the kernel lab's coherent,
  incoherent and local sets), held to ``grid_traverse.supercell_plain`` /
  ``grid_plain`` on all but 1e-4 of the lanes (``chip_smoke.py``'s gate;
  the tree walk not on closest-hit lanes both leave without a hit below
  BIG);
- ``mxup`` (kernel 7): the benchmark box's rect group (6 prims) and cone
  group (424 rows) with 409,600 rays (a 640x640 wavefront) of the kernel
  lab's three sets over each group's box, closest-hit and any-hit (tmin
  1e-3, tmax BIG), held to ``mxu_sweep.mxup_plain`` bit for bit; an earlier
  kernel 7 that reads the tile-major table gets it in the prim-major slot.

Each time is the mean of ``grid_crossover.REPS`` back-to-back launches by
CUDA events after a warm-up.  Prints the card, one JSON line per (build,
query, ray set) with the lanes whose output differs bit for bit from this
checkout's build, then per kernel each build's summed ms (the mean of its
two timings) and the range over the (query, ray set) pairs of this build's
time over the earlier one's.  Needs the card; without one it exits with
status 1.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

BOX_RAYS = 640 * 640
SOURCES = {"sctree": "sctree_traverse", "mxup": "mxu_sweep", "grid": "grid_traverse"}


def terrain_cases(dev, kind):
    """The mesh benchmark's group and ray sets for kernel ``kind`` ("sctree"
    or "grid") -> (query(case, any_hit, earlier), check(out, case, any_hit),
    {(ray set, any_hit): case}), a case being the kernel's ray arguments;
    check holds the output to the kernel's plain version by chip_smoke.py's
    gate."""
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.accel import sctree_traverse as ST
    from pine_tpu_torch.lab.grid_crossover import lab_rays, terrain_rays
    from pine_tpu_torch.lab.kernel_lab import RAYSETS, build_terrain_group

    g, lo, hi = build_terrain_group(dev)
    DT.prepare(g, kind)
    sets = {"phase2b_terrain": terrain_rays(g, dev),
            **{name: lab_rays(name, lo, hi, dev) for name in RAYSETS}}
    tree = kind == "sctree"
    cuda, plain = (ST.sctree_cuda, GT.supercell_plain) if tree else (GT.grid_cuda, GT.grid_plain)

    def query(args, any_hit, earlier=False):
        return cuda(g["tid"], g["rows"], g[kind], *args, any_hit)

    def check(out, args, any_hit):
        t_p, e_p = plain(g["tid"], g["rows"], g[kind], *args, any_hit)
        t_k, e_k = out
        differ = ~(torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6) | (t_k == t_p)) | (e_k != e_p)
        if tree and not any_hit:
            differ &= ~((t_k >= 1e30) & (t_p >= 1e30))
        return int(differ.sum()) <= 1e-4 * t_k.shape[0]

    return query, check, {(rs, h): a[h] for rs, a in sets.items() for h in (False, True)}


def mxup_cases(dev):
    """terrain_cases' counterpart for kernel 7, a case being (group, ray
    arguments)."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.accel import mxu_sweep as MS
    from pine_tpu_torch.lab.kernel_lab import BIG, RAYSETS, synth_rays
    from pine_tpu_torch.scene import shapes as S

    groups = {g["tid"]: g for g in scenes.cbox().compile(dev).unified["groups"]}
    cases = {}
    n = BOX_RAYS
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), BIG, device=dev)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    for name, tid in (("rect6", S.RECT), ("cone424", S.CONE)):
        g = groups[tid]
        DT.prepare(g, "mxup")
        lo, hi = g["prim_aabbs"][:, 0:3].min(0), g["prim_aabbs"][:, 3:6].max(0)
        for rs in RAYSETS:
            o, d = (torch.from_numpy(x).to(dev) for x in synth_rays(n, rs, lo, hi))
            for any_hit in (False, True):
                cases[(f"{name} {rs}", any_hit)] = (g, (o, d, tmin, tmax, tmax, zero))

    def query(case, any_hit, earlier=False):
        g, args = case
        tab = g["mxut"]
        if earlier:  # the earlier kernel reads the tile-major table
            tab = dict(tab, Wp=tab["W"].view(tab["Wp"].shape))
        return MS.mxup_cuda(g["tid"], g["rows"], tab, *args, any_hit)

    def check(out, case, any_hit):
        g, args = case
        t_p, e_p = MS.mxup_plain(g["tid"], g["rows"], g["mxut"], *args, any_hit)
        return torch.equal(out[0].view(torch.int32), t_p.view(torch.int32)) and \
            torch.equal(out[1], e_p)

    return query, check, cases


def earlier_library(parent, source):
    """The C function of ``source`` as the checkout ``parent`` builds it."""
    path = Path(parent).resolve() / "pine_tpu_torch" / "cuda_build.py"
    spec = importlib.util.spec_from_file_location("earlier_cuda_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod.load(source), "pine_" + source)


def run(kernel, dev, parent):
    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.accel import mxu_sweep as MS
    from pine_tpu_torch.accel import sctree_traverse as ST
    from pine_tpu_torch.lab.grid_crossover import timed

    mod = {"sctree": ST, "mxup": MS, "grid": GT}[kernel]
    this = mod._library()
    earlier = mod.bind(earlier_library(parent, SOURCES[kernel]))
    query, check, cases = mxup_cases(dev) if kernel == "mxup" else terrain_cases(dev, kernel)
    want = {key: query(case, key[1]) for key, case in cases.items()}  # this build's output
    real = mod._library
    times = {}
    try:
        for build, fn in (("earlier", earlier), ("this", this), ("this", this),
                          ("earlier", earlier)):
            mod._library = lambda fn=fn: fn
            old = build == "earlier"
            for (rs, any_hit), case in cases.items():
                out = query(case, any_hit, old)
                if not check(out, case, any_hit):
                    raise SystemExit(f"{kernel} ({build} build) disagrees with the plain "
                                     f"version on {rs} (any_hit {any_hit})")
                ref = want[(rs, any_hit)]
                differ = int(((out[0].view(torch.int32) != ref[0].view(torch.int32))
                              | (out[1] != ref[1])).sum())
                ms = timed(lambda: query(case, any_hit, old))
                times.setdefault((build, any_hit, rs), []).append(ms)
                print(json.dumps({"kernel": kernel, "build": build, "any_hit": any_hit,
                                  "rays": rs, "ms": ms, "lanes_differ_from_this_build": differ}),
                      flush=True)
    finally:
        mod._library = real
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    summed = {b: sum(ms for k, ms in mean.items() if k[0] == b) for b in ("earlier", "this")}
    ratio = [mean[("this", *p)] / mean[("earlier", *p)] for p in {k[1:] for k in mean}]
    print(json.dumps({"kernel": kernel, "summed_ms": summed,
                      "this_over_earlier": [min(ratio), max(ratio)]}), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in SOURCES:
        print(f"[Error] usage: redesign_ab PARENT [{' | '.join(SOURCES)} ...]")
        return 1
    parent, sel = argv[0], argv[1:] or list(SOURCES)
    unknown = [k for k in sel if k not in SOURCES]
    if unknown:
        print(f"[Error] unknown kernel {unknown}: one of {list(SOURCES)}")
        return 1
    if not torch.cuda.is_available():
        print("[Error] the kernels are timed on the card: no CUDA device is available")
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    from pine_tpu_torch.lab.grid_crossover import REPS

    print(json.dumps({"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
                      "reps": REPS}), flush=True)
    for kernel in sel:
        run(kernel, dev, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
