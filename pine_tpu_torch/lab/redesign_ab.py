"""A redesigned kernel against an earlier version of its source, measured on
the card.

    python -m pine_tpu_torch.lab.redesign_ab PARENT [kernel ...]

PARENT is a checkout of an earlier version of the repository (for example
``git archive`` of the parent commit unpacked under ``build/``).  For each
kernel named (``sctree``, ``mxup``, ``grid``, ``dense``, ``inst``,
``inst_mxu``, ``bvh``, ``scdense``, ``lattice`` and ``probe``; all ten by
default) its earlier build (PARENT's source, built by PARENT's own
cuda_build into PARENT/build) and this checkout's are timed in the order
earlier, this, this, earlier on the same inputs, both through this
checkout's wrapper and C signature (PARENT must have the same: since the
BVH's node records and scdense's padded rows, every kernel's has), and
each is held to the kernel's plain version:

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
  kernel 7 that reads the tile-major table gets it in the prim-major slot;
- ``dense`` (kernel 1): the benchmark box's three groups (rect, OBB, cone)
  with the same 409,600 rays of the lab's three sets over each group's box,
  and the depth-1 launches of the box's main path (a 1-spp render at
  640x640, depth 4: each group's first-bounce closest-hit and shadow-ray
  query); every launch of the mesh benchmark's rect group (a 1-spp render
  of its main path at 640x640, depth 4) and of the instancing benchmark's
  plane and rect groups (512x512, depth 3); and each of these groups on
  one ray (``floor``: the time of a call with next to no work); held to
  ``dense_traverse.dense_plain`` bit for bit; both builds read the padded
  rows (``dense_rows``);
- ``inst`` and ``inst_mxu`` (kernels 8 and 8m): the instancing benchmark's
  group (1,024 instances of its 4,802-triangle rock) on every launch of a
  1-spp render of its main path at 512x512, depth 3 (depths 0-2
  closest-hit, 0-1 shadow rays), held to ``inst_traverse.inst_plain``
  (with ``mxu`` for 8m) on all but 1e-4 of the lanes; each build gets its
  own stack depth;
- ``bvh`` (kernel 2): every launch of a 1-spp render of the 2 M terrain's
  main path (640x640, depth 4) and the mesh benchmark's 99,458-triangle
  group forced to "bvh" on ``grid_crossover``'s four ray sets, held to
  ``grid_traverse.supercell_plain`` on all but 1e-4 of the lanes (the
  closest-hit lanes both leave without a hit below BIG not compared), each
  reference computed once;
- ``scdense`` (kernel 3): the benchmark box's three groups under
  ``small_kernel="scdense"`` with the same 409,600 rays of the lab's three
  sets over each group's box, and each group's depth-1 launches of the
  box's main path (a 1-spp render at 640x640, depth 4), held to
  ``scdense_traverse.scdense_plain`` bit for bit;
- ``lattice`` (kernel 4): every launch of a 1-spp render of the cone
  forest's main path (640x640, depth 4: its 1,604-row lattice group), and
  ``chip_smoke.py`` phase 2d's other groups on its rays
  (``kernel_lab.lattice_field`` / ``lattice_rays``, the same seeds):
  the benchmark box's 21x20 cone group with the lattice march forced, a
  1x600 field of cones and a 24x24 field of spheres, closest-hit and
  any-hit; held to ``lattice_traverse.lattice_plain`` bit for bit, each
  reference computed once;
- ``probe`` (kernel 9): all seven variants of the cone-sweep probe on the
  box's 424-row cone group and ``cone_probe.N_RAYS`` (65,536) rays of each
  of the lab's three sets (``cone_probe.probe_inputs``), held to
  ``cone_probe.probe_plain`` bit for bit.

One more mode, ``sass``, builds every source by PARENT and by this
checkout and compares each kernel's SASS (``cuobjdump -sass``, instruction
words with their control codes, addresses and symbol names left out) with
the earlier build's: per source, the kernels whose code is identical, and
for each that differs its lines and the lines changed against the earlier
build's kernel in the same place.

Each time is the mean of ``grid_crossover.REPS`` back-to-back calls by
CUDA events after a warm-up: ``ms`` as the host issues them, ``device_ms``
with the calls queued behind a spin kernel, so that only the card's time
counts (a call shorter than the host's time per call is paced by the host
in ``ms``).  Prints the card, one JSON line per (build, query, ray set)
with both times and the lanes whose output differs bit for bit from the
plain version's and from this checkout's build, then per kernel, for each
of the two times, each build's summed ms (the mean of its timings), the
range over the (query, ray set) pairs of this build's time over the
earlier one's and that ratio for each pair.  Needs the card; without one it exits with status 1.
"""
from __future__ import annotations

import difflib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

BOX_RAYS = 640 * 640
SPIN_CYCLES = 20_000_000  # about 10 ms of the card's clock: longer than the host's REPS calls
SOURCES = {"sctree": "sctree_traverse", "mxup": "mxu_sweep", "grid": "grid_traverse",
           "dense": "dense_traverse", "inst": "inst_traverse", "inst_mxu": "inst_traverse",
           "bvh": "bvh_traverse", "scdense": "scdense_traverse", "lattice": "lattice_traverse",
           "probe": "cone_probe"}
MODES = (*SOURCES, "sass")
TYPE_NAMES = ("sphere", "rect", "disk", "plane", "aabb", "obb", "triangle", "cone", "cylinder")


def device_timed(fn, reps):
    """The device's mean ms per call of ``reps`` back-to-back calls: they
    queue behind a spin kernel, so the host's time per call does not pace
    them.  Raises if the host did not queue them all before the spin ended."""
    fn()
    torch.cuda.synchronize()
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda._sleep(SPIN_CYCLES)
    spun.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if spun.query():
        raise RuntimeError("the host queued the calls slower than the spin kernel ran")
    end.synchronize()
    return start.elapsed_time(end) / reps


def lanes_differ(out, ref):
    """Lanes whose (t, id) differ bit for bit."""
    return int(((out[0].view(torch.int32) != ref[0].view(torch.int32))
                | (out[1] != ref[1])).sum())


def within_gate(out, ref, any_hit, tree=False):
    """chip_smoke.py's gate for a culling kernel: t to rtol 1e-5 / atol 1e-6
    and ids equal on all but 1e-4 of the lanes (a tree walk's closest-hit
    lanes that both leave without a hit below BIG not compared)."""
    (t_k, e_k), (t_p, e_p) = out, ref
    differ = ~(torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6) | (t_k == t_p)) | (e_k != e_p)
    if tree and not any_hit:
        differ &= ~((t_k >= 1e30) & (t_p >= 1e30))
    return int(differ.sum()) <= 1e-4 * t_k.shape[0]


def main_path_launches(module, wrapper, render):
    """Run ``render()`` with ``module.wrapper`` recording its launches ->
    [(positional arguments, keyword arguments)], every tensor cloned."""
    calls = []
    real = getattr(module, wrapper)

    def rec(*a, **kw):
        calls.append((tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a), kw))
        return real(*a, **kw)

    setattr(module, wrapper, rec)
    try:
        render()
    finally:
        setattr(module, wrapper, real)
    torch.cuda.synchronize()
    return calls


def render_1spp(scene, size, depth, dev, **kernels):
    """A 1-spp render of a main path (BlueSampler(16), as chip_smoke.py's
    kernel line) -> its compiled scene and the render as a function."""
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    cs = scene.compile(dev, **kernels)
    return cs, lambda: render_wavefront(cs, scene.camera, size, size, BlueSampler(16), 1, depth)


def terrain_cases(dev, kind, libs):
    """The mesh benchmark's group and ray sets for kernel ``kind`` ("sctree"
    or "grid") -> (query(case, any_hit, build), check(out, case, any_hit)
    -> (within the gate, lanes differing bit for bit from the plain version),
    {(ray set, any_hit): case}), a case being the kernel's ray arguments."""
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
    mod, cuda, plain = (ST, ST.sctree_cuda, GT.supercell_plain) if tree else \
        (GT, GT.grid_cuda, GT.grid_plain)

    def query(args, any_hit, build):
        real = mod._library
        mod._library = lambda: libs[build]
        try:
            return cuda(g["tid"], g["rows"], g[kind], *args, any_hit)
        finally:
            mod._library = real

    def check(out, args, any_hit):
        ref = plain(g["tid"], g["rows"], g[kind], *args, any_hit)
        return within_gate(out, ref, any_hit, tree), lanes_differ(out, ref)

    return query, check, {(rs, h): a[h] for rs, a in sets.items() for h in (False, True)}


def box_rays(g, dev):
    """409,600 rays of each of the kernel lab's sets over group ``g``'s box:
    {ray set: ray arguments} (tmin 1e-3, tmax BIG, no hit yet)."""
    from pine_tpu_torch.lab.kernel_lab import BIG, RAYSETS, synth_rays

    n = BOX_RAYS
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), BIG, device=dev)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    lo, hi = g["prim_aabbs"][:, 0:3].min(0), g["prim_aabbs"][:, 3:6].max(0)
    out = {}
    for rs in RAYSETS:
        o, d = (torch.from_numpy(x).to(dev) for x in synth_rays(n, rs, lo, hi))
        out[rs] = (o, d, tmin, tmax, tmax, zero)
    return out


def mxup_cases(dev, libs):
    """terrain_cases' counterpart for kernel 7, a case being (group, ray
    arguments)."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.accel import mxu_sweep as MS
    from pine_tpu_torch.scene import shapes as S

    groups = {g["tid"]: g for g in scenes.cbox().compile(dev).unified["groups"]}
    cases = {}
    for name, tid in (("rect6", S.RECT), ("cone424", S.CONE)):
        g = groups[tid]
        DT.prepare(g, "mxup")
        for rs, args in box_rays(g, dev).items():
            for any_hit in (False, True):
                cases[(f"{name} {rs}", any_hit)] = (g, args)

    def query(case, any_hit, build):
        g, args = case
        tab = g["mxut"]
        if build == "earlier":  # the earlier kernel reads the tile-major table
            tab = dict(tab, Wp=tab["W"].view(tab["Wp"].shape))
        real = MS._library
        MS._library = lambda: libs[build]
        try:
            return MS.mxup_cuda(g["tid"], g["rows"], tab, *args, any_hit)
        finally:
            MS._library = real

    def check(out, case, any_hit):
        g, args = case
        n = lanes_differ(out, MS.mxup_plain(g["tid"], g["rows"], g["mxut"], *args, any_hit))
        return n == 0, n

    return query, check, cases


def dense_cases(dev, libs):
    """terrain_cases' counterpart for kernel 1, a case being (group, ray
    arguments); both builds read the padded rows."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import dense_traverse as DT

    cases = {}
    for tag, scene, size, depth in (("box", scenes.cbox(), 640, 4),
                                    ("terrain", scenes.terrain(), 640, 4),
                                    ("field", scenes.instanced(), 512, 3)):
        cs, render = render_1spp(scene, size, depth, dev)
        calls = [a for a, _ in main_path_launches(DT, "dense_cuda", render)]
        for g in cs.unified["groups"]:
            if g["variant"] != "dense":
                continue
            name = f"{tag} {TYPE_NAMES[g['tid']]}{g['rows'].shape[0]}"
            if tag == "box":
                for rs, args in box_rays(g, dev).items():
                    for any_hit in (False, True):
                        cases[(f"{name} {rs}", any_hit)] = (g, args)
            for any_hit in (False, True):
                mine = [a[3:9] for a in calls if a[0] == g["tid"] and a[-1] == any_hit]
                # the box's depth-1 query (its second of the render), the others' every one
                for k in (1,) if tag == "box" else range(len(mine)):
                    cases[(f"{name} depth{k}", any_hit)] = (g, mine[k])
                cases[(f"{name} floor", any_hit)] = (g, tuple(x[:1] for x in mine[0]))

    def query(case, any_hit, build):
        g, args = case
        rows = DT.kernel_rows(g, "dense")
        n = args[0].shape[0]
        out_t = torch.empty(n, dtype=torch.float32, device=dev)
        out_e = torch.empty(n, dtype=torch.int32, device=dev)
        err = libs[build](
            g["tid"], int(any_hit), rows.data_ptr(), rows.shape[1], rows.shape[0],
            g["gbox"].data_ptr(), *(x.data_ptr() for x in args), out_t.data_ptr(),
            out_e.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dense_traverse ({build} build) launch failed: CUDA error {err}")
        return out_t, out_e

    def check(out, case, any_hit):
        g, args = case
        n = lanes_differ(out, DT.dense_plain(g["tid"], g["rows"], g["gbox"], *args, any_hit))
        return n == 0, n

    return query, check, cases


def bvh_cases(dev, libs):
    """terrain_cases' counterpart for kernel 2, a case being (group, ray
    arguments): every launch of a 1-spp render of the 2 M terrain's main path
    (640x640, depth 4) and the 99,458-triangle terrain's group forced to
    "bvh" on grid_crossover's four ray sets."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import bvh_traverse as BT
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.lab.grid_crossover import lab_rays, terrain_rays
    from pine_tpu_torch.lab.kernel_lab import RAYSETS, build_terrain_group

    cases = {}
    cs, render = render_1spp(scenes.terrain((640, 640), 1002), 640, 4, dev)
    calls = [a for a, _ in main_path_launches(BT, "bvh_cuda", render)]
    (big,) = [g for g in cs.unified["groups"] if g["variant"] == "bvh"]
    for any_hit in (False, True):
        for k, a in enumerate(a for a in calls if a[-1] == any_hit):
            cases[(f"terrain2m depth{k}", any_hit)] = (big, a[3:9])
    del calls
    g, lo, hi = build_terrain_group(dev)
    DT.prepare(g, "bvh")
    sets = {"phase2b_terrain": terrain_rays(g, dev),
            **{name: lab_rays(name, lo, hi, dev) for name in RAYSETS}}
    for rs, a in sets.items():
        for any_hit in (False, True):
            cases[(f"terrain {rs}", any_hit)] = (g, a[any_hit])
    refs = {}

    def query(case, any_hit, build):
        g, args = case
        real = BT._library
        BT._library = lambda: libs[build]
        try:
            return BT.bvh_cuda(g["tid"], DT.kernel_rows(g, "bvh"), g["bvh"], *args, any_hit)
        finally:
            BT._library = real

    def check(out, case, any_hit):
        g, args = case
        key = (id(case), any_hit)
        if key not in refs:
            refs[key] = GT.supercell_plain(g["tid"], g["rows"], g["bvh"], *args, any_hit)
        return within_gate(out, refs[key], any_hit, tree=True), lanes_differ(out, refs[key])

    return query, check, cases


def scdense_cases(dev, libs):
    """terrain_cases' counterpart for kernel 3, a case being (group, ray
    arguments): the benchmark box's three groups under
    ``small_kernel="scdense"`` with 409,600 rays of the lab's three sets
    over each group's box (``box_rays``), and each group's depth-1 launches
    of the box's main path (a 1-spp render at 640x640, depth 4); held to
    ``scdense_plain`` bit for bit."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.accel import scdense_traverse as SD

    cs, render = render_1spp(scenes.cbox(), 640, 4, dev, small_kernel="scdense")
    calls = [a for a, _ in main_path_launches(SD, "scdense_cuda", render)]
    cases, refs = {}, {}
    for g in cs.unified["groups"]:
        name = f"{TYPE_NAMES[g['tid']]}{g['rows'].shape[0]}"
        for rs, args in box_rays(g, dev).items():
            for any_hit in (False, True):
                cases[(f"{name} {rs}", any_hit)] = (g, args)
        for any_hit in (False, True):
            mine = [a[3:9] for a in calls if a[0] == g["tid"] and a[-1] == any_hit]
            cases[(f"{name} depth1", any_hit)] = (g, mine[1])

    def query(case, any_hit, build):
        g, args = case
        real = SD._library
        SD._library = lambda: libs[build]
        try:
            return SD.scdense_cuda(g["tid"], DT.kernel_rows(g, "scdense"), g["scd"], *args,
                                   any_hit)
        finally:
            SD._library = real

    def check(out, case, any_hit):
        g, args = case
        key = (id(case), any_hit)
        if key not in refs:
            refs[key] = SD.scdense_plain(g["tid"], g["rows"], g["scd"], *args, any_hit)
        n = lanes_differ(out, refs[key])
        return n == 0, n

    return query, check, cases


def lattice_cases(dev, libs):
    """terrain_cases' counterpart for kernel 4, a case being (group, ray
    arguments): every launch of a 1-spp render of the cone forest's main
    path (640x640, depth 4), and phase 2d's box, 1x600-cone and
    24x24-sphere groups on its rays (``kernel_lab.lattice_field`` and
    ``lattice_rays``, the same seeds); held to ``lattice_plain`` bit for
    bit."""
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import lattice_traverse as LT
    from pine_tpu_torch.lab import kernel_lab as KL
    from pine_tpu_torch.scene import shapes as S

    forest = scenes.prl_scene(scenes.CONE_FOREST_PRL, "<cone forest>")
    _, render = render_1spp(forest, 640, 4, dev)
    calls = [a for a, _ in main_path_launches(LT, "lattice_cuda", render)]
    cases = {}
    for any_hit in (False, True):
        for k, a in enumerate(a for a in calls if a[-1] == any_hit):
            cases[(f"forest depth{k}", any_hit)] = (a[0], a[1:7])
    groups = (("cbox 21x20 lattice forced", scenes.cbox().compile(dev).unified["groups"][2]),
              ("cones 1x600", KL.lattice_field(dev, S.CONE, 1, 600, 1 / 256, 0.0025)),
              ("spheres 24x24", KL.lattice_field(dev, S.SPHERE, 24, 24, 0.1, 0.04)))
    for k, (what, g) in enumerate(groups, start=1):  # phase 2d's seeds
        r = KL.lattice_rays(np.random.default_rng(40 + k), dev, g)
        for any_hit in (False, True):
            cases[(what, any_hit)] = (g, KL.ray_args(r, any_hit))
    refs = {}

    def query(case, any_hit, build):
        g, args = case
        real = LT._library
        LT._library = lambda: libs[build]
        try:
            return LT.lattice_cuda(g, *args, any_hit)
        finally:
            LT._library = real

    def check(out, case, any_hit):
        g, args = case
        key = (id(case), any_hit)
        if key not in refs:
            refs[key] = LT.lattice_plain(g, *args, any_hit)
        n = lanes_differ(out, refs[key])
        return n == 0, n

    return query, check, cases


def probe_cases(dev, libs):
    """terrain_cases' counterpart for kernel 9, a case being (variant, the
    probe's inputs): every variant on the box's cone group and each of the
    lab's three ray sets; held to ``probe_plain`` bit for bit."""
    from pine_tpu_torch.lab import cone_probe as CP
    from pine_tpu_torch.lab.kernel_lab import RAYSETS

    cases = {}
    for rs in RAYSETS:
        inputs = CP.probe_inputs(dev, CP.N_RAYS, rs)
        for v in CP.VARIANTS:
            cases[(f"{v} {rs}", False)] = (v, inputs)
    refs = {}

    def query(case, any_hit, build):
        v, inputs = case
        real = CP._library
        CP._library = lambda: libs[build]
        try:
            return CP.probe_cuda(v, *inputs)
        finally:
            CP._library = real

    def check(out, case, any_hit):
        v, inputs = case
        if id(case) not in refs:
            refs[id(case)] = CP.probe_plain(v, *inputs)
        n = lanes_differ(out, refs[id(case)])
        return n == 0, n

    return query, check, cases


def inst_cases(dev, libs, depths, mxu):
    """terrain_cases' counterpart for kernels 8 (``mxu`` False) and 8m, a
    case being the ray arguments; ``depths`` holds each build's stack depth."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import inst_traverse as IT
    from pine_tpu_torch.accel import mxu_sweep as MS

    field = scenes.instanced((512, 512))
    cs, render = render_1spp(field, 512, 3, dev)
    calls = main_path_launches(IT, "inst_cuda", render)
    (g,) = cs.unified["inst_groups"]
    if mxu:
        MS.prepare_tables(g, "mxum")
    cases = {}
    for any_hit in (False, True):
        for k, a in enumerate(a for a, _ in calls if a[7] == any_hit):
            cases[(f"depth {k}", any_hit)] = a[1:7]

    def query(args, any_hit, build):
        real, depth = IT._library, IT.STACK_DEPTH
        IT._library, IT.STACK_DEPTH = (lambda: libs[build]), depths[build]
        try:
            return IT.inst_cuda(g, *args, any_hit, mxu=mxu)
        finally:
            IT._library, IT.STACK_DEPTH = real, depth

    def check(out, args, any_hit):
        ref = IT.inst_plain(g, *args, any_hit, mxu=mxu)
        return within_gate(out, ref, any_hit), lanes_differ(out, ref)

    return query, check, cases


def earlier_module(parent):
    """PARENT's own cuda_build module."""
    path = Path(parent).resolve() / "pine_tpu_torch" / "cuda_build.py"
    spec = importlib.util.spec_from_file_location("earlier_cuda_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def earlier_stack_depth(parent):
    """The instanced kernel's stack depth in PARENT's wrapper."""
    src = (Path(parent) / "pine_tpu_torch" / "accel" / "inst_traverse.py").read_text()
    return int(re.search(r"^STACK_DEPTH = (\d+)", src, re.M).group(1))


def run(kernel, dev, parent):
    """Time KERNEL's earlier build against this one on its cases, each held
    to the plain version."""
    from pine_tpu_torch.accel import bvh_traverse as BT
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.accel import inst_traverse as IT
    from pine_tpu_torch.accel import lattice_traverse as LT
    from pine_tpu_torch.accel import mxu_sweep as MS
    from pine_tpu_torch.accel import scdense_traverse as SD
    from pine_tpu_torch.accel import sctree_traverse as ST
    from pine_tpu_torch.lab import cone_probe as CP
    from pine_tpu_torch.lab.grid_crossover import REPS, timed

    source = SOURCES[kernel]
    mod = {"sctree": ST, "mxup": MS, "grid": GT, "dense": DT, "inst": IT, "inst_mxu": IT,
           "bvh": BT, "scdense": SD, "lattice": LT, "probe": CP}[kernel]
    earlier = getattr(earlier_module(parent).load(source), "pine_" + source)
    libs = {"this": mod._library(), "earlier": mod.bind(earlier)}
    if kernel == "bvh":
        query, check, cases = bvh_cases(dev, libs)
    elif kernel == "scdense":
        query, check, cases = scdense_cases(dev, libs)
    elif kernel == "lattice":
        query, check, cases = lattice_cases(dev, libs)
    elif kernel == "probe":
        query, check, cases = probe_cases(dev, libs)
    elif kernel in ("sctree", "grid"):
        query, check, cases = terrain_cases(dev, kernel, libs)
    elif kernel == "mxup":
        query, check, cases = mxup_cases(dev, libs)
    elif kernel in ("inst", "inst_mxu"):
        depths = {"this": IT.STACK_DEPTH, "earlier": earlier_stack_depth(parent)}
        query, check, cases = inst_cases(dev, libs, depths, kernel == "inst_mxu")
    else:
        query, check, cases = dense_cases(dev, libs)
    want = {key: query(case, key[1], "this") for key, case in cases.items()}
    times, device = {}, {}
    for build in ("earlier", "this", "this", "earlier"):
        for (rs, any_hit), case in cases.items():
            out = query(case, any_hit, build)
            ok, from_plain = check(out, case, any_hit)
            if not ok:
                raise SystemExit(f"{kernel} ({build} build) disagrees with the plain version "
                                 f"on {rs} (any_hit {any_hit}): {from_plain} lanes")
            ms = timed(lambda: query(case, any_hit, build))
            device_ms = device_timed(lambda: query(case, any_hit, build), REPS)
            times.setdefault((build, any_hit, rs), []).append(ms)
            device.setdefault((build, any_hit, rs), []).append(device_ms)
            print(json.dumps({"kernel": kernel, "build": build, "any_hit": any_hit, "rays": rs,
                              "ms": ms, "device_ms": device_ms,
                              "lanes_differ_from_plain": from_plain,
                              "lanes_differ_from_this_build": lanes_differ(
                                  out, want[(rs, any_hit)])}), flush=True)
    out = {"kernel": kernel}
    for name, t in (("", times), ("device_", device)):
        mean = {k: sum(v) / len(v) for k, v in t.items()}
        ratio = {f"{rs} {'any-hit' if any_hit else 'closest'}":
                 mean[("this", any_hit, rs)] / mean[("earlier", any_hit, rs)]
                 for any_hit, rs in sorted({k[1:] for k in mean})}
        out.update({f"{name}summed_ms": {b: sum(ms for k, ms in mean.items() if k[0] == b)
                                         for b in libs},
                    f"{name}this_over_earlier": [min(ratio.values()), max(ratio.values())],
                    f"{name}pairs": ratio})
    print(json.dumps(out), flush=True)


def sass_functions(lib):
    """[(name, code)] of a library's kernels in cuobjdump's order, the code
    each function's lines of instruction words with their control codes,
    without addresses and symbol names."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = []
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out.append((name.strip(), [re.sub(r"/\*[0-9a-f]{4,}\*/|`\([^)]*\)", "", ln).strip()
                                   for ln in body.splitlines() if "/*" in ln]))
    return out


def run_sass(parent):
    from pine_tpu_torch import cuda_build

    earlier = earlier_module(parent)
    names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    old = sorted(p.stem for p in earlier.CSRC.glob("*.cu"))
    cuda_build.build(names)
    earlier.build(old)
    for name in names:
        if name not in old:
            print(json.dumps({"source": name, "new": True}), flush=True)
            continue
        a = sass_functions(earlier.library_path(name))
        b = sass_functions(cuda_build.library_path(name))
        codes = {"\n".join(code) for _, code in a}
        differ = [(k, fn) for k, fn in enumerate(b) if "\n".join(fn[1]) not in codes]
        # a differing kernel beside the earlier build's kernel in the same place:
        # the lines of each, and the lines changed between them
        lines = [dict(name=fn[0], lines=len(fn[1]), earlier_lines=len(a[k][1]),
                      changed=sum(max(i2 - i1, j2 - j1) for op, i1, i2, j1, j2 in
                                  difflib.SequenceMatcher(None, a[k][1], fn[1]).get_opcodes()
                                  if op != "equal"))
                 for k, fn in differ if k < len(a)]
        print(json.dumps({"source": name, "kernels": len(b), "identical": len(b) - len(differ),
                          "differ": lines}), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in MODES:
        print(f"[Error] usage: redesign_ab PARENT [{' | '.join(MODES)} ...]")
        return 1
    parent, sel = argv[0], argv[1:] or list(SOURCES)
    unknown = [k for k in sel if k not in MODES]
    if unknown:
        print(f"[Error] unknown kernel {unknown}: one of {list(MODES)}")
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
        if kernel == "sass":
            run_sass(parent)
        else:
            run(kernel, dev, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
