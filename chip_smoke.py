#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of pine-tpu on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over),
run in the order 1, 2, 4, then 3 beside the CLIs of 5 whose walls are not
timed alone (CLI_WORKERS of them at a time: phase 3 measures nothing), then
5's timed commands (the bench, bench_prl, the lab modules) alone:

1. The card (``nvidia-smi`` name and power limit) and the build of every
   source: the CUDA kernels (csrc/*.cu, one nvcc each, all at once) and the
   host SAH builder (csrc/bvh_builder.cpp, g++) into build/pine_tpu_torch/.
2. Kernel against its plain PyTorch version on the card, 65,536 rays with dead
   lanes, far-away lanes and a prepared running best:
   a. the dense traversal for each of the nine prim types, closest-hit and
      any-hit, groups of 1, 16 and 424 prims (OBB and cone also 1,300, more
      than the kernel stages at once), plus the benchmark Cornell box's own
      three groups;
   b. the grid traversal on triangle soups of 300 (no coarse level), 3,000
      and 20,000 triangles and on the 99,458-triangle terrain's own group,
      and on that group three ray sets that drive its two leaf schedules
      (``schedule_rays``: one live lane per warp, full warps aimed at one
      prim, any-hit rays occluded by the middle prim of a cell);
   c. the two-level instanced traversal on the instancing benchmark's rock
      (4,802 triangles) in fields of 2x2, 32x32 (the benchmark's 1,024
      instances) and 101x101 (its --big 10,201), rays aimed into the field
      from above and started inside it;
   d. the lattice traversal on the cone forest's own 40x40 group, on the
      benchmark box's 21x20 cone group with the lattice march forced (the
      JAX package's cbox-lattice A/B), on a 1-D field of 600 cones and on a
      24x24 field of spheres, rays aimed at the field and grazing it; beside
      it, not gated, the dense kernel on the same groups and rays;
   e. the scdense sweep on the benchmark box's three groups, the cone
      forest's group and a 3,000-triangle soup; beside it the dense kernel;
   f. the supercell-tree walk on soups of 3,000 and 20,000 triangles and the
      terrain's group, and on that group b's three schedule ray sets (its
      warp-level walk and the grid kernel's leaf schedules); beside it the
      grid kernel;
   g. the BVH walk on the same soups, the terrain's group and the terrain
      grown to 2,004,002 triangles; beside it the grid kernel;
   h. the fused coefficient-table sweep (kernel 7, "mxup") against
      mxup_plain on groups of 1, 16, 300 (a partial last tile) and 424
      prims of each type with a table (sphere, rect, disk, plane, triangle,
      cone) and on the benchmark box's rect and cone groups; beside it, not
      gated, the dense kernel and the "mxu" route (torch.matmul and the
      epilogue), their agreement by tests/test_mxu_sweep.py's tolerance;
   i. the grid kernel's MXU form against its plain version on soups of
      3,000 and 20,000 triangles and the terrain's group, with b's three
      schedule ray sets; beside it the grid kernel;
   j. the instanced kernel's MXU leaf form against its plain version on the
      rock fields of 2x2 and 32x32; beside it the instanced kernel;
   k. the cone-sweep probe (kernel 9, csrc/cone_probe.cu) in each of its
      seven variants on the benchmark box's 424-row cone group and the
      kernel lab's three ray sets of 65,536 rays (coherent, incoherent,
      local); ``full`` then against the dense kernel on the same group and
      rays (t to rtol 1e-5 / atol 1e-6, ids equal where either hits), and
      ``inva`` against ``full`` (its largest deviation printed; t to rtol
      1e-5 on the lanes both hit, plus, where the far root t0 + sq / a is
      taken, INVA_ULPS ulps of the larger of those two terms, whose sum
      cancels; ids different only at a tie within that tolerance, and no
      lane hit by only one of the two).
   In b, c, f, g, i and j lanes may differ where a cull decides at a box
   face; at most GRID_MISMATCH_SHARE of them, and the counts are printed.
   In a, d, e, h and k no lane may differ, by the tolerance nor bit for bit
   (``lanes_differ_bits``: the dense kernel's gate beside its tolerance).
3. Render parity, card (kernels) against CPU (plain versions): the reduced
   Cornell box (36 cones), the reduced terrain (grid 40, 3,042 triangles,
   the card also with the coherence sort forced on), a reduced rock field
   (3x3 instances of a 242-triangle rock, the card with its origin sort)
   and a reduced cone forest (24x24 cones, still the lattice traversal),
   64x64, 4 spp, depth 4; and the reduced box with ``small_kernel``
   "scdense" and "mxup", the reduced terrain with ``mesh_kernel`` "sctree",
   "bvh" and "mxu" (its triangles made mesh-scale by a lower
   GRID_MAX_PRIMS) and the reduced rock field with ``inst_kernel`` "mxu";
   the reduced house (scenes/house.pine at 48x48, 8 spp, the goldens'
   patches) with PathIntegrator (depth 4) and CachedPathIntegrator (depth
   4, grid 32), each beside its RMSE against its committed golden
   (tests/goldens/house_*_48x48x8.npy, < 0.025 as tests/test_house.py);
   the reduced garden (scenes.REDUCED_GARDEN: 32x32, 4 spp, depth 3) under
   its Atmosphere with SobolSampler by both integrators (the cached one on
   a grid of 32), under the ImageSky with HaltonSampler, and under the Sky
   with SobolSampler and with BlueSampler; the media slice's reduced
   scenes (``media_parity``): the cloud and the emissive explosion on 16^3
   grids, the CSG fog box with the torus (depth 5), the fog box by the
   cached integrator, AO on the reduced box and the volume integrator; the
   lambda slice's (``lambda_parity``, each script run through the PRL
   interpreter on its device): a heightmap of an fbm lambda with a
   Function-node albedo, an SDF whose lambda runs a traced while and a
   traced if, the reduced box by RandomWalkIntegrator and by the path
   integrator with denoise(scene); the guided slice's (``guided_parity``,
   24x24, BlueSampler(4)): the reduced box with the tree and with the grid,
   the CSG fog box, the 16^3 cloud and the explosion, each iteration run on
   both devices from the CPU's guide (lockstep) and held by the rule, the
   guide's entries that differ after it printed; the cloud also rendered
   whole on each device at 8 spp, each training its own guide, held to the
   means; the last slice's (``last_slice_parity``, LAST_REDUCED): ReSTIR at
   32x32 and 4 spp on the reduced box, the fog box and the 16^3 cloud,
   MicroRenderGI on the classic-style scene at 64x32 with 512 surfels, each
   by the rule; MLT on the reduced box with 1,024 chains, one mutation step
   from the CPU's chains on both devices (the mutated samples bit for bit,
   the proposals' radiance lane by lane by the rule, the acceptances that
   differ counted) and the whole render (32x32, 4 spp on average, depth 4)
   on each device held to the means, the chain-steps decided otherwise
   counted; the modules slice's (``modules_parity``): the fly-cam session of
   INTERACTIVE_KEYS on the reduced box at 64x64 on each device, its last
   frame (8 spp at the moved camera) by the rule, and the reduced terrain
   with the octant sort and SORT_DIRBITS octahedral bins on the card.
4. The main paths at full width through ``Scene.compile`` and
   ``render_wavefront`` on the card: the benchmark Cornell box (420 cones;
   built from bench.py's script through the port's PRL interpreter, as
   bench.py builds it, after checking that it gives the Scene API box's
   arrays), the cone forest (the box's floor at twice the density: 1,600
   cones in one lattice group, from its script) and the mesh benchmark's
   terrain (99,458 triangles, one rect light) at 640x640, BlueSampler(16),
   depth 4 (the forest and the terrain, and the forced-kernel paths below,
   at depth 2 since the lambda slice: VARIANT_DEPTH; each path one timed
   render after its recording render, no longer three, for the time); the instancing
   benchmark's field (1,024 rocks, a plane, one rect
   light) at 512x512, BlueSampler(4), depth 3; then, at 640x640x16 spp,
   depth 4, the terrain grown to 2,004,002 triangles (the BVH walk, its
   default; depth 2, TERRAIN2M_DEPTH), the terrain with
   ``mesh_kernel="sctree"`` and the box with ``small_kernel="scdense"``; then the coefficient-table paths at full
   width: the box with ``small_kernel="mxup"`` (kernel 7 on its rect and
   cone groups) and the terrain with ``mesh_kernel="mxu"`` (the grid
   kernel's MXU form, the JAX package's default route for it), 640x640x16
   spp, depth 4, and the rock field with ``inst_kernel="mxu"`` (the
   instanced kernel's MXU leaf form), 512x512x4 spp, depth 3.  For each, the launch counts are zeroed just
   before one render and read just after, and every kernel of that path
   must have run; then a profile of a 2-spp render.  The ``kernel_ab``
   records time one group on every launch it gets in one 1-spp render
   through several kernels: the box's cone group through the dense kernel
   (its default), the lattice march, the scdense sweep, kernel 7 and the
   "mxu" route; the terrain's group through the grid kernel (its default),
   the supercell tree, the BVH walk and the grid kernel's MXU form; the rock
   field's instanced group through the instanced kernel and its MXU leaf
   form.  The kernel line times each kernel form on every launch the main
   path gives it in a 1-spp render (the plain version, over the 2 M group
   seconds a call, on the first launch of each form only), and the dense
   kernel's launches on the terrain, the 2 M terrain and the rock field too
   (entries ``dense_traverse.<path>.*``, each launch held to the plain
   version bit for bit); kernel 7's
   library column is the "mxu" route on the same launches.  The
   ``coherence_sort`` record times the launches of a 1-spp render with the
   sort on (the terrains: the octant key, on by default; rock field: the
   origin key, off by default and forced on here) and with its permutation
   undone, beside the device time of the sort itself.  The house
   (``scenes.house``: the GLB's 4,020 triangles on the grid kernel, one
   DirectionalLight, the window's mesh light) at 640x640 with
   PathIntegrator(BlueSampler(16), 5) as a main path (its kernel-line
   entries ``grid_traverse.house.*``: the grid kernel held to its plain
   version on every launch of a 1-spp render, the DirectionalLight's shadow
   rays to t = 1e10 among them), then the script's own
   CachedPathIntegrator(BlueSampler(128), 5, 128) once, launch counts zeroed
   and read around it, its learning and render phases timed apart.  The
   garden (scenes.GARDEN_PRL: an Atmosphere, a SpotLight, 420 cones of
   Noise3f albedo on a checkered ground, a Subsurface, a Glass and a Metal
   sphere, 24 fence lines) at 640x640, SobolSampler(16), depth 5, and under
   the ImageSky of images/cbox0.png with HaltonSampler(16), depth 2 since
   the lambda slice (GARDEN_IMAGESKY_DEPTH), as main paths:
   the dense kernel on its sphere, rect and cone groups (the subsurface
   walk's eight intersects per depth among its launches), held to
   dense_plain bit for bit on every launch of a 1-spp render (kernel-line
   entries ``dense_traverse.garden.*``, ``dense_traverse.garden_imagesky.*``);
   the line group on the "plain" route, which launches no kernel of the
   port's own (the ``groups`` record; its calls of a 1-spp render timed in
   the ``garden_setup`` record, with the script's build and an Atmosphere's
   map built alone, apart from compile_s).  The media slice's paths
   (``phase_media``): bench_cloud.py's chromatic cloud (pine_tpu_torch.
   bench_cloud's build_scene and render: 1920x1080, a 96^3 VDB, depth 3
   (CLOUD_DEPTH; bench_cloud's 6),
   CLOUD_SPP of bench_cloud's 256 samples, the cut printed), the CSG fog
   box (CSG_FOG_PRL, 640x640, BlueSampler(16), depth 5) and with an SDF
   torus (depth 2 since the last slice, FOG_SDF_DEPTH), and
   AOIntegrator(BlueSampler(16)) on the bench box at 640x640: the dense
   kernel held to dense_plain bit for bit on every launch of a 1-spp
   render (entries ``dense_traverse.cloud.*``,
   ``dense_traverse.csg_fog.*``, ``dense_traverse.csg_fog_sdf.*``,
   ``dense_traverse.ao.*``; the cloud's and the fog box's 8 and 6 prims
   build no accel, so each prim type's table is a group of its own), and a
   ``media_setup`` record of the plain routes (the SDF march, the CSG
   interval walk, the grid media's delta and ratio tracking, the
   homogeneous scatter): their calls and device ms in a 1-spp render.  On
   the AO path the timed render launches the direction kernel
   (csrc/ao_dirs.cu) 8 times a sample, in its blue form only; both forms
   (BlueSampler's draw in the kernel, HaltonSampler's u2 before it) are held
   bit for bit to the PyTorch chain on every launch of 1-spp renders of the
   box at 640x640 and at 1920x1080, the benchmark's AO lane count (entries
   ``ao_dirs.{ao,ao_1080p}.{blue,u}``).  The
   ``lab`` record: kernel 9's main path, the probe's chains on the box's
   cone group and 65,536 coherent rays as ``python -m
   pine_tpu_torch.lab.cone_probe`` runs them, launch counts zeroed just
   before and read just after; its kernel-line entries (one per variant)
   carry those times, each variant's own bound (its operations,
   ``cone_probe.VARIANT_OPS`` a ray-row pair and ``EARLY_OPS`` a pair
   whose discriminant rules out a hit, counted on these rays by
   ``cone_probe.early_misses``) beside the full sweep's, and phase 2k's
   plain times.  The lambda slice's paths (``phase_lambdas``): storm
   (STORM_PRL as written, 640x640 ``draw``) in process, its image against
   the CPU's (its non-finite values, where 0.5 - dot(u, u) is an exact 0,
   the same on both and at most STORM_NONFINITE_SHARE); tests/test_prl.py's
   traced fragments at 640x640, card against CPU bit for bit, their syncs
   per call (and the halving loop with a sync every iteration); the fog
   box with its torus as a PRL SDF lambda (CSG_FOG_SDF_PRL, 640x640,
   BlueSampler(16), depth FOG_SDF_DEPTH) as a main path, its image against
   phase media's torch-function torus, and the host time inside the distance
   function per march step, the lambda's and the torch function's (the
   ``sdf_lambda_host`` record); scenes/benchmark.pine in full with the
   interpreter on the host CPU (exact, the tier taken, wall, syncs),
   and at 10 outer iterations on the card with the masked loop's check
   every iteration and every EXIT_CHECK, in turns;
   RandomWalkIntegrator(BlueSampler(16), 4) and PathIntegrator(BlueSampler
   (16), 4) + denoise(scene) on the bench box as main paths (kernel-line
   entries ``dense_traverse.{csg_fog_sdf_prl,randomwalk,denoise}.*``, the
   dense kernel held to dense_plain bit for bit on every launch of a 1-spp
   render).  The guided slice's paths (``phase_guided``):
   GuidedPathIntegrator on the bench box with the tree and with the grid
   (640x640, BlueSampler(16), depth 4), the CSG fog box (640x640,
   GUIDED_FOG_SPP, GUIDED_FOG_DEPTH) and the cloud (1920x1080, BlueSampler(4),
   GUIDED_CLOUD_DEPTH), each as a main path (entries
   ``dense_traverse.guided_*``), with a
   ``guided`` record: each iteration's spp and seconds, the host's
   refinement ms, the trees' sizes and depths, the peak device memory.
   The last slice's paths (``phase_last_slice``): MltIntegrator(1, 4) on
   the bench box (640x640: 24 bootstrap rounds and 100 steps of 4,096
   chains, the depth-2 direct pass), RestirIntegrator(BlueSampler(16), 2)
   on the box and on the CSG fog box (640x640), MicroRenderGI(2048) on the
   classic-style scene (scenes.CLASSIC_MICRO_PRL, 720x360), each a main
   path (entries ``dense_traverse.{mlt_cbox,restir_cbox,restir_csg_fog,
   micro_classic}.*``: the dense kernel bit for bit its plain version on
   every launch of the recording render), with a ``last_slice`` record:
   peak device memory and, for MLT, its steps, the seconds of its
   bootstrap, chains and direct pass, and a step's seconds alone (one step
   profiled: its launches, the device's busy share).
   The modules slice's paths: the bench box's ``--progressive`` render
   (``render_progressive``, batches of PROGRESSIVE_EVERY of its 16 spp) and
   fly-cam session (``interactive.run_loop`` under INTERACTIVE_KEYS: moves,
   a turn, spp up to 8, a screenshot), each a main path (entries
   ``dense_traverse.{progressive_cbox,interactive_cbox}.*``, the dense
   kernel bit for bit on every launch of a 1-spp progressive render and of
   one frame), with a ``progressive`` record (the snapshots, the final film
   against the one-shot render to 1e-4, each batch's seconds, the wall
   against a one-shot render's) and an ``interactive`` record (frames, the
   frame ms at each spp from the status lines, the screenshot);
   ``phase_shards``: the box sample- and tile-sharded (parallel/
   distributed.py) by a world-size-1 "nccl" group in a subprocess, bit for
   bit render_wavefront's, then by that process and a second as two ranks
   on the card under "gloo" over CUDA tensors (tile bit for bit, sample to SHARD_ATOL), launches counted
   in each process (entries ``dense_traverse.{sample,tile}_sharded_
   {nccl1,gloo2}.*``), Mray/s and the film's all_reduce ms (the
   ``sharded`` records); ``phase_sort_bins``: the terrain with
   ``sort_dirbits`` SORT_DIRBITS as a main path (entries
   ``grid_traverse.terrain_dirbits.*``), its image bit for bit the octant
   sort's, and the ``sort_bins_ab`` record: in turns, the sorts' ms, the
   grid kernel's ms a launch and a 16-spp wall under each key.
5. The CLI: the benchmark box's script plus a render and a save, run as
   ``python -m pine_tpu_torch cbox.pine`` in a subprocess on the card; its
   image must equal phase 4's in-process render of the box (same sampler,
   spp and seed) on 97 % of the pixels; then ``python -m
   pine_tpu_torch.bench`` (bench.py's counterpart) in a subprocess: its
   JSON line finite, its traced rays within 0.5 % of phase 4's box; the
   house script as written (640x640, CachedPathIntegrator(BlueSampler(128),
   5, 128), its save to images/house3.png) with the GLB's path made
   absolute, from build/chip_smoke/: its PNG finite and lit; ``python -m
   pine_tpu_torch garden.pine`` (GARDEN_PRL as it stands, saving
   garden.png): its image equal to phase 4's garden on 97 % of the pixels;
   ``python -m pine_tpu_torch csg_fog.pine`` (CSG_FOG_PRL as it stands): its
   image equal to phase 4's fog box on 97 % of the pixels; a VDBMedium
   script over an .nvdb written to build/chip_smoke/: its PNG finite and lit;
   ``python -m pine_tpu_torch storm.pine`` (STORM_PRL as written): its PNG
   equal to phase 4's in-process run on 97 % of the pixels; ``python -m
   pine_tpu_torch.bench_prl`` (benchmark.pine in full, the lanes on the
   card): 502498700 through the batched tier; ``--seq``'s timing, in
   process: the sequential tier's wall beside the eager interpreter's, the
   same output;
   ``python -m pine_tpu_torch guided.pine`` (the box's script with
   GuidedPathIntegrator(BlueSampler(16), 4)): its PNG equal to phase 4's
   guided box on 97 % of the pixels; ``python -m pine_tpu_torch
   classic_micro.pine`` (CLASSIC_MICRO_PRL as written but for its save's
   path): its PNG equal to phase 4's MicroRenderGI render on 97 % of the
   pixels; the box's script with ``--progressive 4 --progressive-dir``: four
   snapshots, latest.png, index.html, its PNG the last snapshot's and the
   one-shot CLI's by the rule, its wall beside the one-shot's; with
   ``--interactive`` and PINE_INTERACTIVE_KEYS in a directory of its own:
   the frame ms at each spp from its status lines, the screenshot's PNG;
   ``python -m pine_tpu_torch.lab.cone_probe``: seven records, ``full`` and ``inva``
   finite, ``inva`` with ``max_dev_vs_full``; ``python -m
   pine_tpu_torch.lab.kernel_lab``: a time for every workload, route and
   ray set (a refused route, an error record, fails the phase).

Per-case records and the full-width images go to build/chip_smoke/.  The
last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the rest of the repository beside this file, it exits with code 2
and prints no result.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import threading
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
              6: "triangle", 7: "cone", 8: "cylinder", 9: "line"}

T_RTOL, T_ATOL = 1e-5, 1e-6  # as tests/test_torch_dense_kernel.py
N_RAYS = 65536
MAIN_SIZE, MAIN_SPP, MAIN_DEPTH = 640, 16, 4  # bench.py's and bench_mesh.py's configuration
# the depth of the cone forest, the terrain and the forced-kernel paths (the
# bench box keeps MAIN_DEPTH: phase 5's CLI and bench hold it), 2 since the
# lambda slice's paths came in, for chip_smoke.py's time
VARIANT_DEPTH = 2
INST_SIZE, INST_SPP, INST_DEPTH = 512, 4, 3  # bench_instanced.py's configuration
GRID_MISMATCH_SHARE = 1e-4  # lanes where a culling kernel may differ from its plain version
MAIN_RAYS = {}  # traced rays of each main path's render, by tag
MAIN_IMAGES = {}  # the image of each main path's timed render, by tag
MAIN_LAUNCHES = {}  # the launch counts of each main path's timed render, by tag
# the 2 M terrain's depth: 2, not MAIN_DEPTH, since the garden's paths came
# in (at depth 1 a path casts no shadow ray: the any-hit form would not run);
# its plain BVH walk takes 20-24 s a launch, and the kernel line holds every
# launch of a 1-spp render to it (3 at depth 2, 7 at depth 4)
TERRAIN2M_DEPTH = 2
# the garden (pine_tpu_torch/scenes.py GARDEN_PRL): its full width, and the
# groups it compiles to (the fence's lines on the "plain" route, no kernel)
GARDEN_SIZE, GARDEN_SPP, GARDEN_DEPTH = 640, 16, 5
# garden-imagesky's depth: 4 since the media slice's paths came in, 2 since
# the lambda slice's (the garden itself keeps the script's 5: phase 5 holds
# the CLI's image to it)
GARDEN_IMAGESKY_DEPTH = 2
GARDEN_GROUPS = [("dense", 0, 3), ("dense", 1, 1), ("dense", 7, 424), ("plain", 9, 24)]
# the media slice's paths: the cloud (bench_cloud.py's scene and film, 96^3,
# CLOUD_DEPTH; its spp cut from bench_cloud's 256 to CLOUD_SPP for the time), the
# CSG fog box (CSG_FOG_PRL as written) with and without the torus, AO on the
# bench box; scenes of 24 or fewer prims sweep each type's table on the dense
# kernel (CompiledScene.type_groups)
# depth 4 (bench_cloud's 6) since the lambda slice's paths came in, 3 since
# the last slice's
CLOUD_SPP, CLOUD_DEPTH, CLOUD_FULL_SPP = 4, 3, 256
CLOUD_GROUPS = [("dense", 1, 6), ("dense", 4, 2)]
FOG_SIZE, FOG_SPP, FOG_DEPTH = 640, 16, 5
# the fog box with the torus (the torch function's and the PRL lambda's) at
# depth 3 since the guided slice's paths came in, 2 since the last slice's,
# for the time (csg_fog itself keeps the script's 5: phase 5 holds its CLI
# image to it)
FOG_SDF_DEPTH = 2
FOG_GROUPS = [("dense", 1, 6)]
AO_SPP = 16
# csrc/ao_dirs.cu's bytes a lane: the normal read and the direction written,
# 12 each, and the u form's two uniforms read, 8 (the blue form's table
# gathers hit L2); and the benchmark's AO cells' lanes, 2,073,600
AO_DIRS_BYTES = {"blue": 24, "u": 32}
AO_HD = (1920, 1080)

# kind -> (module under pine_tpu_torch.accel, kernel wrapper in it, plain
# version as module.function, the group's table for it, kernel source, the
# TPU kernel it replaces).  The wrappers with a table take (tid, rows,
# table, rays...); with no table (None) a wrapper takes the whole group (g,
# rays...).
KERNELS = {
    "dense": ("dense_traverse", "dense_cuda", "dense_traverse.dense_plain", "gbox",
              "pine_tpu_torch/csrc/dense_traverse.cu", "pine_tpu/accel/pallas_traverse.py:389"),
    "grid": ("grid_traverse", "grid_cuda", "grid_traverse.grid_plain", "grid",
             "pine_tpu_torch/csrc/grid_traverse.cu", "pine_tpu/accel/pallas_traverse.py:791"),
    "inst": ("inst_traverse", "inst_cuda", "inst_traverse.inst_plain", None,
             "pine_tpu_torch/csrc/inst_traverse.cu", "pine_tpu/accel/instanced_kernel.py:56"),
    "lattice": ("lattice_traverse", "lattice_cuda", "lattice_traverse.lattice_plain", None,
                "pine_tpu_torch/csrc/lattice_traverse.cu", "pine_tpu/accel/pallas_traverse.py:592"),
    "scdense": ("scdense_traverse", "scdense_cuda", "scdense_traverse.scdense_plain", "scd",
                "pine_tpu_torch/csrc/scdense_traverse.cu", "pine_tpu/accel/pallas_traverse.py:459"),
    "sctree": ("sctree_traverse", "sctree_cuda", "grid_traverse.supercell_plain", "sctree",
               "pine_tpu_torch/csrc/sctree_traverse.cu", "pine_tpu/accel/pallas_traverse.py:1152"),
    "bvh": ("bvh_traverse", "bvh_cuda", "grid_traverse.supercell_plain", "bvh",
            "pine_tpu_torch/csrc/bvh_traverse.cu", "pine_tpu/accel/pallas_traverse.py:269"),
    "mxup": ("mxu_sweep", "mxup_cuda", "mxu_sweep.mxup_plain", "mxut",
             "pine_tpu_torch/csrc/mxu_sweep.cu", "pine_tpu/accel/mxu_sweep.py:324"),
    "grid_mxu": ("grid_traverse", "grid_cuda", "grid_traverse.grid_plain", "grid_mxu",
                 "pine_tpu_torch/csrc/grid_traverse.cu", "pine_tpu/accel/pallas_traverse.py:968"),
    "inst_mxu": ("inst_traverse", "inst_cuda", "inst_traverse.inst_plain", None,
                 "pine_tpu_torch/csrc/inst_traverse.cu", "pine_tpu/accel/instanced_kernel.py:238"),
    # not a kernel: torch.matmul and the epilogue in PyTorch (the library call
    # beside kernel 7), timed, never in the kernel line
    "mxu": ("mxu_sweep", "mxu_query", "mxu_sweep.mxu_query", "mxu",
            "pine_tpu_torch/accel/mxu_sweep.py", "pine_tpu/accel/mxu_sweep.py:465"),
}
# lanes that may differ: the lattice march has no cull whose outcome depends
# on the visit order, and the scdense sweep makes the same culls in the same
# order as its plain version, so every lane must agree bit for bit; the
# culling kernels that visit in another order may differ at a box face
ALLOWED_SHARE = {"dense": 0.0, "grid": GRID_MISMATCH_SHARE, "inst": GRID_MISMATCH_SHARE,
                 "lattice": 0.0, "scdense": 0.0, "sctree": GRID_MISMATCH_SHARE,
                 "bvh": GRID_MISMATCH_SHARE, "mxup": 0.0, "grid_mxu": GRID_MISMATCH_SHARE,
                 "inst_mxu": GRID_MISMATCH_SHARE}
# the MXU form against the VPU tests (tests/test_mxu_sweep.py:84-91): t of
# lanes both hit to rtol 3e-4 / atol 3e-5, hit sets equal on 99.5 % of lanes
MXU_RTOL, MXU_ATOL, MXU_HIT_SHARE = 3e-4, 3e-5, 0.995
# the MXU leaf forms: the grid and instanced kernels' wrappers with mxu=True
MXU_FORMS = ("grid_mxu", "inst_mxu")
# FP32 operations of kernel 7's coefficient-table test: 12 per pair value
# (six products and six sums, the last adding the constant column; the
# kernel's ordered sum also takes 1*w6 and 0*w7, 15 in all), the epilogue of
# csrc/mxu_epilogue.cuh (add, sub, mul, div, sqrt, max, abs) by prim type,
# and a ray's features o.d, o.o and d.d
VALUE_OPS = 12
EPI_OPS = {0: 10, 1: 7, 2: 9, 3: 1, 6: 6, 7: 24}
FEAT_OPS = 15


EMIT_LOCK = threading.Lock()  # phase 5's CLI threads emit beside the main thread


def emit(obj):
    with EMIT_LOCK:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()


def elapsed(step, t_start):
    """The run's seconds so far, after ``step``."""
    emit(dict(phase="elapsed", after=step, seconds=time.perf_counter() - t_start))


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


def lab():
    """The kernel lab: the query state, lattice groups and rays the checks share."""
    return importlib.import_module("pine_tpu_torch.lab.kernel_lab")


def group_args(kind, g, plain=False):
    """The leading arguments a wrapper of ``kind`` takes for group ``g``: a
    kernel the rows it reads (``dense_traverse.kernel_rows``: padded for the
    dense, scdense and BVH kernels), a plain version the group's own rows, so
    that the comparison also covers the padding."""
    table = KERNELS[kind][3]
    if table is None:
        return (g,)
    rows = g["rows"] if plain else module("dense").kernel_rows(g, kind)
    return (g["tid"], rows, g[table])


def launch(kind, g, args, any_hit, plain=False, **kw):
    """One group's query through the kernel (or its plain version)."""
    if kind in MXU_FORMS:
        kw["mxu"] = True
    if plain:
        name, _, fn = KERNELS[kind][2].partition(".")
        fn = getattr(importlib.import_module("pine_tpu_torch.accel." + name), fn)
    else:
        fn = getattr(module(kind), KERNELS[kind][1])
    return fn(*group_args(kind, g, plain), *args, any_hit, **kw)


def all_groups(cs):
    """The compiled scene's groups: the accel's, or without one the per-type
    groups (``CompiledScene.type_groups``)."""
    if cs.unified is None:
        return cs.type_groups
    return cs.unified["groups"] + cs.unified.get("inst_groups", [])


def group_sig(g):
    """(kernel kind, prim type, rows, prims or instances) of one compiled
    group: rows for the row sweeps (dense, scdense, lattice), prims for the
    culled traversals."""
    if g["kind"] == "instanced":
        return (g.get("variant", "inst"), g["tid"], g["n_inst"])
    v = g["variant"]
    return (v, g["tid"], int(g["rows"].shape[0]) if v in ("dense", "scdense", "lattice", "mxup",
                                                          "mxu")
            else len(g["prim_aabbs"]))


def group_desc(g):
    if g["kind"] == "instanced":
        return f"{TYPE_NAMES[g['tid']]}[{g['n_tris']}] x {g['n_inst']} instances"
    return f"{TYPE_NAMES[g['tid']]}[{group_sig(g)[2]}]"


def check_outputs(kind, out_k, out_p, any_hit):
    """Kernel vs plain outputs -> (max |t error| on the lanes compared, t
    mismatches, id mismatches, lanes that differ, lanes allowed to differ,
    lanes whose t or id differ bit for bit).  A kernel allowed no differing
    lane must also equal its plain version bit for bit: the dense kernel's
    gate, beside its tolerance.
    The tree walks (sctree, bvh) test other prims than their plain version,
    the row-order sweep: a closest-hit lane that both leave without a hit
    below the miss sentinel BIG carries, where its window ended above BIG,
    BIG and the id of a prim each tested first, or its incoming state where
    one tested none; such lanes read as misses to every caller
    (packet_intersect) and are not compared."""
    import torch

    (t_k, e_k), (t_p, e_p) = out_k, out_p
    bits = int(((t_k.view(torch.int32) != t_p.view(torch.int32)) | (e_k != e_p)).sum())
    close = torch.isclose(t_k, t_p, rtol=T_RTOL, atol=T_ATOL) | (t_k == t_p)
    if kind in ("lattice", "scdense", "mxup"):  # the same rounded arithmetic: bit for bit
        close = t_k.view(torch.int32) == t_p.view(torch.int32)
    same_e = e_k == e_p
    if kind in ("sctree", "bvh") and not any_hit:
        miss = (t_k >= 1e30) & (t_p >= 1e30)
        close, same_e = close | miss, same_e | miss
        t_k, t_p = t_k[~miss], t_p[~miss]
    err = float((t_k - t_p).abs().max()) if t_k.numel() else 0.0
    return (err, int((~close).sum()), int((~same_e).sum()), int((~close | ~same_e).sum()),
            ALLOWED_SHARE[kind] * out_k[0].shape[0], bits)


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




def compare(kind, g, args, any_hit, time_it, what):
    """Kernel vs plain on one group and one set of inputs -> record."""
    out_k = launch(kind, g, args, any_hit)
    out_p, plain_ms = timed_plain(kind, g, args, any_hit)
    err, t_bad, e_bad, differ, allowed, bits = check_outputs(kind, out_k, out_p, any_hit)
    t_k, e_k = out_k
    rec = dict(
        group=what, type=TYPE_NAMES[g["tid"]], rows=int(g["rows"].shape[0]),
        form="any_hit" if any_hit else "closest", rays=int(t_k.shape[0]),
        max_abs_err=err, t_mismatch=t_bad, id_mismatch=e_bad, lanes_differ=differ,
        lanes_differ_bits=bits,
        hits=int((e_k > 0).sum()) if any_hit else int((t_k < 1e30).sum()),
    )
    if kind == "grid":
        rec["coarse"] = bool(g["grid"]["use_coarse"])
    if kind == "inst":
        rec["instances"] = g["n_inst"]
    if kind == "lattice":
        rec["lattice"] = f"{g['lat']['ni']}x{g['lat']['nj']}, max_seg {g['lat']['max_seg']}"
    if kind in ("sctree", "bvh"):
        rec["depth"] = g[KERNELS[kind][3]]["depth"]
    if time_it:
        rec["ms"] = cuda_ms(lambda: launch(kind, g, args, any_hit), 20)
        rec["plain_ms"] = plain_ms
    if differ > allowed or (allowed == 0 and bits):
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
    for tid in sorted(TEST_OPS):  # the kernel's prim types (not the line's)
        # a forced dense route on 1,300 rows: three of the kernel's 512-row
        # tiles, the OBB's above the default shared-memory limit
        for n in (1, 16, 424) + ((1300,) if tid in (S.BOX_OBB, S.CONE) else ()):
            rng = np.random.default_rng(1000 * tid + n)
            prims = []
            for i in range(n):
                s = random_shape(S, V, tid, rng)
                prims.append((tid, s.params(), i, s.get_aabb()))
            (g,) = build_packet_accel(prims)["groups"]
            g = upload_group(g, dev)
            r = lab().random_rays(rng, dev, n)
            for any_hit in (False, True):
                recs.append(compare("dense", g, lab().ray_args(r, any_hit), any_hit,
                                    time_it=(n == 424), what=f"{TYPE_NAMES[tid]}[{n}]"))
    # the benchmark box's own groups, fed rays from inside the box
    a = scene_arrays(scenes.cbox())
    rng = np.random.default_rng(7)
    r = lab().random_rays(rng, dev, 424)
    r["ro"] = (r["ro"] * 0.3 + r["ro"].new_tensor([0.0, 1.0, 1.0])).contiguous()
    for i in range(int(a["n_groups"])):
        keys = ("tid", "kind", "base", "rows", "prim_aabbs", "lattice")
        g = upload_group({k: a[f"group.{i}.{k}"] for k in keys}, dev)
        for any_hit in (False, True):
            recs.append(compare("dense", g, lab().ray_args(r, any_hit), any_hit, time_it=True,
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


def schedule_rays(rng, dev, g):
    """Ray sets that drive the grid kernel's two leaf schedules on group
    ``g`` (triangles), 65,536 rays in warps of 32 lanes:
    - "one live lane": terrain_rays with every lane but the first of each
      warp dead (tmax and the running best -1): cells of k = 1, lanes over
      prims;
    - "full warps": each warp's 32 rays from one origin above the group,
      aimed within 1e-3 of one prim's centroid: cells of k = 32, lanes over
      rays;
    - "mid-cell occluders": each warp's rays aimed from 0.5 along the normal
      at the centroid of the middle prim (row 16) of a random cell, tmax 1
      (any-hit: occluded there); every lane in even warps (lanes over rays,
      leaving the cell mid-way), the first lane only in odd warps (lanes over
      prims)."""
    import numpy as np
    import torch

    n, warps = N_RAYS, N_RAYS // 32
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)  # noqa: E731
    rows = g["rows"].cpu().numpy()
    n_prims = len(g["prim_aabbs"])
    cen = (rows[:n_prims, 0:3] + rows[:n_prims, 3:6] + rows[:n_prims, 6:9]) / 3
    lo, hi = cen.min(0), cen.max(0)
    sets = {}

    r = terrain_rays(rng, dev, g)
    dead = torch.arange(n, device=dev) % 32 != 0
    for k in ("tmax", "bt"):
        r[k] = torch.where(dead, -1.0, r[k])
    sets["one live lane"] = r

    def aimed(ro, target, tmax):
        rd = target + rng.uniform(-1e-3, 1e-3, (n, 3)) - ro
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        tmax = np.asarray(tmax, np.float32)
        return dict(ro=t(ro), rd=t(rd), tmin=t(np.zeros(n)), tmax=t(tmax), bt=t(tmax),
                    be=torch.full((n,), -1, dtype=torch.int32, device=dev),
                    occ=torch.zeros(n, dtype=torch.int32, device=dev))

    eye = rng.uniform(lo, hi, (warps, 3)) + [0.0, 2.0, 0.0]
    tgt = cen[rng.integers(0, n_prims, warps)]
    sets["full warps"] = aimed(np.repeat(eye, 32, 0), np.repeat(tgt, 32, 0),
                               np.full(n, 1e30))

    mid = np.minimum(rng.integers(0, n_prims // 32, warps) * 32 + 16, n_prims - 1)
    nrm = np.cross(rows[mid, 3:6] - rows[mid, 0:3], rows[mid, 6:9] - rows[mid, 0:3])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    tmax = np.ones(n)
    tmax[(np.arange(n) // 32 % 2 == 1) & (np.arange(n) % 32 != 0)] = -1.0
    sets["mid-cell occluders"] = aimed(np.repeat(cen[mid] + 0.5 * nrm, 32, 0),
                                       np.repeat(cen[mid], 32, 0), tmax)
    return sets


def phase_grid_vs_plain(dev):
    import numpy as np

    from pine_tpu_torch.accel.dense_traverse import prepare

    cases = []
    for n_tri in (300, 3000, 20000):
        g = soup_group(n_tri, dev)
        prepare(g, "grid")  # a soup of 300 takes the dense kernel in a scene; test the grid anyway
        r = lab().random_rays(np.random.default_rng(n_tri + 1), dev, n_tri)
        cases.append((f"soup{n_tri}", g, r))
    g = terrain_group(dev)
    cases.append(("terrain", g, terrain_rays(np.random.default_rng(5), dev, g)))
    cases += [(f"terrain, {name}", g, r)
              for name, r in schedule_rays(np.random.default_rng(6), dev, g).items()]
    recs = []
    for what, g, r in cases:
        for any_hit in (False, True):
            recs.append(compare("grid", g, lab().ray_args(r, any_hit), any_hit,
                                time_it=what.startswith(("soup20000", "terrain")), what=what))
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

    r = lab().random_rays(rng, dev, vbase)
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
            recs.append(compare("inst", g, lab().ray_args(r, any_hit), any_hit,
                                time_it=n_side == 32, what=f"rock field {n_side}x{n_side}"))
    return recs




def lattice_vs_dense(g, args, any_hit):
    """The lattice kernel against the dense kernel on the same group and rays
    (recorded, not gated: the march rebuilds rows in float32 where the group's
    table holds the model rounded from float64)."""
    import torch

    DT = module("dense")
    t_l, e_l = launch("lattice", g, args, any_hit)
    t_d, e_d = launch("dense", g, args, any_hit)
    if any_hit:
        return dict(flags_differ=int((e_l != e_d).sum()))
    # a hit lowers t below the running best and the miss sentinel BIG
    hit_l, hit_d = (t_l < args[4]) & (t_l < 1e30), (t_d < args[4]) & (t_d < 1e30)
    both = hit_l & hit_d
    return dict(hit_masks_differ=int((hit_l != hit_d).sum()),
                max_abs_dt=float((t_l - t_d)[both].abs().max()) if bool(both.any()) else 0.0,
                t_bits_differ=int((t_l.view(torch.int32) != t_d.view(torch.int32))[both].sum()),
                ids_differ=int((e_l != e_d)[both].sum()), hits=int(both.sum()))


def phase_lattice_vs_plain(dev):
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.scene import shapes as S

    forest = scenes.prl_scene(scenes.CONE_FOREST_PRL).compile(dev).unified["groups"][2]
    cbox = scenes.cbox().compile(dev).unified["groups"][2]
    cases = [("cone forest 40x40", forest), ("bench cbox 21x20, lattice forced", cbox),
             ("cones 1x600", lab().lattice_field(dev, S.CONE, 1, 600, 1 / 256, 0.0025)),
             ("spheres 24x24", lab().lattice_field(dev, S.SPHERE, 24, 24, 0.1, 0.04))]
    recs = []
    for k, (what, g) in enumerate(cases):
        r = lab().lattice_rays(np.random.default_rng(40 + k), dev, g)
        for any_hit in (False, True):
            args = lab().ray_args(r, any_hit)
            rec = compare("lattice", g, args, any_hit, time_it=k < 2, what=what)
            rec["vs_dense"] = lattice_vs_dense(g, args, any_hit)
            if k < 2:
                rec["dense_ms"] = cuda_ms(lambda: launch("dense", g, args, any_hit), 20)
            recs.append(rec)
    return recs


def hits_differ(out_a, out_b, any_hit):
    """Lanes where two kernels' results differ as a caller reads them:
    any-hit, the flag; closest-hit, whether t is a hit (below the miss
    sentinel BIG), and on lanes both hit, t beyond the kernel-vs-plain
    tolerance or the id.  (A lane whose window ends above BIG gets BIG and
    the id of the first prim a kernel tested, which no caller reads.)"""
    import torch

    (t_a, e_a), (t_b, e_b) = out_a, out_b
    if any_hit:
        return int((e_a != e_b).sum())
    hit_a, hit_b = t_a < 1e30, t_b < 1e30
    close = torch.isclose(t_a, t_b, rtol=T_RTOL, atol=T_ATOL) | (t_a == t_b)
    return int(((hit_a != hit_b) | (hit_a & hit_b & (~close | (e_a != e_b)))).sum())


def compare_beside(kind, other, g, r, what, time_it=True):
    """compare() of ``kind`` on group ``g`` and rays ``r``, closest-hit and
    any-hit, and beside it, not gated, kernel ``other`` on the same group and
    rays: its ms and the lanes where the two differ (``hits_differ``)."""
    from pine_tpu_torch.accel.dense_traverse import prepare

    prepare(g, kind)
    prepare(g, other)
    recs = []
    for any_hit in (False, True):
        args = lab().ray_args(r, any_hit)
        rec = compare(kind, g, args, any_hit, time_it, what)
        rec[f"vs_{other}_lanes_differ"] = hits_differ(
            launch(kind, g, args, any_hit), launch(other, g, args, any_hit), any_hit)
        if time_it:
            rec[f"{other}_ms"] = cuda_ms(lambda: launch(other, g, args, any_hit), 10)
        recs.append(rec)
    return recs


def soup_group(n_tri, dev):
    from pine_tpu_torch.accel.packet import build_packet_accel
    from pine_tpu_torch.convert import upload_group

    (g,) = build_packet_accel([], [(triangle_soup(n_tri, n_tri), 0)])["groups"]
    return upload_group(g, dev)


def terrain_rays(rng, dev, g):
    """random_rays' lanes moved around the terrain's box (x in [-4, 4], y about
    [-2, 2], z in [0, 8])."""
    r = lab().random_rays(rng, dev, len(g["prim_aabbs"]))
    r["ro"] = (r["ro"] * r["ro"].new_tensor((1.3, 0.6, 1.3)) + r["ro"].new_tensor((0.0, 0.5, 4.0)))
    r["ro"] = r["ro"].contiguous()
    return r


def phase_scdense_vs_plain(dev):
    """scdense against its plain version (bit for bit) on the benchmark box's
    three groups, the cone forest's 1,604-row group and a 3,000-triangle
    soup; beside it the dense kernel."""
    import numpy as np

    from pine_tpu_torch import scenes

    recs = []
    rng = np.random.default_rng(70)
    for i, g in enumerate(scenes.cbox().compile(dev).unified["groups"]):
        r = lab().random_rays(rng, dev, int(g["rows"].shape[0]))
        r["ro"] = (r["ro"] * 0.3 + r["ro"].new_tensor([0.0, 1.0, 1.0])).contiguous()
        recs += compare_beside("scdense", "dense", g, r, f"cbox.{i}")
    forest = scenes.prl_scene(scenes.CONE_FOREST_PRL).compile(dev).unified["groups"][2]
    recs += compare_beside("scdense", "dense", forest, lab().lattice_rays(rng, dev, forest),
                           "cone forest 40x40")
    g = soup_group(3000, dev)
    recs += compare_beside("scdense", "dense", g, lab().random_rays(rng, dev, 3000), "soup3000")
    return recs


def phase_tree_vs_plain(dev, kind, big):
    """sctree or bvh against its plain version on soups of 3,000 and 20,000
    triangles and on the terrain's group (and, for bvh, the 2,004,002-triangle
    group ``big``; for sctree, ``schedule_rays`` on the terrain's group);
    beside it the grid kernel."""
    import numpy as np

    recs = []
    rng = np.random.default_rng(80)
    for n_tri in (3000, 20000):
        g = soup_group(n_tri, dev)
        recs += compare_beside(kind, "grid", g, lab().random_rays(rng, dev, n_tri), f"soup{n_tri}",
                               time_it=n_tri == 20000)
    terrain = terrain_group(dev)
    groups = [("terrain", terrain)] + ([("terrain 2M", big)] if big else [])
    for what, g in groups:
        recs += compare_beside(kind, "grid", g, terrain_rays(rng, dev, g), what)
    if kind == "sctree":
        for name, r in schedule_rays(np.random.default_rng(6), dev, terrain).items():
            recs += compare_beside(kind, "grid", terrain, r, f"terrain, {name}")
    return recs


def terrain_group(dev, grid=None):
    """The triangle group of the mesh benchmark's terrain (``grid`` cuts or
    grows it), compiled on ``dev``."""
    from pine_tpu_torch import scenes

    scene = scenes.terrain() if grid is None else scenes.terrain(grid=grid)
    return scene.compile(dev).unified["groups"][1]


def mxu_lanes_differ(out_a, out_b, any_hit):
    """Lanes where two results of one group differ beyond the MXU tolerance
    (MXU_RTOL / MXU_ATOL): any-hit, the flag; closest-hit, whether t is a
    hit (below the miss sentinel BIG), and on lanes both hit, t or the id."""
    import torch

    (t_a, e_a), (t_b, e_b) = out_a, out_b
    if any_hit:
        return int((e_a != e_b).sum())
    hit_a, hit_b = t_a < 1e30, t_b < 1e30
    close = torch.isclose(t_a, t_b, rtol=MXU_RTOL, atol=MXU_ATOL) | (t_a == t_b)
    return int(((hit_a != hit_b) | (hit_a & hit_b & (~close | (e_a != e_b)))).sum())


def mxu_agree(out_a, out_b, any_hit):
    """tests/test_mxu_sweep.py's criteria for two results of one group: the
    share of lanes whose hit (closest: t below BIG; any-hit: the flag) is
    the same, the lanes both hit whose t differs beyond rtol 3e-4 / atol
    3e-5, the share of lanes whose id agrees where both hit, and whether
    all hold (hit sets on 99.5 %, no t beyond, ids on 99 %)."""
    import torch

    (t_a, e_a), (t_b, e_b) = out_a, out_b
    if any_hit:
        share = float((e_a == e_b).float().mean())
        return dict(hit_share=share, within=share >= MXU_HIT_SHARE)
    hit_a, hit_b = t_a < 1e30, t_b < 1e30
    share = float((hit_a == hit_b).float().mean())
    both = hit_a & hit_b
    beyond = int((~torch.isclose(t_a[both], t_b[both], rtol=MXU_RTOL, atol=MXU_ATOL)).sum())
    ids = float(((e_a == e_b) | ~both).float().mean())
    return dict(hit_share=share, t_beyond=beyond, id_share=ids,
                within=share >= MXU_HIT_SHARE and beyond == 0 and ids > 0.99)


def prep(g, kind):
    """Build the tables route ``kind`` reads on group ``g`` (a prim group, or
    an instanced group for "inst" / "inst_mxu")."""
    from pine_tpu_torch.accel import mxu_sweep
    from pine_tpu_torch.accel.dense_traverse import prepare

    if kind == "inst_mxu":
        mxu_sweep.prepare_tables(g, "mxum")
    elif kind != "inst":
        prepare(g, kind)


def compare_mxu(kind, others, g, r, what, time_it):
    """compare() of an MXU form ``kind`` on group ``g`` and rays ``r``,
    closest-hit and any-hit, and beside it, not gated, each kernel of
    ``others`` on the same inputs: its agreement by tests/test_mxu_sweep.py's
    criteria (``mxu_agree``) and, when ``time_it``, its ms."""
    for k in (kind, *others):
        prep(g, k)
    recs = []
    for any_hit in (False, True):
        args = lab().ray_args(r, any_hit)
        rec = compare(kind, g, args, any_hit, time_it, what)
        out_k = launch(kind, g, args, any_hit)
        for other in others:
            rec[f"vs_{other}"] = mxu_agree(launch(other, g, args, any_hit), out_k, any_hit)
            if time_it:
                rec[f"{other}_ms"] = cuda_ms(lambda: launch(other, g, args, any_hit), 10)
        recs.append(rec)
    return recs


def phase_mxup_vs_plain(dev):
    """Kernel 7 against mxup_plain, bit for bit, on groups of 1, 16, 300 (a
    partial last tile) and 424 prims of each type with a table and on the
    benchmark box's rect and cone groups; beside it the dense kernel and
    the mxu route (torch.matmul)."""
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel.packet import build_packet_accel
    from pine_tpu_torch.convert import GROUP_KEYS, scene_arrays, upload_group
    from pine_tpu_torch.core import vecmath as V
    from pine_tpu_torch.scene import shapes as S

    from pine_tpu_torch.accel.mxu_tables import MXU_M

    recs = []
    for tid in sorted(MXU_M):
        for n in (1, 16, 300, 424):
            rng = np.random.default_rng(2000 + 1000 * tid + n)
            prims = []
            for i in range(n):
                s = random_shape(S, V, tid, rng)
                prims.append((tid, s.params(), i, s.get_aabb()))
            (g,) = build_packet_accel(prims)["groups"]
            g = upload_group(g, dev)
            recs += compare_mxu("mxup", ("dense", "mxu"), g, lab().random_rays(rng, dev, n),
                                f"{TYPE_NAMES[tid]}[{n}]", time_it=n == 424)
    a = scene_arrays(scenes.cbox())
    rng = np.random.default_rng(8)
    r = lab().random_rays(rng, dev, 424)
    r["ro"] = (r["ro"] * 0.3 + r["ro"].new_tensor([0.0, 1.0, 1.0])).contiguous()
    for i in (0, 2):  # the rect and cone groups (the OBB boxes have no table)
        g = upload_group({k: a[f"group.{i}.{k}"] for k in GROUP_KEYS}, dev)
        recs += compare_mxu("mxup", ("dense", "mxu"), g, r, f"cbox.{i}", time_it=True)
    return recs


def phase_grid_mxu_vs_plain(dev):
    """The grid kernel's MXU form against its plain version on soups of 3,000
    and 20,000 triangles and on the terrain's group; beside it the grid
    kernel."""
    import numpy as np

    recs = []
    rng = np.random.default_rng(90)
    for n_tri in (3000, 20000):
        recs += compare_mxu("grid_mxu", ("grid",), soup_group(n_tri, dev),
                            lab().random_rays(rng, dev, n_tri), f"soup{n_tri}", n_tri == 20000)
    g = terrain_group(dev)
    recs += compare_mxu("grid_mxu", ("grid",), g, terrain_rays(rng, dev, g), "terrain", True)
    for name, r in schedule_rays(np.random.default_rng(6), dev, g).items():
        recs += compare_mxu("grid_mxu", ("grid",), g, r, f"terrain, {name}", True)
    return recs


def phase_inst_mxu_vs_plain(dev):
    """The instanced kernel's MXU leaf form against its plain version on the
    rock fields of 2x2 and 32x32; beside it the instanced kernel."""
    import numpy as np

    recs = []
    for n_side in (2, 32):
        g = inst_group(n_side, dev)
        r = field_rays(np.random.default_rng(100 + n_side), dev, n_side, g["vbase"])
        recs += compare_mxu("inst_mxu", ("inst",), g, r, f"rock field {n_side}x{n_side}",
                            n_side == 32)
    return recs


def probe_t_of(variant, rows, args, lanes, ids):
    """The t of row ``ids`` on ``lanes`` under the probe variant's cone test,
    with no window above."""
    import torch

    from pine_tpu_torch.lab import cone_probe as CP

    ro, rd, tmin = (x[lanes] for x in args[:3])
    rows_k = rows[ids.long()]
    return CP.variant_test(variant)(lambda c: rows_k[:, c], tuple(ro.T), tuple(rd.T), tmin,
                                    torch.full_like(tmin, 1e30))


INVA_ULPS = 4  # the two far-root terms, each rounded in two operations per form


def cone_far_terms(rows, ro, rd, ids):
    """max(|t0|, |sq / a|) of the cone test at row ``ids`` of each lane: the
    two terms whose sum is a far root (csrc/prim_tests.cuh::test_cone)."""
    import torch

    r = rows[ids.long()]
    o = [ro[:, k] - r[:, k] for k in range(3)]
    d = [rd[:, k] for k in range(3)]
    n = [r[:, 3 + k] for k in range(3)]
    A2 = r[:, 6]
    dn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    on = o[0] * n[0] + o[1] * n[1] + o[2] * n[2]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    od = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
    a = -A2 * dn * dn + dd
    b = 2.0 * (-A2 * on * dn + od)
    c = -A2 * on * on + oo
    sq = torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, 0.0))
    a_safe = torch.where(a == 0.0, 1e-6, a)
    return torch.maximum(((-b - sq) / (2.0 * a_safe)).abs(), (sq / a_safe).abs())


def phase_probe_vs_plain(dev):
    """Phase 2k: kernel 9 in each variant against probe_plain on the box's
    cone group and the lab's three ray sets, bit for bit; ``full`` against
    the dense kernel, ``inva`` against ``full`` (module docstring)."""
    import torch

    from pine_tpu_torch.lab import cone_probe as CP
    from pine_tpu_torch.lab import kernel_lab as KL

    DT = module("dense")
    g, lo, hi = KL.build_cone_group(dev)
    rows = DT.kernel_rows(g, "dense")  # the cone rows as the dense kernel reads them
    recs = []
    for rayset in KL.RAYSETS:
        o, d = KL.synth_rays(N_RAYS, rayset, lo, hi)
        ro, rd = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
        tmin = torch.full((N_RAYS,), 1e-3, device=dev)
        bt = torch.full((N_RAYS,), 1e30, device=dev)
        be = torch.zeros(N_RAYS, dtype=torch.int32, device=dev)
        args = (ro, rd, tmin, bt, be)
        out = {}
        for v in CP.VARIANTS:
            t_k, e_k = out[v] = CP.probe_cuda(v, rows, *args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t_p, e_p = CP.probe_plain(v, rows, *args)
            end.record()
            torch.cuda.synchronize()
            differ = (t_k.view(torch.int32) != t_p.view(torch.int32)) | (e_k != e_p)
            fin = (t_k < 1e30) & (t_p < 1e30)
            recs.append(dict(kernel="cone_probe", group=f"cone[424] {rayset}", form=v,
                             max_abs_err=float((t_k - t_p)[fin].abs().max()) if fin.any() else 0.0,
                             lanes_differ=int(differ.sum()), hit_lanes=int((t_k < 1e30).sum()),
                             ms=cuda_ms(lambda: CP.probe_cuda(v, rows, *args), 10),
                             plain_ms=start.elapsed_time(end)))
            if differ.any():
                fail(f"cone_probe.{v} differs from probe_plain on {rayset} rays: {recs[-1]}")
        # full is the dense kernel's sweep without its cull
        t_f, e_f = out["full"]
        t_d, e_d = DT.dense_cuda(g["tid"], DT.dense_rows(g), g["gbox"], ro, rd, tmin, bt, bt, be,
                                 False)
        hit = (t_f < 1e30) | (t_d < 1e30)
        bad = ~(torch.isclose(t_f, t_d, rtol=T_RTOL, atol=T_ATOL) | (t_f == t_d)) \
            | (hit & (e_f != e_d))
        full_rec = next(r for r in recs[-len(CP.VARIANTS):] if r["form"] == "full")
        full_rec["vs_dense"] = dict(lanes_differ=int(bad.sum()), hit_lanes=int(hit.sum()),
                                    bit_equal=bool(torch.equal(t_f.view(torch.int32),
                                                               t_d.view(torch.int32))
                                                   and torch.equal(e_f, e_d)))
        if bad.any():
            fail(f"cone_probe.full differs from the dense kernel on {rayset} rays: {full_rec}")
        # inva: the same roots through one reciprocal.  Where the far root is
        # taken (t0 < tmin), t = t0 + sq / a sums two terms of opposite sign
        # far larger than t, so the two forms may differ there by the rounding
        # of those terms: INVA_ULPS ulps of the larger, beyond rtol 1e-5
        t_i, e_i = out["inva"]
        both = (t_f < 1e30) & (t_i < 1e30)
        flips = int(((t_f < 1e30) ^ (t_i < 1e30)).sum())
        far = cone_far_terms(rows, ro[both], rd[both], e_f[both])
        slack = torch.zeros_like(t_f)
        slack[both] = INVA_ULPS * (torch.nextafter(far, torch.full_like(far, 1e38)) - far)
        beyond = both & ((t_i - t_f).abs() > T_RTOL * t_f.abs() + slack)
        beyond_rtol = both & ~torch.isclose(t_i, t_f, rtol=T_RTOL, atol=0.0)
        lanes = torch.nonzero(both & (e_i != e_f)).squeeze(1)
        ties = torch.isclose(probe_t_of("full", rows, args, lanes, e_i[lanes]),
                             probe_t_of("full", rows, args, lanes, e_f[lanes]), rtol=T_RTOL,
                             atol=0.0)
        inva_rec = next(r for r in recs[-len(CP.VARIANTS):] if r["form"] == "inva")
        inva_rec["vs_full"] = dict(
            max_dev_both_hit=float((t_i - t_f)[both].abs().max()) if both.any() else 0.0,
            both_hit=int(both.sum()), lanes_beyond_rtol=int(beyond_rtol.sum()),
            lanes_beyond_rtol_and_far_root_ulps=int(beyond.sum()),
            ids_differ=int(lanes.numel()), not_ties=int((~ties).sum()), hit_flips=flips)
        if beyond.any() or not ties.all() or flips:
            fail(f"cone_probe.inva disagrees with full on {rayset} rays: {inva_rec}")
    return recs


# ---------------------------------------------------------------- phase 3 ----

def force_sort(cs, mode):
    """Turn the coherence sort on with key ``mode`` ("octant" or "origin")."""
    if mode == "octant":
        cs.heavy_traversal = True  # as on the full terrain
    elif mode == "origin":
        cs.origin_sort = True


def render_parity(what, make_scene, sort=None, kernels=None, sampler="blue", size=64, depth=4,
                  cached=False):
    """Render ``make_scene()`` at ``size``^2 x 4 spp, depth ``depth``, with
    the sampler ``sampler`` (a core.samplers.SAMPLERS key), by the path
    integrator or, with ``cached``, the cached one (grid 32), on the card
    (with the coherence sort forced on with key ``sort``) and on the CPU,
    both routed under the forced-kernel settings ``kernels``, and hold them
    to the port's render criteria."""
    import numpy as np

    from pine_tpu_torch.core.samplers import SAMPLERS
    from pine_tpu_torch.integrators.cachedpath import render_cached
    from pine_tpu_torch.integrators.path import render_wavefront

    out = {}
    for dev in ("cuda", "cpu"):
        sc = make_scene()
        cs = sc.compile(dev, **(kernels or {}))
        if dev == "cuda":
            force_sort(cs, sort)
            if cs.sort_mode(size * size, True) != sort:
                fail(f"{what}: the card's sort key is {cs.sort_mode(size * size, True)}, not "
                     f"{sort}")
        if cached:
            img, st = render_cached(cs, sc.camera, size, size, SAMPLERS[sampler](4), 4, depth,
                                    sc.get_aabb(), 32, return_stats=True)
        else:
            img, st = render_wavefront(cs, sc.camera, size, size, SAMPLERS[sampler](4), 4, depth,
                                       return_stats=True)
        out[dev] = (img.cpu().numpy(), st["traced_rays"])
    (g, rg), (c, rc) = out["cuda"], out["cpu"]
    d = np.abs(g - c)
    agree = ((d <= 1e-3 * np.abs(c)) | (d <= 1e-4)).all(-1).mean()
    rec = dict(phase="render_parity", scene=what, sort=sort, kernels=kernels, sampler=sampler,
               integrator="cached" if cached else "path",
               size=f"{size}x{size}x4spp depth {depth}", pixels_agree=float(agree),
               mean_cuda=float(g.mean()), mean_cpu=float(c.mean()),
               rays_cuda=int(rg), rays_cpu=int(rc), finite=bool(np.isfinite(g).all()))
    emit(rec)
    if not (rec["finite"] and agree >= 0.97 and abs(g.mean() - c.mean()) <= 0.01 * abs(c.mean())
            and abs(rg - rc) <= 0.005 * rc):
        fail(f"card render disagrees with the CPU render: {rec}")


# the reduced house of tests/test_house.py's goldens: integrator, golden file
HOUSE_GOLDENS = {"path": ("PathIntegrator(BlueSampler(8), 4)", "house_path_48x48x8.npy"),
                 "cached": ("CachedPathIntegrator(BlueSampler(8), 4, 32)",
                            "house_cached_48x48x8.npy")}


def house_parity():
    """The reduced house (48x48, 8 spp) rendered by its script on the card and
    on the CPU, for each integrator: the port's render-parity rule, and each
    tone-mapped image's RMSE against its committed golden below 0.025."""
    import numpy as np

    from pine_tpu_torch import scenes

    for name, (expr, golden) in HOUSE_GOLDENS.items():
        card, cpu = scenes.house(48, expr), scenes.house(48, expr, device="cpu")
        g, c = card.camera.film.rgb.cpu().numpy(), cpu.camera.film.rgb.numpy()
        d = np.abs(g - c)
        agree = float(((d <= 1e-3 * np.abs(c)) | (d <= 1e-4)).all(-1).mean())
        ref = np.load(os.path.join(ROOT, "tests", "goldens", golden)).astype(np.float32)
        rmse = {dev: float(np.sqrt(np.mean((f.camera.film.finalized() - ref) ** 2)))
                for dev, f in (("cuda", card), ("cpu", cpu))}
        rec = dict(phase="render_parity", scene=f"reduced house, {expr}", size="48x48x8spp",
                   pixels_agree=agree, mean_cuda=float(g.mean()), mean_cpu=float(c.mean()),
                   finite=bool(np.isfinite(g).all()), golden=golden,
                   rmse_vs_golden_cuda=rmse["cuda"], rmse_vs_golden_cpu=rmse["cpu"])
        emit(rec)
        if not (rec["finite"] and agree >= 0.97 and abs(g.mean() - c.mean()) <= 0.01 * abs(c.mean())
                and max(rmse.values()) < 0.025):
            fail(f"the reduced house disagrees between card and CPU or with its golden: {rec}")


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
    render_parity("reduced cone forest, 24x24 cones",
                  lambda: scenes.prl_scene(scenes.cone_forest_prl(*scenes.REDUCED_FOREST, size=64)))
    for kernel in ("scdense", "mxup"):
        render_parity(f"reduced cbox, 36 cones, {kernel}",
                      lambda: scenes.cbox((64, 64), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0)),
                      kernels=dict(small_kernel=kernel))
    render_parity("reduced rock field, 3x3 x 242 triangles, inst mxu",
                  lambda: lazy_field((64, 64), 3, 12), "origin", dict(inst_kernel="mxu"))
    # the reduced terrain's 3,042 triangles made mesh-scale, so that mesh_kernel
    # routes them (and the card sorts its rays, as on the full terrain)
    from pine_tpu_torch.accel import dense_traverse as DT

    limit, DT.GRID_MAX_PRIMS = DT.GRID_MAX_PRIMS, 1024
    try:
        for kernel in ("sctree", "bvh", "mxu"):
            render_parity(f"reduced terrain, grid 40, {kernel}",
                          lambda: scenes.terrain((64, 64), 40), "octant",
                          dict(mesh_kernel=kernel))
    finally:
        DT.GRID_MAX_PRIMS = limit
    for parity in (house_parity, garden_parity, media_parity, lambda_parity, guided_parity,
                   last_slice_parity):
        t0 = time.perf_counter()
        parity()
        emit(dict(phase="parity_time", parity=parity.__name__,
                  seconds=time.perf_counter() - t0))


def media_parity():
    """The media slice card against CPU: the reduced cloud (16^3) and
    explosion (16^3, emissive), the CSG fog box with the torus (depth 5) by
    the path integrator and the fog box by the cached one, 64x64x4 spp by
    render_parity's rule; AO on the reduced box and the volume integrator
    by the same rule."""
    import numpy as np
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import BlueSampler, UniformSampler
    from pine_tpu_torch.integrators.ao import render_ao
    from pine_tpu_torch.integrators.vol import VolIntegrator

    render_parity("reduced cloud, 16^3", lambda: scenes.cloud((64, 64), 16))
    render_parity("reduced explosion, 16^3, emissive", lambda: scenes.explosion(64, 16))
    render_parity("reduced CSG fog box + torus", lambda: scenes.csg_fog_sdf(64), depth=5)
    render_parity("reduced CSG fog box", lambda: scenes.csg_fog(64), cached=True)
    out = {}
    for dev in ("cuda", "cpu"):
        sc = scenes.cbox((64, 64), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0))
        lo, up = sc.get_aabb()
        out[dev] = render_ao(sc.compile(dev), sc.camera, 64, 64, BlueSampler(4), 4,
                             float(np.linalg.norm(up - lo) / 2)).cpu().numpy()
        sc = scenes.cbox((64, 64))
        out[dev + "_vol"] = VolIntegrator(UniformSampler(1)).render(sc, dev).pixels[..., :3]
    for what, g, c in (("AO, reduced cbox", out["cuda"], out["cpu"]),
                       ("VolIntegrator", out["cuda_vol"], out["cpu_vol"])):
        d = np.abs(g - c)
        agree = float(((d <= 1e-3 * np.abs(c)) | (d <= 1e-4)).all(-1).mean())
        rec = dict(phase="render_parity", scene=what, size="64x64", pixels_agree=agree,
                   mean_cuda=float(g.mean()), mean_cpu=float(c.mean()),
                   finite=bool(np.isfinite(g).all()))
        emit(rec)
        if not (rec["finite"] and agree >= 0.97 and g.mean() > 0
                and abs(g.mean() - c.mean()) <= 0.01 * abs(c.mean())):
            fail(f"card render disagrees with the CPU render: {rec}")
    torch.cuda.empty_cache()


def garden_parity():
    """The reduced garden (scenes.REDUCED_GARDEN: 32x32, 4 spp, depth 3) card
    against CPU: under its Atmosphere with SobolSampler, by the path
    integrator and the cached one; the ImageSky variant with HaltonSampler;
    the Sky variant with SobolSampler and with BlueSampler.  Each scene is
    built once (the Atmosphere's map on the host) and compiled for both
    devices."""
    from pine_tpu_torch import scenes

    size, depth = scenes.REDUCED_GARDEN["size"], scenes.REDUCED_GARDEN["depth"]
    built = {sky: scenes.garden(sky, size) for sky in ("atmosphere", "imagesky", "sky")}
    for sky, sampler, cached in (("atmosphere", "sobol", False), ("atmosphere", "sobol", True),
                                 ("imagesky", "halton", False), ("sky", "sobol", False),
                                 ("sky", "blue", False)):
        render_parity(f"reduced garden, {sky}", lambda: built[sky], sampler=sampler, size=size,
                      depth=depth, cached=cached)


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
    to each lane's first hit in row order.  The MXU form computes the same
    function and gets the same bound: the prim test and the rows, not its
    coefficient-table test and table, which the function does not need."""
    GT = module("grid")
    grid = g["grid"]
    n = args[0].shape[0]
    need = counts
    if not any_hit:
        need = {}
        GT.grid_plain(g["tid"], g["rows"], grid, *args[:4], *out_p, False, counts=need)
    ops = n * 3 + need["slabs"] * GT.SLAB_OPS + need["tests"] * TEST_OPS[g["tid"]]
    table_bytes = g["rows"].numel() * 4 + sum(
        grid[k].numel() * 4 for k in ("coarse_boxes", "sc_boxes", "cell_boxes", "c_order8",
                                       "s_order8"))
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
    inst_plain's order.  The MXU leaf form computes the same function and
    gets the same bound (grid_work)."""
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


def lattice_work(g, args, any_hit, out_p, counts):
    """(FP32 operations, bytes, counts) of one lattice call on these inputs.
    ``counts`` are lattice_plain's (lanes past the group-box clip, windows,
    prim tests).  The bound counts the clip per lane, the march's set-up per
    clipped lane, each window's bounds and first cell, and each candidate's
    prim test; the row rebuild, which stands in for reading the row, is not
    counted.  Closest-hit: the march rerun with each lane's final t as its
    window (the windows and candidates no march order can skip); any-hit:
    the tests up to each lane's first hit, where the kernel stops."""
    LT = module("lattice")
    n = args[0].shape[0]
    need = counts
    if not any_hit:
        need = {}
        LT.lattice_plain(g, *args[:4], *out_p, False, counts=need)
    ops = (n * CULL_OPS + need["live"] * LT.SETUP_OPS + need["windows"] * LT.WINDOW_OPS
           + need["tests"] * TEST_OPS[g["tid"]])
    nbytes = n * ((10 if any_hit else 9) + 2) * 4 + g["lat"]["latf"].nbytes + 24
    if not any_hit:
        nbytes += 4 * int((out_p[0] < args[4]).sum())  # one slot read per improved lane
    return ops, nbytes, dict(live_rays=counts["live"], windows=counts["windows"],
                             prim_tests=counts["tests"], min_windows=need["windows"],
                             min_prim_tests=need["tests"])


def scdense_work(g, args, any_hit, out_p, counts):
    """(FP32 operations, bytes, counts) of one scdense call on these inputs.
    ``counts`` are scdense_plain's (slab and prim tests, in row order, which
    is the kernel's order).  Closest-hit: the sweep rerun with each lane's
    final t as its window, the culls and tests no sweep can skip; any-hit:
    the work up to each lane's first hit."""
    SD = module("scdense")
    n = args[0].shape[0]
    need = counts
    if not any_hit:
        need = {}
        SD.scdense_plain(g["tid"], g["rows"], g["scd"], *args[:4], *out_p, False, counts=need)
    ops = n * 3 + need["slabs"] * module("grid").SLAB_OPS + need["tests"] * TEST_OPS[g["tid"]]
    nbytes = n * ((10 if any_hit else 9) + 2) * 4 + 4 * (
        g["rows"].numel() + g["scd"]["sc_boxes"].numel() + g["scd"]["cell_boxes"].numel())
    return ops, nbytes, dict(slab_tests=counts["slabs"], prim_tests=counts["tests"],
                             min_slab_tests=need["slabs"], min_prim_tests=need["tests"])


def mxup_work(g, args, any_hit):
    """(FP32 operations, bytes, counts) of one kernel-7 call on these inputs:
    every pair of a live lane (its window (tmin, limit) not empty; any-hit:
    not yet occluded) and a row of the group, each VALUE_OPS per pair value
    and the epilogue's, plus each lane's features; any-hit: the
    pairs up to each lane's first hit, where the kernel stops.  The bytes
    are the ray state and the tile-major table, each read once."""
    import torch

    MS = module("mxup")
    ro, rd, tmin, tmax, bt, be = args
    n, tab = ro.shape[0], g["mxut"]
    C = tab["C"]
    limit = tmax if any_hit else bt
    live = (limit > tmin) & ((be < 1) if any_hit else True)
    if any_hit:  # pairs up to the first hit, in row order
        pairs = 0
        F, odr, oor, ddr = MS.features(ro, rd)
        W = tab["W"]
        m = tab["m"]
        for c0 in range(0, n, 8192):
            sl = slice(c0, c0 + 8192)
            hit = []
            for ct in range(tab["n_tiles"]):
                width = min(MS.TILE, C - ct * MS.TILE)
                P = MS.ordered_values(F[sl], W[:, ct * m * MS.TILE:(ct + 1) * m * MS.TILE])
                hit.append(MS.pair_t_vals(g["tid"], lambda v: P[:, v * MS.TILE:v * MS.TILE + width],
                                          odr[sl], oor[sl], ddr[sl], tmin[sl, None],
                                          limit[sl, None]) < MS.BIG)
            hit = torch.cat(hit, 1)
            first = torch.where(hit.any(1), hit.to(torch.int8).argmax(1) + 1, C)
            pairs += int(first[live[sl]].sum())
    else:
        pairs = int(live.sum()) * C
    ops = n * FEAT_OPS + pairs * (VALUE_OPS * tab["m"] + EPI_OPS[g["tid"]])
    nbytes = n * ((10 if any_hit else 9) + 2) * 4 + tab["W"].numel() * 4
    return ops, nbytes, dict(live_rays=int(live.sum()), pairs=pairs)


def tree_work(kind, g, args, any_hit, out_k):
    """(FP32 operations, bytes, counts) of one sctree or bvh call on these
    inputs, order-free: the walk of every node whose child boxes a lane's
    window reaches (two slab tests each), as any order of the walk must make
    it, with the window ending at the lane's final t (closest-hit, from the
    kernel's output) or at tmax (any-hit, lanes the kernel left unoccluded);
    then, for the supercell tree, the box of each supercell of a reached leaf
    and the cells of each reached supercell, and the prim tests of every
    reached leaf (bvh) or cell (sctree).  An occluded any-hit lane counts one
    slab and one prim test.  The bytes are the ray state and each distinct
    table entry that this walk reads, once: the nodes visited, the rows of
    the reached leaves (bvh) or cells, and for the supercell tree the order
    slots of the reached leaves, the boxes of their supercells and those
    supercells' cell boxes.  A BVH node is read from its 64-byte record
    (``unpack_nodes``) and counts its 14 words of data (``NODE_DATA_WORDS``:
    two child boxes and two links; the record's two pad words are never
    read); a supercell-tree node its two child boxes and three index pairs
    (18 words)."""
    import torch

    GT = module("grid")
    t = g[KERNELS[kind][3]]
    node_words = 18
    if kind == "bvh":
        t = dict(t, **module("bvh").unpack_nodes(t["nodes"]))
        node_words = module("bvh").NODE_DATA_WORDS
    ro, rd, tmin, tmax, bt, be = args
    n = ro.shape[0]
    dev = ro.device
    n_prims, width = t["n_prims"], g["rows"].shape[1]
    inv = [module("dense")._safe_inv(rd[:, a]) for a in range(3)]
    if any_hit:
        occluded = (out_k[1] != 0) & (be == 0) & (tmax > tmin)
        live, lim = (be == 0) & (tmax > tmin) & ~occluded, tmax
    else:
        lim = out_k[0]
        live = lim > tmin

    def reach(boxes, lanes):  # (k,6) boxes, (k,) lanes -> (k,) bool
        return GT._slab(boxes, [ro[lanes, a] for a in range(3)], [inv[a][lanes] for a in range(3)],
                        tmin[lanes], lim[lanes])

    def marks(size):
        return torch.zeros(size, dtype=torch.bool, device=dev)

    lanes = torch.nonzero(live).squeeze(1)
    nodes = torch.zeros_like(lanes)
    slabs = tests = nodes_read = 0
    if kind == "bvh":
        rows_read = marks(n_prims)
    else:  # order slots, supercell boxes, cell boxes read; cells whose rows are read
        n_cells = t["cell_boxes"].shape[0]
        slot_read, sc_read = marks(t["sc_order"].shape[0]), marks(t["sc_boxes"].shape[0])
        cell_read, cell_rows = marks(n_cells), marks(n_cells)
    while lanes.numel():
        nodes_read += int(torch.unique(nodes).numel())  # one tree level: distinct from the others
        slabs += 2 * lanes.numel()
        both = torch.stack([reach(t["boxes"][nodes, k], lanes) for k in range(2)], 1)
        child = t["cnode"][nodes]
        leaf = both & (child < 0)
        start, cnt = t["cstart"][nodes][leaf].long(), t["ccount"][nodes][leaf]
        ll = lanes[:, None].expand(-1, 2)[leaf]
        for j in range(int(cnt.max()) if cnt.numel() else 0):
            sel = cnt > j
            if kind == "bvh":  # a leaf's rows
                tests += int(sel.sum())
                rows_read[start[sel] + j] = True
                continue
            # a leaf's supercells, their boxes, their cells' boxes, their prims
            lj = ll[sel]
            slot_read[start[sel] + j] = True
            si = t["sc_order"][start[sel] + j].long()
            sc_read[si] = True
            slabs += lj.numel()
            ok = reach(t["sc_boxes"][si], lj)
            lj, si = lj[ok], si[ok]
            for kc in range(GT.SUPER // GT.CELL):
                cell = si * (GT.SUPER // GT.CELL) + kc
                real = cell * GT.CELL < n_prims
                slabs += int(real.sum())
                cell_read[cell[real]] = True
                hit = real & reach(t["cell_boxes"][cell], lj)
                cell_rows[cell[hit]] = True
                tests += int(torch.clamp(n_prims - cell[hit] * GT.CELL, max=GT.CELL).sum())
        inner = both & (child >= 0)
        lanes = lanes[:, None].expand(-1, 2)[inner]
        nodes = child[inner]
    if any_hit:
        slabs, tests = slabs + int(occluded.sum()), tests + int(occluded.sum())
    ops = n * 3 + slabs * GT.SLAB_OPS + tests * TEST_OPS[g["tid"]]
    if kind == "bvh":
        n_rows = int(rows_read.sum())
        table_words = nodes_read * node_words + n_rows * width
    else:
        first = torch.nonzero(cell_rows).squeeze(1) * GT.CELL
        n_rows = int(torch.clamp(n_prims - first, max=GT.CELL).sum())
        table_words = (nodes_read * node_words + n_rows * width + int(slot_read.sum())
                       + 6 * int(sc_read.sum()) + 6 * int(cell_read.sum()))
    nbytes = n * ((10 if any_hit else 9) + 2) * 4 + 4 * table_words
    return ops, nbytes, dict(min_slab_tests=slabs, min_prim_tests=tests, nodes_read=nodes_read,
                             rows_read=n_rows, table_bytes_read=4 * table_words)


def kernel_line_entry(kind, form, calls, launches, checked=None, label=None,
                      over="one 1-spp render"):
    """Time one kernel form on the recorded main-path launches (every launch
    of ``over``: one 1-spp render); ``label`` names the path in the entry's name where
    another path's entries time the same kernel.  ms and bound_ms are means
    per launch and the work counts sums over the launches; ``by_group``
    holds each group's launches and its means of ms, bound_ms and
    library_ms.  The plain version runs, and the kernel is held to it, on
    every launch, or on the first ``checked`` of them, and plain_ms is the
    mean over those."""
    any_hit = form == "any_hit"
    ms_each, plain_each, lib_each = [], [], []
    bound = err = 0.0
    ops = nbytes = differ = bits = 0
    sums, by_group = {}, {}
    for i, (g, args, _) in enumerate(calls):
        ms_each.append(cuda_ms(lambda: launch(kind, g, args, any_hit), 10))
        per = by_group.setdefault(group_desc(g), dict(launches=0, ms=0.0, bound_ms=0.0,
                                                      library_ms=0.0))
        per["launches"] += 1
        per["ms"] += ms_each[-1]
        out_k = launch(kind, g, args, any_hit)
        counts = out_p = None
        if checked is None or i < checked:
            counts = None if kind in ("dense", "mxup") else {}
            out_p, p_ms = timed_plain(kind, g, args, any_hit, counts)
            plain_each.append(p_ms)
            c_err, _, _, c_differ, allowed, c_bits = check_outputs(kind, out_k, out_p, any_hit)
            if c_differ > allowed or (allowed == 0 and c_bits):
                fail(f"{kind}.{form}: {c_differ} lanes ({c_bits} bit for bit) disagree with the "
                     "plain version on main-path inputs")
            err, differ, bits = max(err, c_err), differ + c_differ, bits + c_bits
        if kind in ("grid", "grid_mxu"):
            c_ops, c_bytes, c = grid_work(g, args, any_hit, out_p, counts)
        elif kind in ("inst", "inst_mxu"):
            c_ops, c_bytes, c = inst_work(g, args, any_hit, out_p, counts)
        elif kind == "mxup":
            c_ops, c_bytes, c = mxup_work(g, args, any_hit)
            prep(g, "mxu")
            lib_each.append(cuda_ms(lambda: launch("mxu", g, args, any_hit), 10))
            per["library_ms"] += lib_each[-1]
        elif kind == "lattice":
            c_ops, c_bytes, c = lattice_work(g, args, any_hit, out_p, counts)
        elif kind == "scdense":
            c_ops, c_bytes, c = scdense_work(g, args, any_hit, out_p, counts)
        elif kind in ("sctree", "bvh"):
            c_ops, c_bytes, c = tree_work(kind, g, args, any_hit, out_k)
        else:
            c_ops, c_bytes, c = dense_work(g, args, any_hit)
        for key, v in c.items():
            sums[key] = sums.get(key, 0) + v
        ops += c_ops
        nbytes += c_bytes
        c_bound = max(c_bytes / HBM_BYTES_PER_S, c_ops / FP32_OPS_PER_S) * 1e3
        bound += c_bound
        per["bound_ms"] += c_bound
    k = len(calls)
    for per in by_group.values():  # means per launch of each group
        for key in ("ms", "bound_ms", "library_ms"):
            per[key] /= per["launches"]
        if not lib_each:
            per["library_ms"] = None
    groups = sorted({group_desc(g) for g, _, _ in calls})
    base = {"grid_mxu": "grid_traverse.mxu", "inst_mxu": "inst_traverse.mxu"}.get(
        kind, KERNELS[kind][0])
    entry = dict(
        name=f"{base}.{label}.{form}" if label else f"{base}.{form}", route="cuda", source=KERNELS[kind][4],
        replaces=KERNELS[kind][5], launches=launches, max_abs_err=err,
        ms=sum(ms_each) / k, plain_ms=sum(plain_each) / len(plain_each), bound_ms=bound / k,
        bound_by="operations" if ops / FP32_OPS_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        # kernel 7's library call: torch.matmul + the epilogue in PyTorch (mxu_route)
        library_ms=sum(lib_each) / k if lib_each else None,
        inputs=" + ".join(groups)
        + f" x {calls[0][1][0].shape[0]} rays; means per launch over the {k} launches "
          f"of {over}, work counts summed over them; the plain version on "
          + (f"the first {len(plain_each)} of them" if len(plain_each) < k else "each"),
        ms_each=ms_each, lanes_differ=differ, lanes_differ_bits=bits,
        **{f"{key}_sum": v for key, v in sums.items()},
        by_group=by_group,
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


def profile_render(what, render, spp=2):
    """Where a render's device time goes: torch.profiler's trace of the
    card's activity over one render of ``spp`` samples, device time by
    kernel name summed from the trace's raw events (key_averages would
    spend 0.2-0.45 ms of host time on each launch), the device's busy share
    of the host wall, and the launches a sample."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}  # kernel (or copy) name -> [device ms, launches]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit(dict(
        phase="profile", scene=what,
        what=f"one {spp}-spp render of the main path under torch.profiler (the card's activity)",
        wall_ms=wall * 1e3, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / (wall * 1e3) if busy_ms else "not measured",
        launches=sum(n for _, n in by_name.values()),
        launches_per_sample=sum(n for _, n in by_name.values()) / spp,
        **{f"{k}_ms": sum(ms for name, (ms, _) in by_name.items() if f"::{k}<" in name)
           for k in ("dense_kernel", "scdense_kernel", "grid_kernel", "grid_mxu_kernel",
                     "sctree_kernel", "bvh_kernel", "inst_kernel", "lattice_kernel",
                     "mxu_sweep_kernel")},
        top=[dict(name=name[:90], ms=ms, count=n) for name, (ms, n) in top],
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

    # a wrapper and the kinds it launches (the grid and instanced wrappers
    # launch their MXU form with mxu=True)
    wrappers = {}
    for kind in kinds:
        wrappers.setdefault(KERNELS[kind][:2], []).append(kind)
    reals = {w: getattr(module(ks[0]), w[1]) for w, ks in wrappers.items()}

    def recorder(w):
        def rec(*a, **kw):
            kind = next((k for k in wrappers[w] if (k in MXU_FORMS) == bool(kw.get("mxu"))),
                        None)
            if kind is not None:
                n_lead = 3 if KERNELS[kind][3] else 1
                lead, rays, any_hit = a[:n_lead], a[n_lead:n_lead + 6], a[n_lead + 6]
                g = lead[0] if n_lead == 1 else next(
                    g for g in groups if lead[1] is g["rows"] or lead[1] is g.get("drows"))
                recorded[(kind, any_hit)].append(
                    (g, tuple(x.clone() for x in rays), current["inv"]))
            return reals[w](*a, **kw)
        return rec

    cs.sort_perm = sort_recorder
    for w in wrappers:
        setattr(module(wrappers[w][0]), w[1], recorder(w))
    try:
        render()
    finally:
        for w in wrappers:
            setattr(module(wrappers[w][0]), w[1], reals[w])
        del cs.sort_perm
    return recorded, sorts


def path_render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
    """The path integrator's render of a main path (render_wavefront)."""
    from pine_tpu_torch.integrators.path import render_wavefront

    return render_wavefront(cs, scene.camera, W, H, sampler, spp, depth,
                            return_stats=return_stats)


def phase_main_path(dev_name, tag, what, scene, groups_want, heavy_want, kinds,
                    size=MAIN_SIZE, spp=MAIN_SPP, depth=MAIN_DEPTH, kernels=None, checked=None,
                    label=None, also=(), sampler="blue", render_fn=path_render, reps=1,
                    forms=("closest", "any_hit"), profile_spp=2, record=None):
    """One main path at full width: compile on the card (routed under the
    forced-kernel settings ``kernels``), record the kernels' inputs (the
    recording render warms the path up), ``reps`` timed renders (launch
    counts zeroed just before the first, read just after), the image checked and saved, a profile, and the kernel
    line's entries for ``kinds`` (the plain version on the first ``checked``
    launches of each form, or on all; ``label`` as kernel_line_entry's) and
    for the path's other kernels ``also`` (the plain version on every
    launch, the entries labelled with the path's tag).  ``sampler`` is a
    core.samplers.SAMPLERS key, ``size`` the film's edge or (width,
    height), ``render_fn`` the integrator's render (``path_render``'s
    arguments); ``reps`` timed renders, after a warm-up where reps > 1 (the
    recording render warms the path up too); ``forms`` the kernel forms the
    path launches (a path without shadow rays launches no any-hit);
    ``profile_spp`` the samples of the profiled render (None: no profile);
    ``record`` (cs, scene) -> (a function whose launches the kernel line
    times, what it runs), by default a 1-spp render.  -> (entries, compiled
    scene)."""
    import numpy as np
    import torch

    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.core.samplers import SAMPLERS
    from pine_tpu_torch.integrators import ao as AO

    W, H = (size, size) if isinstance(size, int) else size
    t_path = t0 = time.perf_counter()
    cs = scene.compile(**(kernels or {}))  # the card, by default; the C++ SAH builder
    compile_s = time.perf_counter() - t0
    groups = [group_sig(g) for g in all_groups(cs)]
    if groups != groups_want or cs.heavy_traversal != heavy_want:
        fail(f"unexpected {tag} groups {groups} (heavy: {cs.heavy_traversal})")
    sampler = SAMPLERS[sampler](spp)
    render = lambda s: render_fn(cs, scene, W, H, sampler, s, depth)  # noqa: E731

    recorded_run, over = ((lambda: render(1)), "one 1-spp render") if record is None else (
        record(cs, scene))
    recorded, _ = record_launches(cs, [*kinds, *also], recorded_run)
    torch.cuda.synchronize()

    if reps > 1:
        render(spp)  # warm-up
        torch.cuda.synchronize()
    walls = []
    for k in range(reps):
        if k == 0:
            DT.reset_launches()
            AO.LAUNCHES.update(dict.fromkeys(AO.LAUNCHES, 0))
        t0 = time.perf_counter()
        img, stats = render_fn(cs, scene, W, H, sampler, spp, depth, return_stats=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if k == 0:
            launches = {**DT.LAUNCHES, **AO.LAUNCHES}
    want = {f"{kind}.{form}" for kind, _, _ in groups_want for form in forms}
    for form in sorted(want):
        if launches[form] <= 0:
            fail(f"the {tag} main path never launched {form}: {launches}")
    img = img.cpu().numpy()
    finite = bool(np.isfinite(img).all())
    rays = int(stats["traced_rays"])
    MAIN_RAYS[tag] = rays
    MAIN_IMAGES[tag] = img
    MAIN_LAUNCHES[tag] = launches
    rec = dict(phase="main_path", scene=what, size=f"{W}x{H}", spp=spp, depth=depth,
               sampler=type(sampler).__name__, device=dev_name, kernels=kernels, groups=groups,
               compile_s=compile_s,
               wall_s=min(walls), walls_s=walls,
               traced_rays=rays, mrays_per_s=rays / min(walls) / 1e6, finite=finite,
               mean=float(img.mean()), launches=launches)
    emit(rec)
    if not finite or img.shape != (H, W, 3) or not img.mean() > 0:
        fail(f"full-width {tag} render is not a finite, lit image: {rec}")
    os.makedirs(OUT_DIR, exist_ok=True)
    scene.camera.film.set_rgb(torch.from_numpy(img))
    scene.camera.film.save(os.path.join(OUT_DIR, f"chip_smoke_{tag}.png"))

    if profile_spp is not None:
        profile_render(tag, lambda: render(profile_spp), profile_spp)

    entries = [kernel_line_entry(kind, form, recorded[(kind, any_hit)],
                                 launches[f"{kind}.{form}"], *((checked, label) if kind in kinds
                                                               else (None, tag)), over=over)
               for kind in (*kinds, *also)
               for form, any_hit in (("closest", False), ("any_hit", True)) if form in forms]
    if (cs.heavy_traversal or cs.inst_traversal) and not kernels:
        emit(coherence_sort_record(cs, tag, kinds, lambda: render(1), W * H))
    emit(dict(phase="path_time", scene=tag, seconds=time.perf_counter() - t_path))
    return entries, cs


def phase_garden(dev_name):
    """The garden (GARDEN_PRL) at full width, 640x640, 16 spp, as main
    paths: under its Atmosphere with SobolSampler (depth GARDEN_DEPTH) and under the
    ImageSky of images/cbox0.png with HaltonSampler (depth
    GARDEN_IMAGESKY_DEPTH).  Each: the dense
    kernel held to dense_plain bit for bit on every launch of a 1-spp render
    (the subsurface walk's eight intersects per depth among them; kernel-line
    entries ``dense_traverse.garden.*`` and ``dense_traverse.garden_imagesky.*``),
    the fence's line group on the "plain" route, its calls of one 1-spp
    render timed on the card; the script's build (the Atmosphere's map on the
    host) and an Atmosphere built alone, timed apart from compile_s.
    -> kernel-line entries."""
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.core.samplers import SAMPLERS
    from pine_tpu_torch.integrators.path import render_wavefront
    from pine_tpu_torch.scene import env_lights as E

    t0 = time.perf_counter()
    atmosphere = E.Atmosphere([0.4, 0.5, -0.6], [1, 1, 1])  # GARDEN_PRL's
    atmosphere_s = time.perf_counter() - t0
    entries = []
    for tag, sky, sampler, depth in (("garden", "atmosphere", "sobol", GARDEN_DEPTH),
                                     ("garden_imagesky", "imagesky", "halton",
                                      GARDEN_IMAGESKY_DEPTH)):
        t0 = time.perf_counter()
        scene = scenes.garden(sky, GARDEN_SIZE)
        build_s = time.perf_counter() - t0
        if sky == "atmosphere" and not (scene.env_light.distr.cdf_cond
                                        == atmosphere.distr.cdf_cond).all():
            fail("the garden's Atmosphere map differs from one built alone")
        e, cs = phase_main_path(
            dev_name, tag, f"the garden under {sky}, {SAMPLERS[sampler].__name__}, from "
            "GARDEN_PRL", scene, GARDEN_GROUPS, False, ["dense"], GARDEN_SIZE, GARDEN_SPP,
            depth, label=tag, sampler=sampler)
        entries += e
        calls, real = [], DT.plain_query

        def record(g, *args):
            calls.append((g, tuple(x.clone() if torch.is_tensor(x) else x for x in args)))
            return real(g, *args)

        DT.plain_query = record
        try:
            render_wavefront(cs, scene.camera, GARDEN_SIZE, GARDEN_SIZE,
                             SAMPLERS[sampler](GARDEN_SPP), 1, depth)
        finally:
            DT.plain_query = real
        ms = [(args[-1], cuda_ms(lambda: real(g, *args), 3)) for g, args in calls]
        emit(dict(phase="garden_setup", scene=tag, script_build_s=build_s,
                  atmosphere_build_s=atmosphere_s if sky == "atmosphere" else None,
                  plain_route=dict(group=group_desc(calls[0][0]), per="one 1-spp render",
                                   closest_calls=sum(not a for a, _ in ms),
                                   any_hit_calls=sum(a for a, _ in ms),
                                   closest_ms=sum(t for a, t in ms if not a),
                                   any_hit_ms=sum(t for a, t in ms if a))))
        del cs, calls
        torch.cuda.empty_cache()
    return entries


def media_setup_record(tag, cs, render):
    """The plain-PyTorch routes of the media slice (no kernel, none of the
    TPU's to replace) in one 1-spp render: the calls of the SDF march, the
    CSG interval walk, the grid media's delta and ratio tracking and the
    homogeneous media's equiangular scatter, each timed on the card on its
    recorded inputs (one run after a warm-up).  The homogeneous scatter's time includes the
    walks, marches and tracking it calls itself."""
    import torch

    from pine_tpu_torch.integrators import path as P
    from pine_tpu_torch.scene import csg_intersect as C
    from pine_tpu_torch.scene import media_track as T
    from pine_tpu_torch.scene import scene as SC

    targets = {"sdf_march": (SC, "_sdf_march"), "csg_walk": (C, "csg_intersect"),
               "grid_delta_tracking": (T, "grid_sample_scatter"),
               "grid_ratio_tracking": (T, "grid_transmittance"),
               "homogeneous_scatter": (P, "_medium_scatter")}
    reals = {k: getattr(m, n) for k, (m, n) in targets.items()}
    calls = {k: [] for k in targets}

    def recorder(key):
        def rec(*a):
            calls[key].append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
            return reals[key](*a)
        return rec

    for k, (m, n) in targets.items():
        setattr(m, n, recorder(k))
    try:
        render()
        torch.cuda.synchronize()
    finally:
        for k, (m, n) in targets.items():
            setattr(m, n, reals[k])
    routes = {k: dict(calls=len(v), ms=sum(cuda_ms(lambda: reals[k](*a), 1) for a in v))
              for k, v in calls.items() if v}
    emit(dict(phase="media_setup", scene=tag, per="one 1-spp render", routes=routes,
              note="plain PyTorch (no kernel); homogeneous_scatter includes the CSG walks, "
                   "SDF marches and tracking it calls"))
    return routes


def phase_media(dev_name):
    """The media slice's main paths at full width: the cloud (bench_cloud's
    build_scene and render: 1920x1080, 96^3, depth CLOUD_DEPTH, CLOUD_SPP of its 256
    samples), the CSG fog box and the fog box with the torus (CSG_FOG_PRL,
    640x640, BlueSampler(16), depth 5 and FOG_SDF_DEPTH), AO on the bench box
    (640x640, BlueSampler(16); ``phase_ao``).  Each as phase_main_path: the dense
    kernel held to dense_plain bit for bit on every launch of a 1-spp render
    (kernel-line entries ``dense_traverse.<tag>.*``); the media_setup record
    times the plain routes.  -> kernel-line entries."""
    import torch

    from pine_tpu_torch import bench_cloud, scenes
    from pine_tpu_torch.core.samplers import BlueSampler

    emit(dict(phase="cloud_spp_cut", spp=CLOUD_SPP, full_spp=CLOUD_FULL_SPP,
              why="chip_smoke.py's time limit; python -m pine_tpu_torch.bench_cloud renders all"))

    def cloud_render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        return bench_cloud.render(cs, scene, sampler, spp, depth, (W, H), return_stats)

    t0 = time.perf_counter()
    scene = bench_cloud.build_scene()
    build_s = time.perf_counter() - t0
    entries, cs = phase_main_path(
        dev_name, "cloud", "bench_cloud's chromatic cloud, 96^3 VDB, 6 rects + 2 AABBs",
        scene, CLOUD_GROUPS, False, ["dense"], (bench_cloud.W, bench_cloud.H), CLOUD_SPP,
        CLOUD_DEPTH, label="cloud", render_fn=cloud_render, reps=1)
    routes = media_setup_record("cloud", cs, lambda: cloud_render(
        cs, scene, bench_cloud.W, bench_cloud.H, BlueSampler(CLOUD_SPP), 1, CLOUD_DEPTH))
    emit(dict(phase="cloud_setup", scene_build_s=build_s))
    if not routes.get("grid_delta_tracking"):
        fail("the cloud's render never tracked its grid medium")
    del cs
    torch.cuda.empty_cache()
    for tag, make in (("csg_fog", lambda: scenes.csg_fog(FOG_SIZE)),
                      ("csg_fog_sdf", lambda: scenes.csg_fog_sdf(FOG_SIZE))):
        scene = make()
        depth = FOG_SDF_DEPTH if tag.endswith("sdf") else FOG_DEPTH
        e, cs = phase_main_path(
            dev_name, tag, "the CSG fog box from CSG_FOG_PRL" + (
                ", + an SDF torus (Python API)" if tag.endswith("sdf") else ""),
            scene, FOG_GROUPS, False, ["dense"], FOG_SIZE, FOG_SPP, depth, label=tag, reps=1)
        entries += e
        routes = media_setup_record(tag, cs, lambda: path_render(
            cs, scene, FOG_SIZE, FOG_SIZE, BlueSampler(FOG_SPP), 1, depth))
        if not (routes.get("csg_walk") and routes.get("homogeneous_scatter")) or (
                tag.endswith("sdf") and not routes.get("sdf_march")):
            fail(f"the {tag} render skipped a plain route: {sorted(routes)}")
        del cs
    return entries + phase_ao(dev_name)


def ao_dirs_entries(cs, scene, W, H, radius, label, timed=None):
    """The AO direction kernel (csrc/ao_dirs.cu) on the recorded launches of a
    1-spp ``render_ao`` of ``scene`` at W x H: with BlueSampler(AO_SPP) (the
    ``blue`` form, the draw in the kernel) and with HaltonSampler(AO_SPP)
    (the ``u`` form, after the sampler's ``u2``).  ao.LAUNCHES is zeroed just
    before each recording render and read just after: DIRECTIONS launches of
    that form and none of the other.  Every launch is held bit for bit to the
    PyTorch chain ``occlusion_dirs_plain`` on its own inputs, and timed beside
    the chain: plain_ms is the whole chain for the blue form and the chain
    after the draw, ``to_world(ns, uniform_hemisphere(u))``, for the u form.
    bound_ms: AO_DIRS_BYTES a lane at HBM_BYTES_PER_S.  ``timed``
    ({"ao_dirs.<form>": launches}): the launches of a form in the path's
    timed render; a form not in it gives the recording render's.  ->
    kernel-line entries ``ao_dirs.<label>.<form>``."""
    import torch

    from pine_tpu_torch.core.samplers import BlueSampler, HaltonSampler
    from pine_tpu_torch.core.sampling import uniform_hemisphere
    from pine_tpu_torch.core.vecmath import to_world
    from pine_tpu_torch.integrators import ao as AO

    entries = []
    for form, sampler in (("blue", BlueSampler(AO_SPP)), ("u", HaltonSampler(AO_SPP))):
        calls, real = [], AO.occlusion_dirs

        def record(ns, s, xs, ys, width, i, k):
            calls.append((ns.clone(), xs, ys, i, k))
            return real(ns, s, xs, ys, width, i, k)

        AO.occlusion_dirs = record
        try:
            AO.LAUNCHES.update(dict.fromkeys(AO.LAUNCHES, 0))
            AO.render_ao(cs, scene.camera, W, H, sampler, 1, radius)
            torch.cuda.synchronize()
            counted = dict(AO.LAUNCHES)
        finally:
            AO.occlusion_dirs = real
        if counted != {**dict.fromkeys(AO.LAUNCHES, 0), f"ao_dirs.{form}": AO.DIRECTIONS}:
            fail(f"a 1-spp AO render with {type(sampler).__name__} launched {counted}")
        ms_each, plain_each, differ = [], [], 0
        for ns, xs, ys, i, k in calls:
            dim = 4 + 2 * k
            if form == "blue":
                tables = sampler.tables(ns.device)
                kernel = lambda: AO.ao_dirs_blue(ns, tables, W, i, dim)  # noqa: E731
                plain = lambda: AO.occlusion_dirs_plain(ns, sampler, xs, ys, i, k)  # noqa: E731
            else:
                u = sampler.u2(xs, ys, i, dim)
                kernel = lambda: AO.ao_dirs_u(ns, u)  # noqa: E731
                plain = lambda: to_world(ns, uniform_hemisphere(u))  # noqa: E731
            ms_each.append(cuda_ms(kernel, 10))
            plain_each.append(cuda_ms(plain, 3))
            got = kernel().view(torch.int32)
            want = AO.occlusion_dirs_plain(ns, sampler, xs, ys, i, k).view(torch.int32)
            differ += int((got != want).any(-1).sum())
        if differ:
            fail(f"ao_dirs.{form}: {differ} lanes differ from the chain bit for bit on the "
                 f"{label} render's inputs")
        n = calls[0][0].shape[0]
        key = f"ao_dirs.{form}"
        entries.append(dict(
            name=f"ao_dirs.{label}.{form}", route="cuda", source="pine_tpu_torch/csrc/ao_dirs.cu",
            replaces="none: pine_tpu/integrators/ao.py:56-57, left to XLA",
            launches=(timed or {}).get(key, counted[key]),
            launches_of="the timed render" if key in (timed or {}) else "one 1-spp render",
            max_abs_err=0.0, ms=sum(ms_each) / len(ms_each),
            plain_ms=sum(plain_each) / len(plain_each),
            bound_ms=n * AO_DIRS_BYTES[form] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None,
            inputs=f"{n} lanes ({W}x{H}); means per launch over the {len(calls)} launches of one "
                   f"1-spp render with {type(sampler).__name__}; the chain on each",
            ms_each=ms_each, lanes_differ=differ, lanes_differ_bits=differ))
    return entries


def phase_ao(dev_name):
    """AOIntegrator(BlueSampler(AO_SPP)) on the bench box at 640x640 as a main
    path (the dense kernel held to dense_plain bit for bit on every launch of a
    1-spp render, entries ``dense_traverse.ao.*``; the timed render must launch
    the direction kernel's blue form DIRECTIONS x AO_SPP times and its u form
    never), then the direction kernel's entries (``ao_dirs_entries``) on that
    path's inputs, ``ao_dirs.ao.*``, and on the box at AO_HD, the benchmark's
    AO cells' lane count, ``ao_dirs.ao_1080p.*``.  -> kernel-line entries."""
    import numpy as np
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.integrators.ao import DIRECTIONS, render_ao

    box = scenes.cbox((MAIN_SIZE, MAIN_SIZE))
    lo, up = box.get_aabb()
    radius = float(np.linalg.norm(up - lo) / 2)

    def ao_render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        return render_ao(cs, scene.camera, W, H, sampler, spp, radius, return_stats)

    entries, cs = phase_main_path(
        dev_name, "ao", "AOIntegrator(BlueSampler(16)) on the bench cbox, 420 cones", box,
        [("dense", 1, 6), ("dense", 5, 2), ("dense", 7, 424)], False, ["dense"], MAIN_SIZE,
        AO_SPP, 1, label="ao", render_fn=ao_render, reps=1)
    launches = {form: MAIN_LAUNCHES["ao"][f"ao_dirs.{form}"] for form in ("blue", "u")}
    if launches != {"blue": DIRECTIONS * AO_SPP, "u": 0}:
        fail(f"the ao main path's timed render launched the direction kernel {launches}")
    entries += ao_dirs_entries(cs, box, MAIN_SIZE, MAIN_SIZE, radius, "ao",
                               {"ao_dirs.blue": launches["blue"]})
    del cs
    box_hd = scenes.cbox(AO_HD)
    entries += ao_dirs_entries(box_hd.compile(), box_hd, *AO_HD, radius, "ao_1080p")
    torch.cuda.empty_cache()
    return entries


def kernel_ab_record(cs, scene, what, tid, kinds, size=MAIN_SIZE, depth=MAIN_DEPTH):
    """One group of a compiled main-path scene (the group of prim type
    ``tid``; the instanced group for "inst" kinds) through each of ``kinds``
    on every launch it gets in one 1-spp render on its own route (the first
    of ``kinds``): device time summed per form, and the lanes where each
    other kernel disagrees with the first (recorded, not gated;
    ``hits_differ``, and for an MXU form beside a VPU form also the lanes
    beyond the MXU tolerance, ``mxu_lanes_differ``)."""
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    inst = kinds[0].startswith("inst")
    (g,) = [g for g in all_groups(cs) if g["tid"] == tid and (g["kind"] == "instanced") == inst]
    for kind in kinds:
        prep(g, kind)
    recorded, _ = record_launches(cs, kinds[:1], lambda: render_wavefront(
        cs, scene.camera, size, size, BlueSampler(MAIN_SPP), 1, depth))
    rec = dict(phase="kernel_ab", scene=what, group=group_desc(g), per="one 1-spp render")
    for any_hit, form in ((False, "closest"), (True, "any_hit")):
        calls = [args for h, args, _ in recorded[(kinds[0], any_hit)] if h is g]
        rec[form] = dict(launches=len(calls))
        for kind in kinds:
            rec[form][f"{kind}_ms"] = sum(cuda_ms(lambda: launch(kind, g, a, any_hit), 10)
                                          for a in calls)
        for kind in kinds[1:]:
            rec[form][f"{kind}_lanes_differ"] = sum(hits_differ(
                launch(kinds[0], g, a, any_hit), launch(kind, g, a, any_hit), any_hit)
                for a in calls)
            if "mxu" in kind:
                rec[form][f"{kind}_lanes_beyond_mxu_tol"] = sum(mxu_lanes_differ(
                    launch(kinds[0], g, a, any_hit), launch(kind, g, a, any_hit), any_hit)
                    for a in calls)
    emit(rec)


def phase_house(dev_name):
    """The house at 640x640: PathIntegrator(BlueSampler(16), 5) as a main path,
    its grid kernel held to grid_plain on every launch of a 1-spp render
    (the DirectionalLight's shadow rays to t = 1e10 among them) -> its
    kernel-line entries; then the script's CachedPathIntegrator(
    BlueSampler(128), 5, 128) once, launch counts zeroed just before and
    read just after, its phases timed."""
    import numpy as np
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.cachedpath import render_cached

    scene = scenes.house(MAIN_SIZE)
    entries, cs = phase_main_path(dev_name, "house", "house.pine: GLB, 4,020 triangles, "
                                  "DirectionalLight + window mesh light, PathIntegrator",
                                  scene, [("grid", 6, 4020)], False, ["grid"], depth=5,
                                  label="house")
    W = H = MAIN_SIZE
    torch.cuda.synchronize()
    DT.reset_launches()
    t0 = time.perf_counter()
    img, st = render_cached(cs, scene.camera, W, H, BlueSampler(128), 128, 5, scene.get_aabb(),
                            128, 1, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(DT.LAUNCHES)
    img = img.cpu().numpy()
    rec = dict(phase="main_path", scene="house.pine as written: CachedPathIntegrator("
               "BlueSampler(128), 5, 128)", size=f"{W}x{H}", spp=128, learning_spp=32, depth=5,
               device=dev_name, wall_s=wall, learn_s=st["learn_s"], render_s=st["render_s"],
               traced_rays=st["traced_rays"], mrays_per_s=st["traced_rays"] / wall / 1e6,
               finite=bool(np.isfinite(img).all()), mean=float(img.mean()), launches=launches)
    emit(rec)
    if not (rec["finite"] and img.mean() > 0) or min(
            launches["grid.closest"], launches["grid.any_hit"]) <= 0:
        fail(f"the house's cached render is not finite and lit, or skipped the grid kernel: {rec}")
    scene.camera.film.set_rgb(torch.from_numpy(img))
    scene.camera.film.save(os.path.join(OUT_DIR, "chip_smoke_house_cached.png"))
    return entries


def phase_lab(dev_name, probe_recs):
    """Kernel 9's main path: the probe's timed chains, as ``python -m
    pine_tpu_torch.lab.cone_probe`` runs them, launch counts zeroed just
    before and read just after -> its kernel-line entries, with phase 2k's
    plain times on the same (coherent) rays."""
    import torch

    from pine_tpu_torch.lab import cone_probe as CP

    inputs = CP.probe_inputs(torch.device("cuda"))
    misses = CP.early_misses(*inputs[:3])  # pairs that leave at the discriminant, for the bound
    CP.reset_launches()
    recs = [CP.time_variant(v, inputs, misses)[0] for v in CP.VARIANTS]
    launches = dict(CP.LAUNCHES)
    emit(dict(phase="lab", device=dev_name, what="cone probe chains, box cone group, "
              f"{N_RAYS} coherent rays, chain {CP.CHAIN}, min of 3", records=recs,
              launches=launches))
    if min(launches.values()) <= 0:
        fail(f"the probe's main path skipped a variant: {launches}")
    checked = {r["form"]: r for r in probe_recs if r["group"] == "cone[424] coherent"}
    return [dict(name=f"cone_probe.{r['variant']}", route="cuda",
                 source="pine_tpu_torch/csrc/cone_probe.cu", replaces="scripts_cone_probe.py:97",
                 launches=launches[r["variant"]], max_abs_err=checked[r["variant"]]["max_abs_err"],
                 ms=checked[r["variant"]]["ms"], plain_ms=checked[r["variant"]]["plain_ms"],
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
                 inputs=f"cone[424] x {N_RAYS} coherent rays, no cull; ms the mean of 10 "
                        "launches back to back (phase 2k), chain_ms per link of the probe's "
                        f"chains of {CP.CHAIN}, min of 3; bound_ms the variant's own "
                        "operations (cone_probe.VARIANT_OPS a pair, EARLY_OPS a pair that "
                        "leaves at the early miss), full_bound_ms the full sweep's",
                 chain_ms=r["per_call_ms"], full_bound_ms=r["full_bound_ms"],
                 early_miss_share=r["early_miss_share"],
                 x_bound=checked[r["variant"]]["ms"] / r["bound_ms"],
                 ns_per_pair=checked[r["variant"]]["ms"] * 1e6 / (N_RAYS * r["n_prims"]))
            for r in recs]


# ---------------------------------------------------------------- phase 5 ----

def prl_box_checked():
    """The benchmark box built from bench.py's script through the port's PRL
    interpreter, as bench.py builds it; its scene arrays must equal the
    Scene API box's (scenes.cbox)."""
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import scene_arrays

    def equal(x, y):  # arrays, or a group's lattice model (a dict or None)
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        if x is None or y is None:
            return x is y
        return np.array_equal(x, y)

    scene = scenes.prl_scene(scenes.CBOX_PRL, "<bench:cbox>")
    a, b = scene_arrays(scene), scene_arrays(scenes.cbox())
    same = a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    emit(dict(phase="prl_scene", scene="bench cbox from CBOX_PRL", arrays=len(a),
              equal_to_scene_api=bool(same)))
    if not same:
        fail("CBOX_PRL through the PRL interpreter differs from scenes.cbox")
    return scene


def read_png(path):
    """(H,W,3) uint8 of an 8-bit RGB PNG as io/image_io.save_image writes it
    (one IDAT stream, every row with filter 0)."""
    import struct
    import zlib

    import numpy as np

    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        fail(f"{path}: a PNG row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_cli():
    """``python -m pine_tpu_torch cbox.pine`` on the card: the benchmark
    box's script plus a render and a save.  Its PNG must equal phase 4's
    in-process render of the box (the same tone-mapped 8-bit pipeline) on
    97 % of the pixels by the render-parity tolerance.  -> its wall seconds."""
    import numpy as np

    from pine_tpu_torch import scenes

    out = os.path.join(OUT_DIR, "cli_cbox.png")
    if os.path.exists(out):
        os.remove(out)
    script = os.path.join(OUT_DIR, "cbox.pine")
    with open(script, "w") as f:
        f.write(scenes.CBOX_PRL + f"\nPathIntegrator(BlueSampler({MAIN_SPP}), {MAIN_DEPTH})"
                ".render(scene);\n" + f"scene.camera.film().save('{out}');\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pine_tpu_torch", script], cwd=OUT_DIR,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    rec = dict(phase="cli", command="python -m pine_tpu_torch cbox.pine", returncode=proc.returncode,
               wall_s=wall, finished=lines[-1] if lines else "", png=os.path.exists(out))
    if proc.returncode != 0 or not rec["png"]:
        emit(rec)
        fail(f"the CLI failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    got = read_png(out).astype(np.float32)
    want = read_png(os.path.join(OUT_DIR, "chip_smoke_cbox.png")).astype(np.float32)
    d = np.abs(got - want)
    rec["pixels_agree"] = float(((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).all(-1).mean())
    emit(rec)
    if got.shape != want.shape or rec["pixels_agree"] < 0.97 or not rec["finished"].startswith(
            "Finished in"):
        fail(f"the CLI's image differs from the in-process render: {rec}")
    return wall


def phase_garden_cli():
    """``python -m pine_tpu_torch garden.pine`` on the card: GARDEN_PRL as it
    stands (its render and its save to garden.png in the working
    directory).  Its PNG must equal phase 4's in-process render of the
    garden on 97 % of the pixels by the render-parity tolerance."""
    import numpy as np

    from pine_tpu_torch import scenes

    out = os.path.join(OUT_DIR, "garden.png")
    if os.path.exists(out):
        os.remove(out)
    with open(os.path.join(OUT_DIR, "garden.pine"), "w") as f:
        f.write(scenes.GARDEN_PRL)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pine_tpu_torch", "garden.pine"], cwd=OUT_DIR,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    rec = dict(phase="cli", command="python -m pine_tpu_torch garden.pine",
               returncode=proc.returncode, wall_s=wall, finished=lines[-1] if lines else "",
               png=os.path.exists(out))
    if proc.returncode != 0 or not rec["png"]:
        emit(rec)
        fail(f"the garden's CLI run failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    got = read_png(out).astype(np.float32)
    want = read_png(os.path.join(OUT_DIR, "chip_smoke_garden.png")).astype(np.float32)
    d = np.abs(got - want)
    rec["pixels_agree"] = float(((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).all(-1).mean())
    emit(rec)
    if got.shape != want.shape or rec["pixels_agree"] < 0.97 or not rec["finished"].startswith(
            "Finished in"):
        fail(f"the garden's CLI image differs from the in-process render: {rec}")


def phase_media_cli():
    """``python -m pine_tpu_torch csg_fog.pine`` on the card: CSG_FOG_PRL as
    it stands (its render and its save to csg_fog.png); its image must equal
    phase 4's in-process render of the script on 97 % of the pixels.  Then a
    script of a VDBMedium over an .nvdb written here (scenes.explosion's
    grids: density, flames, temperature) and a HomoMedium, 96x96, 4 spp,
    depth 4, its PNG finite and lit."""
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.io.nvdb import write_nvdb_multi

    for name, src, want in (("csg_fog", scenes.CSG_FOG_PRL, "chip_smoke_csg_fog.png"),
                            ("vdb", None, None)):
        if src is None:
            dens, flame, temp = scenes.make_explosion(48)
            nvdb = os.path.join(OUT_DIR, "explosion.nvdb")
            write_nvdb_multi(nvdb, {"density": dens, "flames": flame, "temperature": temp})
            src = VDB_PRL.replace("FILE", repr(nvdb))
        out = os.path.join(OUT_DIR, f"{name}.png")
        if os.path.exists(out):
            os.remove(out)
        with open(os.path.join(OUT_DIR, f"{name}.pine"), "w") as f:
            f.write(src)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pine_tpu_torch", f"{name}.pine"],
                              cwd=OUT_DIR, env=dict(os.environ, PYTHONPATH=ROOT),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        rec = dict(phase="cli", command=f"python -m pine_tpu_torch {name}.pine",
                   returncode=proc.returncode, wall_s=wall, finished=lines[-1] if lines else "",
                   png=os.path.exists(out))
        if proc.returncode != 0 or not rec["png"]:
            emit(rec)
            fail(f"the {name} CLI run failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        got = read_png(out).astype(np.float32)
        rec["mean"] = float(got.mean())
        if want is not None:
            ref = read_png(os.path.join(OUT_DIR, want)).astype(np.float32)
            d = np.abs(got - ref)
            rec["pixels_agree"] = float(((d <= 1e-3 * np.abs(ref)) | (d <= 1e-4)).all(-1).mean())
        emit(rec)
        if not rec["finished"].startswith("Finished in") or not got.mean() > 0 or (
                want is not None and (got.shape != ref.shape or rec["pixels_agree"] < 0.97)):
            fail(f"the {name} CLI image is wrong: {rec}")


VDB_PRL = """
scene := Scene();
scene.add("floor", Diffuse([0.45, 0.42, 0.4]));
scene.add(Rect([0, 0, 0], [12, 0, 0], [0, 0, 12]), "floor");
scene.add(Rect([-4, 7, -6], [2.5, 0, 0], [0, 0, 2.5]), Emissive([16, 15, 14]));
scene.add(VDBMedium(FILE, translate([-1.2, 0.0, -1.2]) * scale([2.4, 2.4, 2.4]), CloudPF(0.6), [6, 6, 6], [4, 4, 4], 3.0, 0.9));
scene.add(HomoMedium(AABB([-3, 0, -3], [3, 3, 3]) - AABB([-1.3, 0, -1.3], [1.3, 2.5, 1.3]), HgPF(0.2), [0.01, 0.01, 0.01], [0.05, 0.05, 0.05]));
scene.set(ThinLenCamera(Film([96, 96]), [0, 1.6, -4.6], [0, 1.1, 0], 0.3));
PathIntegrator(BlueSampler(4), 4).render(scene);
scene.camera.film().save("vdb.png");
"""


def phase_bench(box_rays):
    """``python -m pine_tpu_torch.bench`` on the card, bench.py's counterpart:
    its JSON line must parse, be finite, and count traced rays within 0.5 %
    of phase 4's render of the box (``box_rays``)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pine_tpu_torch.bench"], cwd=OUT_DIR,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        got = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"the bench printed no JSON line: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    rec = dict(phase="bench", command="python -m pine_tpu_torch.bench", returncode=proc.returncode,
               process_wall_s=wall, phase4_traced_rays=box_rays, result=got)
    emit(rec)
    if proc.returncode != 0 or got.get("finite") is not True or not (
            abs(got.get("traced_rays", 0) - box_rays) <= 0.005 * box_rays):
        fail(f"the bench's result is not finite or its traced rays differ from phase 4's: {rec}")


def run_module(args, what, timeout=600, cwd=OUT_DIR, env=None):
    """``python -m`` ``args`` from ``cwd`` (build/chip_smoke/), with the
    variables ``env`` added -> (completed process, wall seconds, the JSON
    objects of its output lines)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{what} failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out = []
    for line in proc.stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return proc, wall, out


def phase_house_cli():
    """The house script as written, its GLB's path made absolute, through the
    CLI from build/chip_smoke/: its images/house3.png finite and lit."""
    import numpy as np

    from pine_tpu_torch import scenes

    out = os.path.join(OUT_DIR, "images", "house3.png")
    if os.path.exists(out):
        os.remove(out)
    script = os.path.join(OUT_DIR, "house.pine")
    with open(script, "w") as f:
        f.write(scenes.house_prl(save="images/house3.png"))
    proc, wall, _ = run_module(["pine_tpu_torch", script], "the house CLI")
    lines = proc.stdout.strip().splitlines()
    img = read_png(out).astype(np.float32) if os.path.exists(out) else np.zeros(1)
    rec = dict(phase="cli", command="python -m pine_tpu_torch house.pine", wall_s=wall,
               finished=lines[-1] if lines else "", png=os.path.exists(out),
               size=list(img.shape), mean=float(img.mean()))
    emit(rec)
    if not (rec["png"] and img.shape == (640, 640, 3) and img.mean() > 0
            and rec["finished"].startswith("Finished in")):
        fail(f"the house CLI's image is missing or not lit: {rec}")


def phase_lab_modules():
    """``python -m pine_tpu_torch.lab.cone_probe`` (seven records, full and
    inva finite, inva with max_dev_vs_full) and ``python -m
    pine_tpu_torch.lab.kernel_lab`` (every workload, route and ray set timed:
    the port's groups take every route the lab asks for)."""
    import math

    from pine_tpu_torch.lab import cone_probe as CP
    from pine_tpu_torch.lab import kernel_lab as KL

    _, wall, out = run_module(["pine_tpu_torch.lab.cone_probe"], "the cone probe")
    recs = {r["variant"]: r for r in out if "variant" in r}
    emit(dict(phase="lab_module", command="python -m pine_tpu_torch.lab.cone_probe",
              wall_s=wall, records=list(recs.values())))
    if sorted(recs) != sorted(CP.VARIANTS) or not all(
            math.isfinite(recs[v]["per_call_ms"]) for v in ("full", "inva")) \
            or "max_dev_vs_full" not in recs["inva"]:
        fail(f"the cone probe's records are incomplete: {recs}")
    _, wall, out = run_module(["pine_tpu_torch.lab.kernel_lab"], "the kernel lab", 900)
    recs = [r for r in out if "workload" in r]
    want = sorted((w, v, s) for w, vs in KL.WORKLOADS.items() for v in vs for s in KL.RAYSETS)
    got = sorted((r["workload"], r["variant"], r.get("rays")) for r in recs
                 if math.isfinite(r.get("per_call_ms", math.nan)))
    emit(dict(phase="lab_module", command="python -m pine_tpu_torch.lab.kernel_lab",
              wall_s=wall, records=recs))
    if got != want or len(recs) != len(want):
        fail(f"the kernel lab did not time every route and ray set: {recs}")



# ---- the script-lambda slice: draw, traced control flow, SDF lambdas,
# hot host loops, the random walk and the denoiser --------------------------

LAMBDA_SIZE = 640  # storm's, the traced fragments' and the lambda SDF cell's film edge
RW_SPP, RW_DEPTH = 16, 4  # RandomWalkIntegrator(BlueSampler(16), 4) on the bench box
BOX_GROUPS = [("dense", 1, 6), ("dense", 5, 2), ("dense", 7, 424)]
# tests/test_prl.py's traced fragments (as tests/test_torch_trace_flow.py runs them)
TRACED_FLOW = {
    "while_per_lane": """(u: vec2): vec3 {
    x := u.x + 0.01;
    n := 0.0;
    while x > 0.1 {
        x = x / 2.0;
        n += 1.0;
    }
    return [n / 8.0, x, 0.0];
}""",
    "while_replay": """(u: vec2): vec3 {
    t := 0.0;
    i := 0.0;
    while t < 1.0 {
        t += 0.3 * (u.x + 0.2);
        i += 1.0;
    }
    return [t, i, 0.0];
}""",
    "if_merge": """(u: vec2): vec3 {
    c := 0.0;
    if u.x < 0.5 {
        c = 1.0;
    } else if u.y < 0.5 {
        c = 2.0;
    } else {
        c = 3.0;
    }
    return vec3(c / 3.0);
}""",
    "all_return": """(u: vec2): vec3 {
    if u.x < 0.5 {
        return [1.0, 0.0, 0.0];
    } else {
        return [0.0, 1.0, 0.0];
    }
}""",
}
# phase 3's reduced lambda scenes: a heightmap of an fbm lambda with a
# Function-node albedo; an SDF whose lambda runs a traced while and a traced if
LAMBDA_TERRAIN_PRL = """
scene := Scene();
scene.add(Rect([0, 3, 0], [2, 0, 0], [0, 0, 2]), Emissive([6, 6, 6]));
hm := heightmap([40, 40], (p: vec2): f32 { return fbm(p * 3.0, 5) * 0.4; });
scene.add(hm, Diffuse(Function((c: NodeEvalCtx): vec3 {
    return [0.4 + 0.3 * c.n.y, 0.5 + 0.4 * sin(c.p.x * 6.0), 0.35];
})));
scene.set(ThinLenCamera(Film([64, 64]), [0, 1.6, -2.4], [0, 0, 0], 0.45));
PathIntegrator(BlueSampler(4), 4).render(scene);
"""
LAMBDA_SDF_PRL = """
scene := Scene();
scene.add(Rect([0, 3, 0], [2, 0, 0], [0, 0, 2]), Emissive([8, 8, 8]));
scene.add(Rect([0, -0.7, 0], [3, 0, 0], [0, 0, 3]), Diffuse([0.7, 0.7, 0.7]));
scene.add(SDF([0, 0, 0], [1, 1, 1], (p: vec3): f32 {
    d := length(p) - 0.6;
    k := 0.0;
    while k < 3.0 {
        d = d * 0.5 + (length(p) - 0.6) * 0.5;
        k += 1.0;
    }
    if d > 0.5 {
        d = d * 0.75 + 0.125;
    }
    return d;
}), Diffuse([0.8, 0.4, 0.3]));
scene.set(ThinLenCamera(Film([64, 64]), [0, 0.4, -3], [0, 0, 0], 0.5));
PathIntegrator(BlueSampler(4), 4).render(scene);
"""


STORM_NONFINITE_SHARE = 1e-5  # storm's values where 0.5 - dot(u, u) is an exact 0


def parity_record(what, g, c, nonfinite_share=0.0, **extra):
    """Hold a card image ``g`` to the CPU's ``c`` by render_parity's rule
    (97 % of the pixels to 1e-3 relative or 1e-4 absolute, means to 1 %,
    finite and lit); the record says whether they are equal bit for bit.
    ``nonfinite_share``: the share of each image's values that may be
    non-finite (a pixel with one disagrees; storm's fragment divides by
    0.5 - dot(u, u), an exact 0 where a lane's float32 u lands on that
    circle, a chaotic lane's last bits deciding which)."""
    import numpy as np

    bad_g, bad_c = ~np.isfinite(g), ~np.isfinite(c)
    g0, c0 = np.where(bad_g, 0.0, g), np.where(bad_c, 0.0, c)
    d = np.where(bad_g | bad_c, np.inf, np.abs(g0 - c0))
    agree = float(((d <= 1e-3 * np.abs(c0)) | (d <= 1e-4)).all(-1).mean())
    rec = dict(phase="render_parity", scene=what, pixels_agree=agree,
               bits_equal=bool(np.array_equal(g, c, equal_nan=True)),
               mean_cuda=float(g0.mean()), mean_cpu=float(c0.mean()),
               finite=bool(not bad_g.any()), nonfinite_values=[int(bad_g.sum()), int(bad_c.sum())],
               **extra)
    emit(rec)
    if not (max(bad_g.mean(), bad_c.mean()) <= nonfinite_share and agree >= 0.97 and g0.mean() > 0
            and abs(g0.mean() - c0.mean()) <= 0.01 * abs(c0.mean())):
        fail(f"card image disagrees with the CPU image: {rec}")
    return rec


def lambda_parity():
    """Phase 3's lambda scenes, card against CPU, each built and rendered
    through the PRL interpreter on its device (64x64, BlueSampler(4), depth
    4): the heightmap of an fbm lambda (40x40, 3,042 triangles) with a
    Function-node albedo; the SDF whose lambda runs a traced while and a
    traced if; the reduced box (36 cones) by RandomWalkIntegrator and by
    PathIntegrator with denoise(scene)."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.prl.interp import Interpreter

    box = scenes.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", "-0.3 ~ 0.1 ~ 0.3").replace(
        "0.0 ~ 0.1 ~ 2.0", "0.5 ~ 0.1 ~ 1.0").replace("[640, 640]", "[64, 64]")
    cases = {"heightmap(size, fn) + Function albedo": LAMBDA_TERRAIN_PRL,
             "SDF lambda with a traced while and if": LAMBDA_SDF_PRL,
             "reduced cbox, RandomWalkIntegrator": box
             + "RandomWalkIntegrator(BlueSampler(4), 4).render(scene);",
             "reduced cbox, PathIntegrator + denoise": box
             + "PathIntegrator(BlueSampler(4), 4).render(scene); denoise(scene);"}
    for what, src in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            itp = Interpreter(device=dev, out=lambda s: None)
            itp.run(src, f"<{what}>")
            out[dev] = itp.get_var("scene").camera.film.rgb.cpu().numpy()
        parity_record(what, out["cuda"], out["cpu"], size="64x64x4spp depth 4")


def host_ms_in_sdf(cs, render):
    """Run ``render()`` with the scene's one SDF distance function timed on
    the host (each call as the host issues it, no sync) -> (calls, host ms)."""
    import torch

    (sdf, _), = cs.sdf_shapes
    real, spent = sdf.fn, []

    def timed(p):
        t0 = time.perf_counter()
        r = real(p)
        spent.append(time.perf_counter() - t0)
        return r

    sdf.fn = timed
    try:
        render()
        torch.cuda.synchronize()
    finally:
        sdf.fn = real
    return len(spent), sum(spent) * 1e3


def phase_lambdas(dev_name):
    """The slice's paths at full width on the card.  storm (STORM_PRL as
    written, 640x640 draw) in process: wall, card image against the CPU's.
    The traced fragments at 640x640: card against CPU bit for bit, the
    masked loops' device-to-host syncs per call.  The lambda SDF cell
    (CSG_FOG_SDF_PRL: the fog box with the torus as a PRL SDF lambda,
    640x640, BlueSampler(16), depth FOG_SDF_DEPTH) as a main path, its image
    against phase_media's csg_fog_sdf (the torch-function torus), and the host time
    spent in the lambda (walking its AST and issuing its launches) per
    march step beside the torch function's.  benchmark.pine in full:
    exact, the batched tier taken, wall and syncs with the interpreter on
    the host CPU (on the card: phase_lambda_cli's python -m
    pine_tpu_torch.bench_prl), and at 10 outer iterations on the
    card with the masked loop's check every iteration against every
    EXIT_CHECK.  RandomWalkIntegrator(BlueSampler(16), 4) and
    PathIntegrator(BlueSampler(16), 4) + denoise(scene) on the bench box as
    main paths: the dense kernel held to its plain version on every launch
    of a 1-spp render.  -> kernel-line entries."""
    import numpy as np
    import torch

    from pine_tpu_torch import bench_prl, scenes
    from pine_tpu_torch.integrators.denoiser import denoise_scene
    from pine_tpu_torch.integrators.path import render_wavefront
    from pine_tpu_torch.prl import loop_jit, trace_flow
    from pine_tpu_torch.prl.interp import Interpreter

    def draw_image(src, dev):
        itp = Interpreter(device=dev, out=lambda s: None)
        syncs = trace_flow.SYNCS[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        itp.run(src)
        img = itp.get_var("img").data
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return img.cpu().numpy(), wall, trace_flow.SYNCS[0] - syncs

    # storm: the script as written (saved beside the CLI's), then its image
    storm_png = os.path.join(OUT_DIR, "chip_smoke_storm.png")
    t0 = time.perf_counter()
    Interpreter(out=lambda s: None).run(scenes.storm_prl(LAMBDA_SIZE, storm_png), "<storm>")
    script_wall = time.perf_counter() - t0
    raw = scenes.STORM_PRL.replace('}).save("storm.png");', "});").replace(
        "draw(image_size", "img := draw(image_size")
    g, g_wall, _ = draw_image(raw, "cuda")
    g, g_wall, _ = draw_image(raw, "cuda")  # warm
    c, c_wall, _ = draw_image(raw, "cpu")
    parity_record("storm, 640x640 draw", g, c, STORM_NONFINITE_SHARE, card_draw_s=g_wall,
                  cpu_draw_s=c_wall, script_wall_s=script_wall)
    # the traced fragments
    flows = {}
    for name, frag in TRACED_FLOW.items():
        src = f"img := draw([{LAMBDA_SIZE}, {LAMBDA_SIZE}], {frag});"
        g, g_wall, g_syncs = draw_image(src, "cuda")
        c, c_wall, c_syncs = draw_image(src, "cpu")
        flows[name] = dict(bits_equal=bool(np.array_equal(g, c)), card_s=g_wall, cpu_s=c_wall,
                           syncs_card=g_syncs, syncs_cpu=c_syncs)
        if not flows[name]["bits_equal"]:
            emit(dict(phase="traced_flow", fragments=flows))
            fail(f"the traced fragment {name} differs on the card from the CPU")
    saved = trace_flow.EXIT_CHECK
    trace_flow.EXIT_CHECK = 1  # a sync every iteration, for the record
    try:
        src = f"img := draw([{LAMBDA_SIZE}, {LAMBDA_SIZE}], {TRACED_FLOW['while_replay']});"
        draw_image(src, "cuda")
        _, every_s, every_syncs = draw_image(src, "cuda")
    finally:
        trace_flow.EXIT_CHECK = saved
    emit(dict(phase="traced_flow", size=f"{LAMBDA_SIZE}x{LAMBDA_SIZE}", fragments=flows,
              exit_check=saved, while_replay_every_iteration=dict(card_s=every_s,
                                                                   syncs=every_syncs)))

    # the lambda SDF cell
    scene = scenes.prl_scene(scenes.csg_fog_sdf_prl(FOG_SIZE, integrator=None, save=None),
                             "<csg fog + lambda torus>")
    entries, cs = phase_main_path(
        dev_name, "csg_fog_sdf_prl", "the CSG fog box with the torus as a PRL SDF lambda "
        "(CSG_FOG_SDF_PRL)", scene, FOG_GROUPS, False, ["dense"], FOG_SIZE, FOG_SPP,
        FOG_SDF_DEPTH, label="csg_fog_sdf_prl", reps=1)
    parity_record(f"lambda torus against the torch-function torus, 640x640x16spp, depth "
                  f"{FOG_SDF_DEPTH}, both on the card", MAIN_IMAGES["csg_fog_sdf_prl"],
                  MAIN_IMAGES["csg_fog_sdf"])
    from pine_tpu_torch.core.samplers import BlueSampler

    steps = {}
    for what, sc in (("lambda", scene), ("torch function", scenes.csg_fog_sdf(FOG_SIZE))):
        c2 = cs if sc is scene else sc.compile()
        calls, ms = host_ms_in_sdf(c2, lambda: path_render(
            c2, sc, FOG_SIZE, FOG_SIZE, BlueSampler(FOG_SPP), 1, FOG_SDF_DEPTH))
        steps[what] = dict(calls=calls, host_ms=ms, host_ms_per_call=ms / max(calls, 1))
    emit(dict(phase="sdf_lambda_host", per="one 1-spp render", distance_calls=steps,
              note="host time inside the distance function as the host issues it (no sync): "
                   "for the lambda, walking its AST plus issuing its launches"))
    del cs
    torch.cuda.empty_cache()

    # benchmark.pine on the host CPU (on the card: phase_lambda_cli's
    # python -m pine_tpu_torch.bench_prl), then 10 outer iterations on the card
    # with the masked loop asking for its active lanes every iteration and
    # every EXIT_CHECK
    out, wall, runs, syncs = bench_prl.run_prl("cpu")
    rec = dict(phase="benchmark_pine", device="cpu", output=out, wall_s=wall, tiers=runs,
               masked_loop_syncs=syncs)
    emit(rec)
    if out != [str(bench_prl.OUTER * bench_prl.PER_OUTER)] or not runs["batch"]:
        fail(f"benchmark.pine is wrong or skipped the batched tier: {rec}")
    checks = {}
    for k in (1, trace_flow.EXIT_CHECK, 1, trace_flow.EXIT_CHECK):
        saved, trace_flow.EXIT_CHECK = trace_flow.EXIT_CHECK, k
        try:
            out, wall, runs, syncs = bench_prl.run_prl(None, outer=10)
        finally:
            trace_flow.EXIT_CHECK = saved
        if out != [str(10 * bench_prl.PER_OUTER)] or not runs["batch"]:
            fail(f"benchmark.pine at 10 outer iterations is wrong: {out} {runs}")
        checks.setdefault(f"exit_check_{k}", []).append(dict(wall_s=wall, syncs=syncs))
    emit(dict(phase="benchmark_pine_exit_check", outer=10, device="card", runs=checks))

    # the random walk and the denoiser on the bench box
    box = scenes.prl_scene(scenes.CBOX_PRL, "<bench cbox>")

    def rw_render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        return render_wavefront(cs, scene.camera, W, H, sampler, spp, depth, nee=False,
                                return_stats=return_stats)

    def denoised_render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        out = path_render(cs, scene, W, H, sampler, spp, depth, return_stats)
        img = out[0] if return_stats else out
        scene.camera.film.set_rgb(img)
        den = denoise_scene(scene).rgb
        return (den, out[1]) if return_stats else den

    entries += phase_main_path(
        dev_name, "randomwalk", "RandomWalkIntegrator(BlueSampler(16), 4) on the bench cbox",
        box, BOX_GROUPS, False, ["dense"], MAIN_SIZE, RW_SPP, RW_DEPTH, label="randomwalk",
        render_fn=rw_render, reps=1, forms=("closest",))[0]
    entries += phase_main_path(
        dev_name, "denoise", "PathIntegrator(BlueSampler(16), 4) + denoise(scene) on the "
        "bench cbox", box, BOX_GROUPS, False, ["dense"], MAIN_SIZE, RW_SPP, RW_DEPTH,
        label="denoise", render_fn=denoised_render, reps=1)[0]
    loop_jit._CACHE.clear()
    torch.cuda.empty_cache()
    return entries


STORM_CLI_ROWS = 0.97  # the CLI's storm PNG against the in-process one, pixels that agree


def phase_lambda_cli():
    """``python -m pine_tpu_torch storm.pine`` (STORM_PRL as written, its
    save to storm.png) from build/chip_smoke/: its PNG against phase 4's
    in-process run of the script on 97 % of the pixels; ``python -m
    pine_tpu_torch.bench_prl`` (benchmark.pine in full, the batched tier's
    lanes on the card): 502498700, the
    batched tier taken; bench_prl.run_seq (``--seq``'s timing, in process):
    the sequential tier's wall against the eager interpreter's, the same
    output."""
    import numpy as np

    from pine_tpu_torch import scenes

    out = os.path.join(OUT_DIR, "storm.png")
    if os.path.exists(out):
        os.remove(out)
    with open(os.path.join(OUT_DIR, "storm.pine"), "w") as f:
        f.write(scenes.STORM_PRL)
    proc, wall, _ = run_module(["pine_tpu_torch", "storm.pine"], "the storm CLI run")
    lines = proc.stdout.strip().splitlines()
    got = read_png(out).astype(np.float32)
    ref = read_png(os.path.join(OUT_DIR, "chip_smoke_storm.png")).astype(np.float32)
    d = np.abs(got - ref)
    rec = dict(phase="cli", command="python -m pine_tpu_torch storm.pine", wall_s=wall,
               finished=lines[-1] if lines else "", mean=float(got.mean()),
               pixels_agree=float(((d <= 1e-3 * np.abs(ref)) | (d <= 1e-4)).all(-1).mean()))
    emit(rec)
    if not rec["finished"].startswith("Finished in") or got.shape != ref.shape or (
            rec["pixels_agree"] < STORM_CLI_ROWS) or not got.mean() > 0:
        fail(f"the storm CLI image is wrong: {rec}")
    proc, wall, objs = run_module(["pine_tpu_torch.bench_prl"], "python -m pine_tpu_torch.bench_prl")
    lines = proc.stdout.strip().splitlines()
    rec = dict(phase="bench_prl", command="python -m pine_tpu_torch.bench_prl",
               process_wall_s=wall, output=lines[0] if lines else "",
               result=objs[-1] if objs else None)
    emit(rec)
    if rec["output"] != "502498700" or not (rec["result"] or {}).get("tiers", {}).get("batch"):
        fail(f"bench_prl did not print 502498700 through the batched tier: {rec}")
    from pine_tpu_torch import bench_prl

    seq, eager, outs = bench_prl.run_seq()
    rec = dict(phase="bench_prl_seq", what="bench_prl.SEQ_PRL, best of 3 each", seq_wall_s=seq,
               eager_wall_s=eager, speedup=eager / seq, same_output=outs["seq"] == outs["eager"])
    emit(rec)
    if not rec["same_output"]:
        fail(f"the sequential tier's output differs from the eager interpreter's: {outs}")

# ---------------------------------------------------------------- guided ----

# the guided slice's paths: the bench box with the tree and with the grid at
# 640x640, BlueSampler(16) (iterations of 2, 4 and 10 spp), depth 4; the CSG
# fog box at 640x640, depth GUIDED_FOG_DEPTH (5, 3 since the last slice's
# paths came in), BlueSampler(GUIDED_FOG_SPP) (2 and 2: cut from 16 for the
# time); the cloud at 1920x1080, BlueSampler(4) (2 and 2), depth
# GUIDED_CLOUD_DEPTH (cut from 4 to 3, and to 2 since the last slice's
# paths came in, for the time).  The box with the
# tree is profiled over 4 samples (2 and 2: the first trains the guide),
# the others over a final iteration alone (GUIDED_PROFILE_SPP), for the time
GUIDED_SPP, GUIDED_FOG_SPP, GUIDED_CLOUD_SPP, GUIDED_CLOUD_DEPTH = 16, 4, 4, 2
GUIDED_FOG_DEPTH = 3
GUIDED_PROFILE_SPP = {"guided_cbox": 4, "guided_cbox_grid": 2, "guided_csg_fog": 2,
                      "guided_cloud": 1}
# phase 3's guided renders, card against CPU: 24x24 lockstep at 4 spp
# (iterations of 2 and 2; 32x32 at 8 cut for the CPU's time), the cloud's
# free-running render at 8 (2, 4 and 2: two trainings)
GUIDED_REDUCED = dict(size=24, spp=4, free_spp=8)
# their "grid" structure's cells a side (the default 32 at full width): its
# float64 sums cover the whole histogram, which the CPU side pays for
GUIDED_GRID_RES = 16
GUIDED_PRL = "GuidedPathIntegrator(BlueSampler(16), 4).render(scene);"


def guided_render(struct, last):
    """A main path's ``render_fn`` by render_guided with the structure
    ``struct``; the timed render (return_stats) leaves its stats and its
    peak device memory in ``last``."""
    def render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        import torch

        from pine_tpu_torch.integrators.guidedpath import render_guided

        if return_stats:
            torch.cuda.reset_peak_memory_stats()
        out = render_guided(cs, scene.camera, W, H, sampler, spp, depth, scene.get_aabb(),
                            struct=struct, return_stats=return_stats)
        if return_stats:
            last.update(out[1], peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        return out
    return render


def arenas_differ(a, b):
    """Per training iteration, the entries of each guide array (the
    collector and counts as the iteration left them, the refined arenas; or
    the histogram) that differ between two renders' ``arenas``."""
    return [{k: int((x[k] != y[k]).sum()) if x[k].shape == y[k].shape
             else f"shapes {x[k].shape} and {y[k].shape}" for k in x} for x, y in zip(a, b)]


def guided_parity():
    """Phase 3's guided renders, card against CPU (GUIDED_REDUCED: 24x24,
    BlueSampler(4), iterations of 2 and 2 spp): the reduced box (36
    cones, depth 4) with the tree and with the grid (GUIDED_GRID_RES cells a
    side), the CSG fog box, the 16^3 cloud and the emissive explosion (depth
    3, for the CPU's time).
    In lockstep: each iteration on both devices from the same guide, the
    CPU's (its tree refined on the host after the CPU's iteration, or its
    histogram), each iteration's image held by render_parity's rule
    (parity_record), beside the guide's entries that differ after it.
    Then, for the cloud, the whole render on each device at
    GUIDED_REDUCED["free_spp"], each training its own guide: its image,
    traced rays and trees beside the CPU's, held to the means rule (1 %)
    and finite.  The card's shading
    is not the CPU's bit for bit (a CUDA division by a host scalar
    multiplies by its reciprocal: the BSDFs' pdfs, the tracking's weight;
    the dense kernel's t against its plain version on the CPU on a few
    lanes a call), so a
    quadrant whose flux a differing lane moves across the 1 % split
    (guiding_tree.FLUX_SUBDIV) gives another tree, and every later sample
    differs (the cloud's shadow rays' ratio tracking is keyed by the bits of
    their origins)."""
    import numpy as np

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import guide_state
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators import guidedpath as G

    size, spp = GUIDED_REDUCED["size"], GUIDED_REDUCED["spp"]
    box = lambda: scenes.cbox((size, size), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0))  # noqa: E731
    devs = ("cuda", "cpu")
    for what, make, struct, depth, free_running in (
            ("reduced cbox", box, "tree", 4, False), ("reduced cbox", box, "grid", 4, False),
            ("CSG fog box", lambda: scenes.csg_fog(size), "tree", 3, False),
            ("reduced cloud, 16^3", lambda: scenes.cloud((size, size), 16), "tree", 3, True),
            ("reduced explosion, 16^3, emissive", lambda: scenes.explosion(size, 16), "tree", 3,
             False)):
        sc = make()
        cs = {d: sc.compile(d) for d in devs}
        setup = {d: G.new_guide(cs[d], sc.get_aabb(), size * size, struct, GUIDED_GRID_RES)
                 for d in devs}
        lanes = {d: G.film_lanes(size, size, cs[d].device) for d in devs}
        gt, state = setup["cpu"][0], setup["cpu"][2]
        state = gt.arrays() if gt is not None else {"hist": state["hist"].numpy()}
        for it in G.iterative_scheme(spp):
            out = {}
            for d in devs:
                I, _, gst, rays = G.run_iteration(
                    cs[d], sc.camera.params(cs[d].device), *lanes[d], size, size,
                    BlueSampler(spp), it, depth, setup[d][1], guide_state(state, d))
                out[d] = (I.cpu().numpy().reshape(size, size, 3), int(rays),
                          {k: gst[k].cpu().numpy() for k in ("dcoll", "scount", "hist")
                           if k in gst})
            (g, rg, ag), (c, rc, ac) = out["cuda"], out["cpu"]
            parity_record(f"guided {struct}, lockstep: {what}", g, c,
                          size=f"{size}x{size}, iteration {it['number']} ({it['spp']} spp), "
                               f"depth {depth}", rays_cuda=rg, rays_cpu=rc,
                          arenas_differ={k: int((ag[k] != ac[k]).sum()) for k in ac},
                          arena_nonzero={k: int((ac[k] != 0).sum()) for k in ac})
            if abs(rg - rc) > 0.005 * rc:
                fail(f"guided {what}: the card's traced rays are not the CPU's ({rg}, {rc})")
            if it["is_final"]:
                continue
            if gt is not None:
                gt.absorb(ac["dcoll"], ac["scount"])
                gt.refine(G.refine_threshold(size * size, it["spp"]))
                state = gt.arrays()
            else:
                state = {"hist": ac["hist"]}
        if not free_running:
            continue
        free, fspp = {}, GUIDED_REDUCED["free_spp"]
        for d in devs:
            img, st, _ = G._render_guided(cs[d], sc.camera, size, size, BlueSampler(fspp), fspp,
                                          depth, sc.get_aabb(), GUIDED_GRID_RES, struct,
                                          keep_arenas=True)
            free[d] = (img.cpu().numpy(), st)
        (g, gst), (c, cst) = free["cuda"], free["cpu"]
        d = np.abs(g - c)
        rec = dict(phase="guided_free_running", scene=what, struct=struct,
                   size=f"{size}x{size}x{fspp}spp depth {depth}",
                   pixels_agree=float(((d <= 1e-3 * np.abs(c)) | (d <= 1e-4)).all(-1).mean()),
                   mean_cuda=float(g.mean()), mean_cpu=float(c.mean()),
                   rays_cuda=gst["traced_rays"], rays_cpu=cst["traced_rays"],
                   arenas_differ=arenas_differ(gst["arenas"], cst["arenas"]),
                   tree_cuda=[(it.get("spatial_leaves"), it.get("quadtree_nodes"))
                              for it in gst["iterations"][:-1]],
                   tree_cpu=[(it.get("spatial_leaves"), it.get("quadtree_nodes"))
                             for it in cst["iterations"][:-1]])
        emit(rec)
        if not (np.isfinite(g).all() and g.mean() > 0
                and abs(g.mean() - c.mean()) <= 0.01 * abs(c.mean())):
            fail(f"the card's guided render is not the CPU's by the means rule: {rec}")


def phase_guided(dev_name, box):
    """The guided slice's main paths at full width (GuidedPathIntegrator
    through render_guided): the bench box from CBOX_PRL (``box``) with the
    tree and with the grid at 640x640, GUIDED_SPP, depth MAIN_DEPTH, the CSG
    fog box (CSG_FOG_PRL's scene) at 640x640, GUIDED_FOG_SPP, depth
    GUIDED_FOG_DEPTH, and the cloud (scenes.cloud: 1920x1080, 96^3) at
    GUIDED_CLOUD_SPP, depth GUIDED_CLOUD_DEPTH.
    Each as phase_main_path (the dense kernel held to dense_plain bit for
    bit on every launch of a 1-spp render; kernel-line entries
    ``dense_traverse.<tag>.*``), its profile over GUIDED_PROFILE_SPP[tag]
    samples;
    then a ``guided`` record of the timed render: each iteration's spp and
    seconds, the host ms of the readback, absorb, refinement, export and
    upload, the spatial leaves, quadtree nodes and depths after it, and the
    peak device memory.  -> kernel-line entries."""
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.integrators.guidedpath import iterative_scheme

    entries = []
    for tag, what, make, groups, struct, size, spp, depth in (
            ("guided_cbox", "bench cbox from CBOX_PRL, GuidedPathIntegrator, tree", lambda: box,
             BOX_GROUPS, "tree", MAIN_SIZE, GUIDED_SPP, MAIN_DEPTH),
            ("guided_cbox_grid", "bench cbox from CBOX_PRL, GuidedPathIntegrator, grid",
             lambda: box, BOX_GROUPS, "grid", MAIN_SIZE, GUIDED_SPP, MAIN_DEPTH),
            ("guided_csg_fog", "the CSG fog box from CSG_FOG_PRL, GuidedPathIntegrator, tree",
             lambda: scenes.csg_fog(FOG_SIZE), FOG_GROUPS, "tree", FOG_SIZE, GUIDED_FOG_SPP,
             GUIDED_FOG_DEPTH),
            ("guided_cloud", "bench_cloud's cloud (scenes.cloud, 96^3), GuidedPathIntegrator, "
             "tree", scenes.cloud, CLOUD_GROUPS, "tree", scenes.CLOUD_SIZE, GUIDED_CLOUD_SPP,
             GUIDED_CLOUD_DEPTH)):
        last = {}
        e, cs = phase_main_path(dev_name, tag, what, make(), groups, False, ["dense"], size, spp,
                                depth, label=tag, render_fn=guided_render(struct, last),
                                profile_spp=GUIDED_PROFILE_SPP[tag])
        entries += e
        its = last["iterations"]
        rec = dict(phase="guided", scene=tag, struct=struct, spp=spp, depth=depth,
                   seconds=last["seconds"], traced_rays=last["traced_rays"],
                   peak_memory_gb=last["peak_memory_gb"], iterations=its,
                   refine_host_ms=sum(it.get(f"{k}_ms", 0.0) for it in its
                                      for k in ("readback", "absorb", "refine", "export",
                                                "upload")))
        emit(rec)
        if [it["spp"] for it in its] != [x["spp"] for x in iterative_scheme(spp)] or (
                struct == "tree" and not all(it.get("quadtree_nodes") for it in its[:-1])):
            fail(f"the {tag} render's iterations are not the scheme's: {rec}")
        del cs
        torch.cuda.empty_cache()
    return entries


def phase_guided_cli():
    """``python -m pine_tpu_torch guided.pine`` from build/chip_smoke/: the
    benchmark box's script, GUIDED_PRL (GuidedPathIntegrator(BlueSampler(16),
    4), its render) and a save; its PNG against phase 4's in-process guided
    box (tree) on 97 % of the pixels."""
    import numpy as np

    from pine_tpu_torch import scenes

    out = os.path.join(OUT_DIR, "cli_guided.png")
    if os.path.exists(out):
        os.remove(out)
    with open(os.path.join(OUT_DIR, "guided.pine"), "w") as f:
        f.write(scenes.CBOX_PRL + GUIDED_PRL + f"\nscene.camera.film().save('{out}');\n")
    proc, wall, _ = run_module(["pine_tpu_torch", "guided.pine"], "the guided CLI run")
    lines = proc.stdout.strip().splitlines()
    got = read_png(out).astype(np.float32)
    ref = read_png(os.path.join(OUT_DIR, "chip_smoke_guided_cbox.png")).astype(np.float32)
    d = np.abs(got - ref)
    rec = dict(phase="cli", command="python -m pine_tpu_torch guided.pine", wall_s=wall,
               finished=lines[-1] if lines else "", mean=float(got.mean()),
               pixels_agree=float(((d <= 1e-3 * np.abs(ref)) | (d <= 1e-4)).all(-1).mean()))
    emit(rec)
    if not rec["finished"].startswith("Finished in") or got.shape != ref.shape or (
            rec["pixels_agree"] < 0.97) or not got.mean() > 0:
        fail(f"the guided CLI image differs from the in-process render: {rec}")


# the last slice's paths at full width: MLT on the bench box at 1 spp on
# average (100 mutation steps of 4,096 chains after 24 bootstrap rounds, a
# user's 16 spp being 16 times the steps), depth 4; ReSTIR on the box and
# the CSG fog box, BlueSampler(16) (its depth is kept and not used: direct
# light only); MicroRenderGI on the classic-style scene, 720x360, 2,048
# surfels, as classic.pine renders it
MLT_SPP, MLT_DEPTH, MLT_CHAINS = 1, 4, 4096
RESTIR_SPP, RESTIR_DEPTH = 16, 2
MICRO_SIZE, MICRO_POINTS = (720, 360), 2048
CLASSIC_GROUPS = [("dense", 0, 3), ("dense", 1, 1), ("dense", 2, 1)]
# phase 3's: ReSTIR at 32x32 and 4 spp (16 cut for the time), MicroRenderGI
# at 64x32 with 512 surfels, MLT on the reduced box with 1,024 chains (its
# lockstep step; its whole render at 32x32, 4 spp on average, depth 4)
LAST_REDUCED = dict(size=32, restir_spp=4, micro_size=(64, 32), micro_points=512, chains=1024,
                    mlt_spp=4, mlt_depth=4)


def last_slice_parity():
    """Phase 3's renders of the last slice (MLT, ReSTIR, MicroRenderGI),
    card against CPU (LAST_REDUCED): ReSTIR on the reduced box (36 cones),
    the CSG fog box and the 16^3 cloud (the grid media's terms of the camera
    segment), and MicroRenderGI on the classic-style scene, each by
    render_parity's rule with the traced rays to 0.5 %.  MLT on the reduced
    box in lockstep: one mutation step from the CPU's starting chains on both
    devices, the mutated samples bit for bit, the proposals' radiance lane
    by lane by the rule (a chain a pixel), the acceptances counted; then the
    whole render on each device, held to the means (1 %), with the
    chain-steps whose acceptance the card decided otherwise counted (a
    chain whose radiance differs in the last bit can decide u < a the other
    way, and from then on the two chains differ)."""
    import numpy as np
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.core import rng
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators import mlt as PM
    from pine_tpu_torch.integrators.micro_render import render_micro
    from pine_tpu_torch.integrators.restir import render_restir

    r = LAST_REDUCED
    size, devs = r["size"], ("cuda", "cpu")
    box = lambda: scenes.cbox((size, size), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0))  # noqa: E731

    def held(what, out, **extra):
        (g, rg), (c, rc) = out["cuda"], out["cpu"]
        parity_record(what, g, c, rays_cuda=rg, rays_cpu=rc, **extra)
        if abs(rg - rc) > 0.005 * rc:
            fail(f"{what}: the card's traced rays are not the CPU's ({rg}, {rc})")

    for what, make in (("reduced cbox", box), ("CSG fog box", lambda: scenes.csg_fog(size)),
                       ("reduced cloud, 16^3", lambda: scenes.cloud((size, size), 16))):
        sc, out = make(), {}
        for d in devs:
            img, st = render_restir(sc.compile(d), sc.camera, size, size,
                                    BlueSampler(r["restir_spp"]), r["restir_spp"],
                                    return_stats=True)
            out[d] = (img.cpu().numpy(), st["traced_rays"])
        held(f"ReSTIR: {what}", out, size=f"{size}x{size}x{r['restir_spp']}spp")
    (W, H), pts = r["micro_size"], r["micro_points"]
    sc, out = scenes.classic_micro((W, H)), {}
    for d in devs:
        img, st = render_micro(sc.compile(d), sc, sc.camera, W, H, pts, return_stats=True)
        out[d] = (img.cpu().numpy(), st["traced_rays"])
    held("MicroRenderGI: classic-style scene", out, size=f"{W}x{H}, {pts} surfels")

    sc, C, depth = box(), r["chains"], r["mlt_depth"]
    cs = {d: sc.compile(d) for d in devs}
    D = PM.sample_dims(cs["cpu"], depth)
    ids = torch.arange(C)
    X = rng.uniform(ids[:, None], torch.arange(D)[None, :], 0xC0FFEE, 57)  # render_mlt's start
    Lp, _, _ = PM.mlt_radiance(cs["cpu"], sc.camera.params(torch.device("cpu")), X, depth)
    step = {}
    for d in devs:
        dev = torch.device(d)
        cp = sc.camera.params(dev)
        Xn, _ = PM.mutate(X.to(dev), ids.to(dev), 0)
        Ln, _, rays = PM.mlt_radiance(cs[d], cp, Xn, depth)
        acc = PM.mlt_step(cs[d], cp, X.to(dev), Lp.to(dev), ids.to(dev), 0, size, size, depth)[4]
        step[d] = (Xn.cpu().numpy(), Ln.cpu().numpy(), acc.cpu().numpy(), int(rays))
    (xg, lg, ag, rg), (xc, lc, ac, rc) = step["cuda"], step["cpu"]
    parity_record("MLT lockstep: one mutation step from the CPU's chains, reduced cbox", lg, lc,
                  size=f"{C} chains, depth {depth}", samples_bits_equal=bool(np.array_equal(xg, xc)),
                  accept_differ=int((ag != ac).sum()), rays_cuda=rg, rays_cpu=rc)
    if not np.array_equal(xg, xc) or abs(rg - rc) > 0.005 * rc:
        fail("MLT lockstep: the card's mutation or traced rays are not the CPU's")
    free = {}
    for d in devs:
        img, st = PM.render_mlt(cs[d], sc.camera, size, size, r["mlt_spp"], depth, C,
                                return_stats=True)
        free[d] = (img.cpu().numpy(), st)
    (g, gst), (c, cst) = free["cuda"], free["cpu"]
    a_g, a_c = gst["accepted"].cpu().numpy(), cst["accepted"].cpu().numpy()
    d = np.abs(g - c)
    rec = dict(phase="mlt_free_running", scene="reduced cbox",
               size=f"{size}x{size}, {r['mlt_spp']} spp on average, {C} chains, depth {depth}",
               steps=gst["steps"], boot_rounds=gst["boot_rounds"],
               pixels_agree=float(((d <= 1e-3 * np.abs(c)) | (d <= 1e-4)).all(-1).mean()),
               mean_cuda=float(g.mean()), mean_cpu=float(c.mean()),
               chain_steps_accept_differ=int((a_g != a_c).sum()), chain_steps=int(a_c.size),
               chains_diverged=int((a_g != a_c).any(0).sum()),
               rays_cuda=gst["traced_rays"], rays_cpu=cst["traced_rays"])
    emit(rec)
    if not (np.isfinite(g).all() and g.mean() > 0
            and abs(g.mean() - c.mean()) <= 0.01 * abs(c.mean())):
        fail(f"the card's MLT render is not the CPU's by the means rule: {rec}")


def last_slice_render(kind, last, points=MICRO_POINTS):
    """A main path's ``render_fn`` (path_render's arguments) by render_mlt
    ("mlt": ``spp`` on average), render_restir ("restir") or render_micro
    ("micro": ``points`` surfels); the timed render (return_stats) leaves its
    stats and its peak device memory in ``last``."""
    def render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        import torch

        from pine_tpu_torch.integrators.micro_render import render_micro
        from pine_tpu_torch.integrators.mlt import render_mlt
        from pine_tpu_torch.integrators.restir import render_restir

        if return_stats:
            torch.cuda.reset_peak_memory_stats()
        if kind == "mlt":
            out = render_mlt(cs, scene.camera, W, H, spp, depth, MLT_CHAINS,
                             return_stats=return_stats)
        elif kind == "restir":
            out = render_restir(cs, scene.camera, W, H, sampler, spp, return_stats=return_stats)
        else:
            out = render_micro(cs, scene, scene.camera, W, H, points, return_stats=return_stats)
        if return_stats:
            torch.cuda.synchronize()
            last.update(out[1], peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        return out
    return render


def mlt_chains(cs, scene):
    """(A function that steps render_mlt's chains on the full-width box,
    MLT_CHAINS of them from their start, one step a call, and the chains'
    state: X, L and the steps taken)."""
    import torch

    from pine_tpu_torch.core import rng
    from pine_tpu_torch.integrators import mlt as PM

    dev = cs.device
    cp = scene.camera.params(dev)
    ids = torch.arange(MLT_CHAINS, device=dev)
    D = PM.sample_dims(cs, MLT_DEPTH)
    X = rng.uniform(ids[:, None], torch.arange(D, device=dev)[None, :], 0xC0FFEE, 57)
    state = {"X": X, "L": PM.mlt_radiance(cs, cp, X, MLT_DEPTH)[0], "steps": 0}
    W, H = scene.camera.film.width, scene.camera.film.height

    def step():
        state["X"], state["L"] = PM.mlt_step(cs, cp, state["X"], state["L"], ids,
                                             state["steps"], W, H, MLT_DEPTH)[:2]
        state["steps"] += 1

    return step, state


def mlt_record(cs, scene):
    """phase_main_path's ``record`` for MLT: the chains' start and their first
    MLT_RECORD_STEPS steps (the full render's 125 chain evaluations would
    take the kernel line's count of every launch past two minutes)."""
    def run():
        step, _ = mlt_chains(cs, scene)
        for _ in range(MLT_RECORD_STEPS):
            step()
    return run, f"the MLT chains' start and first {MLT_RECORD_STEPS} steps"


def mlt_step_profile(cs, scene):
    """Profile one mutation step of MLT_CHAINS chains on the full-width box
    (profile_render: its launches, the device's busy share) and time
    MLT_STEP_REPS steps by the host's clock to a device synchronize."""
    import torch

    step, _ = mlt_chains(cs, scene)
    profile_render("mlt_cbox, one mutation step", step, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MLT_STEP_REPS):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / MLT_STEP_REPS


MLT_STEP_REPS = MLT_RECORD_STEPS = 10


def phase_last_slice(dev_name, box):
    """The last slice's main paths at full width: MltIntegrator(MLT_SPP,
    MLT_DEPTH) on the bench box from CBOX_PRL (``box``), 640x640;
    RestirIntegrator(BlueSampler(RESTIR_SPP), RESTIR_DEPTH) on the box and on
    the CSG fog box (CSG_FOG_PRL's scene), 640x640; MicroRenderGI
    (MICRO_POINTS) on the classic-style scene (scenes.CLASSIC_MICRO_PRL),
    720x360.  Each as phase_main_path (the dense kernel held to dense_plain
    bit for bit on every launch of its recording run: MLT's chains' start
    and first MLT_RECORD_STEPS steps, ReSTIR's 1-spp render, MicroRenderGI's
    render; kernel-line entries ``dense_traverse.<tag>.*``), profiled over
    one render (ReSTIR's of 2 spp; MLT over one step, with MLT_STEP_REPS
    steps timed); then a
    ``last_slice`` record: the peak device memory, and for MLT its steps,
    bootstrap rounds, seconds a step and the bootstrap's, chains' and
    direct pass's seconds.  -> kernel-line entries."""
    import torch

    from pine_tpu_torch import scenes

    entries = []
    for tag, what, make, groups, size, spp, depth, kind in (
            ("mlt_cbox", f"bench cbox from CBOX_PRL, MltIntegrator({MLT_SPP}, {MLT_DEPTH})",
             lambda: box, BOX_GROUPS, MAIN_SIZE, MLT_SPP, MLT_DEPTH, "mlt"),
            ("restir_cbox", f"bench cbox from CBOX_PRL, RestirIntegrator(BlueSampler("
             f"{RESTIR_SPP}), {RESTIR_DEPTH})", lambda: box, BOX_GROUPS, MAIN_SIZE, RESTIR_SPP,
             RESTIR_DEPTH, "restir"),
            ("restir_csg_fog", "the CSG fog box from CSG_FOG_PRL, RestirIntegrator(BlueSampler("
             f"{RESTIR_SPP}), {RESTIR_DEPTH})", lambda: scenes.csg_fog(FOG_SIZE), FOG_GROUPS,
             FOG_SIZE, RESTIR_SPP, RESTIR_DEPTH, "restir"),
            ("micro_classic", f"the classic-style scene from CLASSIC_MICRO_PRL, MicroRenderGI("
             f"{MICRO_POINTS})", lambda: scenes.classic_micro(MICRO_SIZE), CLASSIC_GROUPS,
             MICRO_SIZE, 1, 1, "micro")):
        last = {}
        scene = make()
        e, cs = phase_main_path(dev_name, tag, what, scene, groups, False, ["dense"], size, spp,
                                depth, label=tag, render_fn=last_slice_render(kind, last),
                                profile_spp={"mlt": None, "restir": 2, "micro": 1}[kind],
                                record=mlt_record if kind == "mlt" else None)
        entries += e
        rec = dict(phase="last_slice", scene=tag, peak_memory_gb=last["peak_memory_gb"],
                   traced_rays=last["traced_rays"])
        if kind == "mlt":
            rec.update(steps=last["steps"], boot_rounds=last["boot_rounds"],
                       seconds=last["seconds"],
                       chains_s_per_step=last["seconds"]["chains"] / last["steps"],
                       s_per_step_alone=mlt_step_profile(cs, scene))
            if last["steps"] != MAIN_SIZE * MAIN_SIZE * MLT_SPP // MLT_CHAINS:
                fail(f"the MLT render took {last['steps']} steps")
        emit(rec)
        del cs
        torch.cuda.empty_cache()
    return entries


def phase_last_slice_cli():
    """``python -m pine_tpu_torch classic_micro.pine`` from build/chip_smoke/:
    CLASSIC_MICRO_PRL as written but for its save's path; its PNG against
    phase 4's in-process render on 97 % of the pixels."""
    import numpy as np

    from pine_tpu_torch import scenes

    out = os.path.join(OUT_DIR, "cli_classic_micro.png")
    if os.path.exists(out):
        os.remove(out)
    src = scenes.CLASSIC_MICRO_PRL.replace('"classic_micro.png"', repr(out))
    with open(os.path.join(OUT_DIR, "classic_micro.pine"), "w") as f:
        f.write(src)
    proc, wall, _ = run_module(["pine_tpu_torch", "classic_micro.pine"], "the MicroRenderGI CLI run")
    lines = proc.stdout.strip().splitlines()
    got = read_png(out).astype(np.float32)
    ref = read_png(os.path.join(OUT_DIR, "chip_smoke_micro_classic.png")).astype(np.float32)
    d = np.abs(got - ref)
    rec = dict(phase="cli", command="python -m pine_tpu_torch classic_micro.pine", wall_s=wall,
               finished=lines[-1] if lines else "", mean=float(got.mean()),
               pixels_agree=float(((d <= 1e-3 * np.abs(ref)) | (d <= 1e-4)).all(-1).mean()))
    emit(rec)
    if not rec["finished"].startswith("Finished in") or got.shape != ref.shape or (
            rec["pixels_agree"] < 0.97) or not got.mean() > 0:
        fail(f"the MicroRenderGI CLI image differs from the in-process render: {rec}")


# the modules slice (progressive, interactive, multi-GPU, the sort's
# direction bins): the box's snapshots every PROGRESSIVE_EVERY of its 16
# samples; the fly-cam session's keys (moves, a turn, ] up to 8 spp, a
# screenshot, quit) and its reduced card-against-CPU session's film edge;
# the terrain's octahedral bins against the octants
PROGRESSIVE_EVERY = 4
INTERACTIVE_KEYS = "wwadj]]]pq"
INTERACTIVE_REDUCED = 64
SORT_DIRBITS = 6
SHARD_ATOL = 2e-4  # tests/test_distributed.py's, where the sample sums' order differs
# phase 5's CLIs that run beside phase 3, at most this many at once (the
# bench, bench_prl and the lab modules, whose numbers are times, run alone)
CLI_WORKERS = 2
STATUS_RE = r"spp=(\d+)\s+([\d.]+) ms/frame"


@contextlib.contextmanager
def counted_wavefronts(rec):
    """Within it, integrators.path.render_wavefront (as progressive and
    interactive renders call it) returns its image as before, its traced
    rays summed into ``rec["traced_rays"]`` and the time each call ended,
    after a device synchronize, appended to ``rec["ends"]``."""
    import torch

    from pine_tpu_torch.integrators import path as PP

    real = PP.render_wavefront
    rec.setdefault("traced_rays", 0)
    rec.setdefault("ends", [])

    def counted(*a, **kw):
        img, st = real(*a, return_stats=True, **kw)
        torch.cuda.synchronize()
        rec["traced_rays"] += st["traced_rays"]
        rec["ends"].append(time.perf_counter())
        return img

    PP.render_wavefront = counted
    try:
        yield rec
    finally:
        PP.render_wavefront = real


def progressive_render(last):
    """A main path's ``render_fn``: integrators.path.render_progressive of
    the sampler's spp in batches of PROGRESSIVE_EVERY into
    build/chip_smoke/progressive/; the timed render leaves its start, the
    batches' ends and its traced rays in ``last``."""
    def render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        import shutil

        from pine_tpu_torch.integrators.path import render_progressive

        out_dir = os.path.join(OUT_DIR, "progressive")
        shutil.rmtree(out_dir, ignore_errors=True)
        rec = {"t0": time.perf_counter()}
        with counted_wavefronts(rec):
            film = render_progressive(cs, scene.camera, type(sampler)(spp), depth,
                                      PROGRESSIVE_EVERY, out_dir)
        if return_stats:
            last.update(rec, files=sorted(os.listdir(out_dir)))
            return film.rgb, {"traced_rays": rec["traced_rays"]}
        return film.rgb
    return render


def fly_session(cs, scene, depth, keys, out_dir, sampler=None):
    """interactive.run_loop on ``cs`` with PINE_INTERACTIVE_KEYS ``keys``,
    frames into ``out_dir``, the scene's camera put back after -> (the last
    frame, frames, traced rays, [(spp, frame ms)] read from the status
    lines)."""
    import io
    import re
    import shutil

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import PathIntegrator
    from pine_tpu_torch.interactive import run_loop

    cam = scene.camera
    pos, c2w = cam.position.copy(), cam.c2w.copy()
    shutil.rmtree(out_dir, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in ("PINE_INTERACTIVE_KEYS", "PINE_TERM_PREVIEW")}
    os.environ.update(PINE_INTERACTIVE_KEYS=keys, PINE_TERM_PREVIEW="0")
    rec, buf = {}, io.StringIO()
    try:
        with counted_wavefronts(rec), contextlib.redirect_stdout(buf):
            frames = run_loop(PathIntegrator(sampler or BlueSampler(MAIN_SPP), depth), scene, cs,
                              out_dir)
        img = cam.film.rgb
    finally:
        cam.position, cam.c2w = pos, c2w
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    status = [(int(a), float(b)) for a, b in re.findall(STATUS_RE, buf.getvalue())]
    return img, frames, rec["traced_rays"], status


def interactive_render(last):
    """A main path's ``render_fn``: the fly-cam session of INTERACTIVE_KEYS
    into build/chip_smoke/interactive/ (``spp`` unused: the session's frames
    run at 1 to 8); the timed session leaves its frames, screenshot and
    status in ``last``."""
    def render(cs, scene, W, H, sampler, spp, depth, return_stats=False):
        out_dir = os.path.join(OUT_DIR, "interactive")
        img, frames, rays, status = fly_session(cs, scene, depth, INTERACTIVE_KEYS, out_dir)
        if return_stats:
            last.update(frames=frames, status=status, files=sorted(os.listdir(out_dir)),
                        shot=read_png(os.path.join(out_dir, "shot_001.png")))
            return img, {"traced_rays": rays}
        return img
    return render


def one_frame_record(cs, scene):
    """phase_main_path's ``record`` for the fly-cam: one frame (keys "q")."""
    def run():
        fly_session(cs, scene, MAIN_DEPTH, "q", os.path.join(OUT_DIR, "interactive_record"))
    return run, "one frame of the fly-cam loop (1 spp)"


def modules_parity():
    """Phase 3's checks of the modules slice, card against CPU: the fly-cam
    session of INTERACTIVE_KEYS on the reduced box (36 cones) at
    INTERACTIVE_REDUCED^2, its last frames (8 spp at the moved camera) by
    the render rule, the frames and status spp equal; the reduced terrain
    (grid 40) at 64x64x4 spp with the octant sort forced and SORT_DIRBITS
    direction bins on the card."""
    from pine_tpu_torch import scenes

    size, out = INTERACTIVE_REDUCED, {}
    for d in ("cuda", "cpu"):
        sc = scenes.cbox((size, size), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0))
        img, frames, rays, status = fly_session(
            sc.compile(d), sc, MAIN_DEPTH, INTERACTIVE_KEYS,
            os.path.join(OUT_DIR, f"interactive_reduced_{d}"))
        out[d] = (img.cpu().numpy(), frames, rays, [spp for spp, _ in status])
    (g, fg, rg, sg), (c, fc, rc, sc_) = out["cuda"], out["cpu"]
    parity_record(f"reduced cbox, fly-cam session {INTERACTIVE_KEYS!r}, last frame", g, c,
                  size=f"{size}x{size}", frames=[fg, fc], status_spp=sg, rays_cuda=rg,
                  rays_cpu=rc)
    if fg != fc or sg != sc_ or sg[-1] != 8 or abs(rg - rc) > 0.005 * rc:
        fail(f"the fly-cam sessions differ: frames {fg} / {fc}, spp {sg} / {sc_}, rays {rg} / {rc}")

    def terrain_bins():
        sc = scenes.terrain((64, 64), 40)
        sc.compile("cuda").sort_dirbits = SORT_DIRBITS
        return sc

    render_parity(f"reduced terrain, grid 40, sort_dirbits {SORT_DIRBITS}", terrain_bins,
                  "octant")


def phase_progressive_interactive(dev_name, box):
    """The modules slice's in-process main paths on the bench box from
    CBOX_PRL (640x640, BlueSampler(16), depth 4): ``--progressive``'s render
    (integrators.path.render_progressive, batches of PROGRESSIVE_EVERY) and
    the fly-cam session of INTERACTIVE_KEYS (interactive.run_loop), each as
    phase_main_path (the dense kernel bit for bit its plain version on every
    launch of a 1-spp progressive render and of one fly-cam frame; launches
    counted over the timed progressive render and the whole session).  The
    progressive render: its four snapshots, latest.png and index.html, its
    film against phase 4's one-shot render of the box to rtol/atol 1e-4,
    the seconds of each batch (a snapshot's save included) and its wall
    against a one-shot render's timed beside it.  The session: its frames,
    the frame ms at each spp from its status lines, its screenshot's PNG.
    -> kernel-line entries."""
    import numpy as np
    import torch

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    last = {}
    entries, cs = phase_main_path(
        dev_name, "progressive_cbox", f"bench cbox from CBOX_PRL, --progressive {PROGRESSIVE_EVERY}",
        box, BOX_GROUPS, False, ["dense"], label="progressive_cbox",
        render_fn=progressive_render(last), profile_spp=None)
    snaps = [f"snap_{k:05d}spp.png" for k in range(PROGRESSIVE_EVERY, MAIN_SPP + 1,
                                                   PROGRESSIVE_EVERY)]
    img = MAIN_IMAGES["progressive_cbox"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_wavefront(cs, box.camera, MAIN_SIZE, MAIN_SIZE, BlueSampler(MAIN_SPP), MAIN_SPP,
                     MAIN_DEPTH)
    torch.cuda.synchronize()
    one_shot = time.perf_counter() - t0
    ends = [last["t0"]] + last["ends"]
    batches = [b - a for a, b in zip(ends, ends[1:])]
    wall = ends[-1] - ends[0]
    rec = dict(phase="progressive", scene="bench cbox", every=PROGRESSIVE_EVERY, device=dev_name,
               files=last["files"], batch_s=batches, wall_s=wall, one_shot_wall_s=one_shot,
               overhead_s_per_snapshot=(wall - one_shot) / len(snaps),
               max_abs_vs_one_shot=float(np.abs(img - MAIN_IMAGES["cbox"]).max()))
    emit(rec)
    if last["files"] != ["index.html", "latest.png"] + snaps or not np.allclose(
            img, MAIN_IMAGES["cbox"], rtol=1e-4, atol=1e-4):
        fail(f"the progressive render's files or final film are not the one-shot's: {rec}")

    last = {}
    entries += phase_main_path(
        dev_name, "interactive_cbox", f"bench cbox from CBOX_PRL, fly-cam keys {INTERACTIVE_KEYS!r}",
        box, BOX_GROUPS, False, ["dense"], label="interactive_cbox",
        render_fn=interactive_render(last), profile_spp=None, record=one_frame_record)[0]
    shot = last["shot"]
    rec = dict(phase="interactive", scene="bench cbox", keys=INTERACTIVE_KEYS, device=dev_name,
               frames=last["frames"], frame_ms=last["status"], files=last["files"],
               screenshot_mean=float(shot.mean()))
    emit(rec)
    if (last["frames"] != 9 or [spp for spp, _ in last["status"]] != [1] * 6 + [2, 4, 8]
            or last["files"] != ["index.html", "latest.png", "shot_001.png"]
            or shot.shape != (MAIN_SIZE, MAIN_SIZE, 3) or not shot.mean() > 0):
        fail(f"the fly-cam session is not the keys': {rec}")
    return entries


def shard_renders(mode, rank, world, port, out, box, cs):
    """One rank's part of phase_shards: join a group of ``world`` under
    "nccl" (mode "nccl") or "gloo" over CUDA tensors, then for each of the
    sample- and tile-sharded renders of the bench box (640x640,
    BlueSampler(16), depth 4): the launch counts zeroed just before one
    render and read just after, its wall to a device synchronize, its traced
    rays; the film's all_reduce alone (mean of 10, host clock to a
    synchronize); with world 1, render_wavefront of the same scene; rank 0
    the kernel-line entries of a ``world``-spp render of each.  Writes
    ``out``.json (the records) and ``out``.npz (the films)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront
    from pine_tpu_torch.parallel import distributed as D

    D.make_process_group(mode, rank, world, f"tcp://localhost:{port}")
    try:
        W = H = MAIN_SIZE
        films, recs, entries = {}, {}, []
        if world == 1:
            films["single"] = render_wavefront(cs, box.camera, W, H, BlueSampler(MAIN_SPP),
                                               MAIN_SPP, MAIN_DEPTH).cpu().numpy()
        for kind, fn in (("sample", D.render_sample_sharded), ("tile", D.render_tile_sharded)):
            sharded = lambda spp: fn(cs, box.camera, W, H, BlueSampler(spp), spp,  # noqa: E731
                                     MAIN_DEPTH, return_stats=True)
            recorded, _ = record_launches(cs, ["dense"], lambda: sharded(world))
            torch.cuda.synchronize()
            DT.reset_launches()
            t0 = time.perf_counter()
            img, st = sharded(MAIN_SPP)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(DT.LAUNCHES)
            films[kind] = img.cpu().numpy()
            recs[kind] = dict(wall_s=wall, traced_rays=st["traced_rays"],
                              dense_launches=[launches["dense.closest"],
                                              launches["dense.any_hit"]])
            if rank == 0:
                tag = f"{kind}_sharded_{mode}{world}"
                entries += [kernel_line_entry("dense", form, recorded[("dense", any_hit)],
                                              launches[f"dense.{form}"], label=tag,
                                              over=f"one {world}-spp {kind}-sharded render")
                            for form, any_hit in (("closest", False), ("any_hit", True))]
        film = torch.ones(W * H, 3, device=cs.device)
        dist.all_reduce(film)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            dist.all_reduce(film)
        torch.cuda.synchronize()
        allreduce_ms = (time.perf_counter() - t0) * 100
        with open(out + ".json", "w") as f:
            json.dump(dict(rank=rank, recs=recs, allreduce_ms=allreduce_ms, entries=entries), f)
        np.savez(out + ".npz", **films)
    finally:
        dist.destroy_process_group()


def shard_worker(rank, ports, outs):
    """One process of phase_shards (run as ``python -c``): compile the bench
    box from CBOX_PRL on the card; process 0 first renders in a world-size-1
    "nccl" group (``ports[0]``, ``outs[0]``), then both join the two-rank
    "gloo" group (``ports[1]``, ``outs[1 + rank]``)."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    box = scenes.prl_scene(scenes.CBOX_PRL, "<bench:cbox>")
    cs = box.compile()
    render_wavefront(cs, box.camera, MAIN_SIZE, MAIN_SIZE, BlueSampler(1), 1, MAIN_DEPTH)  # warm-up
    if rank == 0:
        shard_renders("nccl", 0, 1, ports[0], outs[0], box, cs)
    shard_renders("gloo", rank, 2, ports[1], outs[1 + rank], box, cs)


def phase_shards(dev_name):
    """The multi-GPU paths on the one card, the bench box at 640x640,
    BlueSampler(16), depth 4, two processes (``shard_worker``): a
    world-size-1 "nccl" group in the first, its sample- and tile-sharded
    films bit for bit render_wavefront's; then both processes as two ranks
    on the card under "gloo" over CUDA tensors (NCCL refuses two ranks on
    one device), their tile-sharded film bit for bit the world-size-1 one,
    their sample-sharded film to SHARD_ATOL (the sums' order differs).  Each
    render's launches counted in its process and its dense launches held to
    dense_plain bit for bit; Mray/s (every rank's traced rays over the
    slowest rank's wall) and the film's all_reduce ms.  -> kernel-line
    entries."""
    import numpy as np

    from pine_tpu_torch.parallel.distributed import free_port

    ports = [free_port(), free_port()]
    outs = [os.path.join(OUT_DIR, name) for name in ("shard_nccl1_rank0", "shard_gloo2_rank0",
                                                     "shard_gloo2_rank1")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as C; C.shard_worker({r}, {ports}, {outs})"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    command_s = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            fail(f"a shard worker failed: {log[-3000:]}")
    recs = []
    for o in outs:
        with open(o + ".json") as f:
            recs.append(json.load(f))
    films1, films2 = (dict(np.load(o + ".npz")) for o in outs[:2])
    for kind in ("sample", "tile"):
        if not np.array_equal(films1[kind], films1["single"]):
            fail(f"the world-size-1 nccl {kind}-sharded film is not render_wavefront's")
    entries = []
    for ranks, films, mode in ((recs[:1], films1, "nccl"), (recs[1:], films2, "gloo")):
        entries += ranks[0]["entries"]
        for kind in ("sample", "tile"):
            d = float(np.abs(films[kind] - films1["single"]).max())
            wall = max(r["recs"][kind]["wall_s"] for r in ranks)
            rays = sum(r["recs"][kind]["traced_rays"] for r in ranks)
            rec = dict(phase="sharded", scene="bench cbox", mode=f"{kind}-sharded", backend=mode,
                       ranks=len(ranks), device=dev_name, size=f"{MAIN_SIZE}x{MAIN_SIZE}",
                       spp=MAIN_SPP, depth=MAIN_DEPTH, wall_s=wall, traced_rays=rays,
                       mrays_per_s=rays / wall / 1e6,
                       dense_launches=[r["recs"][kind]["dense_launches"] for r in ranks],
                       allreduce_ms=[r["allreduce_ms"] for r in ranks], command_s=command_s,
                       max_abs_vs_single=d,
                       bits_equal=bool(np.array_equal(films[kind], films1["single"])),
                       finite=bool(np.isfinite(films[kind]).all()))
            emit(rec)
            exact = kind == "tile" or len(ranks) == 1
            if not (rec["finite"] and (rec["bits_equal"] if exact else d <= SHARD_ATOL)
                    and all(min(n) > 0 for n in rec["dense_launches"])):
                fail(f"the {mode} {kind}-sharded render is not the single process's: {rec}")
    return entries


def phase_sort_bins(dev_name):
    """The coherence sort's octahedral direction bins on the terrain
    (99,458 triangles, 640x640, BlueSampler(16), VARIANT_DEPTH): a main path
    with ``sort_dirbits`` SORT_DIRBITS (its kernel-line entries, profile and
    coherence_sort record), its image bit for bit phase 4's terrain (the
    octants, the default); then in turns 3, SORT_DIRBITS, SORT_DIRBITS, 3:
    the sorts' device ms and the grid kernel's ms on each launch of a 1-spp
    render as it ran, and a 16-spp render's wall.  Not gated on speed.
    -> kernel-line entries."""
    import numpy as np
    import torch

    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    terrain = scenes.terrain((MAIN_SIZE, MAIN_SIZE))
    terrain.compile().sort_dirbits = SORT_DIRBITS  # the cached scene phase_main_path renders
    entries, cs = phase_main_path(
        dev_name, "terrain_dirbits", f"bench_mesh terrain, 99,458 triangles + 1 rect, "
        f"sort_dirbits {SORT_DIRBITS}", terrain, [("dense", 1, 1), ("grid", 6, 99458)], True,
        ["grid"], depth=VARIANT_DEPTH, label="terrain_dirbits", also=["dense"])
    same = bool(np.array_equal(MAIN_IMAGES["terrain_dirbits"], MAIN_IMAGES["terrain"]))
    turns = []
    for bits in (3, SORT_DIRBITS, SORT_DIRBITS, 3):
        cs.sort_dirbits = bits
        render = lambda spp: render_wavefront(cs, terrain.camera, MAIN_SIZE, MAIN_SIZE,  # noqa
                                              BlueSampler(spp), spp, VARIANT_DEPTH)
        recorded, sorts = record_launches(cs, ["grid"], lambda: render(1))
        sort_ms = sum(cuda_ms(lambda: cs.sort_perm(*s), 10) for s in sorts)
        grid_ms = [cuda_ms(lambda: launch("grid", g, args, any_hit), 10)
                   for (_, any_hit), calls in sorted(recorded.items()) for g, args, _ in calls]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(MAIN_SPP)
        torch.cuda.synchronize()
        turns.append(dict(dirbits=bits, sorts=len(sorts), sort_ms=sort_ms,
                          grid_ms_per_launch=sum(grid_ms) / len(grid_ms),
                          grid_ms_each=grid_ms, wall_s=time.perf_counter() - t0))
    cs.sort_dirbits = 3
    emit(dict(phase="sort_bins_ab", scene="bench_mesh terrain", device=dev_name,
              depth=VARIANT_DEPTH, image_bits_equal_to_octants=same, turns=turns))
    if not same:
        fail(f"the terrain with sort_dirbits {SORT_DIRBITS} is not the octant-sorted image")
    return entries


def phase_modules_cli(one_shot_wall):
    """The CLI's flags of the modules slice on the card, from
    build/chip_smoke/: the box's script (phase_cli's) with ``--progressive
    PROGRESSIVE_EVERY --progressive-dir``: its four snapshots, latest.png and
    index.html, its final PNG equal to the last snapshot's and to phase_cli's
    one-shot PNG by the render rule, the seconds between snapshots (their
    files' times) and its wall against the one-shot CLI's; then with
    ``--interactive`` in a directory of its own and PINE_INTERACTIVE_KEYS
    INTERACTIVE_KEYS: the frame ms at each spp from its status lines, its
    screenshot's PNG."""
    import re
    import shutil

    import numpy as np

    from pine_tpu_torch import scenes

    snap_dir = os.path.join(OUT_DIR, "progressive_cli")
    out = os.path.join(OUT_DIR, "cli_cbox_progressive.png")
    shutil.rmtree(snap_dir, ignore_errors=True)
    if os.path.exists(out):
        os.remove(out)
    render = f"\nPathIntegrator(BlueSampler({MAIN_SPP}), {MAIN_DEPTH}).render(scene);\n"
    with open(os.path.join(OUT_DIR, "cbox_progressive.pine"), "w") as f:
        f.write(scenes.CBOX_PRL + render + f"scene.camera.film().save('{out}');\n")
    proc, wall, _ = run_module(["pine_tpu_torch", "cbox_progressive.pine", "--progressive",
                                str(PROGRESSIVE_EVERY), "--progressive-dir", snap_dir],
                               "the --progressive CLI run", env={"PINE_TERM_PREVIEW": "0"})
    snaps = [f"snap_{k:05d}spp.png" for k in range(PROGRESSIVE_EVERY, MAIN_SPP + 1,
                                                   PROGRESSIVE_EVERY)]
    files = sorted(os.listdir(snap_dir))
    times = [os.stat(os.path.join(snap_dir, s)).st_mtime_ns / 1e9 for s in snaps]
    got = read_png(out).astype(np.float32)
    ref = read_png(os.path.join(OUT_DIR, "cli_cbox.png")).astype(np.float32)
    d = np.abs(got - ref)
    last = read_png(os.path.join(snap_dir, snaps[-1]))
    lines = proc.stdout.strip().splitlines()
    rec = dict(phase="cli", command=f"python -m pine_tpu_torch cbox_progressive.pine --progressive "
               f"{PROGRESSIVE_EVERY}", wall_s=wall, one_shot_cli_wall_s=one_shot_wall,
               finished=lines[-1] if lines else "", files=files,
               s_between_snapshots=[b - a for a, b in zip(times, times[1:])],
               pixels_agree_vs_one_shot=float(((d <= 1e-3 * np.abs(ref)) | (d <= 1e-4)).all(-1)
                                              .mean()),
               last_snapshot_equal=bool(np.array_equal(last, got.astype(np.uint8))))
    emit(rec)
    if (files != ["index.html", "latest.png"] + snaps or not rec["last_snapshot_equal"]
            or rec["pixels_agree_vs_one_shot"] < 0.97 or not rec["finished"].startswith(
                "Finished in")):
        fail(f"the --progressive CLI run's files or image are not the one-shot's: {rec}")

    cwd = os.path.join(OUT_DIR, "interactive_cli")
    shutil.rmtree(cwd, ignore_errors=True)
    os.makedirs(cwd)
    with open(os.path.join(cwd, "cbox.pine"), "w") as f:
        f.write(scenes.CBOX_PRL + render)
    proc, wall, _ = run_module(["pine_tpu_torch", "cbox.pine", "--interactive"],
                               "the --interactive CLI run", cwd=cwd,
                               env={"PINE_INTERACTIVE_KEYS": INTERACTIVE_KEYS,
                                    "PINE_TERM_PREVIEW": "0"})
    status = [(int(a), float(b)) for a, b in re.findall(STATUS_RE, proc.stdout)]
    shot = os.path.join(cwd, "interactive", "shot_001.png")
    img = read_png(shot) if os.path.exists(shot) else np.zeros(0)
    lines = proc.stdout.strip().splitlines()
    rec = dict(phase="cli", command="python -m pine_tpu_torch cbox.pine --interactive",
               keys=INTERACTIVE_KEYS, wall_s=wall, frame_ms=status,
               finished=lines[-1] if lines else "",
               files=sorted(os.listdir(os.path.join(cwd, "interactive"))),
               screenshot_mean=float(img.mean()) if img.size else None)
    emit(rec)
    if ([spp for spp, _ in status] != [1] * 6 + [2, 4, 8] or img.shape != (MAIN_SIZE, MAIN_SIZE, 3)
            or not img.mean() > 0 or not rec["finished"].startswith("Finished in")):
        fail(f"the --interactive CLI session is not the keys': {rec}")


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
              ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln
                         or "Compiling entry function" in ln]
                     for k, v in logs.items()}))

    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    phases = (("dense", phase_dense_vs_plain), ("grid", phase_grid_vs_plain),
              ("inst", phase_inst_vs_plain), ("lattice", phase_lattice_vs_plain),
              ("scdense", phase_scdense_vs_plain),
              ("sctree", lambda dev: phase_tree_vs_plain(dev, "sctree", None)),
              ("bvh", lambda dev: phase_tree_vs_plain(dev, "bvh", terrain_group(dev, 1002))),
              ("mxup", phase_mxup_vs_plain), ("grid_mxu", phase_grid_mxu_vs_plain),
              ("inst_mxu", phase_inst_mxu_vs_plain), ("cone_probe", phase_probe_vs_plain))
    for kind, phase in phases:
        t0 = time.perf_counter()
        recs = phase(dev)
        if kind == "cone_probe":
            probe_recs = recs
        with open(os.path.join(OUT_DIR, f"chip_smoke_{kind}.json"), "w") as f:
            json.dump(recs, f, indent=1)
        emit(dict(phase="kernel_vs_plain", kernel=kind, cases=len(recs),
                  max_abs_err=max(r["max_abs_err"] for r in recs),
                  lanes_differ=sum(r["lanes_differ"] for r in recs),
                  lanes_differ_bits=sum(r.get("lanes_differ_bits", 0) for r in recs),
                  timed=[{k: v for k, v in r.items() if k in ("group", "form", "depth") or
                          k.endswith("_ms") or k == "ms" or k.startswith("vs_")}
                         for r in recs if "ms" in r],
                  **({"mxu_tolerance_held": all(v["within"] for r in recs for k, v in r.items()
                                                if k.startswith("vs_"))}
                     if "mxu" in kind else {}),
                  **({"vs_dense": [dict(group=r["group"], form=r["form"], **r["vs_dense"])
                                   for r in recs]} if kind == "lattice" else {}),
                  seconds=time.perf_counter() - t0))
        torch.cuda.empty_cache()
    elapsed("kernels against their plain versions", t_start)

    name = torch.cuda.get_device_name(0)
    W = H = MAIN_SIZE
    box = prl_box_checked()
    kernels, cs = phase_main_path(
        name, "cbox", "bench cbox, 420 cones, from CBOX_PRL", box,
        [("dense", 1, 6), ("dense", 5, 2), ("dense", 7, 424)], False, ["dense"])
    kernel_ab_record(cs, box, "bench cbox", 7, ["dense", "lattice", "scdense", "mxup", "mxu"])
    kernels += phase_main_path(
        name, "forest", "cone forest, 1,600 cones, from CONE_FOREST_PRL",
        scenes.prl_scene(scenes.CONE_FOREST_PRL, "<cone forest>"),
        [("dense", 1, 6), ("dense", 5, 2), ("lattice", 7, 1604)], False, ["lattice"],
        depth=VARIANT_DEPTH)[0]
    terrain = scenes.terrain((W, H))
    entries, cs = phase_main_path(
        name, "terrain", "bench_mesh terrain, 99,458 triangles + 1 rect", terrain,
        [("dense", 1, 1), ("grid", 6, 99458)], True, ["grid"], depth=VARIANT_DEPTH, also=["dense"])
    kernels += entries
    kernel_ab_record(cs, terrain, "bench_mesh terrain", 6, ["grid", "sctree", "bvh", "grid_mxu"],
                     depth=VARIANT_DEPTH)
    field = scenes.instanced((INST_SIZE, INST_SIZE))
    entries, cs = phase_main_path(
        name, "instanced", "bench_instanced rock field, 1,024 x 4,802 triangles + plane + rect",
        field, [("dense", 1, 1), ("dense", 3, 1), ("inst", 6, 1024)], False, ["inst"],
        INST_SIZE, INST_SPP, INST_DEPTH, also=["dense"])
    kernels += entries
    kernel_ab_record(cs, field, "bench_instanced rock field", 6, ["inst", "inst_mxu"],
                     INST_SIZE, INST_DEPTH)
    del cs, entries
    torch.cuda.empty_cache()
    # the slice's three paths: the BVH walk by default on a mesh over 2,000,000
    # triangles, the supercell tree and the scdense sweep forced
    kernels += phase_main_path(
        name, "terrain2m", "bench_mesh terrain at grid 1002, 2,004,002 triangles + 1 rect",
        scenes.terrain((W, H), 1002), [("dense", 1, 1), ("bvh", 6, 2004002)], True, ["bvh"],
        depth=TERRAIN2M_DEPTH, also=["dense"])[0]
    torch.cuda.empty_cache()
    kernels += phase_main_path(
        name, "terrain_sctree", "bench_mesh terrain, 99,458 triangles + 1 rect, "
        "mesh_kernel sctree", scenes.terrain((W, H)), [("dense", 1, 1), ("sctree", 6, 99458)],
        True, ["sctree"], depth=VARIANT_DEPTH, kernels=dict(mesh_kernel="sctree"))[0]
    kernels += phase_main_path(
        name, "cbox_scdense", "bench cbox, 420 cones, from CBOX_PRL, small_kernel scdense", box,
        [("scdense", 1, 6), ("scdense", 5, 2), ("scdense", 7, 424)], False, ["scdense"],
        depth=VARIANT_DEPTH, kernels=dict(small_kernel="scdense"))[0]
    # the slice-6 paths: kernel 7 on the box's rect and cone groups, the grid
    # kernel's MXU form on the terrain (pine_tpu's default route for it) and
    # the instanced kernel's MXU leaf form on the rock field
    kernels += phase_main_path(
        name, "cbox_mxup", "bench cbox, 420 cones, from CBOX_PRL, small_kernel mxup", box,
        [("mxup", 1, 6), ("dense", 5, 2), ("mxup", 7, 424)], False, ["mxup"],
        depth=VARIANT_DEPTH, kernels=dict(small_kernel="mxup"))[0]
    kernels += phase_main_path(
        name, "terrain_mxu", "bench_mesh terrain, 99,458 triangles + 1 rect, mesh_kernel mxu",
        terrain, [("dense", 1, 1), ("grid_mxu", 6, 99458)], True, ["grid_mxu"],
        depth=VARIANT_DEPTH, kernels=dict(mesh_kernel="mxu"))[0]
    kernels += phase_main_path(
        name, "instanced_mxu", "bench_instanced rock field, 1,024 x 4,802 triangles + plane + "
        "rect, inst_kernel mxu", field, [("dense", 1, 1), ("dense", 3, 1), ("inst_mxu", 6, 1024)],
        False, ["inst_mxu"], INST_SIZE, INST_SPP, INST_DEPTH, kernels=dict(inst_kernel="mxu"))[0]
    elapsed("main paths of slices 1-6", t_start)
    kernels += phase_house(name)
    elapsed("house", t_start)
    kernels += phase_garden(name)
    elapsed("garden", t_start)
    kernels += phase_media(name)
    elapsed("media", t_start)
    kernels += phase_lambdas(name)
    elapsed("lambdas", t_start)
    kernels += phase_guided(name, box)
    elapsed("guided", t_start)
    kernels += phase_last_slice(name, box)
    elapsed("MLT, ReSTIR and MicroRenderGI", t_start)
    kernels += phase_progressive_interactive(name, box)
    kernels += phase_shards(name)
    kernels += phase_sort_bins(name)
    elapsed("progressive, interactive, sharded and sort bins", t_start)
    kernels += phase_lab(name, probe_recs)
    t0 = time.perf_counter()
    modules_parity()  # alone: its fly-cam sessions redirect the process's stdout
    emit(dict(phase="parity_time", parity="modules_parity", seconds=time.perf_counter() - t0))
    # phase 3 measures nothing: it runs beside the CLIs whose walls are not
    # timed alone (CLI_WORKERS at a time); the timed commands follow alone
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(CLI_WORKERS) as pool:
        futures = [pool.submit(fn) for fn in (
            lambda: phase_modules_cli(phase_cli()), phase_media_cli, phase_house_cli,
            phase_garden_cli, phase_guided_cli, phase_last_slice_cli)]
        phase_render_parity()
        elapsed("render_parity", t_start)
        for f in futures:
            f.result()
    elapsed("render parity beside the CLIs", t_start)
    phase_bench(MAIN_RAYS["cbox"])
    phase_lambda_cli()
    phase_lab_modules()
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
