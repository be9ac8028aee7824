"""Scene (host container) and CompiledScene (device tables plus queries).

Counterpart of pine_tpu/scene/scene.py for analytic shapes and lines,
triangle meshes (also from GLB files, ``Scene.load``), mesh instancing,
materials with constant, image-texture or procedural parameters, area
(analytic or mesh), point, spot and directional lights, and one environment
light (``Scene.set``: Sky, Atmosphere or ImageSky), which joins the light
list last, as pine_tpu's.  ``Scene.compile(device)`` flattens the scene into the arrays of
pine_tpu_torch/convert.py and uploads them once; the renderer then queries
the CompiledScene.  Scenes with 24 or fewer analytic prims, no mesh and no
lazy instancing build no accel: each prim type's table is one group of its
own (``CompiledScene.type_groups``), swept whole by the dense kernel (lines
by the "plain" route), as pine_tpu's per-type brute-force product; the
others go through the prim groups of accel/packet.py, whose
traversal runs on CUDA the dense kernel (groups of up to 512 prims), the
lattice kernel (larger groups that form a regular lattice, fields a script
builds in loops), the grid kernel (other larger groups), the BVH walk (groups
of more than 2,000,000 prims) or the instanced kernel (lazy instancings); a
group of lines, a type with no ray test of a kernel, takes the "plain" route
(accel/dense_traverse.py).

Forced kernels: ``CompiledScene.small_kernel`` and ``mesh_kernel`` (or the
same arguments of ``Scene.compile``) are the counterparts of pine_tpu's
PINE_SMALL_KERNEL and PINE_MESH_KERNEL: one of "dense", "scdense",
"lattice", "grid", "sctree", "bvh", "mxu" or "mxup" for the groups of at
most GRID_MAX_PRIMS prims (small) or of more and at most 2,000,000 (mesh),
None (the default) for pine_tpu's choice (accel/dense_traverse.group_variant;
"mxu" and "mxup" on a mesh-scale group take the grid kernel's MXU form).
``inst_kernel`` (None or "mxu") is PINE_INST_KERNEL's: "mxu" runs the
instanced kernel's MXU leaf form.  Setting one resolves every group's route
and builds the tables it needs, once; a route a group cannot take raises
and changes nothing.

``Scene.compile`` caches its CompiledScene per device and settings, as
pine_tpu's ``Scene.compile`` does: a render compiles a scene once, and every
``add`` / ``add_material`` / ``add_geometry`` drops the cache.  The camera
is not part of it (renders read ``scene.camera``).  A cached scene whose
settings were changed through its setters is not handed out for its old
settings.

``Scene.add(InstancedShape)`` flattens an instancing into transformed meshes
when its shape is not a Mesh, when an instance is emissive (area-light
sampling needs the geometry) or when it realizes FLATTEN_LIMIT triangles or
fewer; otherwise it stays lazy: the mesh is stored once, and each instance
is one scene geometry of its own (``MESH_TYPE``, ``g_local`` 0, its own
material slot).

The coherence sort: on the card, each bounce's rays are traversed in the
order of a sort (``_ray_sort_perm``), so the lanes of a warp share a region
and a direction octant.  Scenes with a regular group of more than
GRID_MAX_PRIMS prims are "heavy" and take the octant-major key; scenes with
a lazy instanced group (and no heavy group) may take the origin-major key,
whose fine origin cells bin bounce rays by the instance they start on; it is
off unless ``CompiledScene.origin_sort`` is set, because on the H100 it cost
more device time than it saved (PERF.md, PR 3).  The sort is a pure
permutation: per-lane results do not change.  ``CompiledScene.sort_dirbits``
is pine_tpu's PINE_SORT_DIRBITS: the octant key's direction bins, 3 (the
octants, the default) or, above 3, octahedral bins.

Signed-distance shapes and CSG trees take no prim row: the compiled scene
keeps each in a list of its own, marches every SDF in plain PyTorch
(``_sdf_march``: at most SDF_STEPS steps inside its bounding box) and walks
every CSG tree's intervals (scene/csg_intersect.py) after the prim groups,
in ``intersect``, ``any_hit`` and ``surface_info``, as pine_tpu does in XLA.
Participating media (``Scene.add`` of a scene/media.py medium) split into
homogeneous media, whose transmittance along a segment is the closed form
over their shape's intervals, and grid media, tracked by
scene/media_track.py (``CompiledScene.transmittance``).
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.core import profiler
from pine_tpu_torch.core.vecmath import dot
from pine_tpu_torch.scene import csg_intersect as CI
from pine_tpu_torch.scene import intersect as I
from pine_tpu_torch.scene import lights as L
from pine_tpu_torch.scene import media_track as MT
from pine_tpu_torch.scene import shapes as S
from pine_tpu_torch.scene.csg import CSGShape
from pine_tpu_torch.scene.materials import SUBSURFACE
from pine_tpu_torch.scene.nodes import eval_vec3_node

BIG = I.BIG
SORT_MIN_LANES = 4096  # smaller wavefronts are not sorted
# instancings that realize more triangle rows than this stay lazy
FLATTEN_LIMIT = 200_000
SDF_STEPS = 128  # sphere-tracing steps of an SDF march (pine_tpu's)
EXIT_CHECK = 8  # march steps between the compactions of the marching lanes (``_sdf_march``)


def _spread10(x):
    """Interleave-ready bit spread: 10 low bits -> every 3rd bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _morton(ro, world_lo, world_span, cells):
    """Morton code of each origin's cell in a cells^3 grid over the world."""
    q = torch.clamp(((ro - world_lo) * (cells / world_span)).to(torch.int32), 0, cells - 1)
    return _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)


def _ray_sort_perm(ro, rd, tmin, tmax, world_lo, world_span, mode="octant", dirbits=3):
    """Wavefront coherence sort, pine_tpu's: key (dead, direction bin,
    32^3 origin morton) in the octant mode, (dead, 128^3 origin morton,
    direction octant) in the origin mode; stable argsort.  ``world_lo`` is a
    (3,) tensor on the rays' device.  ``dirbits`` (the octant mode's;
    pine_tpu's PINE_SORT_DIRBITS): 3 or less bins directions by octant,
    more by the octahedral map, k = min(dirbits // 2, 7) bits an axis (15
    morton bits, 2k direction bits and the dead bit stay below the int32
    sign bit).  -> (perm, inv_perm)."""
    dead = (tmax <= tmin).to(torch.int32)
    if mode == "origin" or dirbits <= 3:
        dbin = (rd[:, 0] < 0).to(torch.int32) + 2 * (rd[:, 1] < 0).to(torch.int32) \
            + 4 * (rd[:, 2] < 0).to(torch.int32)
        dirbits = 3
    else:
        # octahedral bins: finer than the octants, so a warp's direction cone
        # (and the footprint its culls see) shrinks
        k = min(dirbits // 2, 7)
        s = rd[:, 0].abs() + rd[:, 1].abs() + rd[:, 2].abs()
        px, py = rd[:, 0] / s, rd[:, 1] / s
        neg = rd[:, 2] < 0
        fx = torch.where(neg, (1 - py.abs()) * torch.sign(px), px)
        fy = torch.where(neg, (1 - px.abs()) * torch.sign(py), py)
        hi = (1 << k) - 1
        qx = torch.clamp(((fx + 1) * 0.5 * (hi + 1)).to(torch.int32), 0, hi)
        qy = torch.clamp(((fy + 1) * 0.5 * (hi + 1)).to(torch.int32), 0, hi)
        dbin = qx | (qy << k)
        dirbits = 2 * k
    if mode == "origin":
        key = dbin | (_morton(ro, world_lo, world_span, 128) << 3) | (dead << 24)
    else:
        key = _morton(ro, world_lo, world_span, 32) | (dbin << 15) | (dead << (15 + dirbits))
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


class Scene:
    def __init__(self):
        self.materials = {}  # name -> Material
        self.geometries = []  # (shape, material)
        self.instancings = []  # InstancedShape kept lazy
        self.lights = []
        self.mediums = []
        self.env_light = None
        self.camera = None
        self._compiled = {}  # (device, small_kernel, mesh_kernel, inst_kernel) -> CompiledScene

    def add_material(self, name, material):
        self.materials[name] = material
        self._compiled = {}
        return material

    def add_geometry(self, shape, material):
        if isinstance(material, str):
            if material not in self.materials:
                raise RuntimeError(f"Can't find material `{material}`")
            material = self.materials[material]
        self.geometries.append((shape, material))
        self._compiled = {}
        return material

    def add(self, *args):
        """add(name, material) | add(shape, material) | add(light) |
        add(medium) | add(InstancedShape): flattened or kept lazy (module
        docstring)."""
        if len(args) == 2 and isinstance(args[0], str):
            return self.add_material(args[0], args[1])
        if len(args) == 2:
            if isinstance(args[0], S.Mesh):
                with profiler.span("scene.build", triangles=args[0].num_triangles()):
                    return self.add_geometry(args[0], args[1])
            return self.add_geometry(args[0], args[1])
        (x,) = args
        if isinstance(x, L.Light):
            self.lights.append(x)
            self._compiled = {}
            return x
        if isinstance(x, S.InstancedShape):
            is_mesh = isinstance(x.shape, S.Mesh)
            n_rows = len(x.instances) * x.shape.num_triangles() if is_mesh else 0
            if (not is_mesh or any(mat.is_emissive() for _, mat in x.instances)
                    or n_rows <= FLATTEN_LIMIT):
                for m, mat in x.instances:
                    self.add_geometry(x.shape.transformed(m), mat)
            else:
                self.instancings.append(x)
                self._compiled = {}
            return x
        from pine_tpu_torch.scene.media import GridMedium, HomogeneousMedium

        if isinstance(x, (HomogeneousMedium, GridMedium)):
            self.mediums.append(x)
            self._compiled = {}
            return x
        raise TypeError(f"Scene.add: unsupported argument {type(x).__name__}")

    def load(self, filename, m=None):
        """PRL ``scene.load(file[, m])``: the GLB's primitives, transformed by
        the 4x4 ``m``, added as geometries (each ``add`` drops the compile
        cache)."""
        from pine_tpu_torch.io.gltf import load_glb_into_scene

        load_glb_into_scene(self, filename, None if m is None else getattr(m, "data", m))

    def get_aabb(self):
        """(lo, hi) float32 over every geometry, lazy instances by their mesh
        box's transformed corners."""
        from pine_tpu_torch.accel.packet import box_corners

        lo = np.full(3, np.inf, np.float32)
        up = np.full(3, -np.inf, np.float32)
        for shape, _ in self.geometries:
            a, b = shape.get_aabb()
            lo, up = np.minimum(lo, a), np.maximum(up, b)
        for inst in self.instancings:
            corners = box_corners(*inst.shape.get_aabb())
            for m, _ in inst.instances:
                wc = corners @ m[:3, :3].T + m[:3, 3]
                lo, up = np.minimum(lo, wc.min(0)), np.maximum(up, wc.max(0))
        return lo, up

    def set(self, x):
        """set(camera) | set(environment light): the scene's one of each; a
        new environment light drops the compile cache."""
        from pine_tpu_torch.core.camera import ThinLenCamera

        if isinstance(x, ThinLenCamera):
            self.camera = x
        elif isinstance(x, L.EnvironmentLight):
            self.env_light = x
            self._compiled = {}
        else:
            raise TypeError(f"Scene.set: unsupported argument {type(x).__name__}")
        return x

    def compile(self, device=None, small_kernel=None, mesh_kernel=None, inst_kernel=None):
        """The CompiledScene on ``device`` (default: the card), its groups
        routed under the forced-kernel settings, built once per device and
        settings (module docstring)."""
        from pine_tpu_torch.convert import compiled_scene_from_arrays, scene_arrays
        from pine_tpu_torch.core.place import resolve_device

        kernels = (small_kernel, mesh_kernel, inst_kernel)
        key = (str(resolve_device(device)),) + kernels
        cs = self._compiled.get(key)
        if cs is None or cs._kernels != kernels:  # re-routed through a setter since
            with profiler.span("scene.compile"):
                with profiler.span("scene_arrays"):
                    arrays = scene_arrays(self)
                with profiler.span("compiled_scene_from_arrays"):
                    cs = compiled_scene_from_arrays(arrays, device, *kernels)
            self._compiled[key] = cs
        return cs


class CompiledScene:
    """Device tables of one scene.  Built by convert.compiled_scene_from_arrays."""

    def __init__(self, device, g_type, g_local, g_mat, tables, type_global, unified,
                 materials, lights, camera=None, world_lo=None, world_span=1.0,
                 kernels=(None, None, None), sdf_shapes=(), csg_shapes=(), mediums=(),
                 type_groups=()):
        from pine_tpu_torch.scene.media import GridMedium

        self.device = device
        self.n_global = int(g_type.shape[0])
        self.g_type, self.g_local, self.g_mat = g_type, g_local, g_mat
        self.tables = tables  # tid -> (n, w) unsnapped params
        self.type_global = type_global  # tid -> (n,) geometry ids
        self.unified = unified  # None, or prim groups (accel/packet.py) + mesh tables
        self.type_groups = list(type_groups)  # without an accel: one dense group per table
        self.sdf_shapes = list(sdf_shapes)  # (SDFShape, geometry id)
        self.csg_shapes = list(csg_shapes)  # (CSG tree, geometry id)
        self.media = [m for m in mediums if not isinstance(m, GridMedium)]
        self.grid_media = [m for m in mediums if isinstance(m, GridMedium)]
        self.materials = materials  # per slot: dict of tag and parameter nodes (materials.PARAMS)
        self.lights = lights
        self.env_light = next((li for li in lights if isinstance(li, L.EnvironmentLight)), None)
        self.has_subsurface = any(m["tag"] == SUBSURFACE for m in materials)
        self.emissive_globals = {
            li.global_idx: li for li in lights if isinstance(li, L.AreaLight)
        }
        self.camera = camera
        self.has_meshes = unified is not None and "ent_param" in unified
        # instanced groups are kept apart (unified["inst_groups"]): a large
        # shared mesh does not make a scene heavy
        self.heavy_traversal = unified is not None and any(
            len(g["prim_aabbs"]) > DT.GRID_MAX_PRIMS for g in unified["groups"])
        self._kernels = tuple(kernels)  # (small_kernel, mesh_kernel, inst_kernel), as routed
        self.inst_traversal = unified is not None and bool(unified.get("inst_groups"))
        self.origin_sort = False  # the origin-major sort for instanced scenes (module docstring)
        self.sort_dirbits = 3  # the octant key's direction bins (_ray_sort_perm's dirbits)
        self.world_lo = torch.zeros(3, device=device) if world_lo is None else world_lo
        self.world_span = float(world_span)

    @property
    def small_kernel(self):
        """The forced route of groups of at most GRID_MAX_PRIMS prims, or None."""
        return self._kernels[0]

    @small_kernel.setter
    def small_kernel(self, value):
        self._route(value, *self._kernels[1:])

    @property
    def mesh_kernel(self):
        """The forced route of groups of more than GRID_MAX_PRIMS prims and at
        most 2,000,000, or None."""
        return self._kernels[1]

    @mesh_kernel.setter
    def mesh_kernel(self, value):
        self._route(self._kernels[0], value, self._kernels[2])

    @property
    def inst_kernel(self):
        """The form of the instanced groups: None (the VPU form) or "mxu"."""
        return self._kernels[2]

    @inst_kernel.setter
    def inst_kernel(self, value):
        self._route(*self._kernels[:2], value)

    def _route(self, small_kernel, mesh_kernel, inst_kernel):
        from pine_tpu_torch.accel.inst_traverse import INST_KERNELS, route_inst

        if inst_kernel not in INST_KERNELS:  # refused before any group is re-routed
            raise ValueError(f"unknown instanced route {inst_kernel!r}: one of {INST_KERNELS}")
        if self.unified is not None:
            DT.route(self.unified["groups"], small_kernel, mesh_kernel)
            route_inst(self.unified.get("inst_groups", []), inst_kernel)
        self._kernels = (small_kernel, mesh_kernel, inst_kernel)

    def sort_mode(self, n, on_card):
        """The coherence sort's key for a wavefront of ``n`` lanes: "octant"
        for heavy scenes, "origin" for instanced ones with ``origin_sort``
        set, None when the sort is off (off the card, or under
        SORT_MIN_LANES lanes)."""
        if not (on_card and n >= SORT_MIN_LANES):
            return None
        if self.heavy_traversal:
            return "octant"
        return "origin" if self.inst_traversal and self.origin_sort else None

    def sort_perm(self, ro, rd, dead):
        """Coherence-sort permutation (perm, inv) for a wavefront, or None when
        the sort is off (``sort_mode``).  The integrator shares one per bounce
        between the NEE shadow rays and the next depth's intersect."""
        mode = self.sort_mode(ro.shape[0], ro.is_cuda)
        if mode is None:
            return None
        return _ray_sort_perm(ro, rd, torch.zeros_like(ro[:, 0]), torch.where(dead, -1.0, 1.0),
                              self.world_lo, self.world_span, mode, self.sort_dirbits)

    def intersect(self, ro, rd, tmin, tmax, sort_perm=None):
        """Closest hit -> (t, gidx, hit, mesh_tri); t = BIG on a miss and
        mesh_tri the hit entity (0 on a miss), which surface_info reads for
        mesh lanes.  ``sort_perm`` (from sort_perm) reorders the traversal
        of the prim groups.  The SDFs and CSG trees are tested after the
        groups, each within the closest hit so far.  The span ``intersect``
        (attr ``lanes``) and the counter ``rays.closest``."""
        n = ro.shape[0]
        profiler.count("rays.closest", n)
        with profiler.span("intersect", lanes=n):
            return self._intersect(ro, rd, tmin, tmax, sort_perm)

    def _intersect(self, ro, rd, tmin, tmax, sort_perm):
        if self.unified is not None:
            from pine_tpu_torch.accel.packet import ent_to_gidx, packet_intersect

            if sort_perm is not None:
                perm, inv = sort_perm
                t, ent = packet_intersect(self.unified, ro[perm], rd[perm], tmin[perm],
                                          tmax[perm])
                t, ent = t[inv], ent[inv]
            else:
                t, ent = packet_intersect(self.unified, ro, rd, tmin, tmax)
            better = t < BIG
            best_t, best_g = t, torch.where(better, ent_to_gidx(self.unified, ent), -1)
            mesh_tri = torch.where(better, ent, 0)
        else:
            best_t, best_g = self._type_groups_intersect(ro, rd, tmin, tmax)
            mesh_tri = torch.zeros_like(best_g)
        for sdf, gidx in self.sdf_shapes:
            t = _sdf_march(sdf, ro, rd, tmin, torch.minimum(tmax, best_t))
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_g = torch.where(better, gidx, best_g)
        for csg, gidx in self.csg_shapes:
            t, hit_c = CI.csg_intersect(csg, ro, rd, tmin, torch.minimum(tmax, best_t))
            better = hit_c & (t < best_t)
            best_t = torch.where(better, t, best_t)
            best_g = torch.where(better, gidx, best_g)
        return best_t, best_g, best_t < BIG, mesh_tri

    def _type_groups_intersect(self, ro, rd, tmin, tmax):
        """The closest hit over the per-type groups -> (t, gidx), t = BIG on
        a miss; a later type replaces a hit only on a strictly smaller t."""
        best_t = tmax
        best_g = torch.full_like(tmax, -1, dtype=torch.int32)
        zero = torch.zeros_like(best_g)
        for g in self.type_groups:
            t_new, e_loc = DT.group_query(g, ro, rd, tmin, best_t, best_t, zero)
            best_g = torch.where(t_new < best_t, self.type_global[g["tid"]][e_loc.long()], best_g)
            best_t = t_new
        return torch.where(best_t < tmax, best_t, BIG), best_g

    def any_hit(self, ro, rd, tmin, tmax, sort_perm=None):
        """Shadow-ray occlusion -> (N,) bool.  The span ``any_hit`` (attr
        ``lanes``) and the counter ``rays.any_hit``."""
        n = ro.shape[0]
        profiler.count("rays.any_hit", n)
        with profiler.span("any_hit", lanes=n):
            return self._any_hit(ro, rd, tmin, tmax, sort_perm)

    def _any_hit(self, ro, rd, tmin, tmax, sort_perm):
        if self.unified is not None:
            from pine_tpu_torch.accel.packet import packet_any_hit

            if sort_perm is not None:
                perm, inv = sort_perm
                occ = packet_any_hit(self.unified, ro[perm], rd[perm], tmin[perm],
                                     tmax[perm])[inv]
            else:
                occ = packet_any_hit(self.unified, ro, rd, tmin, tmax)
        else:
            hit = torch.zeros_like(tmax, dtype=torch.int32)
            for g in self.type_groups:
                _, hit = DT.group_query(g, ro, rd, tmin, tmax, tmax, hit, any_hit=True)
            occ = hit != 0
        for sdf, _ in self.sdf_shapes:
            occ = occ | (_sdf_march(sdf, ro, rd, tmin, tmax) < BIG)
        for csg, _ in self.csg_shapes:
            occ = occ | CI.csg_intersect(csg, ro, rd, tmin, tmax)[1]
        return occ

    def _rows_at(self, tid, local):
        params = self.tables[tid]
        return params[local.clamp(0, params.shape[0] - 1).long()]

    def surface_info(self, gidx, p, mesh_tri=None):
        """Per-lane (p_corrected, n, uv) by masked per-type dispatch; mesh
        lanes interpolate their triangle's attributes at ``mesh_tri``, and
        instanced lanes (virtual ids) their instance's triangle's."""
        gi = gidx.clamp(0, self.n_global - 1).long()
        tid_lane, local = self.g_type[gi], self.g_local[gi]
        out_p, out_n = p, torch.zeros_like(p)
        out_uv = torch.zeros_like(p[:, :2])
        for tid in self.tables:
            pc, nn, uv = I.SURFACE_INFO[tid](self._rows_at(tid, local), p)
            m = (tid_lane == tid)[:, None]
            out_p = torch.where(m, pc, out_p)
            out_n = torch.where(m, nn, out_n)
            out_uv = torch.where(m, uv, out_uv)
        for sdf, g in self.sdf_shapes:
            out_n = torch.where((gidx == g)[:, None], _sdf_normal(sdf, p), out_n)
        for csg, g in self.csg_shapes:
            out_n = torch.where((gidx == g)[:, None], CI.csg_normal(csg, p), out_n)
        if self.has_meshes and mesh_tri is not None:
            from pine_tpu_torch.accel.unified import unified_surface_info_triangle

            pc, nn, uv = unified_surface_info_triangle(self.unified, mesh_tri, p)
            m = (tid_lane == S.MESH_TYPE)[:, None]
            out_p = torch.where(m, pc, out_p)
            out_n = torch.where(m, nn, out_n)
            out_uv = torch.where(m, uv, out_uv)
        if self.inst_traversal and mesh_tri is not None:
            from pine_tpu_torch.accel.packet import instanced_surface_info

            out_p, out_n, out_uv = instanced_surface_info(self.unified, mesh_tri, p,
                                                          out_p, out_n, out_uv)
        return out_p, out_n, out_uv

    def light_pdf_at_hit(self, gidx, ro, rd, t, ns):
        """Area pdf of the hit emissive shape under uniform light selection."""
        n_lights = max(len(self.lights), 1)
        pdf = torch.zeros_like(t)
        local = self.g_local[gidx.clamp(0, self.n_global - 1).long()]
        for g, al in self.emissive_globals.items():
            if isinstance(al, L.MeshLight):
                p_t = t**2 / torch.clamp_min(max(al.area, 1e-20) * dot(ns, rd).abs(), 1e-20)
            else:
                p_t = I.PDF[al.tid](self._rows_at(al.tid, local), ro, rd, t, ns)
            pdf = torch.where(gidx == g, p_t, pdf)
        return pdf / n_lights

    def transmittance(self, ro, rd, tmax, key=None, grid=True):
        """Chromatic transmittance (N,3) along [0, tmax]: the closed form over
        each homogeneous medium's intervals (integrator.cpp:75-81), times,
        with ``grid``, the ratio-tracked transmittance of each grid medium
        (medium.cpp:264-290), whose walk ``key`` (N,) seeds (by default the
        rays' bits, scene/media_track.ray_key; grid medium k takes key + k).
        The path integrator's segments take ``grid`` False: its delta
        tracking carries the grid media's extinction already."""
        tr = torch.ones(ro.shape[0], 3, device=ro.device)
        for med in self.media:
            s, e = CI.intervals_of(med.shape, ro, rd)
            lo = torch.minimum(torch.clamp_min(s, 0.0), tmax[:, None])
            hi = torch.minimum(torch.clamp_min(e, 0.0), tmax[:, None])
            overlap = torch.clamp_min(hi - lo, 0.0).sum(1)
            tr = tr * torch.exp(-CI.on_device(med, "sigma_t", ro) * overlap[:, None])
        if self.grid_media and grid:
            if key is None:
                key = MT.ray_key(ro, rd)
            for gi, med in enumerate(self.grid_media):
                tr = tr * MT.grid_transmittance(med, ro, rd, tmax, (key + gi) & 0xFFFFFFFF)
        return tr

    def is_emissive_lane(self, gidx):
        m = torch.zeros_like(gidx, dtype=torch.bool)
        for g in self.emissive_globals:
            m = m | (gidx == g)
        return m

    def emissive_le(self, gidx, ctx, wo):
        """Le of the hit emissive shape, its color node evaluated at the hits
        ``ctx``, front face only."""
        le = torch.zeros_like(wo)
        front = dot(wo, ctx["n"]) >= 0.0
        for g, al in self.emissive_globals.items():
            le_g = torch.where(front[:, None], eval_vec3_node(al.color, ctx, wo.shape[0]), 0.0)
            le = torch.where((gidx == g)[:, None], le_g, le)
        return le


def check_ported(shape):
    """Refuse shapes the port cannot render: a CSG tree with a child that
    has no interval test."""
    if isinstance(shape, CSGShape):
        return CI.check_csg(shape)
    if (shape.type_id not in S.PARAM_WIDTH and not isinstance(shape, (S.Mesh, S.SDFShape))):
        raise TypeError(f"{type(shape).__name__} is not a shape the scene can render")
    return shape


def _sdf_march(sdf, ro, rd, tmin, tmax, steps=SDF_STEPS, eps=1e-5):
    """Sphere tracing (geometry.cpp:730-753) in ``steps`` steps at most, the
    march clamped to the SDF's box -> t (N,), BIG on a miss.  Only the lanes
    still marching are stepped: the march starts on the lanes whose window
    meets the box, and every EXIT_CHECK steps drops those that have hit or
    left it, and ends once none marches.  A step changes nothing on such a
    lane, so this is exact (tests/test_torch_sdf.py)."""
    c, h = CI.on_device(sdf, "center", ro), CI.on_device(sdf, "half", ro)  # get_aabb's float32 sums
    inv = 1.0 / torch.where(rd.abs() < 1e-9, torch.where(rd < 0, -1e-9, 1e-9), rd)
    t0b = ((c - h) - ro) * inv
    t1b = ((c + h) - ro) * inv
    enter = torch.minimum(t0b, t1b).amax(-1)
    exit_ = torch.maximum(t0b, t1b).amin(-1)
    t_lo = torch.maximum(torch.clamp_min(tmin, 0.0), enter)
    t_hi = torch.minimum(tmax, exit_ + 1e-3)
    out = torch.full_like(t_lo, BIG)
    idx = torch.nonzero(t_lo <= t_hi)[:, 0]
    t, o, d, hi = t_lo[idx], ro[idx], rd[idx], t_hi[idx]
    done_hit = torch.zeros_like(t, dtype=torch.bool)
    done_miss = torch.zeros_like(done_hit)
    for i in range(steps):
        if idx.numel() == 0:
            break
        dist = sdf.fn(o + torch.minimum(t, hi)[:, None] * d)
        done_hit_next = done_hit | ((dist < eps) & ~done_miss)
        done_miss = done_miss | ((t >= hi) & ~done_hit)
        done_hit = done_hit_next
        active = ~(done_hit | done_miss)
        t = torch.where(active, torch.minimum(t + dist, hi + 1e-3), t)
        if (i + 1) % EXIT_CHECK == 0:
            out[idx] = torch.where(done_hit, t, BIG)
            keep = torch.nonzero(active)[:, 0]
            idx, t, o, d, hi, done_hit, done_miss = (
                x[keep] for x in (idx, t, o, d, hi, done_hit, done_miss))
    out[idx] = torch.where(done_hit, t, BIG)
    return out


def _sdf_normal(sdf, p, ops=1e-4):
    """Central-difference normal (geometry.cpp:755-762; the step enlarged
    for float32)."""
    from pine_tpu_torch.core.vecmath import safe_normalize

    g = []
    for k in range(3):
        d = torch.zeros(3, dtype=p.dtype, device=p.device)
        d[k] = ops
        g.append(sdf.fn(p + d) - sdf.fn(p - d))
    return safe_normalize(torch.stack(g, -1))
