"""Scene (host container) and CompiledScene (device tables plus queries).

Counterpart of pine_tpu/scene/scene.py for analytic shapes, triangle meshes,
mesh instancing, constant materials, area (analytic or mesh) and point
lights.  ``Scene.compile(device)`` flattens the scene into the arrays of
pine_tpu_torch/convert.py and uploads them once; the renderer then queries
the CompiledScene.  Scenes with 24 or fewer analytic prims, no mesh and no
lazy instancing keep the brute-force per-type product (no accel, no
kernel); the others go through the prim groups of accel/packet.py, whose
traversal runs on CUDA the dense kernel (groups of up to 512 prims), the
lattice kernel (larger groups that form a regular lattice, fields a script
builds in loops), the grid kernel (other larger groups), the BVH walk (groups
of more than 2,000,000 prims) or the instanced kernel (lazy instancings).

Forced kernels: ``CompiledScene.small_kernel`` and ``mesh_kernel`` (or the
same arguments of ``Scene.compile``) are the counterparts of pine_tpu's
PINE_SMALL_KERNEL and PINE_MESH_KERNEL: one of "dense", "scdense",
"lattice", "grid", "sctree" or "bvh" for the groups of at most
GRID_MAX_PRIMS prims (small) or of more and at most 2,000,000 (mesh), None
(the default) for pine_tpu's choice (accel/dense_traverse.group_variant).
Setting one resolves every group's route and builds the tables it needs,
once; a route a group cannot take raises and changes nothing.

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
permutation: per-lane results do not change.

Not ported yet, and refused at compile() with their ROADMAP.md row: SDF and
CSG (modules item 9), environment lights and textured nodes (10), media
(11), the Subsurface and Uber materials (3).
"""
from __future__ import annotations

import torch

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.scene import intersect as I
from pine_tpu_torch.scene import lights as L
from pine_tpu_torch.scene import shapes as S

BIG = I.BIG
SORT_MIN_LANES = 4096  # smaller wavefronts are not sorted
# instancings that realize more triangle rows than this stay lazy
FLATTEN_LIMIT = 200_000


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


def _ray_sort_perm(ro, rd, tmin, tmax, world_lo, world_span, mode="octant"):
    """Wavefront coherence sort, pine_tpu's: key (dead, direction octant,
    32^3 origin morton) in the octant mode, (dead, 128^3 origin morton,
    direction octant) in the origin mode; stable argsort.  ``world_lo`` is a
    (3,) tensor on the rays' device.  -> (perm, inv_perm)."""
    dbin = (rd[:, 0] < 0).to(torch.int32) + 2 * (rd[:, 1] < 0).to(torch.int32) \
        + 4 * (rd[:, 2] < 0).to(torch.int32)
    dead = (tmax <= tmin).to(torch.int32)
    if mode == "origin":
        key = dbin | (_morton(ro, world_lo, world_span, 128) << 3) | (dead << 24)
    else:
        key = _morton(ro, world_lo, world_span, 32) | (dbin << 15) | (dead << 18)
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
        self.camera = None

    def add_material(self, name, material):
        self.materials[name] = material
        return material

    def add_geometry(self, shape, material):
        if isinstance(material, str):
            if material not in self.materials:
                raise RuntimeError(f"Can't find material `{material}`")
            material = self.materials[material]
        self.geometries.append((shape, material))
        return material

    def add(self, *args):
        """add(name, material) | add(shape, material) | add(light) |
        add(InstancedShape): flattened or kept lazy (module docstring)."""
        if len(args) == 2 and isinstance(args[0], str):
            return self.add_material(args[0], args[1])
        if len(args) == 2:
            return self.add_geometry(args[0], args[1])
        (x,) = args
        if isinstance(x, L.Light):
            self.lights.append(x)
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
            return x
        raise NotImplementedError(
            f"Scene.add({type(x).__name__}) is not ported yet: media are ROADMAP.md "
            "modules item 11"
        )

    def set(self, x):
        from pine_tpu_torch.core.camera import ThinLenCamera

        if not isinstance(x, ThinLenCamera):
            raise NotImplementedError(
                f"Scene.set({type(x).__name__}) is not ported yet: environment "
                "lights are ROADMAP.md modules item 10"
            )
        self.camera = x
        return x

    def compile(self, device=None, small_kernel=None, mesh_kernel=None):
        """The CompiledScene on ``device`` (default: the card), its groups
        routed under the forced-kernel settings (module docstring)."""
        from pine_tpu_torch.convert import compiled_scene_from_arrays, scene_arrays

        return compiled_scene_from_arrays(scene_arrays(self), device, small_kernel, mesh_kernel)


class CompiledScene:
    """Device tables of one scene.  Built by convert.compiled_scene_from_arrays."""

    def __init__(self, device, g_type, g_local, g_mat, tables, type_global, unified,
                 materials, lights, camera=None, world_lo=None, world_span=1.0,
                 kernels=(None, None)):
        self.device = device
        self.n_global = int(g_type.shape[0])
        self.g_type, self.g_local, self.g_mat = g_type, g_local, g_mat
        self.tables = tables  # tid -> (n, w) unsnapped params
        self.type_global = type_global  # tid -> (n,) geometry ids
        self.unified = unified  # None, or prim groups (accel/packet.py) + mesh tables
        self.materials = materials  # per slot: dict of tag, albedo, roughness, ior, color
        self.lights = lights
        self.emissive_globals = {
            li.global_idx: li for li in lights if isinstance(li, L.AreaLight)
        }
        self.camera = camera
        self.has_meshes = unified is not None and "ent_param" in unified
        # instanced groups are kept apart (unified["inst_groups"]): a large
        # shared mesh does not make a scene heavy
        self.heavy_traversal = unified is not None and any(
            len(g["prim_aabbs"]) > DT.GRID_MAX_PRIMS for g in unified["groups"])
        self._kernels = tuple(kernels)  # (small_kernel, mesh_kernel), as routed
        self.inst_traversal = unified is not None and bool(unified.get("inst_groups"))
        self.origin_sort = False  # the origin-major sort for instanced scenes (module docstring)
        self.world_lo = torch.zeros(3, device=device) if world_lo is None else world_lo
        self.world_span = float(world_span)

    @property
    def small_kernel(self):
        """The forced route of groups of at most GRID_MAX_PRIMS prims, or None."""
        return self._kernels[0]

    @small_kernel.setter
    def small_kernel(self, value):
        self._route(value, self._kernels[1])

    @property
    def mesh_kernel(self):
        """The forced route of groups of more than GRID_MAX_PRIMS prims and at
        most 2,000,000, or None."""
        return self._kernels[1]

    @mesh_kernel.setter
    def mesh_kernel(self, value):
        self._route(self._kernels[0], value)

    def _route(self, small_kernel, mesh_kernel):
        if self.unified is not None:
            DT.route(self.unified["groups"], small_kernel, mesh_kernel)
        self._kernels = (small_kernel, mesh_kernel)

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
                              self.world_lo, self.world_span, mode)

    def intersect(self, ro, rd, tmin, tmax, sort_perm=None):
        """Closest hit -> (t, gidx, hit, mesh_tri); t = BIG on a miss and
        mesh_tri the hit entity (0 on a miss), which surface_info reads for
        mesh lanes.  ``sort_perm`` (from sort_perm) reorders the traversal."""
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
            g = torch.where(better, ent_to_gidx(self.unified, ent), -1)
            return t, g, better, torch.where(better, ent, 0)
        n = ro.shape[0]
        best_t = torch.full((n,), BIG, device=ro.device)
        best_g = torch.full((n,), -1, dtype=torch.int32, device=ro.device)
        for tid, params in self.tables.items():
            tmat = I.INTERSECT[tid](params, ro, rd, tmin[:, None], tmax[:, None])
            t_min, idx = tmat.min(1)
            better = t_min < best_t
            best_t = torch.where(better, t_min, best_t)
            best_g = torch.where(better, self.type_global[tid][idx], best_g)
        return best_t, best_g, best_t < BIG, torch.zeros_like(best_g)

    def any_hit(self, ro, rd, tmin, tmax, sort_perm=None):
        """Shadow-ray occlusion -> (N,) bool."""
        if self.unified is not None:
            from pine_tpu_torch.accel.packet import packet_any_hit

            if sort_perm is not None:
                perm, inv = sort_perm
                return packet_any_hit(self.unified, ro[perm], rd[perm], tmin[perm],
                                      tmax[perm])[inv]
            return packet_any_hit(self.unified, ro, rd, tmin, tmax)
        return self.intersect(ro, rd, tmin, tmax)[2]

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
                p_t = t**2 / torch.clamp_min(max(al.area, 1e-20) * (ns * rd).sum(-1).abs(), 1e-20)
            else:
                p_t = I.PDF[al.tid](self._rows_at(al.tid, local), ro, rd, t, ns)
            pdf = torch.where(gidx == g, p_t, pdf)
        return pdf / n_lights

    def is_emissive_lane(self, gidx):
        m = torch.zeros_like(gidx, dtype=torch.bool)
        for g in self.emissive_globals:
            m = m | (gidx == g)
        return m

    def emissive_le(self, gidx, n, wo):
        """Le of the hit emissive shape, front face only."""
        le = torch.zeros_like(wo)
        front = (wo * n).sum(-1) >= 0.0
        for g, al in self.emissive_globals.items():
            le_g = torch.where(front[:, None], al.color, 0.0)
            le = torch.where((gidx == g)[:, None], le_g, le)
        return le


def check_ported(shape):
    """Refuse shapes the port cannot render yet."""
    if shape.type_id not in S.PARAM_WIDTH and not isinstance(shape, S.Mesh):
        raise NotImplementedError(
            f"{type(shape).__name__} is not ported yet (ROADMAP.md, modules item 9)"
        )
    return shape

