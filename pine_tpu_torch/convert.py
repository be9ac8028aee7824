"""The compiled scene as flat host arrays, and the device scene built from them.

``scene_arrays(scene)`` flattens a port Scene; ``compiled_scene_from_arrays``
uploads such a dict once and returns the CompiledScene the renderer reads.
The format is plain numpy, so the same geometry can come from pine_tpu's
compiled scene (its tests flatten one into this dict; ``material_record``
takes pine_tpu's materials too): both packages then trace identical rows in
identical order, and entity ids compare directly.

Keys (``i`` counts from 0):

- ``g_type``, ``g_local``, ``g_mat``: int32 (n_global,) per scene geometry.
  A Mesh is one geometry with ``g_type == MESH_TYPE`` (11) and ``g_local``
  its index among the meshes; its triangles live only in the triangle
  group below.  Each instance of a lazy instancing is one geometry too
  (``MESH_TYPE``, ``g_local`` 0), after the scene's other geometries;
- ``table.<tid>`` float32 (n, w) and ``type_global.<tid>`` int32 (n,): the
  per-type parameter rows (unsnapped) and their geometry ids;
- ``world_lo`` float32 (3,) and ``world_span``: the scene's bounds (lazy
  instances by their mesh box's corners), which key the coherence sort's
  origin cells;
- ``n_groups``; ``group.<i>.tid``, ``.kind`` ("dense" or "bvh"), ``.base``,
  ``.rows`` float32 (rows, w) as traversed (leaf order, lattice-snapped, pad
  rows included), ``.prim_aabbs`` float32 (n, 6), ``.lattice``: None, or the
  group's lattice model as a dict (accel/packet._detect_lattice: ``ni``,
  ``nj``, ``K``, ``base``, ``dU``, ``dV``, ``gu``, ``gv``, ``u0``, ``v0``,
  ``r_u``, ``r_v``, ``cap_u``, ``cap_v``, and ``slot_of_k`` int32 (n,), the
  group's row of each lattice index; ``carry_lattice`` takes pine_tpu's);
  a "bvh" group also its SAH tree from the C++ builder, ``.c_lower``,
  ``.c_upper`` float32 (M, 2, 3), ``.c_node``, ``.c_start``, ``.c_count``
  int32 (M, 2) (pine_tpu's ``nodes_np``), which the BVH walk reads;
  ``ent_gidx`` int32: entity -> geometry.  No groups for 24 or fewer
  analytic prims, no mesh and no lazy instancing.  The triangles of all
  meshes form one group of ``tid`` 6 (triangle rows [v0, v1, v2, geometric
  normal]) after the analytic groups;
- ``n_inst_groups``; per lazy instancing (accel/packet._instanced_group)
  ``inst.<i>.tid`` (6), ``.vbase``, ``.stride``, ``.n_tris`` (T),
  ``.n_inst`` (I): hits carry virtual ids vbase + instance * stride + tri;
  the mesh in its own SAH leaf order: ``.rows`` float32 (T + 4, 12) (4
  zero pad rows), ``.prim_aabbs`` (T, 6), ``.tri_n`` (T + 4, 9), ``.tri_t``
  (T + 4, 6), ``.tri_has_n``, ``.tri_has_t`` bool (T + 4,); the SAH tree
  over the instances' world boxes: ``.ic_lower``, ``.ic_upper`` float32
  (M, 2, 3), ``.ic_node``, ``.ic_start``, ``.ic_count`` int32 (M, 2); in
  that tree's instance order: ``.iboxes`` float32 (I, 6) world boxes,
  ``.minv`` (world -> local) and ``.m`` (local -> world) float32 (I + 4,
  12) 3x4 row-major, ``.gidx`` int32 (I + 4,) the instances' geometries (4
  zero pad rows each);
- with meshes, entity-order tables (LEAF_MAX zero rows at the end):
  ``ent_param`` float32 (E, 32) each entity's row, zero-padded;
  ``geom_n`` float32 (E, 3) triangle geometric normals; ``tri_n`` float32
  (E, 9) and ``tri_t`` (E, 6) the three vertex normals and texcoords;
  ``tri_has_n``, ``tri_has_t`` bool (E,) whether the mesh had them;
- ``n_materials``; ``mat.<i>.tag``; for each parameter (``albedo``,
  ``roughness``, ``metallic``, ``transmission``, ``ior``, ``color``; one
  missing takes materials.PARAMS' value) either ``mat.<i>.<param>``, a
  constant (albedo and color (3,), the others scalars), or
  ``mat.<i>.<param>.node``, a node tree as a JSON string: ``["const",
  value]``, ``["uv"]``, ``[op, a, b]`` for op in + - * / ^, ``["texture",
  p, k]`` reading image ``k``;
- ``n_images``; ``image.<k>`` float32 (H, W, C), the texture images the
  node trees read, each once;
- ``n_lights``, in pine_tpu's order: the scene's point and directional
  lights as added, then the emissive shapes in geometry order;
  ``light.<i>.kind`` ("point", "directional", "area" or "mesh"); a point
  light has ``.position`` and ``.color``; a directional light
  ``.direction`` (unit, float32) and ``.color``; an area light ``.tid``,
  ``.params``, ``.gidx`` and ``.color``; a mesh light ``.tris`` float32
  (F, 9) (the mesh's triangles [v0, v1, v2] in mesh order), ``.gidx`` and
  ``.color``;
- optional camera: ``cam.position`` (3,), ``cam.rot`` (3,3) camera-to-world,
  ``cam.fov2d`` (2,), ``cam.len_radius``, ``cam.focus_distance``.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from pine_tpu_torch.accel.dense_traverse import route
from pine_tpu_torch.accel.inst_traverse import route_inst, upload_inst_group
from pine_tpu_torch.accel.lattice_traverse import lattice_layout
from pine_tpu_torch.accel.packet import box_corners, build_packet_accel, instancing_record
from pine_tpu_torch.core.place import resolve_device
from pine_tpu_torch.scene import lights as L
from pine_tpu_torch.scene import materials as M
from pine_tpu_torch.scene import nodes as N
from pine_tpu_torch.scene import shapes as S
from pine_tpu_torch.scene.scene import BIG, CompiledScene, check_ported

DENSE_SCENE_MAX = 24  # scenes with more prims than this (or a mesh) use the prim groups
GROUP_KEYS = ("tid", "kind", "base", "rows", "prim_aabbs", "lattice")
NODE_KEYS = ("c_lower", "c_upper", "c_node", "c_start", "c_count")  # "bvh" groups
MESH_KEYS = ("ent_param", "geom_n", "tri_n", "tri_t", "tri_has_n", "tri_has_t")
INST_KEYS = ("tid", "vbase", "stride", "n_tris", "n_inst", "rows", "prim_aabbs", "tri_n",
             "tri_t", "tri_has_n", "tri_has_t", "ic_lower", "ic_upper", "ic_node", "ic_start",
             "ic_count", "iboxes", "minv", "m", "gidx")


def scene_arrays(scene) -> dict:
    """Flatten a Scene (shapes, used materials, lights, camera) to host arrays."""
    a = {}
    mat_slots, mat_of = [], {}

    def mat_slot(mat):
        if id(mat) not in mat_of:
            mat_of[id(mat)] = len(mat_slots)
            mat_slots.append(mat)
        return mat_of[id(mat)]

    g_type, g_local, g_mat = [], [], []
    per_type, type_global = {}, {}
    prims, meshes, area_lights = [], [], []
    world_lo = np.full(3, np.inf, np.float32)
    world_hi = np.full(3, -np.inf, np.float32)
    for shape, mat in scene.geometries:
        check_ported(shape)
        gidx = len(g_type)
        g_type.append(shape.type_id)
        g_mat.append(mat_slot(mat))
        lo, hi = shape.get_aabb()
        world_lo, world_hi = np.minimum(world_lo, lo), np.maximum(world_hi, hi)
        if isinstance(shape, S.Mesh):
            g_local.append(len(meshes))
            meshes.append((shape, gidx))
            if mat.is_emissive():
                area_lights.append(dict(kind="mesh", tris=shape.triangles(), gidx=gidx,
                                        color=N.constant_vec3(mat.color)))
            continue
        tid = shape.type_id
        rows = per_type.setdefault(tid, [])
        type_global.setdefault(tid, []).append(gidx)
        g_local.append(len(rows))
        rows.append(shape.params())
        prims.append((tid, shape.params(), gidx, (lo, hi)))
        if mat.is_emissive():
            area_lights.append(dict(kind="area", tid=tid, params=shape.params(), gidx=gidx,
                                    color=N.constant_vec3(mat.color)))
    inst_records = []
    for inst in scene.instancings:
        corners = box_corners(*inst.shape.get_aabb())
        gidx = []
        for m, mat in inst.instances:
            gidx.append(len(g_type))
            g_type.append(S.MESH_TYPE)
            g_local.append(0)
            g_mat.append(mat_slot(mat))
            wc = corners @ m[:3, :3].T + m[:3, 3]
            world_lo, world_hi = np.minimum(world_lo, wc.min(0)), np.maximum(world_hi, wc.max(0))
        inst_records.append(instancing_record(inst.shape, [m for m, _ in inst.instances], gidx))
    a["g_type"] = np.asarray(g_type, np.int32)
    a["g_local"] = np.asarray(g_local, np.int32)
    a["g_mat"] = np.asarray(g_mat, np.int32)
    for tid, rows in per_type.items():
        a[f"table.{tid}"] = np.stack(rows).astype(np.float32)
        a[f"type_global.{tid}"] = np.asarray(type_global[tid], np.int32)
    if not (np.isfinite(world_lo).all() and np.isfinite(world_hi).all()):
        world_lo, world_hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    a["world_lo"] = world_lo.astype(np.float32)
    a["world_span"] = np.asarray(max(float(np.max(world_hi - world_lo)), 1e-6))

    use_accel = meshes or inst_records or len(prims) > DENSE_SCENE_MAX
    accel = build_packet_accel(prims, meshes, inst_records) if use_accel else None
    groups = accel["groups"] if accel else []
    a["n_groups"] = np.asarray(len(groups))
    for i, g in enumerate(groups):
        for k in GROUP_KEYS + (NODE_KEYS if g["kind"] == "bvh" else ()):
            a[f"group.{i}.{k}"] = g[k] if k == "lattice" else np.asarray(g[k])
    inst_groups = accel["inst_groups"] if accel else []
    a["n_inst_groups"] = np.asarray(len(inst_groups))
    for i, g in enumerate(inst_groups):
        for k in INST_KEYS:
            a[f"inst.{i}.{k}"] = np.asarray(g[k])
    for k in ("ent_gidx",) + MESH_KEYS:
        if accel and k in accel:
            a[k] = accel[k]

    a["n_materials"] = np.asarray(len(mat_slots))
    images = []
    for i, mat in enumerate(mat_slots):
        a.update({f"mat.{i}.{k}": v for k, v in material_record(M.check_ported(mat), images)
                  .items()})
    a["n_images"] = np.asarray(len(images))
    a.update({f"image.{k}": im for k, im in enumerate(images)})

    lights = [light_record(li) for li in scene.lights] + area_lights
    a["n_lights"] = np.asarray(len(lights))
    for i, li in enumerate(lights):
        for k, v in li.items():
            a[f"light.{i}.{k}"] = np.asarray(v)

    cam = scene.camera
    if cam is not None:
        a["cam.position"] = cam.position
        a["cam.rot"] = cam.c2w[:3, :3].copy()
        a["cam.fov2d"] = cam.fov2d
        a["cam.len_radius"] = np.asarray(cam.len_radius)
        a["cam.focus_distance"] = np.asarray(cam.focus_distance)
    return a


def node_spec(node, images):
    """A node tree (of the port's nodes or pine_tpu's, by class name) as a
    JSON-able spec (module docstring); texture images are appended to
    ``images`` once each."""
    kind = type(node).__name__
    if not hasattr(node, "eval"):  # a plain value (pine_tpu's Uber keeps ior as a float)
        return ["const", np.asarray(node, np.float32).tolist()]
    if kind == "Constant":
        return ["const", np.asarray(node.value, np.float32).tolist()]
    if kind == "UV":
        return ["uv"]
    if kind == "Binary":
        return [node.op, node_spec(node.a, images), node_spec(node.b, images)]
    if kind == "Texture":
        image = np.array(node.image, np.float32)  # a copy: pine_tpu's are read-only
        k = next((k for k, im in enumerate(images) if np.array_equal(im, image)), None)
        if k is None:
            images.append(image)
            k = len(images) - 1
        return ["texture", node_spec(node.p, images), k]
    raise NotImplementedError(f"{kind} nodes are not ported yet (ROADMAP.md, modules item 10)")


def node_of(spec, images):
    """The port's node of a spec of ``node_spec``; ``images`` (H,W,C) arrays."""
    if spec[0] == "const":
        return N.Constant(spec[1])
    if spec[0] == "uv":
        return N.UV()
    if spec[0] == "texture":
        return N.Texture(node_of(spec[1], images), images[spec[2]])
    return N.Binary(spec[0], node_of(spec[1], images), node_of(spec[2], images))


def material_record(mat, images) -> dict:
    """One material (the port's, or pine_tpu's by its attributes) as the
    ``mat.<i>.*`` keys without their prefix: ``tag``, and each parameter a
    constant or a ``.node`` spec (module docstring)."""
    rec = {"tag": np.asarray(mat.tag)}
    for name, default in M.PARAMS.items():
        spec = node_spec(getattr(mat, name, default), images)
        if spec[0] != "const":
            rec[f"{name}.node"] = np.asarray(json.dumps(spec))
        elif name in ("albedo", "color"):
            rec[name] = np.broadcast_to(np.asarray(spec[1], np.float32).reshape(-1), (3,)).copy()
        else:
            rec[name] = np.asarray(np.asarray(spec[1], np.float32).reshape(-1)[0])
    return rec


def light_record(li) -> dict:
    """A scene light (the port's, or pine_tpu's by its attributes) as the
    ``light.<i>.*`` keys without their prefix."""
    kind = type(li).__name__
    if kind == "PointLight":
        return dict(kind="point", position=li.position, color=li.color)
    if kind == "DirectionalLight":
        return dict(kind="directional", direction=li.direction, color=li.color)
    raise NotImplementedError(f"{kind} is not ported yet (ROADMAP.md, modules item "
                              f"{3 if kind == 'SpotLight' else 10})")


def carry_lattice(lat):
    """A lattice model in this format from pine_tpu's group dict (host arrays
    and Python scalars; its ``_latf``, ``_slot`` and ``_max_seg`` kernel
    inputs are dropped), or None."""
    if lat is None:
        return None
    return {k: v if isinstance(v, (int, float)) else np.asarray(v)
            for k, v in lat.items() if not k.startswith("_")}


def upload_group(g: dict, device, small_kernel=None, mesh_kernel=None) -> dict:
    """One prim group as the traversal reads it: the host group of
    ``build_packet_accel`` (tid, kind, base, rows, prim_aabbs, lattice, and
    for a "bvh" group its node arrays, kept on the host as ``nodes``) with
    ``rows`` and the group box ``gbox`` (6,) as float32 tensors on
    ``device``; for a lattice group the lattice kernel's table ``lat``
    (accel/lattice_traverse.lattice_layout), built for any size, so that the
    march can be forced on a group the dense sweep takes by default; and the
    tables of the group's route under the settings
    (accel/dense_traverse.route).  Everything is uploaded here, once, never
    per query."""
    pa = np.asarray(g["prim_aabbs"], np.float32)
    gbox = (np.concatenate([pa[:, 0:3].min(0), pa[:, 3:6].max(0)]) if len(pa)
            else np.array([-BIG] * 3 + [BIG] * 3))
    rows = np.array(g["rows"], np.float32)
    out = dict(
        tid=int(g["tid"]), kind=str(g["kind"]), base=int(g["base"]),
        rows=torch.as_tensor(rows, device=device),
        prim_aabbs=pa, gbox=torch.as_tensor(gbox.astype(np.float32), device=device),
        lattice=g["lattice"],
        nodes={k: g[k] for k in NODE_KEYS} if all(k in g for k in NODE_KEYS) else None,
    )
    if g["lattice"]:
        out["lat"] = lattice_layout(g["lattice"], rows.shape[1], device)
    route([out], small_kernel, mesh_kernel)
    return out


def compiled_scene_from_arrays(arrays: dict, device=None, small_kernel=None,
                               mesh_kernel=None, inst_kernel=None) -> CompiledScene:
    """Upload the arrays of ``scene_arrays``'s format to ``device`` (default:
    the card) and return the CompiledScene, its groups routed under the
    settings ``small_kernel``, ``mesh_kernel`` and ``inst_kernel``
    (CompiledScene)."""
    dev = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    tids = sorted(int(k.split(".")[1]) for k in arrays if k.startswith("table."))
    tables = {tid: t(arrays[f"table.{tid}"], torch.float32) for tid in tids}
    type_global = {tid: t(arrays[f"type_global.{tid}"], torch.int32) for tid in tids}

    unified = None
    n_groups = int(arrays["n_groups"])
    n_inst = int(arrays.get("n_inst_groups", 0))
    if n_groups or n_inst:
        groups = [upload_group({k: arrays[k2] for k in GROUP_KEYS + NODE_KEYS
                                if (k2 := f"group.{i}.{k}") in arrays}, dev, small_kernel,
                               mesh_kernel) for i in range(n_groups)]
        inst_groups = [upload_inst_group({k: arrays[f"inst.{i}.{k}"] for k in INST_KEYS}, dev)
                       for i in range(n_inst)]
        route_inst(inst_groups, inst_kernel)
        unified = dict(groups=groups, inst_groups=inst_groups,
                       ent_gidx=t(arrays["ent_gidx"], torch.int32))
        unified.update({k: t(arrays[k]) for k in MESH_KEYS if k in arrays})

    images = [arrays[f"image.{k}"] for k in range(int(arrays.get("n_images", 0)))]
    materials = []
    for i in range(int(arrays["n_materials"])):
        mat = {"tag": int(arrays[f"mat.{i}.tag"])}
        for name, default in M.PARAMS.items():
            key = f"mat.{i}.{name}"
            mat[name] = (node_of(json.loads(str(arrays[key + ".node"])), images)
                         if key + ".node" in arrays else N.Constant(arrays.get(key, default)))
        materials.append(mat)

    lights = []
    for i in range(int(arrays["n_lights"])):
        get = lambda k: arrays[f"light.{i}.{k}"]  # noqa: E731
        kind = str(get("kind"))
        if kind == "point":
            lights.append(L.PointLight(get("position"), get("color")))
        elif kind == "directional":
            lights.append(L.DirectionalLight.unit(get("direction"), get("color")))
        elif kind == "mesh":
            lights.append(L.MeshLight(get("tris"), int(get("gidx")),
                                      t(get("color"), torch.float32), dev))
        else:
            lights.append(L.AreaLight(
                int(get("tid")), t(get("params"), torch.float32), int(get("gidx")),
                t(get("color"), torch.float32),
            ))

    camera = None
    if "cam.position" in arrays:
        camera = dict(
            position=t(arrays["cam.position"], torch.float32),
            rot=t(arrays["cam.rot"], torch.float32),
            fov2d=t(arrays["cam.fov2d"], torch.float32),
            len_radius=float(arrays["cam.len_radius"]),
            focus_distance=float(arrays["cam.focus_distance"]),
        )
    return CompiledScene(
        dev, t(arrays["g_type"], torch.int32), t(arrays["g_local"], torch.int32),
        t(arrays["g_mat"], torch.int32), tables, type_global, unified, materials,
        lights, camera, t(arrays["world_lo"], torch.float32), float(arrays["world_span"]),
        (small_kernel, mesh_kernel, inst_kernel),
    )
