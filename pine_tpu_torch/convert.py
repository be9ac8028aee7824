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
  ``roughness``, ``metallic``, ``transmission``, ``ior``, ``color``,
  ``sigma_s``; one missing takes materials.PARAMS' value) either
  ``mat.<i>.<param>``, a constant (albedo, color and sigma_s (3,), the
  others scalars), or ``mat.<i>.<param>.node``, a node tree as a JSON
  string (``node_spec``): ``["const", value]``, ``["uv"]``,
  ``["position"]``, ``["normal"]``, ``[op, a, b]`` for op in + - * / ^,
  ``["unary", op, a]`` for op in - s r f, ``["lerp", t, a, b]``,
  ``["checker", p, ratio]``, ``["noisef", p, octaves]``, ``["noise3f", p,
  octaves]``, ``["comp", p, index]``, ``["vec3", a...]``, ``["texture", p,
  k]`` reading image ``k``, ``["function", k]`` Function node ``k``;
- ``n_images``; ``image.<k>`` float32 (H, W, C), the texture images the
  node trees read, each once; ``n_functions``; ``function.<k>`` the
  Function nodes they read (objects: a closure has no array form);
- ``n_lights``, in pine_tpu's order: the scene's point, spot and
  directional lights as added, then the emissive shapes in geometry order,
  then the environment light; ``light.<i>.kind`` ("point", "spot",
  "directional", "area", "mesh", "sky", "atmosphere" or "imagesky"); a
  point light has ``.position`` and ``.color``; a spot light ``.position``,
  ``.direction`` (unit, float32), ``.color``, ``.falloff_cos`` and
  ``.cutoff_cos``; a directional light ``.direction`` (unit, float32) and
  ``.color``; an area light ``.tid``, ``.params``, ``.gidx`` and its color
  as a material parameter (``.color`` or ``.color.node``); a mesh light
  ``.tris`` float32 (F, 9) (the mesh's triangles [v0, v1, v2] in mesh
  order), ``.gidx`` and its color likewise; a sky ``.sun_color``; an
  atmosphere ``.sun_direction`` (unit, float32), ``.sun_color`` and its
  importance map as ``.pdf_img`` (h, w), ``.cdf_marg`` (h,) and
  ``.cdf_cond`` (h, w) (scene/env_lights.Distribution2D); an image sky
  ``.image`` (H, W, 3), ``.tint``, ``.l2w`` (3, 3) (absent when it is not
  rotated) and its map likewise;
- optional camera: ``cam.position`` (3,), ``cam.rot`` (3,3) camera-to-world,
  ``cam.fov2d`` (2,), ``cam.len_radius``, ``cam.focus_distance``;
- the shapes and media that are no rows, as the port's objects (``carry``
  makes them from pine_tpu's): ``n_sdf``, ``sdf.<i>`` an SDFShape and
  ``sdf.<i>.gidx`` its geometry (``g_type`` SDF_TYPE); ``n_csg``,
  ``csg.<i>`` a CSG tree (scene/csg.py) and ``csg.<i>.gidx`` (``g_type``
  -1); ``n_media``, ``medium.<i>`` a HomogeneousMedium or GridMedium
  (scene/media.py), in the scene's order.

Without groups (24 or fewer analytic prims, no mesh, no lazy instancing)
each ``table.<tid>`` becomes a group of its own on the upload
(``type_group``), on the dense kernel (lines on the "plain" route).
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
from pine_tpu_torch.scene.csg import CSGShape
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

    images, fns = [], []
    g_type, g_local, g_mat = [], [], []
    per_type, type_global = {}, {}
    prims, meshes, area_lights, sdfs, csgs = [], [], [], [], []
    world_lo = np.full(3, np.inf, np.float32)
    world_hi = np.full(3, -np.inf, np.float32)
    for shape, mat in scene.geometries:
        check_ported(shape)
        gidx = len(g_type)
        g_type.append(shape.type_id)
        g_mat.append(mat_slot(mat))
        lo, hi = shape.get_aabb()
        world_lo, world_hi = np.minimum(world_lo, lo), np.maximum(world_hi, hi)
        if isinstance(shape, (CSGShape, S.SDFShape)):
            # no row; an emissive one is no light, as in pine_tpu (no area sampling)
            listed = csgs if isinstance(shape, CSGShape) else sdfs
            g_local.append(len(listed))
            listed.append((shape, gidx))
            continue
        if isinstance(shape, S.Mesh):
            g_local.append(len(meshes))
            meshes.append((shape, gidx))
            if mat.is_emissive():
                area_lights.append(dict(kind="mesh", tris=shape.triangles(), gidx=gidx,
                                        **param_record("color", mat.color, images, fns)))
            continue
        tid = shape.type_id
        rows = per_type.setdefault(tid, [])
        type_global.setdefault(tid, []).append(gidx)
        g_local.append(len(rows))
        rows.append(shape.params())
        prims.append((tid, shape.params(), gidx, (lo, hi)))
        if mat.is_emissive():
            area_lights.append(dict(kind="area", tid=tid, params=shape.params(), gidx=gidx,
                                    **param_record("color", mat.color, images, fns)))
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
    for name, listed in (("sdf", sdfs), ("csg", csgs)):
        a[f"n_{name}"] = np.asarray(len(listed))
        for i, (shape, gidx) in enumerate(listed):
            a[f"{name}.{i}"], a[f"{name}.{i}.gidx"] = shape, np.asarray(gidx)
    a["n_media"] = np.asarray(len(scene.mediums))
    for i, med in enumerate(scene.mediums):
        if hasattr(med, "shape"):
            check_ported(med.shape)
        a[f"medium.{i}"] = med
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
    for i, mat in enumerate(mat_slots):
        a.update({f"mat.{i}.{k}": v for k, v in material_record(mat, images, fns).items()})
    a["n_images"] = np.asarray(len(images))
    a["n_functions"] = np.asarray(len(fns))
    a.update({f"function.{k}": fn for k, fn in enumerate(fns)})
    a.update({f"image.{k}": im for k, im in enumerate(images)})

    lights = [light_record(li) for li in scene.lights] + area_lights
    if scene.env_light is not None:
        lights.append(light_record(scene.env_light))
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


NODE_KINDS = {"Position": "position", "Normal": "normal", "UV": "uv"}


def node_spec(node, images, fns=None):
    """A node tree (of the port's nodes or pine_tpu's, by class name) as a
    JSON-able spec (module docstring); texture images are appended to
    ``images`` once each, the port's Function nodes to ``fns`` (a spec of a
    closure only indexes it: without ``fns`` such a node is refused)."""
    kind = type(node).__name__
    if not hasattr(node, "eval"):  # a plain value (pine_tpu's Uber keeps ior as a float)
        return ["const", np.asarray(node, np.float32).tolist()]
    if kind == "Constant":
        return ["const", np.asarray(node.value, np.float32).tolist()]
    if kind in NODE_KINDS:
        return [NODE_KINDS[kind]]
    if kind == "Binary":
        return [node.op, node_spec(node.a, images, fns), node_spec(node.b, images, fns)]
    if kind == "Unary":
        return ["unary", node.op, node_spec(node.a, images, fns)]
    if kind == "Lerp":
        return ["lerp"] + [node_spec(x, images, fns) for x in (node.t, node.a, node.b)]
    if kind == "Checkerboard":
        return ["checker", node_spec(node.p, images, fns), float(node.ratio)]
    if kind in ("Noisef", "Noise3f"):
        return [kind.lower(), node_spec(node.p, images, fns), node_spec(node.octaves, images, fns)]
    if kind == "Component":
        return ["comp", node_spec(node.p, images, fns), int(node.index)]
    if kind == "ToVec3":
        return ["vec3"] + [node_spec(x, images, fns) for x in node.args]
    if kind == "Texture":
        image = np.array(node.image, np.float32)  # a copy: pine_tpu's are read-only
        k = next((k for k, im in enumerate(images) if np.array_equal(im, image)), None)
        if k is None:
            images.append(image)
            k = len(images) - 1
        return ["texture", node_spec(node.p, images, fns), k]
    if kind == "Function":
        if fns is None or not isinstance(node, N.Function):
            raise NotImplementedError(
                "a Function node wraps a script closure, which a node spec cannot carry: "
                "build the node in this package (run the same script through its interpreter)")
        fns.append(node)
        return ["function", len(fns) - 1]
    raise NotImplementedError(f"{kind} nodes have no spec")


def node_of(spec, images, fns=()):
    """The port's node of a spec of ``node_spec``; ``images`` (H,W,C) arrays,
    ``fns`` the Function nodes it indexes."""
    kind, args = spec[0], spec[1:]
    sub = lambda x: node_of(x, images, fns)  # noqa: E731
    if kind == "function":
        return fns[args[0]]
    if kind == "const":
        return N.Constant(args[0])
    if kind in ("position", "normal", "uv"):
        return {"position": N.Position, "normal": N.Normal, "uv": N.UV}[kind]()
    if kind == "texture":
        return N.Texture(sub(args[0]), images[args[1]])
    if kind == "unary":
        return N.Unary(args[0], sub(args[1]))
    if kind == "lerp":
        return N.Lerp(*map(sub, args))
    if kind == "checker":
        return N.Checkerboard(sub(args[0]), args[1])
    if kind == "noisef":
        return N.Noisef(sub(args[0]), sub(args[1]))
    if kind == "noise3f":
        return N.Noise3f(sub(args[0]), sub(args[1]))
    if kind == "comp":
        return N.Component(sub(args[0]), args[1])
    if kind == "vec3":
        return N.ToVec3(*map(sub, args))
    return N.Binary(kind, sub(args[0]), sub(args[1]))


VEC3_PARAMS = ("albedo", "color", "sigma_s")


def param_record(name, node, images, fns=None):
    """One node parameter as record keys: ``name`` the constant ((3,) for
    VEC3_PARAMS, else a scalar), or ``name.node`` its spec as JSON."""
    spec = node_spec(node, images, fns)
    if spec[0] != "const":
        return {f"{name}.node": np.asarray(json.dumps(spec))}
    if name in VEC3_PARAMS:
        return {name: np.broadcast_to(np.asarray(spec[1], np.float32).reshape(-1), (3,)).copy()}
    return {name: np.asarray(np.asarray(spec[1], np.float32).reshape(-1)[0])}


def param_of(rec, name, images, default, fns=()):
    """The node of a parameter recorded by ``param_record`` in the keys of
    ``rec`` (a mapping), or Constant(``default``) where it is absent."""
    if f"{name}.node" in rec:
        return node_of(json.loads(str(rec[f"{name}.node"])), images, fns)
    return N.Constant(rec[name] if name in rec else default)


def material_record(mat, images, fns=None) -> dict:
    """One material (the port's, or pine_tpu's by its attributes) as the
    ``mat.<i>.*`` keys without their prefix: ``tag``, and each parameter a
    constant or a ``.node`` spec (module docstring)."""
    rec = {"tag": np.asarray(mat.tag)}
    for name, default in M.PARAMS.items():
        rec.update(param_record(name, getattr(mat, name, default), images, fns))
    return rec


def distr_record(distr):
    """An environment light's importance map (its Distribution2D, the
    port's or pine_tpu's) as record keys."""
    return {k: np.asarray(getattr(distr, k), np.float32)
            for k in ("pdf_img", "cdf_marg", "cdf_cond")}


def light_record(li) -> dict:
    """A scene light (the port's, or pine_tpu's by its attributes) as the
    ``light.<i>.*`` keys without their prefix."""
    kind = type(li).__name__
    if kind == "PointLight":
        return dict(kind="point", position=li.position, color=li.color)
    if kind == "SpotLight":
        return dict(kind="spot", position=li.position, direction=li.direction, color=li.color,
                    falloff_cos=li.falloff_cos, cutoff_cos=li.cutoff_cos)
    if kind == "DirectionalLight":
        return dict(kind="directional", direction=li.direction, color=li.color)
    if kind == "Sky":
        return dict(kind="sky", sun_color=li.sun_color)
    if kind == "Atmosphere":
        return dict(kind="atmosphere", sun_direction=li.sun_direction, sun_color=li.sun_color,
                    **distr_record(li.distr))
    if kind == "ImageSky":
        rec = dict(kind="imagesky", image=np.asarray(li.image, np.float32), tint=li.tint,
                   **distr_record(li.distr))
        if li.l2w is not None:
            rec["l2w"] = np.asarray(li.l2w, np.float32)
        return rec
    raise TypeError(f"{kind} is not a light")


def light_of(rec, images, device, fns=()):
    """The port's light of a ``light.<i>.*`` record (keys without the prefix)."""
    from pine_tpu_torch.scene import env_lights as E

    kind = str(rec["kind"])
    if kind == "point":
        return L.PointLight(rec["position"], rec["color"])
    if kind == "spot":
        return L.SpotLight.of_record(rec["position"], rec["direction"], rec["color"],
                                     rec["falloff_cos"], rec["cutoff_cos"])
    if kind == "directional":
        return L.DirectionalLight.unit(rec["direction"], rec["color"])
    if kind == "sky":
        return L.Sky(rec["sun_color"])
    if kind in ("atmosphere", "imagesky"):
        distr = E.Distribution2D(rec["pdf_img"], rec["cdf_marg"], rec["cdf_cond"])
        if kind == "atmosphere":
            return E.Atmosphere(rec["sun_direction"], rec["sun_color"], distr=distr)
        return E.ImageSky(rec["image"], rec["tint"], distr=distr, l2w=rec.get("l2w"))
    color = param_of(rec, "color", images, M.PARAMS["color"], fns)
    if kind == "mesh":
        return L.MeshLight(rec["tris"], int(rec["gidx"]), color, device)
    return L.AreaLight(int(rec["tid"]), torch.as_tensor(np.array(rec["params"]), device=device),
                       int(rec["gidx"]), color)


def carry(x):
    """The port's counterpart of one of pine_tpu's shapes (a CSG tree, its
    analytic leaves, an SDFShape whose ``fn`` is kept as it is), phase
    functions or media, by class name, every attribute carried as it is
    (host arrays and Python scalars; a grid medium's device grids as numpy
    arrays).  A medium's shape and phase function are carried too."""
    import importlib

    kind = type(x).__name__
    for mod in ("scene.csg", "scene.shapes", "scene.media"):
        cls = getattr(importlib.import_module(f"pine_tpu_torch.{mod}"), kind, None)
        if cls is not None:
            break
    else:
        raise TypeError(f"nothing of the port carries a {kind}")
    out = cls.__new__(cls)
    for k, v in vars(x).items():
        if k in ("a", "b", "base", "shape", "pf", "l0", "l1"):
            v = carry(v)
        elif hasattr(v, "__array__") and not isinstance(v, np.ndarray):
            v = np.asarray(v)  # a device array of pine_tpu's
        out.__dict__[k] = v
    if kind in ("GridMedium", "VDBMedium"):
        out.res_f = np.asarray(out.res, np.float32)
        if out.temperature is not None:
            out.bb_table = np.asarray(out.bb_table, np.float32)
    return out


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


def _prefixed(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


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

    type_groups = []
    if unified is None:
        type_groups = [type_group(tid, tables[tid]) for tid in tids]
        route(type_groups)

    images = [arrays[f"image.{k}"] for k in range(int(arrays.get("n_images", 0)))]
    fns = [arrays[f"function.{k}"] for k in range(int(arrays.get("n_functions", 0)))]
    materials = []
    for i in range(int(arrays["n_materials"])):
        rec = _prefixed(arrays, f"mat.{i}.")
        materials.append({"tag": int(rec["tag"]), **{name: param_of(rec, name, images, default, fns)
                                                     for name, default in M.PARAMS.items()}})
    lights = [light_of(_prefixed(arrays, f"light.{i}."), images, dev, fns)
              for i in range(int(arrays["n_lights"]))]

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
        *([(arrays[f"{name}.{i}"], int(arrays[f"{name}.{i}.gidx"]))
           for i in range(int(arrays.get(f"n_{name}", 0)))] for name in ("sdf", "csg")),
        [arrays[f"medium.{i}"] for i in range(int(arrays.get("n_media", 0)))], type_groups,
    )


def type_group(tid, table):
    """One per-type table of a scene without groups as a group of its own,
    every lane tested against every row (a group box that culls nothing):
    pine_tpu's brute-force product over that table, on the dense kernel."""
    n = table.shape[0]
    box = torch.tensor([-BIG] * 3 + [BIG] * 3, dtype=torch.float32, device=table.device)
    return dict(tid=tid, kind="dense", base=0, rows=table, gbox=box, lattice=None, nodes=None,
                prim_aabbs=np.zeros((n, 6), np.float32))


def guide_state(arrays, device=None):
    """The guided integrator's guide state on ``device`` from host arrays:
    a "tree" structure's arenas (integrators/guiding_tree.TREE_KEYS: int
    ``schild``, ``sdroot``, ``dchild`` as int64, float32 ``dflux``,
    ``dcoll``, ``scount``; the port's GuidingTree.arrays(), or pine_tpu's
    GuidingTree's ``_arrays``) with both trees' depths (``sdepth``,
    ``ddepth``: taken from the arrays when they are not given), or a "grid"
    structure's ``hist`` (cells, 256) float32."""
    from pine_tpu_torch.integrators.guiding_tree import TREE_KEYS, arena_depths

    dev = resolve_device(device)
    if "hist" in arrays:
        return {"hist": torch.as_tensor(np.asarray(arrays["hist"], np.float32), device=dev)}
    out = {k: torch.as_tensor(np.asarray(arrays[k]), device=dev) for k in TREE_KEYS}
    for k in ("schild", "sdroot", "dchild"):
        out[k] = out[k].long()
    if "sdepth" in arrays:
        out["sdepth"], out["ddepth"] = int(arrays["sdepth"]), int(arrays["ddepth"])
    else:
        out["sdepth"], out["ddepth"] = arena_depths(arrays["schild"], arrays["sdroot"],
                                                    arrays["dchild"])
    return out
