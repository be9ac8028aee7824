"""Minimal GLB (binary glTF 2.0) importer.  Counterpart of pine_tpu/io/gltf.py
(parity: core/fileio.cpp:146-571).

Pure Python (json, struct, numpy): meshes (POSITION, NORMAL and TEXCOORD_0
accessors, u8/u16/u32 indices), the recursive node transform tree (a matrix,
or translation-rotation-scale with a quaternion) and pbrMetallicRoughness
materials (base color factor and texture, metallic, roughness -> Uber;
emissive -> Emissive), the subset the reference reads.  Embedded PNG
textures decode through io/image_io.decode_png, converted to RGB and
sRGB-decoded (/255, then **2.2) as pine_tpu's importer converts them.
"""
from __future__ import annotations

import json
import struct

import numpy as np

from pine_tpu_torch.io.image_io import decode_png, rgb_of
from pine_tpu_torch.scene import materials as M
from pine_tpu_torch.scene import nodes as N
from pine_tpu_torch.scene.shapes import Mesh

_COMP_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def parse_glb(data: bytes):
    """-> (gltf_json, bin_chunk)."""
    magic, _version, length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file")
    off = 12
    gltf = None
    binary = b""
    while off < length:
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off:off + clen]
        off += clen
        if ctype == 0x4E4F534A:  # JSON
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # BIN
            binary = chunk
    return gltf, binary


class _Reader:
    def __init__(self, gltf, binary):
        self.gltf = gltf
        self.binary = binary

    def accessor(self, idx):
        acc = self.gltf["accessors"][idx]
        bv = self.gltf["bufferViews"][acc["bufferView"]]
        dtype = _COMP_DTYPE[acc["componentType"]]
        ncomp = _TYPE_COUNT[acc["type"]]
        count = acc["count"]
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        if stride and stride != itemsize:
            return np.stack([np.frombuffer(self.binary, dtype, ncomp, offset + i * stride)
                             for i in range(count)])
        return np.frombuffer(self.binary, dtype, count * ncomp, offset).reshape(count, ncomp)

    def image(self, idx):
        """Embedded image ``idx`` as sRGB-decoded float32 (H,W,3)."""
        img = self.gltf["images"][idx]
        bv = self.gltf["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        raw = self.binary[off:off + bv["byteLength"]]
        arr = np.asarray(rgb_of(decode_png(raw)), np.float32) / 255.0
        return arr**2.2  # sRGB decode for base-color textures


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major in file
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        s = np.asarray(node["scale"], np.float32)
        m = np.diag(np.append(s, 1.0)).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        # quaternion (x,y,z,w) -> rotation matrix
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _material_of(gltf, reader, prim, textures_cache):
    midx = prim.get("material")
    if midx is None:
        return M.Diffuse(N.Constant([0.8, 0.8, 0.8]))
    mat = gltf["materials"][midx]
    emissive = np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32)
    if emissive.max() > 0:
        return M.Emissive(N.Constant(emissive))
    pbr = mat.get("pbrMetallicRoughness", {})
    base = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)[:3]
    metallic = float(pbr.get("metallicFactor", 1.0))
    roughness = float(pbr.get("roughnessFactor", 1.0))
    albedo_node = N.Constant(base)
    tex = pbr.get("baseColorTexture")
    if tex is not None:
        tidx = tex["index"]
        if tidx not in textures_cache:
            textures_cache[tidx] = reader.image(gltf["textures"][tidx]["source"])
        albedo_node = N.Texture(N.UV(), textures_cache[tidx]) * N.Constant(base)
    return M.Uber(albedo_node, N.Constant(roughness), N.Constant(metallic))


def iter_glb_meshes(filename_or_bytes, transform=None):
    """[(Mesh, Material)] per primitive, with node transforms applied."""
    if isinstance(filename_or_bytes, (bytes, bytearray)):
        data = bytes(filename_or_bytes)
    else:
        with open(filename_or_bytes, "rb") as f:
            data = f.read()
    gltf, binary = parse_glb(data)
    reader = _Reader(gltf, binary)
    textures_cache = {}
    base = np.eye(4, dtype=np.float32) if transform is None else np.asarray(transform, np.float32)

    scene_idx = gltf.get("scene", 0)
    roots = gltf["scenes"][scene_idx]["nodes"] if "scenes" in gltf else range(len(gltf["nodes"]))

    out = []

    def walk(node_idx, parent_m):
        node = gltf["nodes"][node_idx]
        m = parent_m @ _node_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                attrs = prim["attributes"]
                verts = reader.accessor(attrs["POSITION"]).astype(np.float32)
                if "indices" in prim:
                    idx = reader.accessor(prim["indices"]).reshape(-1).astype(np.uint32)
                else:
                    idx = np.arange(len(verts), dtype=np.uint32)
                normals = (reader.accessor(attrs["NORMAL"]).astype(np.float32)
                           if "NORMAL" in attrs else None)
                uvs = (reader.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                       if "TEXCOORD_0" in attrs else None)
                msh = Mesh(verts, idx.reshape(-1, 3), uvs, normals)
                msh.apply(m)
                out.append((msh, _material_of(gltf, reader, prim, textures_cache)))
        for child in node.get("children", []):
            walk(child, m)

    for r in roots:
        walk(r, base)
    return out


def load_glb_into_scene(scene, filename, transform=None):
    for mesh, mat in iter_glb_meshes(filename, transform):
        scene.add_geometry(mesh, mat)


def mesh_from_glb(filename):
    """PRL ``Mesh(file)``: all primitives merged into one mesh."""
    parts = iter_glb_meshes(filename)
    if not parts:
        raise ValueError(f"no meshes in {filename}")
    mesh = parts[0][0]
    for m, _ in parts[1:]:
        mesh.merge(m)
    return mesh
