"""Minimal NanoVDB ``.nvdb`` reader and writers.  Counterpart of
pine_tpu/io/nvdb.py (parity: the vendored
src/contrib/NanoVDB.h v32.6 + nanovdb::io, consumed by medium.cpp:152-213).

Reads uncompressed (Codec NONE) files and raw grid buffers, densifies the
named FloatGrid's LEAF values into a numpy array over the grid's index
bounding box.  Active tile values at internal levels are not expanded (cloud
/ smoke assets keep their density in leaves); ZIP/BLOSC codecs raise.

Struct layout facts hard-coded here (all little-endian):
- FileHeader: 16B  {u64 magic, u32 version, u16 gridCount, u16 codec}
- FileMetaData: 176B (NanoVDB.h:7859-7873)
- GridData: 672B (NanoVDB.h GridData, "sizeof(GridData) = 672")
- TreeData: 64B   {i64 nodeOffset[4], u32 nodeCount[3], u32 tileCount[3],
                   u64 voxelCount}
- LeafData<float, LOG2DIM=3>: 2144B = 12+3+1+64 header, 4x4 stats (offset
  80..96), 512 float values at offset 96.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC_FILE0 = 0x304244566F6E614E  # "NanoVDB0" (io::FileHeader)
MAGIC_GRID = 0x314244566F6E614E   # "NanoVDB1" (raw GridData)
MAGIC_FILE2 = 0x324244566F6E614E  # "NanoVDB2"
GRID_TYPE_FLOAT = 1
LEAF_SIZE = 2144
LEAF_VALUES_OFF = 96
LEAF_DIM = 8

FILE_META = struct.Struct(
    "<QQQQ II 6d 6i 3d I 4I 3I HH I"
)  # 176 bytes (NanoVDB.h:7859-7873)
assert FILE_META.size == 176, FILE_META.size


def _parse_grid_blob(blob, name_hint=b"density"):
    """GridData+Tree blob -> (density (X,Y,Z) float32, index_bbox (2,3) int)."""
    magic, = struct.unpack_from("<Q", blob, 0)
    if magic not in (MAGIC_GRID, MAGIC_FILE0):
        raise ValueError(f"not a NanoVDB grid blob (magic {magic:#x})")
    grid_name = blob[40 : 40 + 256].split(b"\0", 1)[0]
    grid_type, = struct.unpack_from("<I", blob, 636)
    if grid_type != GRID_TYPE_FLOAT:
        raise ValueError(f"grid '{grid_name.decode()}' is not a FloatGrid ({grid_type})")

    tree_off = 672
    node_off = struct.unpack_from("<4q", blob, tree_off)
    node_cnt = struct.unpack_from("<3I", blob, tree_off + 32)
    n_leaf = node_cnt[0]
    leaf0 = tree_off + node_off[0]

    if n_leaf == 0:
        return np.zeros((1, 1, 1), np.float32), np.zeros((2, 3), np.int64)

    raw = np.frombuffer(blob, np.uint8)
    idx = leaf0 + np.arange(n_leaf, dtype=np.int64)[:, None] * LEAF_SIZE
    # leaf origins from mBBoxMin rounded down to the 8^3 leaf lattice
    bbox_min = (
        raw[(idx + np.arange(12)[None, :])]
        .reshape(n_leaf, 12)
        .view(np.int32)
        .reshape(n_leaf, 3)
    )
    origins = bbox_min & ~(LEAF_DIM - 1)
    vals = (
        raw[(idx + LEAF_VALUES_OFF + np.arange(512 * 4)[None, :])]
        .reshape(n_leaf, 2048)
        .view(np.float32)
        .reshape(n_leaf, LEAF_DIM, LEAF_DIM, LEAF_DIM)
    )

    lo = origins.min(axis=0)
    hi = origins.max(axis=0) + LEAF_DIM
    shape = hi - lo
    dense = np.zeros(tuple(shape), np.float32)
    o = origins - lo
    for k in range(n_leaf):
        x, y, z = o[k]
        dense[x : x + LEAF_DIM, y : y + LEAF_DIM, z : z + LEAF_DIM] = vals[k]
    index_bbox = np.stack([lo, hi])
    return dense, index_bbox


def read_nvdb_density(filename, grid_name="density"):
    """-> (density (X,Y,Z) float32 normalized grid, index_bbox (2,3))."""
    with open(filename, "rb") as f:
        data = f.read()
    magic, = struct.unpack_from("<Q", data, 0)
    if magic == MAGIC_GRID:
        return _parse_grid_blob(data)
    if magic not in (MAGIC_FILE0, MAGIC_FILE2):
        raise ValueError(f"{filename}: not a NanoVDB file (magic {magic:#x})")
    version, grid_count, codec = struct.unpack_from("<IHH", data, 8)
    off = 16
    want = grid_name.encode()
    for _ in range(grid_count):
        meta = FILE_META.unpack_from(data, off)
        file_size = meta[1]
        name_size = meta[21]   # nameSize (field order per NanoVDB.h:7859-7873)
        codec_g = meta[29]
        off += FILE_META.size
        name = data[off : off + name_size].split(b"\0", 1)[0]
        off += name_size
        blob = data[off : off + file_size]
        off += file_size
        if name == want:
            if codec_g != 0:
                raise ValueError(
                    f"{filename}: codec {codec_g} (ZIP/BLOSC) not supported; "
                    "re-export uncompressed"
                )
            return _parse_grid_blob(blob, want)
    raise ValueError(f"{filename}: no grid named '{grid_name}'")


def list_nvdb_grids(filename):
    """-> list of grid names in the file (raw single-grid blobs report their
    embedded name, like nanovdb::io::hasGrid, medium.cpp:181-203)."""
    with open(filename, "rb") as f:
        data = f.read()
    magic, = struct.unpack_from("<Q", data, 0)
    if magic == MAGIC_GRID:
        return [data[40 : 40 + 256].split(b"\0", 1)[0].decode()]
    if magic not in (MAGIC_FILE0, MAGIC_FILE2):
        raise ValueError(f"{filename}: not a NanoVDB file (magic {magic:#x})")
    _, grid_count, _ = struct.unpack_from("<IHH", data, 8)
    off = 16
    names = []
    for _ in range(grid_count):
        meta = FILE_META.unpack_from(data, off)
        file_size = meta[1]
        name_size = meta[21]
        off += FILE_META.size
        names.append(data[off : off + name_size].split(b"\0", 1)[0].decode())
        off += name_size + file_size
    return names


# ---------------------------------------------------------------------------
# test-support writer: emits a minimal single-FloatGrid raw buffer with the
# same layout the reader consumes (round-trip coverage; real files from
# nanovdb tooling share these struct layouts).
# ---------------------------------------------------------------------------

def _grid_blob(name, density):
    density = np.asarray(density, np.float32)
    X, Y, Z = density.shape
    assert X % LEAF_DIM == 0 and Y % LEAF_DIM == 0 and Z % LEAF_DIM == 0
    leaves = []
    for x in range(0, X, LEAF_DIM):
        for y in range(0, Y, LEAF_DIM):
            for z in range(0, Z, LEAF_DIM):
                block = density[x : x + LEAF_DIM, y : y + LEAF_DIM, z : z + LEAF_DIM]
                leaves.append(((x, y, z), block))
    n_leaf = len(leaves)

    grid_data = bytearray(672)
    struct.pack_into("<Q", grid_data, 0, MAGIC_GRID)
    struct.pack_into("<Q", grid_data, 8, (1 << 64) - 1)  # checksum disabled
    nb = name.encode()[:255]
    grid_data[40 : 40 + len(nb)] = nb
    struct.pack_into("<I", grid_data, 636, GRID_TYPE_FLOAT)

    tree = bytearray(64)
    leaf_bytes = bytearray(n_leaf * LEAF_SIZE)
    for k, ((x, y, z), block) in enumerate(leaves):
        base = k * LEAF_SIZE
        struct.pack_into("<3i", leaf_bytes, base, x, y, z)
        leaf_bytes[base + LEAF_VALUES_OFF : base + LEAF_VALUES_OFF + 2048] = (
            np.ascontiguousarray(block, np.float32).tobytes()
        )
    struct.pack_into("<4q", tree, 0, 64, 0, 0, 0)  # leaves right after TreeData
    struct.pack_into("<3I", tree, 32, n_leaf, 0, 0)
    return bytes(grid_data) + bytes(tree) + bytes(leaf_bytes)


def write_nvdb_dense(filename, density):
    """Single raw 'density' grid blob (no file container)."""
    with open(filename, "wb") as f:
        f.write(_grid_blob("density", density))


def write_nvdb_multi(filename, grids):
    """Multi-grid file container: grids = {name: (X,Y,Z) array}.  Used to
    author emissive-volume assets (density + flames + temperature, the grid
    set the reference's VDBMedium probes, medium.cpp:181-203)."""
    parts = [struct.pack("<QIHH", MAGIC_FILE0, 0, len(grids), 0)]
    for name, arr in grids.items():
        blob = _grid_blob(name, arr)
        nb = name.encode() + b"\0"
        meta = bytearray(FILE_META.size)
        struct.pack_into("<QQ", meta, 0, len(blob), len(blob))  # gridSize, fileSize
        # nameSize lives right after {4Q, 2I, 6d, 6i, 3d} = offset 136
        struct.pack_into("<I", meta, 136, len(nb))
        parts.append(bytes(meta) + nb + blob)
    with open(filename, "wb") as f:
        f.write(b"".join(parts))
