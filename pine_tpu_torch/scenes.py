"""Scenes built through the port's Scene API.

``instanced`` is the instancing benchmark of the repository's
``bench_instanced.py``: an n_side x n_side field of instances (1,024 at the
benchmark's 32) of one bumpy-ellipsoid rock of (rock_grid-1)^2 * 2 triangles
(4,802 at its 50), on a ground plane, under one emissive rect.  The rock's
vertices and indices and the instance transforms are the benchmark's to the
bit.  The benchmark's field realizes 4.9 M triangles, so it stays lazy
(scene.FLATTEN_LIMIT); smaller fields flatten unless that limit is lowered.

``terrain`` is the mesh benchmark of the repository's ``bench_mesh.py``: a
seeded fbm heightfield of (grid-1)^2 * 2 triangles (99,458 at the benchmark's
grid of 224), one emissive rect above it, a low camera in the valley.  Its
vertices and indices are bench_mesh's to the bit.

``cbox`` is the benchmark Cornell box of the repository's ``bench.py``
(``CBOX_PRL``): five walls, a floor field of cones, a diffuse box, a metal box
and one small emissive rect, seen by a ThinLenCamera.  The cone loops follow
the script's ``for x in a ~ step ~ b`` semantics (double-precision
accumulation, the bound inclusive), so the shapes match the script's to the
bit.

``CBOX_PRL`` is that script itself, character for character, and
``CONE_FOREST_PRL`` the same box with its cone floor at twice the density
(``cone_forest_prl``): 40 x 40 = 1,600 cones of half the size over the same
extent, one lattice group of more than 512 prims, so it takes the lattice
traversal.  ``prl_scene`` runs such a script through the port's PRL
interpreter and returns its ``scene``.
"""
from __future__ import annotations

import numpy as np

from pine_tpu_torch.core.camera import ThinLenCamera
from pine_tpu_torch.core.film import Film
from pine_tpu_torch.core.vecmath import rotate_y, scale, translate
from pine_tpu_torch.scene import materials as M
from pine_tpu_torch.scene import shapes as S
from pine_tpu_torch.scene.scene import Scene

# the benchmark's cone field, as (begin, step, end) of its two loops
CONES_X = (-1.0, 0.1, 1.0)
CONES_Z = (0.0, 0.1, 2.0)

CBOX_PRL = """
scene := Scene();
image_size := [640, 640];

scene.add("floor", Diffuse([0.9, 0.9, 0.9]));
scene.add("red", Diffuse([0.9, 0.1, 0.05]));
scene.add("green", Diffuse([0.2, 0.9, 0.05]));
scene.add("metal", Metal([1, 1, 1], 0.0));
scene.add("glossy", Glossy([1, 1, 1] / 4.0, 0.05));
scene.add("skin", Subsurface([1, 1, 1], 0.0, 40.0));

scene.add(Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "floor");
scene.add(Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "floor");
scene.add(Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), "red");
scene.add(Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), "green");
scene.add(Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "floor");

for x in -1.0 ~ 0.1 ~ 1.0 {
    for z in 0.0 ~ 0.1 ~ 2.0 {
        scene.add(Cone([x, 0, z], Y, 0.05, 0.05), "floor");
    }
}
scene.add(Box(AABB([0, 0, 0], [1, 1, 1]), translate([0.0, 0.0, 0.6]) * rotate_y(0.4) * scale([0.6, 0.6, 0.6])), "floor");
scene.add(Box(AABB([0, 0, 0], [1, 1, 1]), translate([-0.6, 0.0, 1.0]) * rotate_y(-0.4) * scale([0.6, 1.3, 0.6])), "metal");

scene.add(Rect([0.0, 1.9, 0.5], [0.1, 0, 0], [0, 0, 0.1]), Emissive(600 * [1.0, 0.64, 0.185]));

scene.set(ThinLenCamera(Film(image_size, Uncharted2()), [0, 1, -4], [0, 1, 0], 0.25));
"""

# the cone forest: the benchmark box's floor at twice the density
FOREST_X = (-1.0, 0.05, 1.0)
FOREST_Z = (0.0, 0.05, 2.0)
# cut to 24 x 24 = 576 cones in the middle of the floor (as the reduced box's
# field): still over 512, so still the lattice traversal
REDUCED_FOREST = ((-0.6, 0.05, 0.56), (0.5, 0.05, 1.66))


def cone_forest_prl(forest_x=FOREST_X, forest_z=FOREST_Z, size=640):
    """CBOX_PRL with the cone loops over ``forest_x`` and ``forest_z``
    (begin, step, end), cones of radius 0.025 and height 0.05, and the film
    ``size`` pixels square."""
    (x0, dx, x1), (z0, dz, z1) = forest_x, forest_z
    src = CBOX_PRL
    for old, new in (("-1.0 ~ 0.1 ~ 1.0", f"{x0} ~ {dx} ~ {x1}"),
                     ("0.0 ~ 0.1 ~ 2.0", f"{z0} ~ {dz} ~ {z1}"),
                     ("Cone([x, 0, z], Y, 0.05, 0.05)", "Cone([x, 0, z], Y, 0.025, 0.05)"),
                     ("image_size := [640, 640];", f"image_size := [{size}, {size}];")):
        assert old in src, old
        src = src.replace(old, new)
    return src


CONE_FOREST_PRL = cone_forest_prl()


def prl_scene(src, name="<script>"):
    """The ``scene`` a PRL scene script builds, through the port's interpreter.
    Building runs on the host; a script that also renders does so where
    ``core.options.device`` says, the card unless the caller set "cpu"."""
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter()
    itp.run(src, name)
    return itp.get_var("scene")


def prl_range(begin, step, end):
    """Values of ``for v in begin ~ step ~ end``: ``v += step`` in double
    precision while ``v <= end``."""
    out = []
    v = float(begin)
    while v <= end:
        out.append(v)
        v += step
    return out


def cbox(size=(640, 640), cones_x=CONES_X, cones_z=CONES_Z):
    """The benchmark Cornell box at film ``size`` (width, height)."""
    scene = Scene()
    scene.add("floor", M.Diffuse([0.9, 0.9, 0.9]))
    scene.add("red", M.Diffuse([0.9, 0.1, 0.05]))
    scene.add("green", M.Diffuse([0.2, 0.9, 0.05]))
    scene.add("metal", M.Metal([1, 1, 1], 0.0))
    scene.add("glossy", M.Glossy(np.float32([1, 1, 1]) / np.float32(4.0), 0.05))
    scene.add("skin", M.Subsurface([1, 1, 1], 0.0, 40.0))  # declared, unused

    scene.add(S.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "floor")
    scene.add(S.Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "floor")
    scene.add(S.Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), "red")
    scene.add(S.Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), "green")
    scene.add(S.Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "floor")

    for x in prl_range(*cones_x):
        for z in prl_range(*cones_z):
            scene.add(S.Cone([x, 0, z], [0, 1, 0], 0.05, 0.05), "floor")
    unit = S.BoxAABB([0, 0, 0], [1, 1, 1])
    scene.add(S.BoxOBB(unit, translate([0.0, 0.0, 0.6]) @ rotate_y(0.4) @ scale([0.6, 0.6, 0.6])),
              "floor")
    scene.add(S.BoxOBB(unit, translate([-0.6, 0.0, 1.0]) @ rotate_y(-0.4) @ scale([0.6, 1.3, 0.6])),
              "metal")
    scene.add(S.Rect([0.0, 1.9, 0.5], [0.1, 0, 0], [0, 0, 0.1]),
              M.Emissive(np.float32(600) * np.float32([1.0, 0.64, 0.185])))
    scene.set(ThinLenCamera(Film(size, "uncharted2"), [0, 1, -4], [0, 1, 0], 0.25))
    return scene


TERRAIN_GRID = 224  # bench_mesh.py's GRID: 99,458 triangles


def make_terrain(grid=TERRAIN_GRID, size=8.0, amp=1.2, seed=7):
    """Deterministic fbm heightfield mesh -> (vertices (grid^2,3), indices)."""
    xs = np.linspace(-size / 2, size / 2, grid, dtype=np.float32)
    zs = np.linspace(0.0, size, grid, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="xy")
    rng = np.random.default_rng(seed)
    Y = np.zeros_like(X)
    for octave in range(5):
        f = 2.0 ** octave
        ph = rng.uniform(0, 2 * np.pi, 4)
        Y += (amp / f) * (
            np.sin(f * X * 1.3 + ph[0]) * np.cos(f * Z * 0.9 + ph[1])
            + 0.5 * np.sin(f * (X + Z) * 0.7 + ph[2]) * np.cos(f * (X - Z) * 1.1 + ph[3])
        )
    V = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(grid * grid, dtype=np.uint32).reshape(grid, grid)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    F = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)]).astype(np.uint32)
    return V, F


ROCK_GRID = 50  # bench_instanced.py's GRID: 4,802 triangles per rock
ROCK_SIDE = 32  # bench_instanced.py's N_SIDE: 1,024 instances


def make_rock(grid=ROCK_GRID):
    """Bumpy ellipsoid mesh -> (vertices (grid^2, 3), indices)."""
    th = np.linspace(0, np.pi, grid, dtype=np.float32)
    ph = np.linspace(0, 2 * np.pi, grid, dtype=np.float32)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.25 * (np.sin(3 * T + 1.3) * np.cos(4 * P)
                      + 0.5 * np.sin(7 * T) * np.sin(5 * P + 0.7))
    V = np.stack([r * np.sin(T) * np.cos(P), 0.8 * r * np.cos(T), r * np.sin(T) * np.sin(P)],
                 axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(grid * grid, dtype=np.uint32).reshape(grid, grid)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    F = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)]).astype(np.uint32)
    return V, F


def rock_transforms(n_side=ROCK_SIDE, seed=11):
    """The field's instance transforms, row-major over (i, j): a random
    scale in [0.35, 0.6), resting on the ground, on a jittered 1.6 grid."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_side):
        for j in range(n_side):
            m = np.eye(4, dtype=np.float32)
            s = 0.35 + 0.25 * rng.random()
            m[:3, :3] *= s
            m[0, 3] = (i - n_side / 2) * 1.6 + rng.uniform(-0.3, 0.3)
            m[1, 3] = 0.8 * s
            m[2, 3] = j * 1.6 + 2.0 + rng.uniform(-0.3, 0.3)
            out.append(m)
    return out


def instanced(size=(512, 512), n_side=ROCK_SIDE, rock_grid=ROCK_GRID):
    """The instancing benchmark's scene at film ``size``; ``n_side`` and
    ``rock_grid`` cut the field and the rock."""
    V, F = make_rock(rock_grid)
    scene = Scene()
    scene.add(S.Plane([0, -0.1, 0], [0, 1, 0]), M.Diffuse([0.55, 0.5, 0.45]))
    inst = S.InstancedShape(S.Mesh(V, F))
    mat = M.Diffuse([0.6, 0.55, 0.5])
    for m in rock_transforms(n_side):
        inst.add(m, mat)
    scene.add(inst)
    scene.add(S.Rect([0, 30, 20], [6, 0, 0], [0, 0, 6]),
              M.Emissive(np.asarray([400.0, 390.0, 360.0], np.float32)))
    scene.set(ThinLenCamera(Film(size, "uncharted2"), [0.0, 6.0, -6.0], [0.0, 0.5, 14.0], 0.7))
    return scene


def terrain(size=(640, 640), grid=TERRAIN_GRID):
    """The mesh benchmark's scene at film ``size``; ``grid`` cuts the mesh."""
    V, F = make_terrain(grid)
    scene = Scene()
    scene.add("ground", M.Diffuse([0.75, 0.7, 0.6]))
    scene.add(S.Mesh(V, F), "ground")
    scene.add(S.Rect([0.0, 6.0, 4.0], [1.5, 0, 0], [0, 0, 1.5]),
              M.Emissive(np.asarray([300.0, 290.0, 260.0], np.float32)))
    # the camera sits low in the valley, so the mesh fills the frame
    hmax = float(V[:, 1].max())
    scene.set(ThinLenCamera(Film(size, "uncharted2"), [0.0, hmax * 0.55, 0.8],
                            [0.5, 0.2, 5.5], 0.7))
    return scene
