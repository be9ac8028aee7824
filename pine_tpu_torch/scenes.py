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
interpreter and returns its ``scene``.  ``cbox_prl`` gives CBOX_PRL with a
render line of a caller's integrator and a save.

``GARDEN_PRL`` is an outdoor scene that runs the rest of the scene model: a
640x640 film under an ``Atmosphere`` with ``SobolSampler(16)``, depth 5;
a large ground rect whose albedo is a ``Checkerboard`` of ``Position()``;
the bench box's 420 cones (one 424-row group, the dense kernel) whose
albedo is ``Noise3f`` of the position; a ``Subsurface`` sphere (the
random walk), a ``Glass`` sphere and a ``Metal`` sphere whose roughness is
built from ``Noisef``, ``Vec3``, ``Comp`` and ``lerp``; a fence of 24
``Line``s of thickness 0.02 (the "plain" route); a ``SpotLight``.  It
renders and saves ``garden.png`` in the working directory.
``garden_prl`` gives it with the sky, sampler, film, spp and depth a caller
asks: garden-imagesky (``garden_prl("imagesky", "HaltonSampler")``: an
``ImageSky`` of the repository's images/cbox0.png, by absolute path) and
the ``Sky`` variant, and their reduced sizes (``REDUCED_GARDEN``: the film,
spp and depth cut, as chip_smoke.py's phase 3 renders them).

``cloud`` is the repository's ``bench_cloud.py`` scene: a 96^3 synthetic
cumulus (``make_cloud``, scripts_cloud.py's, over ``fbm3``,
scripts_explosion.py's) read as a ``VDBMedium`` from a ``.nvdb`` file
written at run time, per-channel sigma_a and sigma_s and
``CloudPhaseFunction(0.65)``, in the Cornell box (6 rects, one emissive, and
2 AABB boxes) at 1920x1080.  ``explosion`` is scripts_explosion.py's: an
emissive VDB (``density``, ``flames`` and ``temperature`` grids written by
``write_nvdb_multi``) over a floor and a backdrop.

``CSG_FOG_PRL`` is a script of the CSG and media paths at 640x640,
BlueSampler(16), depth 5: the bench box's walls and light, a glass lens
(``Sphere * Sphere``), a sphere minus a box, a cylinder united with a cone,
an OBB minus a cylinder, and a fog (``HomoMedium`` over a box minus a
sphere, ``HgPF(0.3)``).  It renders and saves ``csg_fog.png`` in the
working directory.  ``csg_fog_prl`` gives it cut as a caller asks,
``csg_fog`` builds its scene, and ``csg_fog_sdf`` adds a torus
(``SDFShape`` with ``torus_sdf``, a torch distance function) through the
Python API.

``CLASSIC_MICRO_PRL`` is the classic-style scene of the repository's
tests/test_integrators.py as a script at the reference's classic.pine size,
720x360, rendered by ``MicroRenderGI(1024 * 2)`` as classic.pine is: a disk
floor, an Uber sphere, a Subsurface sphere whose surface albedo is black, an
orange Uber sphere and one emissive rect.  It saves ``classic_micro.png`` in
the working directory; ``classic_micro_prl`` cuts it, ``classic_micro``
builds its scene.

``house`` is the repository's ``scenes/house.pine``: ``assets/house.glb``
(ten mesh primitives, 4,020 triangles in one triangle group, textured and
factor-only Uber materials, an emissive window) under one DirectionalLight,
rendered by ``CachedPathIntegrator(BlueSampler(128), 5, 128)`` at 640x640.
``house_prl`` gives that script with the asset's path made absolute and the
film size, the render line and the save cut as a caller asks.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from pine_tpu_torch.core import fmath as fm
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


def cbox_prl(integrator, save=None, size=640):
    """CBOX_PRL on a film ``size`` pixels square, rendered by ``integrator`` (a
    PRL integrator expression, e.g. "MltIntegrator(1, 4)") and saved to
    ``save`` (None: not saved)."""
    src = CBOX_PRL.replace("image_size := [640, 640];", f"image_size := [{size}, {size}];")
    src += f"{integrator}.render(scene);\n"
    return src if save is None else src + f"scene.camera.film().save({save!r});\n"


def prl_scene(src, name="<script>", device=None):
    """The ``scene`` a PRL scene script builds, through the port's interpreter.
    Building runs on the host; a script that also renders does so on
    ``device``, or where ``core.options.device`` says, the card unless the
    caller set "cpu"."""
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(device=device)
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


def small_cbox(res=64):
    """A small Cornell box through the Scene API: the benchmark box without
    its cones, glossy and subsurface materials, at a ``res`` x ``res`` film.
    The port's copy of the repository's ``__graft_entry__._build_cbox``
    (the multi-chip dry run's scene, ``parallel.distributed.dryrun_multichip``)."""
    scene = Scene()
    scene.add("floor", M.Diffuse([0.9, 0.9, 0.9]))
    scene.add("red", M.Diffuse([0.9, 0.1, 0.05]))
    scene.add("green", M.Diffuse([0.2, 0.9, 0.05]))
    scene.add("metal", M.Metal([1.0, 1.0, 1.0], 0.0))
    scene.add(S.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "floor")
    scene.add(S.Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "floor")
    scene.add(S.Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), "red")
    scene.add(S.Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), "green")
    scene.add(S.Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "floor")
    m1 = translate([0.0, 0.0, 0.6]) @ rotate_y(0.4) @ scale([0.6, 0.6, 0.6])
    m2 = translate([-0.6, 0.0, 1.0]) @ rotate_y(-0.4) @ scale([0.6, 1.3, 0.6])
    scene.add(S.BoxOBB(S.BoxAABB([0, 0, 0], [1, 1, 1]), m1), "floor")
    scene.add(S.BoxOBB(S.BoxAABB([0, 0, 0], [1, 1, 1]), m2), "metal")
    scene.add(S.Rect([0.0, 1.9, 0.5], [0.1, 0, 0], [0, 0, 0.1]),
              M.Emissive(600 * np.asarray([1.0, 0.64, 0.185])))
    scene.set(ThinLenCamera(Film([res, res], "uncharted2"), [0, 1, -4], [0, 1, 0], 0.25))
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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOUSE_PINE = os.path.join(ROOT, "scenes", "house.pine")
HOUSE_GLB = os.path.join(ROOT, "assets", "house.glb")
HOUSE_INTEGRATOR = "CachedPathIntegrator(BlueSampler(128), 5, 128)"


def house_prl(size=640, integrator=HOUSE_INTEGRATOR, save=None):
    """``scenes/house.pine`` with its GLB read from the checkout by absolute
    path, the film ``size`` pixels square, ``integrator`` (a PRL expression)
    rendering the scene, or no render for None, and the film saved to
    ``save``, or not saved for None (the script saves to
    images/house3.png)."""
    with open(HOUSE_PINE) as f:
        src = f.read()
    render = "" if integrator is None else f"{integrator}.render(scene);"
    save_line = "" if save is None else f"scene.camera.film().save({save!r});"
    for old, new in (('scene.load("assets/house.glb")', f"scene.load({HOUSE_GLB!r})"),
                     ("image_size := [640, 640]", f"image_size := [{size}, {size}]"),
                     (f"{HOUSE_INTEGRATOR}.render(scene);", render),
                     ('scene.camera.film().save("images/house3.png");', save_line)):
        assert old in src, old
        src = src.replace(old, new)
    return src


def house(size=640, integrator=None, device=None):
    """The house scene built (and, with ``integrator``, rendered into its
    film on ``device``, default the card) through the port's interpreter."""
    return prl_scene(house_prl(size, integrator), "<house>", device)


GARDEN_PRL = """
scene := Scene();
image_size := [640, 640];

scene.add("ground", Diffuse(lerp(Checkerboard(Position() * 2.0 + [0.0, 0.25, 0.0]), [0.3, 0.42, 0.18], [0.55, 0.6, 0.35])));
scene.add("floor", Diffuse(Noise3f(Position() * 4.0, 4)));
scene.add("skin", Subsurface([0.9, 0.6, 0.5], 0.0, 40.0));
scene.add("glass", Glass([1, 1, 1], 0.0, 1.5));
scene.add("metal", Metal([0.95, 0.8, 0.55], lerp(Comp(Vec3(Noisef(Position() * 3.0, 3)), 0), 0.05, 0.5)));
scene.add("wood", Diffuse([0.45, 0.3, 0.18]));

scene.add(Rect([0, 0, 4], [40, 0, 0], [0, 0, 40]), "ground");
for x in -1.0 ~ 0.1 ~ 1.0 {
    for z in 0.0 ~ 0.1 ~ 2.0 {
        scene.add(Cone([x, 0, z], Y, 0.05, 0.05), "floor");
    }
}
scene.add(Sphere([-0.7, 0.35, 2.6], 0.35), "skin");
scene.add(Sphere([0.0, 0.3, 2.9], 0.3), "glass");
scene.add(Sphere([0.75, 0.4, 2.7], 0.4), "metal");
for i in 0..12 {
    x := -2.2 + 0.4 * i;
    scene.add(Line([x, 0, 3.6], [x, 0.8, 3.6], 0.02), "wood");
    scene.add(Line([x, 0.55, 3.6], [x + 0.4, 0.55, 3.6], 0.02), "wood");
}

scene.set(Atmosphere([0.4, 0.5, -0.6], [1, 1, 1]));
scene.add(SpotLight([0.0, 3.0, 0.5], [0.0, -1.0, 0.6], [12, 11, 9], 0.35, 0.1));
scene.set(ThinLenCamera(Film(image_size, Uncharted2()), [0, 2.4, -1.2], [0, 0.2, 2.0], 0.4));

PathIntegrator(SobolSampler(16), 5).render(scene);
scene.camera.film().save("garden.png");
"""

IMAGESKY_PNG = os.path.join(ROOT, "images", "cbox0.png")
ATMOSPHERE = "Atmosphere([0.4, 0.5, -0.6], [1, 1, 1])"
SKIES = {"atmosphere": ATMOSPHERE,
         "imagesky": f"ImageSky(load_image({IMAGESKY_PNG!r}))",
         "sky": "Sky([1, 1, 1])"}
# the reduced garden of the tests and phase 3: film, spp and depth cut
REDUCED_GARDEN = dict(size=32, spp=4, depth=3)


def garden_prl(sky="atmosphere", sampler="SobolSampler", size=640, spp=16, depth=5,
               integrator="PathIntegrator", save="garden.png"):
    """GARDEN_PRL under ``sky`` (a key of SKIES), rendered by ``integrator``
    (a PRL name taking (sampler, depth), or None for no render) with
    ``sampler`` (a PRL sampler name) at ``spp`` and ``depth`` on a film
    ``size`` pixels square, saved to ``save`` (None: not saved)."""
    render = "" if integrator is None else f"{integrator}({sampler}({spp}), {depth}).render(scene);"
    save_line = "" if save is None else f"scene.camera.film().save({save!r});"
    src = GARDEN_PRL
    for old, new in (("image_size := [640, 640];", f"image_size := [{size}, {size}];"),
                     (f"scene.set({ATMOSPHERE});", f"scene.set({SKIES[sky]});"),
                     ("PathIntegrator(SobolSampler(16), 5).render(scene);", render),
                     ('scene.camera.film().save("garden.png");', save_line)):
        assert old in src, old
        src = src.replace(old, new)
    return src



def garden(sky="atmosphere", size=640):
    """The garden's scene under ``sky`` (a key of SKIES) on a film ``size``
    pixels square, built (not rendered) through the port's interpreter."""
    return prl_scene(garden_prl(sky, size=size, integrator=None, save=None), "<garden>")


# ---- the cloud, the explosion and the CSG fog box --------------------------

def fbm3(shape, octaves=5, seed=3):
    """Cheap value-noise fbm on a grid (deterministic): scripts_explosion.py's."""
    rng = np.random.default_rng(seed)
    n = shape[0]
    out = np.zeros(shape, np.float32)
    for o in range(octaves):
        res = max(2, 2 ** (o + 1))
        coarse = rng.standard_normal((res + 1,) * 3).astype(np.float32)
        idx = np.linspace(0, res, n, endpoint=False)
        i0 = idx.astype(np.int32)
        f = (idx - i0).astype(np.float32)
        f = f * f * (3 - 2 * f)

        def lerp_axis(a, ax):
            g0 = a.take(i0, axis=ax)
            g1 = a.take(i0 + 1, axis=ax)
            shape_f = [1, 1, 1]
            shape_f[ax] = n
            ff = f.reshape(shape_f)
            return g0 * (1 - ff) + g1 * ff

        g = lerp_axis(lerp_axis(lerp_axis(coarse, 0), 1), 2)
        out += g * (0.6 ** o)
    return out


def make_cloud(n=96):
    """The cumulus density grid (n, n, n): scripts_cloud.py's."""
    g = (np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n) - 0.5
    x, y, z = g
    turb = fbm3((n, n, n), octaves=6, seed=7)
    # a few overlapping puff lobes, eroded by fbm
    lobes = [
        ((0.0, 0.05, 0.0), 0.33), ((-0.22, -0.02, 0.08), 0.22),
        ((0.2, -0.04, -0.1), 0.24), ((0.05, 0.18, -0.05), 0.2),
        ((-0.1, 0.12, -0.15), 0.17),
    ]
    d = np.zeros_like(x)
    for (cx, cy, cz), r in lobes:
        rr = np.sqrt((x - cx) ** 2 + ((y - cy) * 1.35) ** 2 + (z - cz) ** 2)
        d = np.maximum(d, np.clip((r - rr) * 9, 0, 1))
    dens = np.clip(d * np.clip(0.55 + 0.8 * turb, 0, 1.4) - 0.08, 0, 1).astype(
        np.float32
    ) * 1.5
    dens *= np.clip((y + 0.32) * 9, 0, 1)  # a flat-ish base
    return dens


def make_explosion(n=96):
    """(density, flame, temperature) grids (n, n, n): scripts_explosion.py's."""
    g = (np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n) - 0.5
    x, y, z = g
    turb = fbm3((n, n, n), seed=11)
    r_head = np.sqrt(x * x + (y - 0.18) ** 2 * 1.4 + z * z)
    r_stem = np.sqrt(x * x + z * z) * 2.2 + np.clip(-(y + 0.05), 0, 1) * 0.4
    head = np.clip((0.26 + 0.10 * turb) - r_head, 0, 1) * 9
    stem = np.clip((0.12 + 0.07 * turb) - r_stem, 0, 1) * 8 * (y < 0.22)
    dens = np.clip(head + stem, 0, 1.6).astype(np.float32)
    heat = fbm3((n, n, n), seed=23)
    core = np.clip((0.20 + 0.08 * heat) - r_head, 0, 1) * 4 + np.clip(
        (0.10 + 0.05 * heat) - r_stem, 0, 1
    ) * 5
    flame = (np.clip(core, 0, 1) * dens).astype(np.float32)
    temp = np.clip(0.5 + 0.8 * np.clip(core, 0, 1) + 0.15 * heat, 0.0, 1.6).astype(
        np.float32
    )
    return dens, flame, temp


CLOUD_SIZE = (1920, 1080)  # bench_cloud.py's film
CLOUD_GRID = 96


def vdb_medium(grids, *args, path=None):
    """A VDBMedium(path, *args) over ``grids`` ({name: (X,Y,Z) array}, a
    "density" grid among them), written by ``write_nvdb_multi`` to ``path``,
    or to a file in a temporary directory that is removed once read."""
    import tempfile

    from pine_tpu_torch.io.nvdb import write_nvdb_multi
    from pine_tpu_torch.scene.media import VDBMedium

    if path is not None:
        write_nvdb_multi(path, grids)
        return VDBMedium(path, *args)
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "grids.nvdb")
        write_nvdb_multi(f, grids)
        return VDBMedium(f, *args)


def cloud(size=CLOUD_SIZE, n=CLOUD_GRID):
    """bench_cloud.py's scene at film ``size`` (width, height) with an
    ``n``^3 cloud (n a multiple of 8)."""
    from pine_tpu_torch.scene.media import CloudPhaseFunction

    sc = Scene()
    sc.add("white", M.Diffuse([0.9, 0.9, 0.9]))
    sc.add("red", M.Diffuse([0.9, 0.2, 0.1]))
    sc.add("green", M.Diffuse([0.25, 0.8, 0.1]))
    sc.add(S.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "white")
    sc.add(S.Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "white")
    sc.add(S.Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "white")
    sc.add(S.Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), "red")
    sc.add(S.Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), "green")
    sc.add(S.BoxAABB([-0.75, 0.0, 0.9], [-0.45, 1.45, 1.25]), "white")
    sc.add(S.BoxAABB([0.1, 0.0, 1.0], [0.75, 0.62, 1.7]), "white")
    sc.add(S.Rect([0, 1.98, 1.0], [0.35, 0, 0], [0, 0, 0.35]), M.Emissive([42.0, 40.0, 37.0]))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.diag([1.7, 0.9, 1.3]).astype(np.float32)
    m[:3, 3] = [-0.85, 0.95, 0.45]
    sc.add(vdb_medium({"density": make_cloud(n)}, m, CloudPhaseFunction(0.65),
                      [1.2, 2.2, 4.0], [38.0, 30.0, 22.0]))
    sc.set(ThinLenCamera(Film(size, "uncharted2"), [0, 1.0, -2.6], [0, 1.0, 1.0], 0.44))
    return sc


def explosion(size=400, n=72):
    """scripts_explosion.py's scene at a film ``size`` pixels square with
    ``n``^3 grids (n a multiple of 8)."""
    from pine_tpu_torch.scene.media import CloudPhaseFunction

    dens, flame, temp = make_explosion(n)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= np.diag([2.4, 2.4, 2.4]).astype(np.float32)
    m[:3, 3] = [-1.2, 0.0, -1.2]
    sc = Scene()
    sc.add("floor", M.Diffuse([0.45, 0.42, 0.4]))
    sc.add(S.Rect([0, 0, 0], [12, 0, 0], [0, 0, 12]), "floor")
    sc.add(S.Rect([0, 0.01, 6], [12, 0, 0], [0, 10, 0], True), "floor")  # backdrop
    sc.add(S.Rect([-4, 7, -6], [2.5, 0, 0], [0, 0, 2.5]), M.Emissive([16.0, 15.0, 14.0]))
    sc.add(vdb_medium({"density": dens, "flames": flame, "temperature": temp}, m,
                      CloudPhaseFunction(0.6), [6.0, 6.0, 6.0], [4.0, 4.0, 4.0], 3.0, 0.9))
    sc.set(ThinLenCamera(Film((size, size), "uncharted2"), [0, 1.6, -4.6], [0, 1.1, 0], 0.3))
    return sc


CSG_FOG_PRL = """
scene := Scene();
image_size := [640, 640];

scene.add("floor", Diffuse([0.9, 0.9, 0.9]));
scene.add("red", Diffuse([0.9, 0.1, 0.05]));
scene.add("green", Diffuse([0.2, 0.9, 0.05]));
scene.add("glass", Glass([1, 1, 1], 0.0, 1.5));
scene.add("metal", Metal([0.95, 0.8, 0.55], 0.2));
scene.add("blue", Diffuse([0.2, 0.35, 0.85]));

scene.add(Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "floor");
scene.add(Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "floor");
scene.add(Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), "red");
scene.add(Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), "green");
scene.add(Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "floor");
scene.add(Rect([0.0, 1.9, 0.5], [0.1, 0, 0], [0, 0, 0.1]), Emissive(600 * [1.0, 0.64, 0.185]));

lens := Sphere([-0.45, 1.1, 0.55], 0.4) * Sphere([-0.45, 1.1, 1.05], 0.4);
scene.add(lens, "glass");
scene.add(Sphere([0.45, 0.3, 1.3], 0.3) - AABB([0.45, 0.3, 0.9], [0.85, 0.7, 1.3]), "metal");
scene.add(Cylinder([-0.55, 0, 1.5], [-0.55, 0.45, 1.5], 0.1) + Cone([-0.55, 0.45, 1.5], Y, 0.25, 0.3), "blue");
scene.add(Box(AABB([0, 0, 0], [1, 1, 1]), translate([-0.05, 0.0, 0.45]) * rotate_y(0.5) * scale([0.4, 0.4, 0.4])) - Cylinder([0.15, 0.2, -0.2], [0.15, 0.2, 1.4], 0.12), "floor");

scene.add(HomoMedium(AABB([-1, 0, 0], [1, 2, 2]) - Sphere([0.0, 1.3, 1.2], 0.45), HgPF(0.3), [0.02, 0.02, 0.02], [0.3, 0.3, 0.3]));
scene.set(ThinLenCamera(Film(image_size, Uncharted2()), [0, 1, -4], [0, 1, 0], 0.25));

PathIntegrator(BlueSampler(16), 5).render(scene);
scene.camera.film().save("csg_fog.png");
"""


def csg_fog_prl(size=640, spp=16, depth=5, integrator="PathIntegrator", save="csg_fog.png"):
    """CSG_FOG_PRL on a film ``size`` pixels square, rendered by
    ``integrator`` (a PRL name taking (sampler, depth), then with
    BlueSampler(``spp``) at ``depth``; or a whole integrator expression,
    e.g. "RestirIntegrator(BlueSampler(16), 2)"; or None for no render),
    saved to ``save`` (None: not saved)."""
    if integrator is None:
        render = ""
    elif "(" in integrator:
        render = f"{integrator}.render(scene);"
    else:
        render = f"{integrator}(BlueSampler({spp}), {depth}).render(scene);"
    save_line = "" if save is None else f"scene.camera.film().save({save!r});"
    src = CSG_FOG_PRL
    for old, new in (("image_size := [640, 640];", f"image_size := [{size}, {size}];"),
                     ("PathIntegrator(BlueSampler(16), 5).render(scene);", render),
                     ('scene.camera.film().save("csg_fog.png");', save_line)):
        assert old in src, old
        src = src.replace(old, new)
    return src


def csg_fog(size=640):
    """The CSG fog box's scene on a film ``size`` pixels square, built (not
    rendered) through the port's interpreter."""
    return prl_scene(csg_fog_prl(size, integrator=None, save=None), "<csg fog>")


TORUS = dict(center=(0.35, 0.1, 0.35), major=0.2, minor=0.07)


def torus_sdf(p, center=TORUS["center"], major=TORUS["major"], minor=TORUS["minor"]):
    """Signed distance (N,) of points p (N,3) to a torus around the y axis
    through ``center``, written out term by term."""
    x = p[:, 0] - center[0]
    y = p[:, 1] - center[1]
    z = p[:, 2] - center[2]
    q = fm.sqrt(x * x + z * z) - major
    return fm.sqrt(q * q + y * y) - minor


def torus_shape(fn=torus_sdf):
    """An SDFShape of the torus with distance function ``fn``, its box the
    torus's bounds widened by 0.01."""
    r = TORUS["major"] + TORUS["minor"] + 0.01
    return S.SDFShape(TORUS["center"], (r, TORUS["minor"] + 0.01, r), fn)


def csg_fog_sdf(size=640):
    """The CSG fog box with the torus added through the Python API."""
    scene = csg_fog(size)
    scene.add(torus_shape(), M.Diffuse([0.85, 0.55, 0.2]))
    return scene


# README's draw() example (the Shadertoy-derived "storm" fragment), as the
# repository's golden test runs it, saving storm.png in the working directory
STORM_PRL = """
image_size = [640, 640];

draw(image_size, (u: vec2): vec3 {
    u *= image_size;
    v = vec2(image_size);
    u = 0.2 * (2 * u - v) / v.y;
    w = u;

   o = [1, 2, 3.0];
   z = o;
   a = 0.5;
   t = 4.2;
    for i in 0..19 {
        a += 0.03;
        t += 1;
        t2 = vec2(t);
        v = cos(t2 - 7 * u * pow(a, i)) - 5 * u;
        m = mat2(cos(vec2(i + 0.02 * t) - vec2(0, 11)), cos(vec2(i + 0.02 * t) - vec2(33, 0)));
        u = m * u;
        u += tanh(40 * dot(u, u) * cos(100 * [u.y, u.x] + t2)) / 200
           + 0.2 * a * u
           + cos(4 / exp(dot(o, o) / 100) + t) / 300;

        o += 0.4 * (vec3(1) + cos(z + vec3(t))) / length( (1 + i * length(v, v)) * sin(1.5 * u / (0.5 - dot(u, u)) - 9 * [u.y, u.x] + t2) );
    }

    w -= u;
   return pow((25.6 / (min(o, vec3(13)) + 164 / o) - dot(w, w) / 250), 4);
}).save("storm.png");
"""


def storm_prl(size=640, save="storm.png"):
    """STORM_PRL on a ``size`` x ``size`` image, saved to ``save``."""
    src = STORM_PRL
    for old, new in (("image_size = [640, 640];", f"image_size = [{size}, {size}];"),
                     ('.save("storm.png");', f".save({save!r});")):
        assert old in src, old
        src = src.replace(old, new)
    return src


# the torus of TORUS as a PRL SDF lambda: csg_fog_sdf's torus_sdf written in
# the script, its box torus_shape's
TORUS_SDF_PRL = """scene.add(SDF([0.35, 0.1, 0.35], [0.28, 0.08, 0.28], (p: vec3): f32 {
    x := p.x - 0.35;
    y := p.y - 0.1;
    z := p.z - 0.35;
    q := sqrt(x * x + z * z) - 0.2;
    return sqrt(q * q + y * y) - 0.07;
}), Diffuse([0.85, 0.55, 0.2]));
"""
_FOG_CAMERA = ("scene.set(ThinLenCamera(Film(image_size, Uncharted2()), [0, 1, -4], [0, 1, 0], "
               "0.25));\n")
CSG_FOG_SDF_PRL = CSG_FOG_PRL.replace(_FOG_CAMERA, _FOG_CAMERA + TORUS_SDF_PRL).replace(
    '"csg_fog.png"', '"csg_fog_sdf.png"')
assert TORUS_SDF_PRL in CSG_FOG_SDF_PRL


def csg_fog_sdf_prl(size=640, spp=16, depth=5, integrator="PathIntegrator",
                    save="csg_fog_sdf.png"):
    """CSG_FOG_SDF_PRL cut as csg_fog_prl cuts CSG_FOG_PRL."""
    src = csg_fog_prl(size, spp, depth, integrator, save)
    return src.replace(_FOG_CAMERA, _FOG_CAMERA + TORUS_SDF_PRL)


CLASSIC_MICRO_PRL = """
scene := Scene();
image_size := [720, 360];

scene.add(Disk([0, 0, 0], [0, 1, 0], 50), Diffuse([0.8, 0.8, 0.8]));
scene.add(Sphere([-2.2, 1, 0], 1), Uber([1.0, 1.0, 1.0], 0.0, 1.0));
scene.add(Sphere([0, 1, 0], 1), Subsurface([0, 0, 0], 0, [1, 0.8, 0.6]));
scene.add(Sphere([2.2, 1, 0], 1), Uber([0.98, 0.55, 0.02], 0.0, 0.0));
scene.add(Rect([-1, 3, -1], [1, 0, 0], [0, 0, 1]), Emissive([160, 160, 160]));
scene.set(ThinLenCamera(Film(image_size), [0, 4, -8], [0, 1, 0], 0.3));

MicroRenderGI(1024 * 2).render(scene);
scene.camera.film().save("classic_micro.png");
"""


def classic_micro_prl(size=(720, 360), points="1024 * 2", save="classic_micro.png"):
    """CLASSIC_MICRO_PRL on a film of ``size`` (width, height), rendered by
    MicroRenderGI(``points``) (None: no render), saved to ``save`` (None: not
    saved)."""
    src = CLASSIC_MICRO_PRL
    for old, new in (("image_size := [720, 360];", f"image_size := [{size[0]}, {size[1]}];"),
                     ("MicroRenderGI(1024 * 2).render(scene);",
                      "" if points is None else f"MicroRenderGI({points}).render(scene);"),
                     ('scene.camera.film().save("classic_micro.png");',
                      "" if save is None else f"scene.camera.film().save({save!r});")):
        src = src.replace(old, new)
    return src


def classic_micro(size=(720, 360)):
    """The classic-style scene on a film of ``size``, built (not rendered)
    through the port's interpreter."""
    return prl_scene(classic_micro_prl(size, None, None), "<classic micro>")
