"""The program's scene of a configuration, built through the program's own
entries: a PRL script run by its interpreter (``"program": {"prl":
file}``, the file beside the configuration), or its Python scene API from
the configuration's plain description (``"program": {"plain": true}``).
Either way the camera is then set on a film of the cell's size, at the
camera the scene states."""
from __future__ import annotations

import os

import numpy as np


def _plain_scene(plain):
    from pine_tpu_torch.core.camera import ThinLenCamera
    from pine_tpu_torch.core.film import Film
    from pine_tpu_torch.core.vecmath import rotate_y, scale, translate
    from pine_tpu_torch.scene import materials as M
    from pine_tpu_torch.scene import shapes as S
    from pine_tpu_torch.scene.scene import Scene

    from perfbench.reference.heightfield import make_heightfield
    from perfbench.reference.scene import loop_values

    scene = Scene()
    for name, m in plain["materials"].items():
        if m["type"] == "diffuse":
            scene.add(name, M.Diffuse(m["albedo"]))
        elif m["type"] == "metal":
            scene.add(name, M.Metal(m["albedo"], m["roughness"]))
        else:
            scene.add(name, M.Emissive(np.float32(m["scale"]) * np.float32(m["color"])))
    ops = {"translate": translate, "rotate_y": rotate_y, "scale": scale}
    for sh in plain["shapes"]:
        t, mat = sh["type"], sh["material"]
        if t == "rect":
            scene.add(S.Rect(sh["position"], sh["ex"], sh["ey"]), mat)
        elif t == "cone_grid":
            for x in loop_values(*sh["x"]):
                for z in loop_values(*sh["z"]):
                    scene.add(S.Cone([x, sh["y"], z], sh["axis"], sh["radius"], sh["height"]),
                              mat)
        elif t == "box":
            m = np.eye(4, dtype=np.float32)
            for op, arg in sh["transform"]:
                m = m @ ops[op](arg)
            scene.add(S.BoxOBB(S.BoxAABB(sh["lower"], sh["upper"]), m), mat)
        elif t == "heightfield":
            V, F = make_heightfield(sh["grid"], sh["size"], sh["amp"], sh["seed"])
            scene.add(S.Mesh(V, F), mat)
        else:
            raise ValueError(f"unknown shape type {t!r}")
    cam = plain["camera"]
    scene.set(ThinLenCamera(Film([2, 2], cam["tone_map"]), cam["from"], cam["to"], cam["fov"]))
    return scene


def program_scene(cfg, cfg_dir, size):
    """-> the program's Scene of configuration ``cfg`` with a ``size``
    (width, height) film."""
    from pine_tpu_torch.core.camera import ThinLenCamera
    from pine_tpu_torch.core.film import Film

    prog = cfg["program"]
    if "prl" in prog:
        from pine_tpu_torch.prl.interp import Interpreter

        path = os.path.join(cfg_dir, prog["prl"])
        with open(path) as f:
            src = f.read()
        itp = Interpreter()
        itp.run(src, os.path.basename(path))
        scene = itp.get_var("scene")
    else:
        scene = _plain_scene(cfg["plain"])
    old = scene.camera
    scene.set(ThinLenCamera(Film(size, old.film.tone_mapper), old.position,
                            old.position + old.c2w[:3, 2], old.fov, old.len_radius,
                            old.focus_distance))
    return scene


def set_view(camera, position, forward):
    """Write a frame's view into the scene's ThinLenCamera, as the program's
    fly-camera does."""
    from pine_tpu_torch.core.vecmath import look_at

    camera.position = np.asarray(position, np.float32)
    camera.c2w = look_at(camera.position, camera.position + np.asarray(forward, np.float32))
