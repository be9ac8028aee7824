"""Terminal fly-camera loop.  Counterpart of pine_tpu/interactive.py, the
analog of the reference's interactive OpenGL path tracer
(impl/integrator/path_opengl.cpp:11-127, camera controls :104-117).

The terminal takes the keys and shows an ANSI half-block thumbnail of every
frame (io/term_preview.py; PINE_TERM_PREVIEW=0 turns it off); the frames at
full resolution go to <dir>/latest.png beside a self-refreshing index.html.
Each key that moves the camera renders a new frame through the same
compiled scene at low spp: the camera is not part of the CompiledScene, and
``ThinLenCamera.params`` rebuilds its tensors from ``position`` and ``c2w``
on every render, so a move costs one render and no rebuild.

Keys: WASD move, E/C up/down, IJKL look, [ ] halve/double spp,
p screenshot, q quit.  PINE_INTERACTIVE_KEYS scripts the session (headless
runs and demos); otherwise keys come from the raw tty, and with neither the
loop ends after its first frame.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

MOVE = 0.25  # world units per keypress
TURN = 0.08  # radians per keypress


def _keys():
    scripted = os.environ.get("PINE_INTERACTIVE_KEYS")
    if scripted is not None:
        yield from scripted
        return
    if not sys.stdin.isatty():
        return
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            yield sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


class FlyCam:
    """Yaw/pitch camera state; writes back into the scene's ThinLenCamera
    (host numpy, as pine_tpu's, so both packages move a camera alike)."""

    def __init__(self, cam):
        self.cam = cam
        self.pos = np.asarray(cam.position, np.float32).copy()
        fwd = np.asarray(cam.c2w[:3, 2], np.float32)
        self.yaw = float(np.arctan2(fwd[0], fwd[2]))
        self.pitch = float(np.arcsin(np.clip(fwd[1], -1.0, 1.0)))

    def forward(self):
        cp = np.cos(self.pitch)
        return np.array(
            [np.sin(self.yaw) * cp, np.sin(self.pitch), np.cos(self.yaw) * cp],
            np.float32,
        )

    def apply_key(self, ch):
        fwd = self.forward()
        right = np.cross([0.0, 1.0, 0.0], fwd)
        n = np.linalg.norm(right)
        right = right / n if n > 1e-6 else np.array([1.0, 0, 0], np.float32)
        moves = {
            "w": fwd, "s": -fwd, "a": -right, "d": right,
            "e": np.array([0, 1.0, 0], np.float32),
            "c": np.array([0, -1.0, 0], np.float32),
        }
        if ch in moves:
            self.pos = self.pos + MOVE * moves[ch]
            return True
        if ch == "j":
            self.yaw += TURN
            return True
        if ch == "l":
            self.yaw -= TURN
            return True
        if ch == "i":
            self.pitch = min(1.5, self.pitch + TURN)
            return True
        if ch == "k":
            self.pitch = max(-1.5, self.pitch - TURN)
            return True
        return False

    def write_back(self):
        from pine_tpu_torch.core.vecmath import look_at

        self.cam.position = self.pos.astype(np.float32)
        self.cam.c2w = look_at(self.pos, self.pos + self.forward())


def run_loop(integrator, scene, cscene, out_dir="interactive"):
    """The fly-cam loop on ``cscene``'s device, entered from
    PathIntegrator.render when ``options.interactive`` is set.  A frame is a
    render_wavefront of ``type(sampler)(spp)`` at the camera as it stands,
    spp from 1, halved or doubled between 1 and 256 by [ and ]; its time is
    taken after the device has finished it.  -> the frames rendered."""
    import torch

    from pine_tpu_torch.integrators.path import VIEWER_HTML, render_wavefront
    from pine_tpu_torch.io.term_preview import preview_enabled, print_frame

    cam = scene.camera
    film = cam.film
    W, H = film.width, film.height
    spp = 1
    fly = FlyCam(cam)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(VIEWER_HTML)
    n_shot = 0
    frames = 0

    def frame():
        nonlocal frames
        sampler = type(integrator.sampler)(spp)
        t0 = time.perf_counter()
        img = render_wavefront(cscene, cam, W, H, sampler, spp, integrator.max_path_length)
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
        dt = time.perf_counter() - t0
        frames += 1
        film.set_rgb(img)
        film.save(os.path.join(out_dir, "latest.png"))
        if preview_enabled(True):
            print_frame(film.finalized())
        return dt

    _status(fly, spp, frame(), out_dir)
    for ch in _keys():
        if ch == "q":
            break
        if ch == "p":
            n_shot += 1
            film.save(os.path.join(out_dir, f"shot_{n_shot:03d}.png"))
            print(f"\n[screenshot] {out_dir}/shot_{n_shot:03d}.png")
            continue
        if ch == "[":
            spp = max(1, spp // 2)
        elif ch == "]":
            spp = min(256, spp * 2)
        elif not fly.apply_key(ch):
            continue
        fly.write_back()
        _status(fly, spp, frame(), out_dir)
    print()
    return frames


def _status(fly, spp, dt, out_dir):
    p = fly.pos
    sys.stdout.write(
        f"\r[interactive] pos=({p[0]:+.2f},{p[1]:+.2f},{p[2]:+.2f}) "
        f"yaw={fly.yaw:+.2f} pitch={fly.pitch:+.2f} spp={spp} "
        f"{dt * 1e3:7.1f} ms/frame  view: {out_dir}/index.html   "
    )
    sys.stdout.flush()
