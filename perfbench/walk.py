"""The shot's camera path: a seeded walk of small moves around the
configuration's own camera.

Each frame moves the position by a normal step on each axis (``step``
times the distance from the camera to its target), and the yaw and pitch
by normal steps of ``turn`` radians; each coordinate is reflected back
into its band of ``max_offset`` (the same unit) or ``max_turn`` radians
around the home camera, so the scene stays in frame.  The forward vector
is the fly-camera's, (sin yaw cos pitch, sin pitch, cos yaw cos pitch).
The walk is the benchmark's input: the program and the reference are both
handed each frame's (position, forward)."""
from __future__ import annotations

import numpy as np


def seed_words(seed, stream):
    """Non-negative entropy words for ``numpy.random.default_rng``."""
    return [int(seed) % (1 << 63), int(stream)]


def _reflect(x, bound):
    if x > bound:
        x = 2 * bound - x
    elif x < -bound:
        x = -2 * bound - x
    return min(max(x, -bound), bound)


class Walk:
    def __init__(self, camera, params, seed):
        frm = np.asarray(camera["from"], np.float64)
        to = np.asarray(camera["to"], np.float64)
        fwd = (to - frm) / np.linalg.norm(to - frm)
        self.home = frm
        self.yaw0 = float(np.arctan2(fwd[0], fwd[2]))
        self.pitch0 = float(np.arcsin(np.clip(fwd[1], -1.0, 1.0)))
        unit = float(np.linalg.norm(to - frm))
        self.step = float(params["step"]) * unit
        self.max_offset = float(params["max_offset"]) * unit
        self.turn = float(params["turn"])
        self.max_turn = float(params["max_turn"])
        self.rng = np.random.default_rng(seed_words(seed, 1))
        self.offset = np.zeros(3)
        self.dyaw = self.dpitch = 0.0

    @staticmethod
    def forward(yaw, pitch):
        cp = np.cos(pitch)
        return np.array([np.sin(yaw) * cp, np.sin(pitch), np.cos(yaw) * cp], np.float32)

    def home_view(self):
        return self.home.astype(np.float32), self.forward(self.yaw0, self.pitch0)

    def next(self):
        """-> (position, forward), float32, of the next frame."""
        mv = self.rng.normal(0.0, 1.0, 5)
        self.offset = np.array([_reflect(o + self.step * m, self.max_offset)
                                for o, m in zip(self.offset, mv[:3])])
        self.dyaw = _reflect(self.dyaw + self.turn * mv[3], self.max_turn)
        self.dpitch = _reflect(self.dpitch + self.turn * mv[4], self.max_turn)
        return ((self.home + self.offset).astype(np.float32),
                self.forward(self.yaw0 + self.dyaw, self.pitch0 + self.dpitch))
