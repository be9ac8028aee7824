"""The frozen heightfield generator: the terrain of the repository's
``bench_mesh.py`` (a seeded fbm heightfield of (grid - 1)^2 * 2 triangles,
99,458 at its grid of 224), kept here so that the benchmark's mesh does not
move when the program's copy does.  NumPy only; both the scene handed to
the program and the plain reference are built from its arrays."""
from __future__ import annotations

import numpy as np


def make_heightfield(grid=224, size=8.0, amp=1.2, seed=7):
    """-> (vertices (grid^2, 3) float32, indices (2 (grid-1)^2, 3) uint32)."""
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
