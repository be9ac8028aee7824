"""What decides ``correct``: pixels of the frames the window finished, drawn
from the seed, against the plain reference (reference/render.py) given the
same pixels, camera and blue-noise values.

Each of a cell's ``pixels`` draws picks a finished frame and a pixel of it
uniformly (``Draws``).  A drawn pixel is off when a channel of the program's
tone-mapped value lies further from the reference's than ``tol_abs +
tol_rel * |reference|``.  The numbers compared, each against the cell's
limit (``checks/<workload>.json``):

- ``px_off``: the share of drawn pixels that are off;
- ``mean_gap``: |sum of the program's values - sum of the reference's| over
  the sum of the reference's, over every channel of the drawn pixels.

A path that takes another branch in one sample (a ray that grazes an edge
in the other order of operations) moves its pixel by far more than the
tolerance, so ``px_off`` is the share of pixels where any of the samples'
paths parted; a systematic error moves every pixel and the mean."""
from __future__ import annotations

import numpy as np

from perfbench.walk import seed_words


class Draws:
    """The pixels a run checks.  Each frame, as it ends, gives up ``count``
    pixels drawn from the seed and the frame's index (``take``); after the
    window, ``count`` of all those, each a uniform (frame, pixel) pair, are
    the ones compared (``chosen``).  Only the drawn values are kept, not the
    frames."""

    def __init__(self, seed, width, height, count):
        self.seed, self.width, self.height, self.count = seed, width, height, count
        self.pixels, self.values = [], []

    def take(self, image):
        rng = np.random.default_rng(seed_words(self.seed, 2) + [len(self.values)])
        xy = np.stack([rng.integers(0, self.width, self.count),
                       rng.integers(0, self.height, self.count)], 1)
        self.pixels.append(xy)
        self.values.append(np.asarray(image)[xy[:, 1], xy[:, 0]].astype(np.float64))

    def chosen(self, views):
        """-> (the program's values (N,3), reference rows (x, y, position,
        forward), frames with a non-finite chosen value)."""
        rng = np.random.default_rng(seed_words(self.seed, 3))
        f = rng.integers(0, len(self.values), self.count)
        j = rng.integers(0, self.count, self.count)
        prog = np.stack([self.values[a][b] for a, b in zip(f, j)])
        rows = np.array([[*self.pixels[a][b], *views[a][0], *views[a][1]] for a, b in zip(f, j)],
                        np.float64)
        bad = len({a for a, v in zip(f, prog) if not np.isfinite(v).all()})
        return prog, rows, bad


def compare(prog, ref, rule):
    """-> {"px_off": share, "mean_gap": relative gap} of (N,3) values."""
    ref = np.asarray(ref, np.float64)
    prog = np.asarray(prog, np.float64)
    tol = rule["tol_abs"] + rule["tol_rel"] * np.abs(ref)
    off = ~(np.abs(prog - ref) <= tol).all(1)  # a NaN is off
    gap = abs(prog.sum() - ref.sum()) / max(abs(ref.sum()), 1e-30)
    return {"px_off": float(off.mean()), "mean_gap": float(gap) if np.isfinite(gap) else 1.0}


def judge(numbers, limits):
    """-> (correct, {name: {"value", "limit"}}); a number at or under its
    limit passes."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
