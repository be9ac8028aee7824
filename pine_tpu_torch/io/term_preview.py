"""In-terminal image preview by ANSI truecolor half-blocks.  Counterpart of
pine_tpu/io/term_preview.py (the strings are the same byte for byte).

The reference's interactive integrator shows frames in an OpenGL window
(impl/integrator/path_opengl.cpp:11-127).  A GPU host reached over a
terminal may have no display, so the fly-cam loop and ``--progressive``
snapshots print a thumbnail inline: each text cell shows two vertical
pixels with the upper-half-block glyph, its foreground the top pixel's
colour and its background the bottom one's (24-bit SGR codes).  Numpy on
the host: the frame is already read back for its PNG.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def _box_downsample(img, out_h, out_w):
    """Integer-bin box filter to (out_h, out_w, 3); exact for any size."""
    h, w, _ = img.shape
    ys = (np.arange(out_h + 1) * h) // out_h
    xs = (np.arange(out_w + 1) * w) // out_w
    row = np.add.reduceat(img, ys[:-1], axis=0)
    rc = np.add.reduceat(row, xs[:-1], axis=1)
    counts = (ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :]
    return rc / counts[..., None]


def ansi_frame(rgb, max_cols=80, max_lines=24):
    """(H,W,3) float values in [0,1] as an ANSI string, gamma-encoded by
    1/2.2 as the PNG output is (array.h:37-44).  One text line shows two
    pixel rows."""
    img = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
    h, w, _ = img.shape
    # fit (cols, 2*lines) keeping the aspect; terminal cells are about 1:2
    scale = min(max_cols / w, (2 * max_lines) / h, 1.0)
    out_w = max(2, int(round(w * scale)))
    out_h = max(2, int(round(h * scale)) & ~1)  # an even row count
    small = _box_downsample(img, out_h, out_w)
    u8 = (small ** (1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)
    top, bot = u8[0::2], u8[1::2]
    lines = []
    for t_row, b_row in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(t_row, b_row)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def preview_enabled(live):
    """PINE_TERM_PREVIEW=1/0 forces it; by default on for a live tty."""
    env = os.environ.get("PINE_TERM_PREVIEW")
    if env is not None:
        return env not in ("0", "", "off")
    return bool(live) and sys.stdout.isatty()


def print_frame(rgb, max_cols=80, max_lines=24):
    sys.stdout.write(ansi_frame(rgb, max_cols, max_lines) + "\n")
    sys.stdout.flush()
