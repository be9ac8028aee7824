"""Process-wide render options set by the CLI.  Counterpart of
pine_tpu/core/options.py.

There is no flag system in the reference (the .pine script is the config,
SURVEY §5.6), so the few runtime knobs that make no sense as scene code live
here.  ``device``: where a script's ``render`` runs when its interpreter was
given none (``--platform``: None, the card, or "cpu").
``progressive_every``: if set, PathIntegrator renders in sample batches of
this size and writes the running mean to ``progressive_dir`` after each
batch, the analog of the reference's accumulating viewer
(path_opengl.cpp:11-127).  Snapshots are written as they are made: a film
readback from the card is an ordinary copy.  ``interactive``: the terminal
fly-camera loop (interactive.py) after the render.
"""
from __future__ import annotations

device = None
progressive_every = None  # int spp per snapshot, or None (off)
progressive_dir = "progressive"
interactive = False  # --interactive: terminal fly-camera loop after render
