"""Process-wide render options set by the CLI.  Counterpart of
pine_tpu/core/options.py.

There is no flag system in the reference (the .pine script is the config,
SURVEY §5.6), so the few runtime knobs that make no sense as scene code live
here.  ``device``: where a script's ``render`` runs when its interpreter was
given none (``--platform``: None, the card, or "cpu").  pine_tpu's
progressive snapshots and interactive loop (``progressive_every``,
``progressive_dir``, ``interactive``) are not ported (ROADMAP.md, modules
item 13); the CLI refuses their flags.
"""
from __future__ import annotations

device = None
