"""CLI entry: ``python -m pine_tpu_torch <file.pine> [--platform cpu|gpu]``
(parity: src/cli/pine.cpp, and pine_tpu/cli.py).

The script renders on the card unless ``--platform cpu`` asks for the CPU;
without a card and without that flag the CLI exits with status 1 and
``resolve_device``'s message before it runs anything, so it never quietly
runs on the CPU.  Render progress is polled at 10 Hz from a watcher thread
and reprinted as a ``\\r`` line, as the reference's g_progress loop does
(pine.cpp:36-40).  The last line is ``Finished in <seconds>s``.
"""
from __future__ import annotations

import os
import sys

USAGE = """usage: python -m pine_tpu_torch <file.pine> [--platform P]

--platform P   where the script renders: gpu (the default, the CUDA card) or
               cpu (the plain PyTorch versions of the kernels)

pine_tpu's --progressive, --progressive-dir and --interactive are not ported
yet (ROADMAP.md, modules item 13)."""

PLATFORMS = {"gpu": None, "cpu": "cpu"}
NOT_PORTED = ("--progressive", "--progressive-dir", "--interactive")


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    from pine_tpu_torch.core import options

    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--platform":
            if i + 1 >= len(argv) or argv[i + 1] not in PLATFORMS:
                print("error: --platform requires cpu or gpu")
                return 1
            options.device = PLATFORMS[argv[i + 1]]
            i += 2
        elif a in NOT_PORTED:
            print(f"error: {a} is not ported yet (ROADMAP.md, modules item 13)")
            return 1
        else:
            args.append(a)
            i += 1
    if len(args) != 1:
        print(USAGE)
        return 1
    from pine_tpu_torch.core.log import Timer
    from pine_tpu_torch.core.place import resolve_device

    try:
        resolve_device(options.device)
    except RuntimeError as e:
        print(f"[Error] {e}")
        return 1
    from pine_tpu_torch.core.profiler import Profiler
    from pine_tpu_torch.core.progress import ProgressReporter
    from pine_tpu_torch.prl.interp import interpret_file

    timer = Timer()
    try:
        with Profiler("Total"), ProgressReporter():
            interpret_file(args[0])
    except Exception as e:  # mirror pine.cpp's catch-log behavior
        if os.environ.get("PINE_DEBUG"):
            import traceback

            traceback.print_exc()
        print(f"[Error] {e}")
        return 1
    Profiler.finalize()
    print(f"Finished in {timer.elapsed_ms() / 1e3:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
