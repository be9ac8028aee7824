"""CLI entry: ``python -m pine_tpu_torch <file.pine> [--platform cpu|gpu]
[--progressive N] [--progressive-dir D] [--interactive] [--trace PATH]`` (parity:
src/cli/pine.cpp, and pine_tpu/cli.py, whose flags and messages these are).

The script renders on the card unless ``--platform cpu`` asks for the CPU;
without a card and without that flag the CLI exits with status 1 and
``resolve_device``'s message before it runs anything, so it never quietly
runs on the CPU.  Render progress is polled at 10 Hz from a watcher thread
and reprinted as a ``\\r`` line, as the reference's g_progress loop does
(pine.cpp:36-40).  The last line is ``Finished in <seconds>s``.  With
``--trace PATH`` every frame is traced (core/profiler.py): the record goes
to PATH as Chrome trace-event JSON and the span tree (per span, host and
host self time, device time) is printed before that line.
"""
from __future__ import annotations

import os
import sys

USAGE = """usage: python -m pine_tpu_torch <file.pine> [--platform P] [--progressive N]
            [--progressive-dir D] [--interactive] [--trace PATH]

--platform P         where the script renders: gpu (the default, the CUDA
                     card) or cpu (the plain PyTorch versions of the kernels)
--progressive N      snapshot the film every N samples per pixel (the analog
                     of the reference's accumulating viewer,
                     path_opengl.cpp:11-127); each snapshot is read back from
                     the card and written as its batch finishes
--progressive-dir D  snapshot directory (default: progressive/)
--interactive        after the script's first render, open a terminal
                     fly-camera loop (WASD move, E/C up/down, IJKL look,
                     [ ] spp, p screenshot, q quit) rendering the compiled
                     scene at each new camera on the card; frames go to
                     interactive/latest.png beside a self-refreshing
                     index.html (path_opengl.cpp:104-117)
--trace PATH         trace every frame: spans of each stage (host time and,
                     on the card, device time), host-device syncs, kernel
                     launches and lanes; written to PATH as Chrome
                     trace-event JSON at exit, the span tree printed"""

PLATFORMS = {"gpu": None, "cpu": "cpu"}


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    from pine_tpu_torch.core import options

    args = []
    trace = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--platform":
            if i + 1 >= len(argv) or argv[i + 1] not in PLATFORMS:
                print("error: --platform requires cpu or gpu")
                return 1
            options.device = PLATFORMS[argv[i + 1]]
            i += 2
        elif a == "--interactive":
            options.interactive = True
            i += 1
        elif a == "--progressive":
            if i + 1 >= len(argv) or not argv[i + 1].isdigit() or int(argv[i + 1]) < 1:
                print("error: --progressive requires a positive integer")
                return 1
            options.progressive_every = int(argv[i + 1])
            i += 2
        elif a == "--trace":
            if i + 1 >= len(argv):
                print("error: --trace requires a path")
                return 1
            trace = argv[i + 1]
            i += 2
        elif a == "--progressive-dir":
            if i + 1 >= len(argv):
                print("error: --progressive-dir requires a path")
                return 1
            options.progressive_dir = argv[i + 1]
            i += 2
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
    from pine_tpu_torch.core import profiler
    from pine_tpu_torch.core.progress import ProgressReporter
    from pine_tpu_torch.prl.interp import interpret_file

    if trace is not None:
        profiler.enable()
    timer = Timer()
    try:
        with ProgressReporter():
            interpret_file(args[0])
    except Exception as e:  # mirror pine.cpp's catch-log behavior
        if os.environ.get("PINE_DEBUG"):
            import traceback

            traceback.print_exc()
        print(f"[Error] {e}")
        return 1
    elapsed = timer.elapsed_ms() / 1e3
    if trace is not None:
        profiler.disable()
        for line in profiler.tree():
            print(line)
        profiler.export(trace)
        print(f"trace written to {trace}")
    print(f"Finished in {elapsed:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
