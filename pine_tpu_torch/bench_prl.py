"""PRL host-script benchmark: ``scenes/benchmark.pine`` (Collatz), the
counterpart of the repository's ``bench_prl.py``.

    python -m pine_tpu_torch.bench_prl [--platform gpu|cpu] [--outer N] [--c-ref benchmark.c]
    python -m pine_tpu_torch.bench_prl --seq

The reference positions PRL against C and numba with this exact script
(scenes/benchmark.{pine,c,py}; its LLVM -O3 JIT, jit.cpp:2219-2354).  Here
the eager interpreter hands the inner loop's 49,999 independent Collatz
chains to loop_jit's batched tier (one slab of lanes, the data-dependent
``while`` a masked loop) for each of the 100 outer iterations, on the
interpreter's device: the card, or the host CPU with ``--platform cpu``.
``--outer N`` runs N of the 100 outer iterations (the sum is then N *
5024987).

Prints the script's output, which must be 502498700 (the reference's i32
value; N * 5024987 with --outer), then one JSON line: the wall in seconds
(interpreter start to end), the tier taken and the masked loop's
device-to-host syncs, and, given the reference's ``benchmark.c`` with
``--c-ref``, the multiple of a ``gcc -O3`` build of it timed on the same
host.  Exits with status 1 if the output is wrong or the batched tier was
not taken, and without a card unless ``--platform cpu``.

``--seq`` times the sequential tier instead (on the host, where it runs):
``SEQ_PRL``, tests/test_loop_jit.py's loop-carried loop at 30,000
iterations, lowered by loop_jit against the eager interpreter
(PINE_NO_LOOPJIT=1), each the best of three, and prints one JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PINE = os.path.join(ROOT, "scenes", "benchmark.pine")
PER_OUTER = 5024987  # the Collatz steps of 1..49,999, one outer iteration
OUTER = 100
SEQ_PRL = """
a = 1;
b = 0;
for i in 0..30000 {
    t = a + b;
    b = a;
    a = t % 1000003;
}
println(a, ' ', b);
"""


def run_prl(device, outer=OUTER):
    """-> (output lines, wall s, loop_jit.RUNS, trace_flow syncs)."""
    from pine_tpu_torch.prl import loop_jit, trace_flow
    from pine_tpu_torch.prl.interp import Interpreter

    src = open(BENCH_PINE).read()
    if outer != OUTER:
        assert "0..100" in src
        src = src.replace("0..100", f"0..{outer}")
    before = dict(loop_jit.RUNS)
    syncs = trace_flow.SYNCS[0]
    out = []
    t0 = time.perf_counter()
    Interpreter(out=out.append, device=device).run(src, BENCH_PINE)
    wall = time.perf_counter() - t0
    runs = {k: loop_jit.RUNS[k] - before[k] for k in before}
    return out, wall, runs, trace_flow.SYNCS[0] - syncs


def run_seq(reps=3):
    """-> (the sequential tier's wall, the eager interpreter's, their
    outputs), each the best of ``reps``, on SEQ_PRL."""
    from pine_tpu_torch.prl import loop_jit
    from pine_tpu_torch.prl.interp import Interpreter

    walls, outs = {}, {}
    for mode in ("seq", "eager"):
        best = None
        for _ in range(reps):
            before = loop_jit.RUNS["seq"]
            if mode == "eager":
                os.environ["PINE_NO_LOOPJIT"] = "1"
            out = []
            try:
                t0 = time.perf_counter()
                Interpreter(out=out.append, device="cpu").run(SEQ_PRL)
                wall = time.perf_counter() - t0
            finally:
                os.environ.pop("PINE_NO_LOOPJIT", None)
            assert (loop_jit.RUNS["seq"] > before) == (mode == "seq"), mode
            best = wall if best is None else min(best, wall)
            outs[mode] = out
        walls[mode] = best
    return walls["seq"], walls["eager"], outs


def run_c(path):
    """Wall seconds of a gcc -O3 build of the reference's benchmark.c, or
    None without gcc."""
    with tempfile.TemporaryDirectory() as d:
        exe = os.path.join(d, "bench")
        try:
            subprocess.run(["gcc", "-O3", "-o", exe, path], check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        t0 = time.perf_counter()
        r = subprocess.run([exe], capture_output=True, text=True, check=True)
        wall = time.perf_counter() - t0
        assert r.stdout.strip() == str(OUTER * PER_OUTER), r.stdout
        return wall


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m pine_tpu_torch.bench_prl")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--outer", type=int, default=OUTER)
    ap.add_argument("--c-ref", default=None, help="the reference's scenes/benchmark.c")
    ap.add_argument("--seq", action="store_true", help="time the sequential tier instead")
    args = ap.parse_args(argv)
    if args.seq:
        seq, eager, outs = run_seq()
        ok = outs["seq"] == outs["eager"]
        print(json.dumps(dict(metric="prl_seq_tier_wall_s", value=seq, unit="s",
                              eager_wall_s=eager, speedup=eager / seq, same_output=ok,
                              output=outs["seq"], note="SEQ_PRL: 30,000 loop-carried iterations")))
        return 0 if ok else 1
    device = "cpu" if args.platform == "cpu" else None
    from pine_tpu_torch.core.place import resolve_device

    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"[Error] {e}")
        return 1
    out, wall, runs, syncs = run_prl(device, args.outer)
    for line in out:
        print(line)
    want = str(args.outer * PER_OUTER)
    if out != [want] or not runs["batch"]:
        print(f"[Error] expected [{want}] through the batched tier, got {out} (tiers {runs})")
        return 1
    c_wall = run_c(args.c_ref) if args.c_ref else None
    print(json.dumps(dict(
        metric="prl_collatz_wall_s", value=wall, unit="s", outer=args.outer,
        platform=str(dev), tiers=runs, masked_loop_syncs=syncs,
        c_O3_wall_s=c_wall, vs_baseline=(wall / c_wall) if c_wall else None,
        note="scenes/benchmark.pine, outer x 49,999 Collatz chains; vs_baseline = the "
             "multiple of gcc -O3's wall on this host")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
