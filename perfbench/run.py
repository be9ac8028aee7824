"""The benchmark's one command: one run of one cell on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see perfbench/README.md.
"""
import os
import sys
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this script's directory
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]

if __name__ == "__main__":
    from perfbench import harness

    sys.exit(harness.main(t_start=harness.process_start() or T_START))
