"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process (set-up once):

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> --frames <f> \
        --control-seeds <m> [--first-seed <s>]

For each of ``--seeds`` seeds, ``--frames`` frames of the seed's camera
walk through the program's timed path, then the check a run makes (the
cell's pixel draws against the plain reference): the lower readings.  For
each of the first ``--control-seeds`` seeds, the control, the reference
computed in bfloat16 put in the program's place for the same draws: the
upper readings.  One JSON line a reading; the benchmark's runs never run
this."""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_001)
    args = ap.parse_args()

    import torch

    from perfbench import build_scene, check, harness
    from perfbench.reference.render import render_pixels
    from perfbench.reference.scene import PlainScene
    from perfbench.walk import Walk

    reg = harness.Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, cfg_dir = reg.config(cell["config"])
    traffic, rule = reg.traffic(cell["traffic"]), reg.check(args.workload)
    harness.set_cache_dirs(ROOT)
    W, H = traffic["film"]
    spp, depth = traffic["spp"], traffic.get("depth", 0)
    scene = build_scene.program_scene(cfg, cfg_dir, (W, H))
    integ = harness.make_integrator(traffic, spp)
    plain = PlainScene(cfg["plain"])
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        walk = Walk(cfg["plain"]["camera"], traffic["walk"], seed)
        draws, views = check.Draws(seed, W, H, rule["pixels"]), []
        t0 = time.perf_counter()
        for _ in range(args.frames):
            views.append(walk.next())
            build_scene.set_view(scene.camera, *views[-1])
            integ.render(scene, device="cuda")
            draws.take(scene.camera.film.finalized())
        t1 = time.perf_counter()
        prog, rows, _ = draws.chosen(views)
        ref = render_pixels(plain, traffic["integrator"], rows, W, H, spp, depth, device="cuda")
        t2 = time.perf_counter()
        out = dict(seed=seed, kind="program", frames_s=t1 - t0, reference_s=t2 - t1,
                   **check.compare(prog, ref, rule))
        if k < args.control_seeds:
            ctl = render_pixels(plain, traffic["integrator"], rows, W, H, spp, depth,
                                device="cuda", dtype=torch.bfloat16)
            out["control"] = check.compare(ctl, ref, rule)
        print(json.dumps(out), flush=True)
    print(json.dumps(dict(kind="device", name=torch.cuda.get_device_name(0),
                          forbidden=harness.forbidden_modules())), flush=True)


if __name__ == "__main__":
    main()
