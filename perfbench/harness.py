"""One run of one benchmark cell: set-up, the timed window, the traced frames
(``--trace 1``), the check against the plain reference, and the result line.

Everything a cell is made of is found by name: the cell in BENCHMARK.json's
``workloads``, its configuration at the ``file`` the configuration's entry
names, its traffic mix at ``traffic/<name>.json`` and its check at
``checks/<cell>.json`` under one of the benchmark's ``paths``, and each
per-layer metric's reader at ``metrics/<name>.py`` there.  A run:

1. set-up: imports, the scene (``build_scene``), ``Scene.compile`` and one
   1-spp warm-up frame at the cell's film, from the start of the process;
2. the window: frames back to back, each at the next view of the seeded
   camera walk (``walk``), until the first frame that ends after
   ``--seconds``; a frame is the integrator's ``render(scene)`` and the
   film's tone-mapped image in host memory;
3. with ``--trace 1``, two more frames under torch.profiler: one of the
   card's activity alone (busy time, launches, the kernels that took most
   time), and one with the host's operations and the benchmark's ranges
   around the compiled scene's ``intersect`` and ``any_hit`` (device time
   by range, the idle gaps by what the host was doing);
4. the program's state freed, the check (``check``), and the result.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pine_tpu")
INTEGRATORS = {
    "path": ("pine_tpu_torch.integrators.path", "PathIntegrator"),
    "ao": ("pine_tpu_torch.integrators.ao", "AOIntegrator"),
}


class Registry:
    """BENCHMARK.json of the checkout at ``root``, and its files by name."""

    def __init__(self, root=ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _find(self, sub, name, ext):
        for p in self.bench["paths"]:
            path = os.path.join(self.root, p, sub, name + ext)
            if os.path.isfile(path):
                return path
        raise FileNotFoundError(f"no {sub}/{name}{ext} under {self.bench['paths']}")

    def workload(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        """-> (configuration dict, its directory)."""
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        path = os.path.join(self.root, entry["file"])
        with open(path) as f:
            return json.load(f), os.path.dirname(path)

    def traffic(self, name):
        with open(self._find("traffic", name, ".json")) as f:
            return json.load(f)

    def check(self, workload):
        with open(self._find("checks", workload, ".json")) as f:
            return json.load(f)

    def metrics(self, workload, group):
        """The ``group`` ("end_to_end" or "per_layer") metrics of a cell."""
        return [m for m in self.bench[group]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, name):
        """The ``read(ctx)`` function of metrics/<name>.py."""
        path = self._find("metrics", name, ".py")
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def process_start():
    """Wall-clock time at which this process started, from /proc; None where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def set_cache_dirs(root):
    """Build and kernel caches inside the checkout, at fixed paths, so that
    only a checkout's first run builds.  The program's own nvcc libraries go
    to build/pine_tpu_torch/ (cuda_build.BUILD_DIR); these two hold what a
    PyTorch extension or a Triton kernel of the program would build."""
    base = os.path.join(root, "build", "perfbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def make_integrator(traffic, spp):
    import importlib

    mod, cls = INTEGRATORS[traffic["integrator"]]
    from pine_tpu_torch.core.samplers import BlueSampler

    Integ = getattr(importlib.import_module(mod), cls)
    sampler = BlueSampler(spp)
    return Integ(sampler, traffic["depth"]) if traffic["integrator"] == "path" else Integ(sampler)


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def traced_frames(scene, device, render_frame):
    """The two traced frames -> (trace_a, trace_b, breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import profile_events as pe

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_frame()
        wall_a = time.perf_counter() - t0
    ev_a = pe.device_events(prof)
    names = pe.by_name(ev_a)
    trace_a = dict(wall_s=wall_a, busy_s=pe.busy_ns(ev_a) / 1e9, launches=len(ev_a))

    cs = scene.compile(device)
    calls = []
    real = {"intersect": cs.intersect, "any_hit": cs.any_hit}

    def wrap(kind):
        def traced(ro, *a, **kw):
            with record_function(pe.PREFIX + kind):
                out = real[kind](ro, *a, **kw)
            calls.append((kind, int(ro.shape[0])))
            return out
        return traced

    cs.intersect, cs.any_hit = wrap("intersect"), wrap("any_hit")
    try:
        sync(device)
        with profile(activities=[ProfilerActivity.CPU] + acts[:on_card]) as prof:
            with record_function(pe.PREFIX + "frame"):
                render_frame()
    finally:
        del cs.intersect, cs.any_hit  # the class's methods again
    ev_b = pe.device_events(prof)
    by_range, placed = pe.device_ns_by_range(prof, ev_b)
    ranges = pe.host_ranges(prof)
    frame = next((r for r in ranges if r[0] == "frame"), None)
    gaps = pe.idle_gaps(ev_b, ranges, frame[1], frame[2]) if frame and ev_b else []
    trace_b = dict(device_ns=sum(d for _, _, d, *_ in ev_b),
                   traversal_ns=by_range.get("intersect", 0) + by_range.get("any_hit", 0),
                   calls=calls, placed=placed)
    totals = {}
    for label, s in gaps:
        totals[label] = totals.get(label, 0.0) + s
    print(f"[perfbench] traced frame B: launches placed by runtime call / linked op / not "
          f"{placed}; idle seconds by host range {totals}", file=sys.stderr)
    # idle seconds by what the host was doing, then the longest gaps themselves
    idle = [[f"total.{label}", s] for label, s in sorted(totals.items(), key=lambda kv: -kv[1])]
    breakdown = {
        "device_ops": [[n[:120], s] for n, (s, _) in
                       sorted(names.items(), key=lambda kv: -kv[1][0])[:10]],
        "idle_gaps": (idle + [[label, s] for label, s in gaps])[:10],
    }
    if not ev_a:
        return None, None, None
    return trace_a, trace_b, breakdown


def run(workload, seed, seconds, trace, root=ROOT, device="cuda", t_start=None):
    """One run of cell ``workload`` -> (result dict, check lines)."""
    t_start = time.time() if t_start is None else t_start
    reg = Registry(root)
    cell = reg.workload(workload)
    cfg, cfg_dir = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    rule = reg.check(workload)
    set_cache_dirs(root)

    import torch

    from perfbench import build_scene, check
    from perfbench.reference.render import render_pixels
    from perfbench.reference.scene import PlainScene
    from perfbench.roofline import prim_bytes
    from perfbench.walk import Walk

    W, H = traffic["film"]
    spp = traffic["spp"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.set_num_threads(1)  # one host thread: the launches, not a pool, set the pace
    spans = {}
    t0 = time.perf_counter()
    scene = build_scene.program_scene(cfg, cfg_dir, (W, H))
    spans["scene_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene.compile(device)
    sync(device)
    spans["compile"] = time.perf_counter() - t0
    cam = scene.camera
    walk = Walk(cfg["plain"]["camera"], traffic["walk"], seed)
    integrator = make_integrator(traffic, spp)

    def render_frame(integ=integrator):
        integ.render(scene, device=device)
        return cam.film.finalized()

    build_scene.set_view(cam, *walk.home_view())
    render_frame(make_integrator(traffic, 1))  # the warm-up frame
    sync(device)
    setup_s = time.time() - t_start
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    draws = check.Draws(seed, W, H, rule["pixels"])
    views, walls = [], []
    t_w = time.perf_counter()
    while True:
        view = walk.next()
        build_scene.set_view(cam, *view)
        t0 = time.perf_counter()
        img = render_frame()
        t1 = time.perf_counter()
        draws.take(img)
        views.append(view)
        walls.append(t1 - t0)
        if t1 - t_w >= seconds:
            break
    window_s = t1 - t_w
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {}
    frames = len(views)
    e2e = {"msamples_per_s": frames * W * H * spp / window_s / 1e6, "setup_s": setup_s}

    trace_a = trace_b = breakdown = None
    if trace:
        def next_frame():
            build_scene.set_view(cam, *walk.next())
            render_frame()

        trace_a, trace_b, breakdown = traced_frames(scene, device, next_frame)

    plain = PlainScene(cfg["plain"])
    if trace:
        # what the readers read: set-up spans, the window's frame walls, the
        # traced frames' summaries (None without a card), the plain scene's bytes
        ctx = SimpleNamespace(spans=spans, spp=spp, frame_walls=walls, trace_a=trace_a,
                              trace_b=trace_b, scene_bytes=prim_bytes(plain),
                              peak_window_bytes=peak_window, on_card=on_card)
        for m in reg.metrics(workload, "per_layer"):
            v = reg.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in reg.metrics(workload, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the program's state goes before the reference runs
    del scene, integrator, cam, render_frame
    if on_card:
        torch.cuda.empty_cache()
    prog, rows, failed = draws.chosen(views)
    ref = render_pixels(plain, traffic["integrator"], rows, W, H, spp, traffic.get("depth", 0),
                        device=device)
    numbers = check.compare(prog, ref, rule)
    correct, compared = check.judge(numbers, rule["limits"])
    correct = correct and failed == 0

    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": int(max(peak_setup, peak_window))}
    if trace and trace_a is not None:
        device_rec["busy_s"] = trace_a["busy_s"]
        device_rec["window_s"] = trace_a["wall_s"]
    result = {"correct": bool(correct), "attempted": frames, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = compared
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in compared.items()]
    lines.append(f"check frames with a non-finite drawn pixel: {failed} of {frames} (limit 0)")
    q = np.quantile(walls, [0, 0.5, 1])
    print(f"[perfbench] {frames} frames in {window_s:.4f} s; frame s min / median / max "
          f"{q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f}; first {[round(w, 4) for w in walls[:4]]}",
          file=sys.stderr)
    return result, lines


def forbidden_modules():
    """Modules of JAX or of the JAX package this process holds, by whole
    top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None, t_start=None):
    import argparse

    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    reg = Registry()
    chips = reg.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[perfbench] needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = run(args.workload, args.seed, args.seconds, args.trace, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] the process holds JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
