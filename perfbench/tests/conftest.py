"""Fixtures of the benchmark's CPU tests: a checkout-like root in a temporary
directory whose BENCHMARK.json adds tiny cells (the films cut to a few
pixels) beside the real ones, with their traffic and checks under a second
path; the real ``perfbench`` is linked in, so the harness's code, the
configurations and the readers are the committed ones."""
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WALK = {"step": 0.0025, "max_offset": 0.01, "turn": 0.002, "max_turn": 0.01}
# tiny cell -> (configuration, integrator, film, the real cell whose check it takes)
TINY = {
    "cbox.path-tiny": ("cbox", "path", [10, 8], "cbox.ao-1440sq"),
    "cbox.ao-tiny": ("cbox", "ao", [10, 8], "cbox.ao-1440sq"),
    "terrain.ao-tiny": ("terrain", "ao", [6, 4], "terrain.ao-1080p"),
}


def write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def make_root(tmp, extra_configs=(), extra_cells=()):
    """A checkout-like root under ``tmp`` -> its path.  ``extra_cells``:
    (name, configuration, traffic dict, check dict)."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.symlink(os.path.join(REPO, "perfbench"), os.path.join(tmp, "perfbench"))
    bench["paths"] = bench["paths"] + ["extra"]
    cells = []
    for name, (cfg, integ, film, real) in TINY.items():
        traffic = {"integrator": integ, "spp": 16, "film": film, "walk": WALK}
        if integ == "path":
            traffic["depth"] = 4
        with open(os.path.join(REPO, "perfbench", "checks", real + ".json")) as f:
            rule = json.load(f)
        rule["pixels"] = 64
        cells.append((name, cfg, traffic, rule))
    for name, cfg, traffic, rule in cells + list(extra_cells):
        tname = name.split(".", 1)[1]
        write_json(os.path.join(tmp, "extra", "traffic", tname + ".json"), traffic)
        write_json(os.path.join(tmp, "extra", "checks", name + ".json"), rule)
        bench["workloads"].append({"name": name, "config": cfg, "traffic": tname, "chips": 1,
                                   "why": "a tiny CPU cell"})
    for entry in extra_configs:
        bench["configs"].append(entry)
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + [c[0] for c in cells + list(extra_cells)]
    write_json(os.path.join(tmp, "BENCHMARK.json"), bench)
    return str(tmp)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
