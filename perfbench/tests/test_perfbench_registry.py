"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its name, including a configuration, a traffic mix and a
metric added as files in a temporary directory."""
import json
import os
import re

import pytest

from conftest import REPO, make_root, write_json
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/") and os.path.isfile(os.path.join(REPO, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_piece_found_by_name(cell):
    reg = harness.Registry(REPO)
    w = reg.workload(cell)
    cfg, _ = reg.config(w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == []
    traffic = reg.traffic(w["traffic"])
    assert traffic["integrator"] in harness.INTEGRATORS and traffic["spp"] == 16
    rule = reg.check(cell)
    assert set(rule["limits"]) == {"px_off", "mean_gap"}
    for m in reg.metrics(cell, "per_layer"):
        assert callable(reg.reader(m["name"]))


def test_added_as_files_from_a_temporary_directory(tmp_path):
    """A throwaway configuration (a floor, a box and a light), a traffic mix
    and a metric, each a file of its own, run through the committed harness."""
    extra = tmp_path / "extra"
    write_json(str(extra / "configs" / "plainbox.json"), {
        "name": "plainbox", "source": "a test", "reduced": [], "program": {"plain": True},
        "plain": {
            "materials": {"white": {"type": "diffuse", "albedo": [0.8, 0.8, 0.8]},
                          "lamp": {"type": "emissive", "color": [20, 20, 20], "scale": 1}},
            "shapes": [
                {"type": "rect", "position": [0, 0, 0], "ex": [4, 0, 0], "ey": [0, 0, 4],
                 "material": "white"},
                {"type": "box", "lower": [0, 0, 0], "upper": [1, 1, 1],
                 "transform": [["translate", [-0.5, 0.0, -0.5]]], "material": "white"},
                {"type": "rect", "position": [0, 3, 0], "ex": [1, 0, 0], "ey": [0, 0, 1],
                 "material": "lamp"}],
            "camera": {"from": [0, 2, -4], "to": [0, 0.5, 0], "fov": 0.5,
                       "tone_map": "uncharted2"}}})
    os.makedirs(extra / "metrics")
    (extra / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.frame_walls))\n")
    traffic = {"integrator": "path", "spp": 16, "depth": 2, "film": [6, 4],
               "walk": {"step": 0.0025, "max_offset": 0.01, "turn": 0.002, "max_turn": 0.01}}
    rule = {"pixels": 24, "tol_abs": 1e-3, "tol_rel": 1e-3,
            "limits": {"px_off": 0.2, "mean_gap": 0.01}}
    root = make_root(tmp_path, extra_configs=[{
        "name": "plainbox", "source": "a test", "file": "extra/configs/plainbox.json",
        "reduced": [], "why": "a test"}], extra_cells=[("plainbox.tiny", "plainbox", traffic, rule)])
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "msamples_per_s", "workloads": ["plainbox.tiny"]})
    write_json(os.path.join(root, "BENCHMARK.json"), bench)
    result, _ = harness.run("plainbox.tiny", 2**31 + 11, 0, 1, root=root, device="cpu")
    assert result["correct"], result["check"]
    assert result["metrics"]["frames_seen"] == {"value": 1.0, "unit": "frames"}
    assert result["metrics"]["scene_build_s"]["value"] > 0
