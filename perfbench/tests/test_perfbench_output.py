"""The result line's keys, the refusal without a card, and the import rules:
no module of perfbench imports JAX or the JAX package at its top level,
and nothing of the reference imports the program, by whole top-level
names."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO
from perfbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(tiny_root, trace):
    result, lines = harness.run("cbox.ao-tiny", 987654321987, 0, trace, root=tiny_root,
                                device="cpu")
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[-1] == "check" and lines[0].startswith("check px_off")
    assert keys[:5] == KEYS and set(keys) <= set(KEYS) | {"breakdown", "check"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())


def _imports(tree, top_level_only):
    nodes = tree.body if top_level_only else list(ast.walk(tree))
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(REPO, "perfbench", sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    yield path, ast.parse(fh.read())


def test_no_top_level_jax_import():
    for path, tree in _sources():
        bad = set(_imports(tree, True)) & {"jax", "jaxlib", "flax", "pine_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path, tree in _sources("reference"):
        bad = set(_imports(tree, False)) & {"jax", "jaxlib", "flax", "pine_tpu",
                                            "pine_tpu_torch"}
        assert not bad, (path, bad)


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "pine_tpu_torch_fake", object())
    assert "pine_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pine_tpu.fake", object())
    assert "pine_tpu.fake" in harness.forbidden_modules()


def test_refuses_without_a_card_or_a_program(tmp_path):
    """Here, with no card, and in a directory with only BENCHMARK.json and
    the benchmark's files: a non-zero exit and no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "cbox.ao-1440sq",
                           "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
