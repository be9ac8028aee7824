"""The port's tracer (pine_tpu_torch/core/profiler.py) and the spans and
counters of the frame path, on the CPU at 16x16 films; the two tests marked
``cuda`` run on the card (the syncs counter against PyTorch's sync debug
mode, and the device events of a profiled frame with and without the spans)
and skip without one.  No JAX here."""
from __future__ import annotations

import collections
import json
import warnings

import numpy as np
import pytest
import torch

from pine_tpu_torch import cli, scenes
from pine_tpu_torch.core import profiler
from pine_tpu_torch.core.samplers import BlueSampler
from pine_tpu_torch.integrators.ao import AOIntegrator, render_ao
from pine_tpu_torch.integrators.path import PathIntegrator, render_wavefront

SIZE = 16
SPP = 2
DEPTH = 3
AO_NEST = {"sample": "frame", "camera": "sample", "intersect": "sample", "surface": "sample",
           "occlusion": "sample", "film": "sample", "any_hit": "occlusion"}
PATH_NEST = {"tile_order": "frame", "chunk": "frame", "sample": "chunk", "camera": "sample",
             "depth": "sample", "intersect": "depth", "arrive": "depth", "material": "depth",
             "bsdf": "depth", "sort": "depth", "nee": "depth", "any_hit": "nee"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


@pytest.fixture(scope="module")
def box():
    return scenes.cbox((SIZE, SIZE))


def integrator(kind):
    return AOIntegrator(BlueSampler(SPP)) if kind == "ao" else PathIntegrator(BlueSampler(SPP),
                                                                              DEPTH)


def render(scene, kind):
    integrator(kind).render(scene, device="cpu")
    return scene.camera.film.finalized()


def by_id(rec):
    return {s["id"]: s for s in rec["spans"]}


def test_off_records_nothing(box):
    assert profiler.span("x", a=1) is profiler.NOOP
    assert profiler.sync("x") is profiler.NOOP
    render(box, "ao")
    assert profiler.frames() == [] and profiler.first_frame() is None
    assert profiler.setup_spans() == []
    assert profiler.span("intersect", lanes=4) is profiler.NOOP


def test_enable_records_parents_frames_attrs_and_exports(box, tmp_path):
    profiler.enable()
    with profiler.span("outer", k=1):
        with profiler.span("inner"):
            pass
    render(box, "ao")
    render(box, "path")
    setup = profiler.setup_spans()
    outer, inner = setup
    assert (outer["name"], outer["parent"], outer["frame"], outer["attrs"]) == ("outer", None,
                                                                                None, {"k": 1})
    assert inner["parent"] == outer["id"] and inner["t0_ns"] >= outer["t0_ns"]
    assert inner["t1_ns"] <= outer["t1_ns"]
    ao, path = profiler.frames()
    assert path["id"] == ao["id"] + 1
    assert (ao["attrs"], path["attrs"]) == ({"integrator": "ao"}, {"integrator": "path"})
    for rec in (ao, path):
        assert all(s["frame"] == rec["id"] for s in rec["spans"])
        assert all(s["device_ms"] is None for s in rec["spans"])  # off the card
        assert [s["name"] for s in rec["spans"] if s["parent"] not in by_id(rec)] == [
            "frame", "film.readback"]
    assert [s["attrs"]["i"] for s in ao["spans"] if s["name"] == "sample"] == list(range(SPP))
    assert [s["attrs"]["k"] for s in ao["spans"] if s["name"] == "occlusion"] == list(range(8)) * SPP
    assert {s["attrs"]["lanes"] for s in ao["spans"] if s["name"] in ("intersect", "any_hit")} == {
        SIZE * SIZE}
    assert [s["attrs"]["d"] for s in path["spans"] if s["name"] == "depth"] == list(range(DEPTH)) * SPP
    out = tmp_path / "trace.json"
    profiler.export(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    cs = [e for e in events if e["ph"] == "C"]
    assert len(xs) == len(setup) + len(ao["spans"]) + len(path["spans"])
    assert {e["name"] for e in cs} >= {"rays.camera", "rays.closest", "rays.any_hit", "lanes.hit",
                                       "lanes.live.d0"}
    frame = next(e for e in xs if e["name"] == "frame")
    assert frame["ts"] == ao["t0_ns"] / 1e3 and frame["dur"] > 0 and frame["args"]["frame"] == ao["id"]
    lines = profiler.tree()
    assert lines[0].split()[:2] == ["span", "calls"]
    assert any(ln.split()[0] == "frame" and ln.split()[1] == "2" for ln in lines[1:])
    assert any(ln.startswith("      any_hit") for ln in lines)  # frame > sample > occlusion


@pytest.mark.parametrize("kind", ["ao", "path"])
def test_profiler_session_carries_ranges_and_nesting(box, kind):
    from torch.profiler import ProfilerActivity, profile

    render(box, kind)  # not recorded: nothing was recording as it started
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(box, kind)
    render(box, kind)  # the session is over: not recorded
    names = {e.name for e in prof.events()}
    assert {"pine.frame", "pine.sample", "pine.intersect", "pine.any_hit", "pine.camera",
            "pine.film.readback"} <= names
    (rec,) = profiler.frames()
    assert profiler.first_frame() == rec
    spans = by_id(rec)
    nest = AO_NEST if kind == "ao" else PATH_NEST
    for s in rec["spans"]:
        parent = spans.get(s["parent"], {}).get("name")
        if s["name"] in nest:
            assert parent == nest[s["name"]], (s["name"], parent)
        elif s["name"].startswith("group."):
            assert parent in ("intersect", "any_hit")
    assert {s["name"] for s in rec["spans"]} >= set(nest) | {"frame", "film.readback"}


@pytest.mark.parametrize("kind", ["ao", "path"])
def test_image_is_bit_for_bit_with_tracing_on(box, kind):
    off = render(box, kind)
    profiler.enable()
    on = render(box, kind)
    assert profiler.frames() and np.array_equal(off, on)


def test_counters_agree_with_return_stats(box):
    profiler.enable()
    cs, cam = box.compile("cpu"), box.camera
    with profiler.frame("cpu"):
        _, stats = render_ao(cs, cam, SIZE, SIZE, BlueSampler(SPP), SPP, 1.5, return_stats=True)
    with profiler.frame("cpu"):
        _, pstats = render_wavefront(cs, cam, SIZE, SIZE, BlueSampler(SPP), SPP, DEPTH,
                                     chunk=SIZE * SIZE // 2, return_stats=True)
    ao, path = (r["counters"] for r in profiler.frames())
    assert ao["rays.camera"] == SIZE * SIZE * SPP
    assert ao["rays.camera"] + 8 * ao["lanes.hit"] == stats["traced_rays"]
    assert ao["rays.any_hit"] == 8 * SIZE * SIZE * SPP and "syncs" not in ao  # no sync on the CPU
    live = sum(v for k, v in path.items() if k.startswith("lanes.live.d"))
    shadow = sum(v for k, v in path.items() if k.startswith("lanes.shadow.d"))
    assert live + shadow == pstats["traced_rays"]
    assert path["lanes.live.d0"] == SIZE * SIZE * SPP == path["rays.camera"]
    assert path["rays.closest"] == DEPTH * SIZE * SIZE * SPP
    assert {k for k in path if k.startswith("lanes.live.d")} == {f"lanes.live.d{d}"
                                                                 for d in range(DEPTH)}


def test_record_format_the_readers_rely_on(box):
    profiler.enable()
    for _ in range(profiler.KEEP + 2):
        render(box, "ao")
    recs = profiler.frames()
    first = profiler.first_frame()
    assert len(recs) == profiler.KEEP and first["id"] < recs[0]["id"]
    for rec in [first] + recs:
        assert set(rec) == {"id", "attrs", "t0_ns", "t1_ns", "counters", "spans"}
        assert rec["t0_ns"] <= rec["spans"][0]["t0_ns"] and rec["t1_ns"] > rec["t0_ns"]
        for s in rec["spans"]:
            assert set(s) == {"name", "id", "parent", "frame", "attrs", "t0_ns", "t1_ns",
                              "own_ns", "device_ms"}
            assert isinstance(s["t0_ns"], int) and s["t1_ns"] >= s["t0_ns"]
            assert isinstance(s["own_ns"], int) and s["own_ns"] >= 0
        spans = by_id(rec)
        inside = collections.Counter()  # children's host time and the tracer's own on them
        for s in rec["spans"]:
            if s["parent"] in spans:
                inside[s["parent"]] += s["t1_ns"] - s["t0_ns"] + s["own_ns"]
        assert all(n <= spans[p]["t1_ns"] - spans[p]["t0_ns"] for p, n in inside.items())
        assert all(isinstance(v, int) for v in rec["counters"].values())
        json.dumps(rec)
    assert profiler.frames() == recs  # reading resolves once, then reads the same


def test_launches_counted_from_dense_traverse_and_ranges_need_the_fast_range(box, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from pine_tpu_torch.accel import dense_traverse

    assert any(c is dense_traverse.LAUNCHES for c in profiler._launches)  # read, not duplicated
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="_RecordFunctionFast"):
            render(box, "ao")


def test_counter_keeps_device_tensors_until_read():
    profiler.enable()
    with profiler.frame("cpu"):
        profiler.count("c", torch.tensor(3))
        profiler.count("c", 4)
        profiler.count("lanes.live.d", torch.tensor(2), 0)
        profiler.count("h", 1.5)
    (rec,) = profiler.frames()
    assert rec["counters"] == {"c": 7, "lanes.live.d0": 2, "h": 1.5}


def test_cli_trace_writes_the_record(tmp_path, monkeypatch, capsys):
    from pine_tpu_torch.core import options

    monkeypatch.setattr(options, "device", options.device)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "s.pine").write_text(
        "scene := Scene();"
        "scene.add(Rect([0, 2, 0], [1, 0, 0], [0, 0, 1]), Emissive([10, 10, 10]));"
        "scene.add(Sphere([0, 0, 0], 0.5), Diffuse([0.7, 0.6, 0.5]));"
        "scene.set(ThinLenCamera(Film([8, 8]), [0, 0.6, -2.5], [0, 0, 0], 0.5));"
        "AOIntegrator(UniformSampler(2)).render(scene);"
        "scene.camera.film().save('s.png');\n")
    assert cli.main(["s.pine", "--platform", "cpu", "--trace", "t.json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("Finished in") and out[-2] == "trace written to t.json"
    assert any(ln.split()[0] == "scene.build" for ln in out)
    names = {e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"scene.build", "scene.compile", "frame", "sample", "film.readback"} <= names
    assert profiler.span("x") is profiler.NOOP  # tracing ends with the script
    assert cli.main(["s.pine", "--platform", "cpu", "--trace"]) == 1


def _device_events(prof):
    """Kernels, copies and sets of a profiled run, without the annotations the
    profiler mirrors onto the card's timeline (perfbench/profile_events.py's
    rule)."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0
            and "annotation" not in (e.activity_type() if hasattr(e, "activity_type") else "")]


def _card_scene(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' device intervals and syncs exist there alone")
    scene = scenes.cbox((256, 256))
    integ = AOIntegrator(BlueSampler(16)) if kind == "ao" else PathIntegrator(BlueSampler(16), 4)
    integ.render(scene, device="cuda")  # warm-up: kernels, tables
    scene.camera.film.finalized()
    torch.cuda.synchronize()
    return scene, integ


@pytest.fixture
def card_box():
    return _card_scene("ao")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ao", "path"])
def test_syncs_counter_equals_sync_debug_warnings_on_card(kind):
    """Every synchronisation PyTorch's sync debug mode reports over a frame
    falls inside a ``sync.*`` span, as the innermost open span, and each such
    span holds exactly one."""
    scene, integ = _card_scene(kind)
    profiler.enable()
    at = []  # the innermost open span's id at each synchronisation

    def note(message, *args, **kwargs):
        if "synchroniz" in str(message):
            at.append(profiler._stack[-1].id if profiler._stack else None)

    torch.cuda.set_sync_debug_mode("warn")  # its own first call warns once: not recorded
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            integ.render(scene, device="cuda")
            scene.camera.film.finalized()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (rec,) = profiler.frames()
    syncs = {s["id"]: s["name"] for s in rec["spans"] if s["name"].startswith("sync.")}
    per_span, spans = collections.Counter(at), by_id(rec)
    outside = [spans[i]["name"] if i in spans else i for i in per_span if i not in syncs]
    assert not outside, f"synchronisations outside a sync span, under: {outside}"
    assert set(per_span) == set(syncs) and set(per_span.values()) == {1}
    assert rec["counters"]["syncs"] == len(at) > 0
    for s in rec["spans"]:  # a device interval on every span but the syncs and groups
        assert (s["device_ms"] is None) == s["name"].startswith(("sync.", "group.")), s["name"]


@pytest.mark.cuda
def test_spans_add_no_device_event_on_card(card_box, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    scene, integ = card_box
    counts = []
    for traced in (True, False):
        if not traced:  # the spans forced off under the same profiler sessions
            monkeypatch.setattr(profiler, "_profiler_recording", lambda: False)
        for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                integ.render(scene, device="cuda")
                scene.camera.film.finalized()
            counts.append(len(_device_events(prof)))
    assert len(profiler.frames()) == 2
    assert counts[:2] == counts[2:] and counts[0] == counts[1] > 0
