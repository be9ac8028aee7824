"""The readers of the program's own spans and counters (host_ms_per_sample,
syncs_per_frame, traversal_span_ms_per_sample, shading_span_ms_per_sample)
on a record the tracer made on the CPU: a frame of each integrator recorded
under a torch.profiler session, as the harness's first traced frame is.  The
CPU has no device intervals and no syncs, so the test gives the record the
ones a card would (each span's device time its host time, two sync spans in
the first sample) and checks each reader's arithmetic against the record."""
from types import SimpleNamespace

import pytest
import torch

from conftest import REPO
from perfbench import harness

SPP = 2
READERS = ["host_ms_per_sample", "syncs_per_frame", "traversal_span_ms_per_sample",
           "shading_span_ms_per_sample"]


def reader(name):
    return harness.Registry(REPO).reader(name)


@pytest.fixture(params=["ao", "path"])
def record(request, monkeypatch):
    from pine_tpu_torch import scenes
    from pine_tpu_torch.core import profiler
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.ao import AOIntegrator
    from pine_tpu_torch.integrators.path import PathIntegrator

    profiler.disable()
    profiler.reset()
    scene = scenes.cbox((8, 8))
    integ = (AOIntegrator(BlueSampler(SPP)) if request.param == "ao"
             else PathIntegrator(BlueSampler(SPP), 3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        integ.render(scene, device="cpu")
        scene.camera.film.finalized()
    integ.render(scene, device="cpu")  # a later frame: not the one the readers read
    rec = profiler.first_frame()
    profiler.reset()
    for s in rec["spans"]:
        s["device_ms"] = (s["t1_ns"] - s["t0_ns"]) / 1e6
    first = next(s for s in rec["spans"] if s["name"] == "sample")
    for k in range(2):
        t0 = first["t0_ns"] + k * 250_000
        rec["spans"].append(dict(name="sync.cross", id=10 ** 9 + k, parent=first["id"],
                                 frame=rec["id"], attrs={}, t0_ns=t0, t1_ns=t0 + 125_000,
                                 own_ns=1_000, device_ms=None))
    rec["counters"]["syncs"] = 2
    monkeypatch.setattr(profiler, "first_frame", lambda: rec)
    return rec


def ctx(on_card=True):
    return SimpleNamespace(on_card=on_card, spp=SPP, spans={}, frame_walls=[1.0], trace_a=None,
                           trace_b=None)


def host_ms(s):
    return (s["t1_ns"] - s["t0_ns"]) / 1e6


def test_readers_on_a_cpu_record(record):
    spans = record["spans"]
    samples = [s for s in spans if s["name"] == "sample"]
    trav = [s for s in spans if s["name"] in ("intersect", "any_hit")]
    ids = {s["id"]: s for s in spans}
    assert trav and all(ids[s["parent"]]["name"] not in ("intersect", "any_hit") for s in trav)

    def in_sample(s):
        while s["parent"] in ids:
            s = ids[s["parent"]]
            if s["name"] == "sample":
                return True
        return False

    own = sum(s["own_ns"] for s in spans if in_sample(s)) / 1e6
    assert own > 0.002  # the tracer's own time on every span inside, the two syncs' among it
    want = {
        "host_ms_per_sample": (sum(map(host_ms, samples)) - 0.25 - own) / SPP,
        "syncs_per_frame": 2,
        "traversal_span_ms_per_sample": sum(s["device_ms"] for s in trav) / SPP,
        "shading_span_ms_per_sample": (sum(s["device_ms"] for s in samples)
                                       - sum(s["device_ms"] for s in trav)) / SPP,
    }
    for name in READERS:
        assert reader(name)(ctx()) == pytest.approx(want[name], rel=1e-12), name
    assert want["shading_span_ms_per_sample"] > 0 and want["host_ms_per_sample"] > 0


def test_readers_read_nothing_off_the_card_or_without_the_tracer(record, monkeypatch):
    from pine_tpu_torch.core import profiler

    for name in READERS:
        assert reader(name)(ctx(on_card=False)) is None
    monkeypatch.setattr(profiler, "first_frame", lambda: None)
    for name in READERS:
        assert reader(name)(ctx()) is None
    monkeypatch.delattr(profiler, "first_frame")  # the parent commit's program
    for name in READERS:
        assert reader(name)(ctx()) is None


def test_device_readers_need_the_device_intervals(record):
    for s in record["spans"]:
        s["device_ms"] = None  # a record made off the card
    assert reader("host_ms_per_sample")(ctx()) > 0
    for name in ("traversal_span_ms_per_sample", "shading_span_ms_per_sample"):
        assert reader(name)(ctx()) is None
