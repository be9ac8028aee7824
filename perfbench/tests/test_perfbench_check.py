"""The check that decides ``correct``, at sizes a CPU holds: the plain
reference against the port's CPU render on a tiny film of each
configuration; the control (the reference computed in bfloat16 in the
program's place) against each cell's limits; and a run whose timed path
is broken underneath, once for each fault a one-chip render can have."""
import numpy as np
import pytest
import torch

from conftest import TINY
from perfbench import check, harness
from perfbench.reference.render import render_pixels
from perfbench.reference.scene import PlainScene
from perfbench.walk import Walk

SEED = 3_141_592_653


@pytest.mark.parametrize("cell", sorted(TINY))
def test_reference_against_the_port_on_the_cpu(tiny_root, cell):
    result, lines = harness.run(cell, SEED, 0, 0, root=tiny_root, device="cpu")
    assert result["correct"], lines
    assert result["check"]["mean_gap"]["value"] < 1e-3


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_in_bfloat16_is_not_correct(tiny_root, cell):
    """The reference in bfloat16 put in the program's place, on twelve
    pixels of a frame of each of three seeds."""
    reg = harness.Registry(tiny_root)
    w = reg.workload(cell)
    cfg, _ = reg.config(w["config"])
    traffic, rule = reg.traffic(w["traffic"]), reg.check(cell)
    W, H = traffic["film"]
    scene = PlainScene(cfg["plain"])
    for seed in (1, 2**31 + 7, 99):
        walk = Walk(cfg["plain"]["camera"], traffic["walk"], seed)
        pos, fwd = walk.next()
        xy = np.random.default_rng(seed).integers(0, [W, H], (12, 2))
        rows = np.array([[x, y, *pos, *fwd] for x, y in xy], np.float64)
        args = (scene, traffic["integrator"], rows, W, H, 16, traffic.get("depth", 0))
        control = render_pixels(*args, dtype=torch.bfloat16)
        ref = render_pixels(*args)
        ok, compared = check.judge(check.compare(control, ref, rule), rule["limits"])
        assert not ok, compared


def _stale(mod, cls):
    def render(self, scene, device=None):
        return scene.camera.film  # the state left as it was: the frame before
    return cls, "render", render


def _half(mod, cls):
    import importlib

    m = importlib.import_module(mod)
    name = "render_wavefront" if cls == "PathIntegrator" else "render_ao"
    real = getattr(m, name)

    def halved(cscene, cam, W, H, sampler, spp, *a, **kw):
        return real(cscene, cam, W, H, sampler, spp // 2, *a, **kw)  # the mean of the rest
    return m, name, halved


def _altered(mod, cls):
    import importlib

    real = getattr(getattr(importlib.import_module(mod), cls), "render")

    def render(self, scene, device=None):
        film = real(self, scene, device)
        film.set_rgb(film.rgb * 1.02)  # every answer moved where it is produced
        return film
    return cls, "render", render


@pytest.mark.parametrize("cell", ["cbox.path-tiny", "cbox.ao-tiny"])
@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    import importlib

    reg = harness.Registry(tiny_root)
    integ = reg.traffic(reg.workload(cell)["traffic"])["integrator"]
    mod, cls = harness.INTEGRATORS[integ]
    target, name, fn = fault(mod, cls)
    if isinstance(target, str):
        target = getattr(importlib.import_module(mod), target)
    monkeypatch.setattr(target, name, fn)
    result, lines = harness.run(cell, SEED, 0, 0, root=tiny_root, device="cpu")
    assert not result["correct"], lines
