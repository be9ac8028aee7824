"""The AO integrator's occlusion directions (pine_tpu_torch/integrators/ao.py,
csrc/ao_dirs.cu).

On the CPU ``render_ao`` takes the PyTorch chain ``occlusion_dirs_plain``
and launches no kernel; the wrappers refuse what the kernel does not take
before they build or launch anything.  The tests marked ``cuda`` hold both
forms of the kernel to the chain bit for bit on the card (2,073,600 lanes
and a ragged count, all eight directions of two samples, the normals at the
frame's edges), and ``render_ao``'s images to the chain's; they skip
without a card.  No JAX here."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pine_tpu_torch import scenes
from pine_tpu_torch.core import profiler
from pine_tpu_torch.core.samplers import BlueSampler, HaltonSampler, UniformSampler
from pine_tpu_torch.core.sampling import uniform_hemisphere
from pine_tpu_torch.core.vecmath import to_world
from pine_tpu_torch.integrators import ao
from pine_tpu_torch.integrators.ao import AOIntegrator

torch.set_num_threads(2)

SIZE = 16
SPP = 2


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


def _render(scene, sampler, device):
    AOIntegrator(sampler).render(scene, device=device)
    return scene.camera.film.finalized()


def _chain(monkeypatch):
    """render_ao's directions through the PyTorch chain, on any device."""
    monkeypatch.setattr(ao, "occlusion_dirs",
                        lambda ns, sampler, xs, ys, W, i, k:
                        ao.occlusion_dirs_plain(ns, sampler, xs, ys, i, k))


def _ao_dirs_launches(rec):
    return {k: v for k, v in rec["counters"].items() if k.startswith("launches.ao_dirs.")}


# ---- on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("sampler", [BlueSampler(SPP), UniformSampler(SPP)],
                         ids=["blue", "uniform"])
def test_cpu_render_takes_the_chain_and_launches_nothing(sampler, monkeypatch):
    box = scenes.cbox((SIZE, SIZE))
    before = dict(ao.LAUNCHES)

    def refuse(*args):
        raise AssertionError("a kernel wrapper was called on the CPU")

    monkeypatch.setattr(ao, "ao_dirs_blue", refuse)
    monkeypatch.setattr(ao, "ao_dirs_u", refuse)
    profiler.enable()
    img = _render(box, sampler, "cpu")
    (rec,) = profiler.frames()
    assert ao.LAUNCHES == before
    assert all(_ao_dirs_launches(rec).get(f"launches.ao_dirs.{f}", 0) == 0 for f in ("blue", "u"))
    _chain(monkeypatch)
    assert np.array_equal(img, _render(box, sampler, "cpu"))


def test_occlusion_dirs_on_the_cpu_is_the_chain():
    rng = np.random.default_rng(5)
    n = 7 * 5
    ns = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    idx = torch.arange(n)
    xs, ys = (idx % 7).to(torch.int32), (idx // 7).to(torch.int32)
    s = BlueSampler(16)
    for k in (0, 7):
        want = to_world(ns, uniform_hemisphere(s.u2(xs, ys, 3, 4 + 2 * k)))
        assert torch.equal(ao.occlusion_dirs(ns, s, xs, ys, 7, 3, k), want)


@pytest.mark.parametrize("case", ["cpu", "dtype", "shape", "noncontiguous"])
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    ns = torch.zeros(12, 3)
    if case == "dtype":
        ns = ns.double()
    elif case == "shape":
        ns = torch.zeros(12, 4)
    elif case == "noncontiguous":
        ns = torch.zeros(3, 12).t()
    want = {"cpu": "CUDA tensor", "dtype": "want torch.float32", "shape": r"\(12, 3\)",
            "noncontiguous": "contiguous"}[case]
    tables = BlueSampler(16).tables(torch.device("cpu"))
    before = dict(ao.LAUNCHES)
    with pytest.raises(ValueError, match=want):
        ao.ao_dirs_blue(ns, tables, 4, 0, 4)
    with pytest.raises(ValueError, match=want):
        ao.ao_dirs_u(ns, torch.zeros(12, 2))
    assert ao.LAUNCHES == before


@pytest.mark.parametrize("spp", [1, 16, 256])
def test_blue_tables_have_the_layout_the_kernel_reads(spp):
    """csrc/ao_dirs.cu draws from BlueSampler's tables as u1 does: one
    layout, ``TABLE_SIZES`` and ``TILE``, checked when the tables load."""
    s = BlueSampler(spp)
    sizes = [t.shape for t in s.tables(torch.device("cpu"))]
    assert sizes == [(size,) for _, size in BlueSampler.TABLE_SIZES]
    assert BlueSampler.TILE == 128 * 128 * 8 and dict(BlueSampler.TABLE_SIZES)["sobol"] == 256 * 256


def test_launch_counters_are_read_beside_the_traversal_ones():
    from pine_tpu_torch.accel import dense_traverse

    assert any(c is ao.LAUNCHES for c in profiler._launches)
    assert any(c is dense_traverse.LAUNCHES for c in profiler._launches)
    totals = profiler._launch_totals()
    assert {"ao_dirs.blue", "ao_dirs.u", "dense.any_hit"} <= set(totals)


# ---- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


EDGE_NORMALS = [
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    (0.6, 0.6, 0.52915026), (-0.6, 0.6, 0.52915026), (0.6, -0.6, -0.52915026),
    (0.5, -0.5, 0.0), (-0.0, 0.0, 1.0), (0.0, -0.0, -1.0), (-0.0, -0.0, 1.0), (-0.0, 1.0, -0.0),
    (1.0, -0.0, 0.0), (-1.0, 0.0, -0.0), (0.0, 0.0, 0.0), (1e-30, -1e-30, 0.0),
    (3.0, -2.0, 1.0), (1e-3, 1e-3, -1.0),
]


def _normals(n, dev, seed=11):
    """``n`` normals: the edge ones first, then random unit normals, some of
    them off unit length."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[::5] *= np.float32(1.5)
    v[:len(EDGE_NORMALS)] = np.asarray(EDGE_NORMALS, np.float32)
    return torch.from_numpy(v).to(dev)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("W, H", [(1920, 1080), (37, 29)], ids=["2073600", "ragged"])
def test_kernel_forms_equal_the_chain_bit_for_bit_on_card(W, H):
    dev = _card()
    n = W * H
    ns = _normals(n, dev)
    idx = torch.arange(n, device=dev)
    xs, ys = (idx % W).to(torch.int32), (idx // W).to(torch.int32)
    blue, other = BlueSampler(16), HaltonSampler(16)
    before = dict(ao.LAUNCHES)
    for i in (0, 13):
        for k in range(ao.DIRECTIONS):
            dim = 4 + 2 * k
            got = ao.ao_dirs_blue(ns, blue.tables(dev), W, i, dim)
            want = to_world(ns, uniform_hemisphere(blue.u2(xs, ys, i, dim)))
            assert _bits_equal(got, want), (i, k)
            u = other.u2(xs, ys, i, dim)
            assert _bits_equal(ao.ao_dirs_u(ns, u), to_world(ns, uniform_hemisphere(u))), (i, k)
    assert ao.LAUNCHES["ao_dirs.blue"] - before["ao_dirs.blue"] == 2 * ao.DIRECTIONS
    assert ao.LAUNCHES["ao_dirs.u"] - before["ao_dirs.u"] == 2 * ao.DIRECTIONS


@pytest.mark.cuda
def test_u_form_equals_the_chain_on_edge_values_on_card():
    """u at 0, at the samplers' largest value, at 0.25 / 0.5 / 0.75 (phi at
    the quadrants), each pair under every edge normal; then 2^20 lanes of u
    uniform in [0, 1) under random normals."""
    dev = _card()
    edges = np.float32([0.0, 0.25, 0.5, 0.75, 1.0 - 1e-7, 0.99999994, 1e-30, 0.5 / 256])
    grid = np.stack(np.meshgrid(edges, edges), -1).reshape(-1, 2)
    u = np.concatenate([np.tile(grid, (len(EDGE_NORMALS), 1)),
                        np.random.default_rng(3).random((1 << 20, 2), dtype=np.float32)])
    u = torch.from_numpy(u).to(dev)
    ns = _normals(u.shape[0], dev, seed=4)
    ns[:len(EDGE_NORMALS) * len(grid)] = torch.from_numpy(
        np.repeat(np.asarray(EDGE_NORMALS, np.float32), len(grid), 0)).to(dev)
    assert _bits_equal(ao.ao_dirs_u(ns, u), to_world(ns, uniform_hemisphere(u)))


@pytest.mark.cuda
def test_wrappers_refuse_on_card():
    dev = _card()
    ns = torch.zeros(12, 3, device=dev)
    tables = BlueSampler(16).tables(dev)
    with pytest.raises(ValueError, match="contiguous"):
        ao.ao_dirs_blue(torch.zeros(3, 12, device=dev).t(), tables, 4, 0, 4)
    with pytest.raises(ValueError, match="want torch.int32"):
        ao.ao_dirs_blue(ns, tuple(t.long() for t in tables), 4, 0, 4)
    with pytest.raises(ValueError, match="sobol"):
        ao.ao_dirs_blue(ns, (tables[0][:100],) + tables[1:], 4, 0, 4)
    with pytest.raises(RuntimeError, match="CUDA error"):  # no film width
        ao.ao_dirs_blue(ns, tables, 0, 0, 4)
    with pytest.raises(ValueError, match="want torch.float32"):
        ao.ao_dirs_u(ns, torch.zeros(12, 2, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="on cuda"):
        ao.ao_dirs_u(ns, torch.zeros(12, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "terrain"])
@pytest.mark.parametrize("sampler", ["blue", "uniform"])
def test_render_ao_on_card_equals_the_chain(name, sampler, monkeypatch):
    _card()
    dev = "cuda"
    size = (96, 56)
    scene = scenes.cbox(size) if name == "box" else scenes.terrain(size, grid=40)
    spp = 4
    s = BlueSampler(spp) if sampler == "blue" else UniformSampler(spp)
    _render(scene, s, dev)  # warm-up: kernels, tables
    profiler.enable()
    fused = _render(scene, s, dev)
    with monkeypatch.context() as m:
        _chain(m)
        chain = _render(scene, s, dev)
    fused_rec, chain_rec = profiler.frames()
    form = "blue" if sampler == "blue" else "u"
    assert _ao_dirs_launches(fused_rec) == {f"launches.ao_dirs.{form}": ao.DIRECTIONS * spp}
    assert _ao_dirs_launches(chain_rec) == {}
    assert fused_rec["counters"]["syncs"] < chain_rec["counters"]["syncs"]
    assert np.array_equal(fused, chain)
