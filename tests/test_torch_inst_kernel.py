"""The instanced traversal (pine_tpu_torch/accel/inst_traverse.py) against pine_tpu.

On the CPU ``inst_query`` runs ``inst_plain``, the plain PyTorch version of
the CUDA two-level instanced kernel.  It is held against:

- pine_tpu's XLA two-level packet walk (its CPU default,
  ``PINE_TPU_PALLAS=0``) on a 3x3 field of ``bench_instanced.make_rock(12)``
  (242 triangles, 9 instances) and a 4x4 field of the ball mesh of
  tests/test_instancing.py, rays from above the field and from inside it:
  hit sets equal, t to rtol/atol 2e-4 (tests/test_instancing.py's criterion;
  the XLA walk forms local rays with einsum, the port in the kernel's
  expression order), virtual ids equal, occlusion flags equal.  The XLA walk
  keeps the first-visited hit on an exact tie across instances, the port the
  lowest id; no tie occurs on these inputs (the ids are all equal).
- a brute force over every instance and every row (``dense_plain`` in each
  instance's frame, merged by the ``(t, virtual id)`` rule): bit for bit,
  with a prepared running best and prepared occlusion flags.

pine_tpu's Pallas instanced kernel itself has no case here: in interpret
mode it did not answer one 64-ray query within 400 s on the CPU.
The JAX package's own tests/test_instancing.py::
test_instanced_fast_path_interpret_parity holds that kernel against the XLA
walk, so the port is held against the kernel through the XLA walk.

The GPU test holds the CUDA kernel to ``inst_plain`` on the card and skips
without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pine_tpu_torch import scenes
from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import inst_traverse as IT
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.scene import shapes as PS
from test_torch_render import jax_inst_group

torch.set_num_threads(2)

BIG = 1e30


class _JaxMesh:
    def __init__(self, V, F):
        self.vertices, self.indices = V, F
        self.normals = self.texcoords = None


def ball_mesh(n=12, r=0.4):
    """tests/test_instancing.py's UV sphere."""
    th = np.linspace(0, np.pi, n)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    V = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T), r * np.sin(T) * np.sin(P)],
                 axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :], idx[1:, :]
    c, d = np.roll(idx[:-1, :], -1, axis=1), np.roll(idx[1:, :], -1, axis=1)
    F = np.concatenate([np.stack([a.ravel(), b.ravel(), c.ravel()], -1),
                        np.stack([c.ravel(), b.ravel(), d.ravel()], -1)]).astype(np.uint32)
    return V, F


def ball_transforms(nx, nz, spacing=1.2):
    """tests/test_instancing.py's grid of instances."""
    ms = []
    for i in range(nx):
        for j in range(nz):
            m = np.eye(4, dtype=np.float32)
            m[0, 3] = (i - nx / 2) * spacing
            m[1, 3] = 0.15 * ((i * 7 + j * 3) % 5)
            m[2, 3] = j * spacing + 1.0
            ms.append(m)
    return ms


def field(which):
    """(mesh vertices, indices, instancing record of the port's Mesh) of one
    test field."""
    if which == "rock3x3":
        (V, F), ms = scenes.make_rock(12), scenes.rock_transforms(3)
    else:
        (V, F), ms = ball_mesh(), ball_transforms(4, 4)
    return V, F, PPK.instancing_record(PS.Mesh(V, F), ms, np.arange(len(ms)))


def both(which):
    """One instancing in both packages -> (pine_tpu accel, port accel with
    pine_tpu's group carried across by convert's format and uploaded to the
    CPU).  pine_tpu's rows are taken as they are: on the symmetric ball its
    -march=native SAH build breaks cost ties another way than the port's
    (ROADMAP.md, section 3), and the ids follow the leaf order."""
    from pine_tpu.accel import packet as JPK

    V, F, rec = field(which)
    jacc = JPK.build_packet_accel([], [], instanced=[dict(rec, mesh=_JaxMesh(V, F))])
    (jg,) = jacc["groups"]
    pacc = dict(groups=[], inst_groups=[IT.upload_inst_group(jax_inst_group(jg), "cpu")],
                ent_gidx=torch.as_tensor(np.array(jacc["ent_gidx"])))
    return jacc, pacc


def field_rays(n, seed):
    """Half the rays from above and in front of the field, aimed into it;
    half start inside the field's box in random directions; every 9th lane
    is dead."""
    rng = np.random.default_rng(seed)
    h = n // 2
    ro = np.concatenate([np.tile([[0.0, 3.0, -4.0]], (h, 1)),
                         rng.uniform([-3, 0, 0.5], [2, 1.2, 5.5], (n - h, 3))]).astype(np.float32)
    tgt = np.stack([rng.uniform(-3.5, 2, h), rng.uniform(-0.2, 0.8, h),
                    rng.uniform(1.0, 6, h)], -1)
    rd = np.concatenate([tgt - ro[:h], rng.normal(size=(n - h, 3))]).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::9] = -1.0
    return ro, rd, tmin, tmax


@pytest.fixture(scope="module", params=["rock3x3", "ball4x4"])
def fields(request):
    return (request.param,) + both(request.param)


def test_plain_matches_xla_walk(fields, monkeypatch):
    import jax.numpy as jnp
    from pine_tpu.accel import packet as JPK

    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    which, jacc, pacc = fields
    ro, rd, tmin, tmax = field_rays(1024, seed=len(which))
    j = [jnp.asarray(x) for x in (ro, rd, tmin)]
    p = [torch.from_numpy(x) for x in (ro, rd, tmin)]
    t_j, e_j = (np.asarray(x) for x in JPK.packet_intersect(jacc, *j, jnp.asarray(tmax)))
    t_p, e_p = (x.numpy() for x in PPK.packet_intersect(pacc, *p, torch.from_numpy(tmax)))
    hit = t_j < 1e29
    np.testing.assert_array_equal(t_p < 1e29, hit)
    assert hit.sum() > 200, "the field must actually be hit"
    np.testing.assert_allclose(t_p[hit], t_j[hit], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(e_p[hit], e_j[hit])  # no tie breaks differently here

    tmax2 = np.where(tmax > 0, 3.0, -1.0).astype(np.float32)
    occ_j = np.asarray(JPK.packet_any_hit(jacc, *j, jnp.asarray(tmax2)))
    occ_p = PPK.packet_any_hit(pacc, *p, torch.from_numpy(tmax2)).numpy()
    assert 50 < occ_j.sum() < len(occ_j) - 50
    np.testing.assert_array_equal(occ_p, occ_j)


def brute_force(g, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Every instance, every row (dense_plain in the instance's frame), then
    the (t, virtual id) rule: the function the kernel computes."""
    rows = g["rows"][: g["n_tris"]]
    gbox = torch.tensor([-BIG] * 3 + [BIG] * 3)
    n = ro.shape[0]
    occ = best_e.clone()
    cur_t, cur_e = best_t.clone(), best_e.clone()
    for j in range(g["n_inst"]):
        ol, dl = IT.local_rays(g["minv"][j].expand(n, 12), ro, rd)
        if any_hit:
            _, o = DT.dense_plain(6, rows, gbox, ol, dl, tmin, tmax, tmax,
                                  torch.zeros_like(occ), True)
            occ = torch.maximum(occ, torch.where((best_e == 0) & (tmax > tmin), o, 0))
            continue
        t, e = DT.dense_plain(6, rows, gbox, ol, dl, tmin, best_t, best_t,
                              torch.full_like(best_e, -1), False)
        vid = g["vbase"] + j * g["stride"] + e
        better = (e >= 0) & ((t < cur_t) | ((t == cur_t) & (vid < cur_e)))
        cur_t, cur_e = torch.where(better, t, cur_t), torch.where(better, vid, cur_e)
    return (best_t, occ) if any_hit else (cur_t, cur_e)


def test_plain_is_the_brute_force(fields):
    """Culls only skip work: inst_plain equals the brute force bit for bit,
    against a prepared running best (regular ids below vbase) and prepared
    occlusion flags."""
    which, _, pacc = fields
    g = pacc["inst_groups"][0]
    n = 1024
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in field_rays(n, seed=len(which) + 1))
    rng = np.random.default_rng(len(which) + 2)
    held = torch.from_numpy(rng.uniform(size=n) < 0.3)
    bt = torch.where(held, torch.from_numpy(rng.uniform(2, 6, n).astype(np.float32)), tmax)
    be = torch.where(held, 2, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=n) < 0.2).astype(np.int32))
    tmax2 = torch.where(tmax > 0, 3.0, -1.0)
    for any_hit, args in ((False, (tmax, bt, be)), (True, (tmax2, tmax2, occ))):
        got = IT.inst_plain(g, ro, rd, tmin, *args, any_hit)
        want = brute_force(g, ro, rd, tmin, *args, any_hit)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if not any_hit:
            assert (got[1] >= g["vbase"]).sum() > 100
            assert torch.equal(got[1][held & (got[1] < g["vbase"])],
                               be[held & (got[1] < g["vbase"])])


def test_plain_counts_work(fields):
    """``counts`` adds the instances entered and grid_plain's tests; with
    each lane's final t as its window the closest-hit work shrinks."""
    which, _, pacc = fields
    g = pacc["inst_groups"][0]
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in field_rays(512, seed=len(which) + 3))
    be = torch.full((512,), -1, dtype=torch.int32)
    c_row = {}
    t, e = IT.inst_plain(g, ro, rd, tmin, tmax, tmax, be, False, counts=c_row)
    c_min = {}
    IT.inst_plain(g, ro, rd, tmin, tmax, t, e, False, counts=c_min)
    for k in ("entries", "slabs", "cells", "tests"):
        assert 0 < c_min[k] <= c_row[k], k
    assert c_row["cells"] <= c_row["slabs"]


def test_stack_need_gates_the_kernel(monkeypatch):
    """A group whose worst-case stack exceeds the kernel's is refused with
    both numbers, before anything is launched; the benchmark's fields fit."""
    _, pacc = both("rock3x3")
    g = pacc["inst_groups"][0]
    assert g["need"] == IT.stack_need(g["d_top"], g["d_mesh"]) <= IT.STACK_DEPTH
    # the kernel's own push rule needs d_top + 2 * TREE_LEAF + d_mesh - 2 at most
    for d_top in range(1, 20):
        for d_mesh in range(1, 8):
            assert d_top + 2 * IT.TREE_LEAF + d_mesh - 2 <= IT.stack_need(d_top, d_mesh)
    assert IT.stack_need(12, 5) == 117 <= IT.STACK_DEPTH  # the 101x101 field
    monkeypatch.setattr(IT, "STACK_DEPTH", g["need"] - 1)
    z = torch.zeros(4)
    with pytest.raises(NotImplementedError, match=f"{g['need']} entries.*has {g['need'] - 1}"):
        IT.inst_cuda(g, z.reshape(-1, 1).expand(4, 3), z.reshape(-1, 1).expand(4, 3), z, z, z,
                     z.to(torch.int32), False)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["rock3x3", "ball4x4"])
def test_kernel_matches_plain_on_card(which):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    V, F, rec = field(which)
    acc = PPK.build_packet_accel([], [], [rec])
    g = IT.upload_inst_group(acc["inst_groups"][0], dev)
    n = 8192
    ro, rd, tmin, tmax = (torch.from_numpy(x).to(dev) for x in field_rays(n, seed=5))
    rng = np.random.default_rng(6)
    held = torch.from_numpy(rng.uniform(size=n) < 0.3).to(dev)
    bt = torch.where(held, 2.5, tmax)
    be = torch.where(held, 1, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=n) < 0.2).astype(np.int32)).to(dev)
    tmax2 = torch.where(tmax > 0, 3.0, -1.0)
    for any_hit, args in ((False, (tmax, bt, be)), (True, (tmax2, tmax2, occ))):
        t_k, e_k = IT.inst_cuda(g, ro, rd, tmin, *args, any_hit)
        t_p, e_p = IT.inst_plain(g, ro, rd, tmin, *args, any_hit)
        torch.cuda.synchronize()
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
        assert torch.equal(e_k, e_p)
