"""The dense traversal (pine_tpu_torch/accel/dense_traverse.py) against pine_tpu.

On the CPU ``group_query`` runs the plain PyTorch version of the CUDA kernel.
It is held against both references pine_tpu has on the CPU, for each of the
nine prim types, closest-hit and any-hit:

- the XLA packet walk (``PINE_TPU_PALLAS=0``), and
- the Pallas dense kernel in interpret mode (``_make_dense_kernel`` through
  ``pallas_group_query(..., variant="dense")``), on groups of 32 prims or fewer.

The rays mix a whole block that misses the group box (it must pass the
prepared state through bit for bit), dead lanes (``tmax = -1``), already
occluded lanes and a prepared ``best_t`` / ``best_e``.  Tolerance: t to rtol
1e-5, atol 1e-6 (as tests/test_dense_cull.py); ids equal on hit lanes; flags
equal.  The GPU test compares the CUDA kernel with the plain version on the
card and skips without one; it needs no JAX, so pine_tpu is imported only by
the tests that compare with it (the machine with the card has no JAX).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.convert import upload_group
from pine_tpu_torch.core import vecmath as PV
from pine_tpu_torch.scene import shapes as PS

torch.set_num_threads(2)

BIG = 1e30
N_RAYS = 2048  # two (8,128) blocks of the Pallas kernel
TYPES = {
    "sphere": PS.SPHERE, "rect": PS.RECT, "disk": PS.DISK, "plane": PS.PLANE,
    "aabb": PS.BOX_AABB, "obb": PS.BOX_OBB, "triangle": PS.TRIANGLE,
    "cone": PS.CONE, "cylinder": PS.CYLINDER,
}


@pytest.fixture()
def jx():
    """pine_tpu's modules and jax.numpy, for the tests that compare with them."""
    import types

    import jax.numpy as jnp

    from pine_tpu.accel import packet
    from pine_tpu.accel.pallas_traverse import pallas_group_query

    return types.SimpleNamespace(jnp=jnp, packet=packet, pallas_group_query=pallas_group_query)


def _unit(rng):
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def make_shape(tid, rng):
    """One random shape of type ``tid`` near the origin (the port's shape
    classes; their params() rows are pine_tpu's)."""
    c = rng.uniform(-1, 1, 3)
    if tid == PS.SPHERE:
        return PS.Sphere(c, rng.uniform(0.1, 0.3))
    if tid == PS.RECT:
        ex = _unit(rng) * rng.uniform(0.3, 0.8)
        ey = np.cross(ex, _unit(rng))
        ey = ey / np.linalg.norm(ey) * rng.uniform(0.3, 0.8)
        return PS.Rect(c, ex, ey)
    if tid == PS.DISK:
        return PS.Disk(c, _unit(rng), rng.uniform(0.1, 0.4))
    if tid == PS.PLANE:
        return PS.Plane(c, _unit(rng))
    if tid == PS.BOX_AABB:
        return PS.BoxAABB(c - rng.uniform(0.05, 0.3, 3), c + rng.uniform(0.05, 0.3, 3))
    if tid == PS.BOX_OBB:
        a = rng.uniform(-1, 1, 3)
        m = (PV.translate(c) @ PV.rotate_z(a[2]) @ PV.rotate_y(a[1]) @ PV.rotate_x(a[0])
             @ PV.scale(rng.uniform(0.2, 0.6, 3)))
        return PS.BoxOBB(PS.BoxAABB([0, 0, 0], [1, 1, 1]), m)
    if tid == PS.TRIANGLE:
        return PS.Triangle(c, c + rng.uniform(-0.5, 0.5, 3), c + rng.uniform(-0.5, 0.5, 3))
    if tid == PS.CONE:
        return PS.Cone(c, _unit(rng), rng.uniform(0.1, 0.3), rng.uniform(0.1, 0.5))
    return PS.Cylinder(c, c + _unit(rng) * rng.uniform(0.2, 0.6), rng.uniform(0.05, 0.2))


def make_prims(tid, n, seed):
    rng = np.random.default_rng(seed)
    prims = []
    for i in range(n):
        s = make_shape(tid, rng)
        prims.append((tid, s.params(), i, s.get_aabb()))
    return prims


def make_group(tid, n, seed, device="cpu"):
    (g,) = PPK.build_packet_accel(make_prims(tid, n, seed))["groups"]
    assert g["kind"] == "dense"
    return upload_group(g, device)


def make_both(jx, tid, n, seed):
    """The same random group in both packages: (pine_tpu accel, port group)."""
    jaccel = jx.packet.build_packet_accel(make_prims(tid, n, seed), [])
    pg = make_group(tid, n, seed)
    (jg,) = jaccel["groups"]
    assert jg["kind"] == "dense"
    np.testing.assert_array_equal(pg["rows"].numpy(), jg["rows_np"])
    return jaccel, pg


def make_rays(seed, n=N_RAYS):
    """Block 0 starts far out and points away from every group; block 1 is
    random, with dead lanes, small tmin and finite tmax."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[:1024] = [500.0, 0.0, 0.0]
    rd[:1024] = [1.0, 0.0, 0.0]
    tmin = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, 0.5, n)).astype(np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.3, rng.uniform(1, 6, n), 3.4e38).astype(np.float32)
    tmax[1024::7] = -1.0  # dead lanes
    return ro, rd, tmin, tmax


def prepared_closest(seed, tmax, n_prims):
    """A running best: some lanes already hold a hit (t, id), others start at tmax."""
    rng = np.random.default_rng(seed)
    n = tmax.shape[0]
    held = rng.uniform(size=n) < 0.3
    bt = np.where(held, np.minimum(rng.uniform(0.5, 4, n), tmax), tmax).astype(np.float32)
    be = np.where(held, rng.integers(0, n_prims, n), -1).astype(np.int32)
    return bt, be


def prepared_occ(seed, n):
    return (np.random.default_rng(seed).uniform(size=n) < 0.2).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(pg, ro, rd, tmin, tmax, bt, be, any_hit):
    t, e = DT.group_query(pg, _t(ro), _t(rd), _t(tmin), _t(tmax), _t(bt), _t(be), any_hit)
    return t.numpy(), e.numpy()


@pytest.mark.parametrize("name", list(TYPES))
def test_plain_matches_xla_walk(name, jx, monkeypatch):
    jnp, JPK = jx.jnp, jx.packet
    tid = TYPES[name]
    jaccel, pg = make_both(jx, tid, 12, seed=tid)
    ro, rd, tmin, tmax = make_rays(100 + tid)
    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    j = tuple(jnp.asarray(x) for x in (ro, rd, tmin))

    # closest-hit, against a prepared running best
    bt, be = prepared_closest(200 + tid, tmax, 12)
    t_x, e_x = (np.asarray(x) for x in JPK.packet_intersect(jaccel, *j, jnp.asarray(bt)))
    t_p, e_p = _port(pg, ro, rd, tmin, tmax, bt, be, any_hit=False)
    hit = t_x < BIG
    assert hit[1024:].any(), "the random rays should hit something"
    np.testing.assert_array_equal(t_p < np.minimum(bt, BIG), hit)
    np.testing.assert_allclose(t_p[hit], t_x[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(e_p[hit], e_x[hit])
    # a lane whose limit is above the miss sentinel takes BIG, as in pine_tpu
    changed = t_p < bt
    assert (t_p[changed & ~hit] == np.float32(BIG)).all()
    # lanes the group does not improve pass through bit for bit
    np.testing.assert_array_equal(t_p[~changed].view(np.int32), bt[~changed].view(np.int32))
    np.testing.assert_array_equal(e_p[~changed], be[~changed])

    # any-hit: occ_out = max(occ_in, hit within (tmin, tmax))
    occ_in = prepared_occ(300 + tid, N_RAYS)
    occ_x = np.asarray(JPK.packet_any_hit(jaccel, *j, jnp.asarray(tmax)))
    t_p, occ_p = _port(pg, ro, rd, tmin, tmax, tmax, occ_in, any_hit=True)
    np.testing.assert_array_equal(occ_p, np.maximum(occ_in, occ_x.astype(np.int32)))
    np.testing.assert_array_equal(t_p.view(np.int32), tmax.view(np.int32))
    assert not occ_x[tmax <= tmin].any()


@pytest.mark.parametrize("name", list(TYPES))
def test_plain_matches_pallas_interpret(name, jx, monkeypatch):
    jnp = jx.jnp
    monkeypatch.setenv("PINE_TPU_PALLAS", "1")
    monkeypatch.setenv("PINE_SMALL_KERNEL", "dense")
    tid = TYPES[name]
    jaccel, pg = make_both(jx, tid, 8, seed=10 + tid)
    (jg,) = jaccel["groups"]
    ro, rd, tmin, tmax = make_rays(400 + tid)
    bt, be = prepared_closest(500 + tid, tmax, 8)
    occ_in = prepared_occ(600 + tid, N_RAYS)
    for any_hit, (bt_in, be_in) in ((False, (bt, be)), (True, (tmax, occ_in))):
        t_k, e_k = (np.asarray(x) for x in jx.pallas_group_query(
            jg, *(jnp.asarray(x) for x in (ro, rd, tmin, tmax, bt_in, be_in)),
            any_hit=any_hit, variant="dense"))
        t_p, e_p = _port(pg, ro, rd, tmin, tmax, bt_in, be_in, any_hit)
        if any_hit:
            np.testing.assert_array_equal(e_p, e_k)
            np.testing.assert_array_equal(t_p.view(np.int32), t_k.view(np.int32))
        else:
            hit = t_k < np.minimum(bt_in, BIG)
            np.testing.assert_array_equal(t_p < np.minimum(bt_in, BIG), hit)
            np.testing.assert_allclose(t_p[hit], t_k[hit], rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(e_p[hit], e_k[hit])
            # a miss either passes through or takes the sentinel: the TPU
            # kernel sweeps whole blocks, the port culls lane by lane
            miss = ~hit
            passthrough = t_p[miss].view(np.int32) == bt_in[miss].view(np.int32)
            assert (passthrough | (t_p[miss] == np.float32(BIG))).all()
        # block 0 misses the group box: the state passes through bit for bit
        np.testing.assert_array_equal(t_p[:1024].view(np.int32), bt_in[:1024].view(np.int32))
        np.testing.assert_array_equal(e_p[:1024], be_in[:1024])


def test_cull_window_rules():
    """Occluded lanes and dead lanes get an empty window; the rest reach the box."""
    pg = make_group(PS.SPHERE, 4, seed=1)
    n = 6
    ro = torch.tensor([[0.0, 0.0, -5.0]] * n)
    rd = torch.tensor([[0.0, 0.0, 1.0]] * n)
    tmin = torch.zeros(n)
    tmax = torch.tensor([1e30, 1e30, -1.0, 1e30, 1e-3, 1e30])
    occ = torch.tensor([0, 1, 0, 0, 0, 0], dtype=torch.int32)
    o = (ro[:, 0], ro[:, 1], ro[:, 2])
    d = (rd[:, 0], rd[:, 1], rd[:, 2])
    live = DT.cull_window(pg["gbox"], o, d, tmin, tmax, tmax, occ, any_hit=True)
    assert live.tolist() == [True, False, False, True, False, True]


def test_group_variant_choice():
    assert DT.group_variant(dict(rows=np.zeros((424, 12)), lattice=True, prim_aabbs=np.zeros((420, 6)))) == "dense"
    assert DT.group_variant(dict(rows=np.zeros((1004, 12)), lattice=True, prim_aabbs=np.zeros((1000, 6)))) == "lattice"
    assert DT.group_variant(dict(rows=np.zeros((1004, 12)), lattice=False, prim_aabbs=np.zeros((1000, 6)))) == "grid"


def test_lattice_rows_snap_like_pine_tpu(jx):
    """The reduced cbox's 36-cone lattice: snapped rows bit-equal to pine_tpu's,
    entity by entity."""
    import bench
    from pine_tpu.prl.interp import Interpreter

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import scene_arrays

    src = (bench.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", "-0.3 ~ 0.1 ~ 0.3")
           .replace("0.0 ~ 0.1 ~ 2.0", "0.5 ~ 0.1 ~ 1.0"))
    itp = Interpreter()
    itp.run(src, "<reduced cbox>")
    jcs = itp.get_var("scene").compile()
    jg = jcs.unified["groups"][2]
    assert jg["tid"] == PS.CONE and jg.get("lattice") is not None
    a = scene_arrays(scenes.cbox((32, 32), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0)))
    assert bool(a["group.2.lattice"]) and a["group.2.rows"].shape == (40, 12)
    n = 36

    def by_gidx(rows, base, ent_gidx):
        return {int(g): rows[k] for k, g in enumerate(ent_gidx[base:base + n])}

    jrows = by_gidx(jg["rows_np"], jg["base"], np.asarray(jcs.unified["ent_gidx"]))
    prows = by_gidx(a["group.2.rows"], int(a["group.2.base"]), a["ent_gidx"])
    assert jrows.keys() == prows.keys()
    for g in jrows:
        np.testing.assert_array_equal(prows[g].view(np.int32), jrows[g].view(np.int32))
    # unsnapped, the script's rows drift from the lattice model
    raw = a["table.7"]
    assert not np.array_equal(raw, np.stack([prows[g] for g in sorted(prows)]))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain_on_card(any_hit):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    for name, tid in TYPES.items():
        g = make_group(tid, 12, seed=20 + tid, device=dev)
        ro, rd, tmin, tmax = make_rays(700 + tid)
        if any_hit:
            bt_in, be_in = tmax, prepared_occ(800 + tid, N_RAYS)
        else:
            bt_in, be_in = prepared_closest(800 + tid, tmax, 12)
        args = [torch.from_numpy(np.array(x)).to(dev) for x in (ro, rd, tmin, tmax, bt_in, be_in)]
        t_k, e_k = DT.group_query(g, *args, any_hit=any_hit)
        t_p, e_p = DT.dense_plain(g["tid"], g["rows"], g["gbox"], *args, any_hit)
        torch.cuda.synchronize()
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6, msg=name)
        assert torch.equal(e_k, e_p), name
