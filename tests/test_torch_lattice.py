"""The lattice traversal (pine_tpu_torch/accel/lattice_traverse.py) against pine_tpu.

A prim group that forms a regular lattice (script loops) of more than 512
rows takes the lattice march: the CUDA kernel csrc/lattice_traverse.cu on the
card, ``lattice_plain`` on the CPU.  Held here:

- the lattice model: the port's ``_detect_lattice`` returns pine_tpu's dict
  key for key (affine model, dual basis, margins, capacities, snapped rows)
  on cone fields of 6x5, 24x24, 1x24 and 40x40 (the cone forest's) and
  rejects a jittered field as pine_tpu does; ``build_packet_accel``'s
  ``slot_of_k`` sends each lattice index to the same row in both packages;
  ``lattice_layout``'s table and window cap equal ``_lattice_smem``'s;
- ``lattice_plain`` against pine_tpu's Pallas lattice kernel in interpret
  mode (``pallas_group_query(..., variant="lattice")``) on pine_tpu's 6x5
  group carried across, 512 rays as tests/test_lattice.py makes them,
  closest-hit and any-hit: the same lanes improve, ids equal on them
  (pine_tpu gathers a slot on every lane and its caller masks the rest; the
  port passes best_e through), flags equal; t to rtol 1e-4 / atol 1e-6.
  Not bit for bit: XLA's CPU backend, which runs the interpret mode, fuses
  a*b + c into one rounding (FMA) and the port does not, so every one of
  the 26 hit lanes differs in its last bits (measured: 23 within 1e-5
  relative, 3 grazing a cone within 6.4e-5);
- ``lattice_plain`` against the dense sweep of the same group: it equals
  the dense sweep over the rows it rebuilds (float32 (base + i*dU) + j*dV)
  bit for bit; the group's table holds the model evaluated in float64 and
  rounded, so against ``dense_plain`` on the stored rows hit masks agree on
  all but 1e-3 of the lanes and t, where both hit, bit for bit on 97 % of
  them (measured on the 24x24 field: 48 of 576 rebuilt rows differ from the
  stored ones by an ULP; hit masks equal, 4,026 of 4,096 lanes bit-equal,
  the rest within 1.8e-4 at grazing incidence on a cone);
- ``group_variant`` / ``group_query``'s routing and forced variants;
- the premises of the kernel's design: the value its C entry gives a
  constant column (dU and dV both +-0) is (base + fi*dU) + fj*dV bit for
  bit in every cell, signed zeros included; the first candidate cell (i_lo, j_lo)
  is monotone along every lane's march; and a march that skips a cell
  already tested (in the previous window's clamped rectangle, or a clamped
  repeat of its neighbour), written here, equals ``lattice_plain`` bit for
  bit.

The GPU test holds the CUDA kernel to ``lattice_plain`` bit for bit (lanes
that miss the group box, NaN and infinite lanes, one-ray launches among
them; translated fields, which run the kernel's TRANS form, and fields whose
cone slope and height also vary, which rebuild every column, each with
K = 4 and on a narrow lattice) and skips without a card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import lattice_traverse as LT
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.convert import carry_lattice, upload_group
from pine_tpu_torch.scene import shapes as PS

torch.set_num_threads(2)

BIG = 1e30


def cone_field(ni, nj, spacing=0.1, radius=0.05, jitter=0.0, seed=0):
    """analytic_prims of an ni x nj cone lattice like the benchmark box's
    floor (the cone forest's at spacing 0.05, radius 0.025)."""
    rng = np.random.default_rng(seed)
    prims = []
    for i in range(ni):
        for j in range(nj):
            x = -1.0 + spacing * i + (rng.uniform(-jitter, jitter) if jitter else 0.0)
            c = PS.Cone([x, 0.0, spacing * j], [0, 1, 0], radius, 0.05)
            prims.append((PS.CONE, c.params(), 0, c.get_aabb()))
    return prims


def sphere_field(ni, nj):
    prims = []
    for i in range(ni):
        for j in range(nj):
            s = PS.Sphere([-1.0 + 0.1 * i, 0.05, 0.1 * j], 0.04)
            prims.append((PS.SPHERE, s.params(), 0, s.get_aabb()))
    return prims


def rays(n, seed=1):
    """tests/test_lattice.py's rays: from above the field toward its floor,
    every 7th grazing along the floor plane."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform([-2, 0.2, -2], [2, 2.5, 3], (n, 3)).astype(np.float32)
    tgt = rng.uniform([-1.2, 0.0, -0.2], [1.2, 0.06, 2.2], (n, 3)).astype(np.float32)
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[::7, 1] = 0.02
    g = rng.normal(size=(len(ro[::7]), 3)).astype(np.float32)
    g[:, 1] *= 0.05
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    rd[::7] = g
    return ro, rd


def port_group(prims, device="cpu"):
    (g,) = PPK.build_packet_accel(prims)["groups"]
    return upload_group(g, device)


def query_args(n, seed, any_hit, device="cpu"):
    """Rays with tmin 1e-4 and, closest-hit, a running best of 1e30 / -1 on
    most lanes and a prepared hit on some; any-hit, tmax 3 and some lanes
    already occluded."""
    ro, rd = rays(n, seed)
    rng = np.random.default_rng(seed + 1)
    tmin = np.full(n, 1e-4, np.float32)
    if any_hit:
        tmax = np.full(n, 3.0, np.float32)
        state = (tmax, (rng.uniform(size=n) < 0.1).astype(np.int32))
    else:
        tmax = np.full(n, BIG, np.float32)
        held = rng.uniform(size=n) < 0.2
        state = (np.where(held, rng.uniform(1.0, 3.0, n), BIG).astype(np.float32),
                 np.where(held, 3, -1).astype(np.int32))
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (ro, rd, tmin, tmax, *state)]


@pytest.mark.parametrize("shape", [(6, 5), (24, 24), (1, 24), (40, 40)])
def test_detect_lattice_matches_pine_tpu(shape):
    from pine_tpu.accel import packet as JPK

    ni, nj = shape
    forest = shape == (40, 40)
    prims = cone_field(ni, nj, *((0.05, 0.025) if forest else ()))
    params = np.stack([p[1] for p in prims]).astype(np.float32)
    lo = np.stack([p[3][0] for p in prims]).astype(np.float32)
    hi = np.stack([p[3][1] for p in prims]).astype(np.float32)
    want = JPK._detect_lattice(params, lo, hi)
    got = PPK._detect_lattice(params, lo, hi)
    assert want is not None and got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert (got["ni"], got["nj"]) == shape
    # the groups: each lattice index maps to the same (snapped) row.  The
    # leaf orders may differ: the two SAH builds break the lattice's exact
    # cost ties differently (ROADMAP.md, section 3)
    (jg,) = JPK.build_packet_accel(prims, [])["groups"]
    (pg,) = PPK.build_packet_accel(prims)["groups"]
    assert "snapped" not in pg["lattice"]
    jslot, pslot = jg["lattice"]["slot_of_k"], pg["lattice"]["slot_of_k"]
    np.testing.assert_array_equal(pg["rows"][pslot], jg["rows_np"][jslot])
    np.testing.assert_array_equal(np.sort(pslot), np.arange(ni * nj))


def test_detect_lattice_rejects_jitter():
    from pine_tpu.accel import packet as JPK

    prims = cone_field(6, 5, jitter=0.02)
    assert JPK.build_packet_accel(prims, [])["groups"][0].get("lattice") is None
    assert PPK.build_packet_accel(prims)["groups"][0]["lattice"] is None


@pytest.mark.parametrize("shape", [(6, 5), (24, 24), (1, 24)])
def test_layout_matches_lattice_smem(shape):
    from pine_tpu.accel import packet as JPK
    from pine_tpu.accel import pallas_traverse as PT

    (jg,) = JPK.build_packet_accel(cone_field(*shape), [])["groups"]
    pg = upload_group(dict(tid=jg["tid"], kind=jg["kind"], base=jg["base"],
                           rows=jg["rows_np"], prim_aabbs=jg["_prim_aabbs"],
                           lattice=carry_lattice(jg["lattice"])), "cpu")
    want = PT._lattice_smem(jg)
    lay = pg["lat"]
    np.testing.assert_array_equal(lay["latf"], np.asarray(want["_latf"]))
    np.testing.assert_array_equal(lay["slot"].numpy(), np.asarray(want["_slot"]))
    assert lay["max_seg"] == want["_max_seg"]
    assert lay["latf"].shape == (3 * 12 + 12,)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_matches_pallas_interpret(any_hit):
    """pine_tpu's own 6x5 group, carried across; its Pallas lattice kernel in
    interpret mode against lattice_plain.  Any-hit: flags and the passed-
    through t bit for bit.  Closest-hit: the same lanes improve, ids equal on
    them and passed through elsewhere, t to rtol 1e-4 / atol 1e-6 (XLA's
    fused multiply-adds; see the module docstring)."""
    import jax.numpy as jnp

    from pine_tpu.accel import packet as JPK
    from pine_tpu.accel import pallas_traverse as PT

    (jg,) = JPK.build_packet_accel(cone_field(6, 5), [])["groups"]
    pg = upload_group(dict(tid=jg["tid"], kind=jg["kind"], base=jg["base"],
                           rows=jg["rows_np"], prim_aabbs=jg["_prim_aabbs"],
                           lattice=carry_lattice(jg["lattice"])), "cpu")
    args = query_args(512, seed=1, any_hit=any_hit)
    t_k, e_k = (np.asarray(x) for x in PT.pallas_group_query(
        jg, *(jnp.asarray(x.numpy()) for x in args), any_hit=any_hit, variant="lattice"))
    t_p, e_p = (x.numpy() for x in DT.group_query(pg, *args, any_hit=any_hit,
                                                  variant="lattice"))
    bt_in, be_in = args[4].numpy(), args[5].numpy()
    if any_hit:
        np.testing.assert_array_equal(t_p.view(np.int32), t_k.view(np.int32))
        np.testing.assert_array_equal(e_p, e_k)
        assert (e_k > be_in).sum() > 10  # rays were occluded here
    else:
        improved = t_k < bt_in
        assert improved.sum() > 15  # as tests/test_lattice.py: the field is hit
        np.testing.assert_array_equal(t_p < bt_in, improved)
        # XLA's CPU backend fuses a*b + c into one rounding (FMA), which
        # neither the plain version nor the kernel (-fmad=false) does
        np.testing.assert_allclose(t_p, t_k, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(e_p[improved], e_k[improved])
        np.testing.assert_array_equal(e_p[~improved], be_in[~improved])


@pytest.mark.parametrize("field", ["cones 24x24", "spheres 24x24", "cones 1x24"])
def test_plain_against_dense_sweep(field):
    kind, shape = field.split()
    ni, nj = map(int, shape.split("x"))
    g = port_group(cone_field(ni, nj) if kind == "cones" else sphere_field(ni, nj))
    lay = g["lat"]
    assert DT.group_variant(g) == ("lattice" if ni * nj > 512 else "dense")
    # the rows the march rebuilds, in the group's row order
    lf, w = lay["latf_t"], lay["width"]
    k = torch.arange(ni * nj)
    fi, fj = (k // nj).to(torch.float32), (k % nj).to(torch.float32)
    rebuilt = g["rows"].clone()
    rebuilt[lay["slot"].long()] = torch.stack(
        [lf[c] + fi * lf[w + c] + fj * lf[2 * w + c] for c in range(w)], 1)
    for any_hit in (False, True):
        args = query_args(4096, seed=5, any_hit=any_hit)
        t_l, e_l = LT.lattice_plain(g, *args, any_hit)
        t_r, e_r = DT.dense_plain(g["tid"], rebuilt, g["gbox"], *args, any_hit)
        assert torch.equal(t_l, t_r) and torch.equal(e_l, e_r)
        t_d, e_d = DT.dense_plain(g["tid"], g["rows"], g["gbox"], *args, any_hit)
        if any_hit:
            assert (e_l != e_d).float().mean() <= 1e-3 and e_l.sum() > 100
        else:
            hit_l, hit_d = t_l < args[4], t_d < args[4]
            assert (hit_l != hit_d).float().mean() <= 1e-3 and hit_l.sum() > 100
            both = hit_l & hit_d
            assert (t_l[both] == t_d[both]).float().mean() >= 0.97


@pytest.mark.parametrize("field", ["cones 24x24", "cones 1x24"])
def test_plain_sweeps_a_varying_shape_as_its_rebuilt_rows(field):
    """The card test's lattices whose cone slope and height vary (columns
    outside a translation's, which the kernel rebuilds in its general form):
    lattice_plain equals the dense sweep of the rows it rebuilds, bit for
    bit, and the field is hit."""
    ni, nj = map(int, field.split()[1].split("x"))
    g = with_varying_shape(port_group(cone_field(ni, nj)), "cpu")
    lay = g["lat"]
    lf, w = lay["latf_t"], lay["width"]
    varying = ((lf[w:2 * w] != 0) | (lf[2 * w:3 * w] != 0)).nonzero().squeeze(1).tolist()
    assert varying == ([0, 2, 6, 10] if ni > 1 else [2, 6, 10])
    k = torch.arange(ni * nj)
    fi, fj = (k // nj).to(torch.float32), (k % nj).to(torch.float32)
    rebuilt = g["rows"].clone()
    rebuilt[lay["slot"].long()] = torch.stack(
        [lf[c] + fi * lf[w + c] + fj * lf[2 * w + c] for c in range(w)], 1)
    for any_hit in (False, True):
        args = query_args(4096, seed=5, any_hit=any_hit)
        t_l, e_l = LT.lattice_plain(g, *args, any_hit)
        t_r, e_r = DT.dense_plain(g["tid"], rebuilt, g["gbox"], *args, any_hit)
        assert torch.equal(t_l.view(torch.int32), t_r.view(torch.int32))
        assert torch.equal(e_l, e_r)
        assert int((e_l != args[5]).sum()) > 50


def test_group_query_routing_and_forced_variants():
    big = port_group(cone_field(24, 24))
    small = port_group(cone_field(6, 5))
    jittered = port_group(cone_field(24, 24, jitter=0.02))
    assert [DT.group_variant(g) for g in (big, small, jittered)] == ["lattice", "dense", "grid"]
    assert small["lattice"]["slot_of_k"].shape == (30,) and "lat" in small
    assert jittered["lattice"] is None and "lat" not in jittered
    for g in (big, small):
        for any_hit in (False, True):
            args = query_args(1024, seed=9, any_hit=any_hit)
            lat = LT.lattice_plain(g, *args, any_hit)
            dense = DT.dense_plain(g["tid"], g["rows"], g["gbox"], *args, any_hit)
            for variant, want in ((None, lat if g is big else dense), ("lattice", lat),
                                  ("dense", dense)):
                got = DT.group_query(g, *args, any_hit=any_hit, variant=variant)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), variant
    # "lattice" forced on a group that is no lattice falls back to its size default
    args = query_args(256, seed=3, any_hit=False)
    got = DT.group_query(jittered, *args, variant="lattice")
    want = DT.group_query(jittered, *args, variant="grid")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_counts_work():
    g = port_group(cone_field(24, 24))
    counts = {}
    args = query_args(2048, seed=2, any_hit=False)
    LT.lattice_plain(g, *args, False, counts=counts)
    assert 0 < counts["live"] <= 2048
    assert counts["live"] <= counts["windows"] <= counts["live"] * g["lat"]["max_seg"]
    assert counts["tests"] == counts["windows"] * 16


def forest_group():
    """The reduced cone forest's lattice group (scenes.REDUCED_FOREST: 23x23
    cones at the forest's spacing), compiled on the CPU."""
    from pine_tpu_torch import scenes

    cs = scenes.prl_scene(scenes.cone_forest_prl(*scenes.REDUCED_FOREST, size=48)).compile("cpu")
    (g,) = [g for g in cs.unified["groups"] if g["variant"] == "lattice"]
    return g


def aimed_args(g, n, seed, any_hit):
    """query_args' state on rays aimed from above at points of the group's
    box, every 7th grazing its floor; or, for ``g`` None, rays of random
    origin and direction about the unit cube."""
    rng = np.random.default_rng(seed)
    args = query_args(n, seed, any_hit)
    if g is None:
        ro = rng.uniform(-1.5, 2.5, (n, 3))
        rd = rng.normal(size=(n, 3))
    else:
        box = g["gbox"].numpy().astype(np.float64)
        tgt = rng.uniform(box[:3], box[3:], (n, 3))
        ro = tgt + rng.uniform([-1.0, 0.2, -1.0], [1.0, 2.0, 1.0], (n, 3))
        ro[::7, 1] = rng.uniform(0.0, 0.06, len(ro[::7]))
        rd = tgt - ro
        rd[::7, 1] = rng.normal(scale=0.02, size=len(rd[::7]))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    args[0], args[1] = (torch.from_numpy(x.astype(np.float32)) for x in (ro, rd))
    return args


def march(g, ro, rd, tmin, tmax, best_t, best_e, any_hit, skip=False, origins=None):
    """lattice_plain's march written again over every lane at once.  With
    ``skip`` a candidate is not tested where its clamped cell repeats the
    previous ki's or kj's, or lies in the previous window's clamped
    rectangle.  ``origins`` (a list) receives each window's (lanes
    marching, i_lo, j_lo).  -> (best_t, best_e, candidates skipped)."""
    lay, gbox = g["lat"], g["gbox"]
    test = DT.PRIM_TESTS[g["tid"]]
    lf = lay["latf_t"]
    w, ni, nj = lay["width"], lay["ni"], lay["nj"]
    ki_n, kj_n = min(lay["K"], ni), min(lay["K"], nj)
    o = [ro[:, a] for a in range(3)]
    d = [rd[:, a] for a in range(3)]
    near = tmin
    far = torch.where(best_e == 0, tmax, tmin - 1.0) if any_hit else best_t
    for a in range(3):
        inv = DT._safe_inv(d[a])
        t0, t1 = (gbox[a] - o[a]) * inv, (gbox[3 + a] - o[a]) * inv
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    live = near <= far
    gu, gv = [lf[3 * w + a] for a in range(3)], [lf[3 * w + 3 + a] for a in range(3)]
    u0, v0, r_u, r_v, cap_u, cap_v = (lf[3 * w + 6 + k] for k in range(6))
    du = d[0] * gu[0] + d[1] * gu[1] + d[2] * gu[2]
    dv = d[0] * gv[0] + d[1] * gv[1] + d[2] * gv[2]
    ou = o[0] * gu[0] + o[1] * gu[1] + o[2] * gu[2] - u0
    ov = o[0] * gv[0] + o[1] * gv[1] + o[2] * gv[2] - v0
    seg = torch.clamp_min(far - near, 0.0)
    n_seg = torch.ceil(torch.clamp_min(
        torch.maximum(du.abs() * seg / cap_u, dv.abs() * seg / cap_v), 1.0))
    n_seg = torch.where(live, n_seg, 0.0)
    dt = seg / torch.clamp_min(n_seg, 1.0)
    occ, bt, k_best = best_e.clone(), best_t.clone(), torch.zeros_like(best_e)
    prev, skipped = None, 0
    for s in range(lay["max_seg"]):
        act = (s < n_seg) & (occ == 0) if any_hit else s < n_seg
        ta, tb = near + s * dt, near + (s + 1) * dt
        ua, ub, va, vb = ou + ta * du, ou + tb * du, ov + ta * dv, ov + tb * dv
        i_lo = torch.clamp(torch.floor(torch.minimum(ua, ub) - r_u), -1e6, 1e6).to(torch.int32)
        j_lo = torch.clamp(torch.floor(torch.minimum(va, vb) - r_v), -1e6, 1e6).to(torch.int32)
        if origins is not None:
            origins.append((act, i_lo, j_lo))

        def ci(k, i_lo=i_lo):
            return torch.clamp(i_lo + k, 0, ni - 1)

        def cj(k, j_lo=j_lo):
            return torch.clamp(j_lo + k, 0, nj - 1)

        for ki in range(ki_n):
            ii = ci(ki)
            for kj in range(kj_n):
                jj = cj(kj)

                def fetch(c, fi=ii.float(), fj=jj.float()):
                    return lf[c] + fi * lf[w + c] + fj * lf[2 * w + c]

                todo = act
                if skip:
                    rep = (ii == ci(ki - 1)) if ki else torch.zeros_like(act)
                    if kj:
                        rep = rep | (jj == cj(kj - 1))
                    if prev is not None:
                        rep = rep | ((ii >= prev[0]) & (ii <= prev[1]) & (jj >= prev[2])
                                     & (jj <= prev[3]))
                    skipped += int((act & rep).sum())
                    todo = act & ~rep
                if any_hit:
                    tt = test(fetch, o, d, tmin, tmax)
                    occ = torch.where(todo & (tt < BIG), 1, occ)
                else:
                    tt = test(fetch, o, d, tmin, bt)
                    better = todo & (tt < bt)
                    bt = torch.where(better, tt, bt)
                    k_best = torch.where(better, ii * nj + jj, k_best)
        prev = (ci(0), ci(ki_n - 1), cj(0), cj(kj_n - 1))
    if any_hit:
        return best_t, occ, skipped
    slot = lay["slot"]
    return bt, torch.where(bt < best_t, slot[k_best.long()], best_e), skipped


@pytest.mark.parametrize("lattice", ["cone forest 40x40", "signed zeros"])
def test_constant_columns_are_the_rebuilt_value(lattice):
    """The value the kernel's C entry gives a constant column (dU and dV
    both +-0), (base + copysign(0, dU)) + copysign(0, dV) in float32, is
    what (base + fi*dU) + fj*dV rounds to in every cell of the lattice, bit
    for bit: on the cone forest's group, where every column but the anchor's
    x and z is constant (so the kernel rebuilds only a translation's
    columns), and on a model whose 12 columns take every combination of
    base +0, -0 or 1.5 with dU and dV +0 or -0."""
    g = port_group(cone_field(40, 40, 0.05, 0.025))
    lat = g["lattice"]
    if lattice == "signed zeros":
        base = np.array([0.0, -0.0, 1.5] * 4, np.float32)
        dU = np.array([0.0] * 6 + [-0.0] * 6, np.float32)
        dV = np.array(([0.0] * 3 + [-0.0] * 3) * 2, np.float32)
        lat = dict(lat, base=base, dU=dU, dV=dV)
    lay = LT.lattice_layout(lat, 12, "cpu")
    w = lay["width"]
    base, dU, dV = (lay["latf"][k * w:(k + 1) * w] for k in range(3))
    const = (dU == 0) & (dV == 0)
    zero = np.float32(0.0)
    cval = (base + np.copysign(zero, dU)) + np.copysign(zero, dV)  # the C entry's formula
    assert cval.dtype == np.float32
    if lattice == "signed zeros":
        assert const.all()
        # -0 survives only where base, dU and dV are all -0 (column 10)
        assert list(np.nonzero(np.signbit(cval))[0]) == [10]
    else:
        assert list(np.nonzero(~const)[0]) == [0, 2]
    lf = lay["latf_t"]
    k = torch.arange(lay["ni"] * lay["nj"])
    fi, fj = (k // lay["nj"]).to(torch.float32), (k % lay["nj"]).to(torch.float32)
    for c in np.nonzero(const)[0]:
        rebuilt = lf[c] + fi * lf[w + c] + fj * lf[2 * w + c]
        want = torch.full_like(rebuilt, float(cval[c]))
        assert torch.equal(rebuilt.view(torch.int32), want.view(torch.int32)), c


@pytest.mark.parametrize("rays", ["reduced forest", "random rays"])
def test_window_origin_is_monotone_along_the_march(rays):
    """i_lo and j_lo, the first candidate cell of each window, never turn
    back along a lane's march: each is a rounded monotone function of the
    window's start (near + s*dt), so a cell tested twice lies in the
    previous window's rectangle as well."""
    g = forest_group()
    for any_hit in (False, True):
        aimed = rays == "reduced forest"
        args = aimed_args(g if aimed else None, 4096 if aimed else 32768, 21, any_hit)
        origins = []
        march(g, *args, any_hit, origins=origins)
        assert sum(int(a.sum()) for a, _, _ in origins[1:]) > 50  # lanes with two windows
        for k in (1, 2):  # i_lo, then j_lo
            steps = [(cur[k] - before[k]).long() for before, cur in zip(origins, origins[1:])]
            marching = [cur[0] for cur in origins[1:]]
            up = torch.stack([(st > 0) & a for st, a in zip(steps, marching)]).any(0)
            down = torch.stack([(st < 0) & a for st, a in zip(steps, marching)]).any(0)
            assert not bool((up & down).any())
            assert bool(up.any()) and bool(down.any())


@pytest.mark.parametrize("field", ["cones 24x24", "spheres 24x24", "cones 1x24",
                                   "reduced forest"])
def test_skipping_repeated_cells_is_exact(field):
    """A march that skips every candidate already tested (the kernel's
    LAT_SKIP premise) equals lattice_plain bit for bit, t and id, and the
    rewritten march without skips is lattice_plain itself."""
    if field == "reduced forest":
        g = forest_group()
    else:
        kind, shape = field.split()
        ni, nj = map(int, shape.split("x"))
        g = port_group(cone_field(ni, nj) if kind == "cones" else sphere_field(ni, nj))
    for any_hit in (False, True):
        args = aimed_args(g, 4096, 31, any_hit)
        want = LT.lattice_plain(g, *args, any_hit)
        for skip in (False, True):
            t, e, skipped = march(g, *args, any_hit, skip=skip)
            assert torch.equal(t.view(torch.int32), want[0].view(torch.int32)), skip
            assert torch.equal(e, want[1]), skip
            assert (skipped > 500) == skip


def card_cases(g, args, any_hit):
    """The card test's launches: ``args`` with lanes that start beyond the
    group box and point away from it, lanes with a NaN or infinite origin or
    direction, and one-ray launches of a marching lane and of a missing one."""
    ro, rd = args[0].clone(), args[1].clone()
    ro[1::16] = g["gbox"][3:] + 1.0
    rd[1::16] = torch.tensor([0.6, 0.0, 0.8], device=ro.device)
    bad = torch.tensor([float("nan"), float("inf"), -float("inf")], device=ro.device)
    ro[2::32, 0] = bad[torch.arange(ro[2::32].shape[0], device=ro.device) % 3]
    rd[18::32, 1] = bad[torch.arange(rd[18::32].shape[0], device=ro.device) % 3]
    full = [ro, rd, *args[2:]]
    return [full, [x[:1] for x in full], [x[1:2] for x in full]]


def with_varying_shape(g, device):
    """``g`` with a lattice model whose cone slope (column 6) varies along i
    and j and whose height (column 10) varies along j: columns outside a
    translation's, so the kernel rebuilds every column."""
    lat = g["lattice"]
    dU, dV = (np.array(lat[k], np.float32) for k in ("dU", "dV"))
    dU[6], dV[6], dV[10] = 2e-3, 1e-3, 5e-4
    lat = dict(lat, dU=dU, dV=dV)
    return dict(g, lattice=lat, lat=LT.lattice_layout(lat, g["lat"]["width"], device))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain_on_card(any_hit):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    groups = [port_group(prims, dev) for prims in (
        cone_field(24, 24), cone_field(1, 24), sphere_field(24, 24),
        cone_field(40, 40, 0.05, 0.025))]
    groups += [with_varying_shape(g, dev) for g in groups[:2]]  # K = 4, and 1 x 24
    for g in groups:
        hits = 0
        for args in card_cases(g, query_args(8192, seed=11, any_hit=any_hit, device=dev),
                               any_hit):
            t_k, e_k = LT.lattice_cuda(g, *args, any_hit)
            t_p, e_p = LT.lattice_plain(g, *args, any_hit)
            torch.cuda.synchronize()
            assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
            assert torch.equal(e_k, e_p)
            hits += int((e_p != args[5]).sum())
        assert hits > 0
