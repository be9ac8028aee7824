"""The coefficient-table sweeps (pine_tpu_torch/accel/mxu_tables.py and
mxu_sweep.py, the MXU forms of accel/grid_traverse.py and
accel/inst_traverse.py) against pine_tpu/accel/mxu_sweep.py.

- The tables: ``build_w``, the tile-major and the supercell-major layouts
  equal pine_tpu's ``_build_w``, ``build_tiled_tables`` and
  ``build_mesh_tables`` bit for bit for the six types with a table, on
  seeded groups; the supercell-major table of a SAH ("bvh") group and of an
  instanced group's mesh drops the builder's pad rows as pine_tpu does.
- The routes: ``mxu_route`` (torch.matmul) and ``mxup_plain`` (kernel 7's
  plain version) against pine_tpu's plain-XLA ``mxu_sweep.group_query`` on
  the same rows, closest-hit and any-hit, six types, with
  tests/test_mxu_sweep.py's tolerance: t of lanes both hit to rtol 3e-4 /
  atol 3e-5, hit sets equal on 99.5 % of the lanes, ids on 99 %; a lane
  whose window is empty passes through bit for bit.
- One interpret-mode case of pine_tpu's fused kernel
  (``group_query_fused``, kernel 7, a cone group, closest-hit) against
  ``mxup_plain``, by the same tolerance (XLA's CPU backend fuses
  multiply-adds, so the two round differently).
- The grid kernel's MXU form's plain version on a 3,000-triangle soup
  against ``group_query`` over the same rows, by the same tolerance.
- The instanced MXU leaf form's plain version on a 3x3 reduced rock field
  against the port's ``inst_plain`` and pine_tpu's XLA two-level walk, by
  the same tolerance.  pine_tpu's instanced kernel has no interpret-mode
  case (tests/test_torch_inst_kernel.py says why).
- Reduced renders of the box with ``small_kernel="mxup"``, the terrain with
  ``mesh_kernel="mxu"`` (GRID_MAX_PRIMS cut so that its 3,042 triangles are
  mesh-scale) and the rock field with ``inst_kernel="mxu"`` against the
  port's default renders, by tests/test_torch_render.py's criteria.

- Kernel 7's prim-major table (``mxu_tables.prim_major``, what the CUDA
  kernel stages) is a permutation of the tile-major table's floats, bit for
  bit, and the kernel's per-thread order over it (each tile's first
  ``width`` prims in turn, each pair value the ordered sum with ``1*w6``
  taken as ``w6`` and ``0*w7`` as ``+0``), emulated in PyTorch on the CPU,
  equals ``mxup_plain`` bit for bit on groups of 1, 16 and 300 prims of
  each type; the wrapper refuses a table it cannot stage.

The GPU tests hold kernel 7 to ``mxup_plain`` bit for bit (groups of 1, 16,
300 and 424 prims, ray counts that are not a multiple of a block's rays, an
any-hit set occluded in the first tile) and the two MXU leaf forms to their
plain versions, and skip without a card.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from test_torch_dense_kernel import TYPES, make_shape
from test_torch_render import REDUCED, assert_renders_agree

from pine_tpu_torch import scenes
from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import mxu_sweep as MS
from pine_tpu_torch.accel import mxu_tables as MT
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.convert import upload_group

torch.set_num_threads(2)

BIG = 1e30
MXU_TYPES = {k: v for k, v in TYPES.items() if MT.supports(v)}
RTOL, ATOL, HIT_SHARE, ID_SHARE = 3e-4, 3e-5, 0.995, 0.99
GRID_MISMATCH_SHARE = 1e-4  # lanes where a culling kernel may differ (chip_smoke.py)


def shape_prims(tid, n, seed):
    rng = np.random.default_rng(seed)
    prims = []
    for i in range(n):
        s = make_shape(tid, rng)
        prims.append((tid, s.params(), i, s.get_aabb()))
    return prims


def port_group(tid, n, seed, device="cpu"):
    """A seeded group of n prims of type tid, built and uploaded by the port."""
    (g,) = PPK.build_packet_accel(shape_prims(tid, n, seed))["groups"]
    return upload_group(g, device)


def jax_group(g):
    """pine_tpu's view of a port group for mxu_sweep: the same rows."""
    return {"tid": g["tid"], "rows_np": g["rows"].cpu().numpy(), "kind": g["kind"]}


def sweep_rays(n, seed, held=True):
    """Rays around the groups' box; every 9th lane dead; with ``held`` a third
    of the lanes carry a prepared running best (closest) or flag (any-hit)."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = rng.uniform(0.5, 6.0, n).astype(np.float32)
    tmax[::3] = 1e30
    tmax[::9] = -1.0
    bt = tmax.copy()
    be = np.zeros(n, np.int32)
    occ = np.zeros(n, np.int32)
    if held:
        h = rng.uniform(size=n) < 0.3
        bt = np.where(h, np.minimum(rng.uniform(0.5, 4, n), tmax), tmax).astype(np.float32)
        be = np.where(h, 3, 0).astype(np.int32)
        occ = (rng.uniform(size=n) < 0.2).astype(np.int32)
    return ro, rd, tmin, tmax, bt, be, occ


def assert_agree(t_a, e_a, t_b, e_b, any_hit, what=""):
    """tests/test_mxu_sweep.py's criteria for two results of one group."""
    t_a, e_a, t_b, e_b = (np.asarray(x) for x in (t_a, e_a, t_b, e_b))
    if any_hit:
        assert (e_a == e_b).mean() >= HIT_SHARE, what
        return
    hit_a, hit_b = t_a < 1e29, t_b < 1e29
    assert (hit_a == hit_b).mean() >= HIT_SHARE, f"{what}: hit sets differ"
    both = hit_a & hit_b
    np.testing.assert_allclose(t_a[both], t_b[both], rtol=RTOL, atol=ATOL, err_msg=what)
    assert ((e_a == e_b) | ~both).mean() >= ID_SHARE, what


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MXU_TYPES))
def test_tables_match_pine_tpu(name):
    from pine_tpu.accel import mxu_sweep as JM

    tid = MXU_TYPES[name]
    g = port_group(tid, 300, 10 + tid)
    rows = g["rows"].numpy()
    np.testing.assert_array_equal(MT.build_w(tid, rows),
                                  JM._build_w(tid, rows.astype(np.float64)))
    tt = MT.build_tiled_tables(tid, rows)
    jt = JM.build_tiled_tables(dict(tid=tid, rows_np=rows))
    assert (tt["m"], tt["C"], tt["n_tiles"]) == (jt["m"], jt["C"], jt["n_tiles"]) == (
        MT.MXU_M[tid], rows.shape[0], 3)
    np.testing.assert_array_equal(tt["W"], np.asarray(jt["W"]))
    for e_pad in (384, 2048):  # the grid's padding, and the TPU's coarse alignment
        np.testing.assert_array_equal(
            MT.build_mesh_tables(tid, rows, e_pad),
            np.asarray(JM.build_mesh_tables(dict(tid=tid, rows_np=rows, kind="dense"),
                                            e_pad, 128)["Wm"]))


def test_mesh_tables_drop_builder_pad_rows():
    """A SAH group's rows end in LEAF_MAX zero pad rows, which the grid
    layout leaves out; so does the supercell-major table, as pine_tpu's
    (mxu_sweep.py:299-305), for a prim group and an instanced group's mesh."""
    from pine_tpu.accel import mxu_sweep as JM
    from test_torch_inst_kernel import both as inst_both
    from test_torch_scdense import both

    jacc, pacc = both(3000, 21)
    (jg,), (pg,) = jacc["groups"], pacc["groups"]
    assert pg["kind"] == jg["kind"] == "bvh" and pg["rows"].shape[0] == 3000 + 4
    DT.prepare(pg, "grid_mxu")
    want = JM.build_mesh_tables(jg, 3072, 128)["Wm"]
    np.testing.assert_array_equal(pg["grid_mxu"]["mxu"]["W"].numpy(), np.asarray(want))
    jacc, pacc = inst_both("rock3x3")
    (jg,), (ig,) = jacc["groups"], pacc["inst_groups"]
    assert ig["rows"].shape[0] == ig["n_tris"] + 4
    tab = MS.prepare_tables(ig, "mxum")
    want = JM.build_mesh_tables(jg["mesh"], 256, 128)["Wm"]
    np.testing.assert_array_equal(tab["W"].numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(MXU_TYPES))
def test_prim_major_table_is_a_permutation(name):
    tid = MXU_TYPES[name]
    g = port_group(tid, 300, 15 + tid)
    tab = MS.prepare_tables(g, "mxut")
    W, Wp, m = tab["W"].numpy(), tab["Wp"].numpy(), tab["m"]
    assert Wp.shape == (3, 128, m, MT.RAY_FEATS) and Wp.dtype == np.float32
    perm = MT.prim_major(np.arange(W.size).reshape(W.shape), m).ravel()
    np.testing.assert_array_equal(np.sort(perm), np.arange(W.size))
    np.testing.assert_array_equal(Wp.ravel().view(np.int32), W.ravel()[perm].view(np.int32))
    ct, c, v, f = 2, 5, m - 1, 3  # [ct, c, v, f] is W[f, (ct*m + v)*128 + c]
    assert Wp[ct, c, v, f] == W[f, (ct * m + v) * 128 + c]


def kernel7_emulated(tid, tab, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """csrc/mxu_sweep.cu's per-thread order in PyTorch, every ray at once:
    the prim-major tiles' first ``width`` prims in turn, each pair value
    ((((((f0*w0 + f1*w1) + f2*w2) + f3*w3) + f4*w4) + f5*w5) + w6) + 0, a
    closest-hit best replaced on a strictly lower t, any-hit flags."""
    Wp, C, m = tab["Wp"], tab["C"], tab["m"]
    F, odr, oor, ddr = MS.features(ro, rd)
    limit = tmax if any_hit else best_t
    live = (limit > tmin) & ((best_e < 1) if any_hit else True)
    bt_run = torch.full_like(best_t, BIG)
    be_run = torch.full_like(best_e, MS.INT_BIG)
    hit = torch.zeros_like(live)
    for ct in range(tab["n_tiles"]):
        for c in range(min(128, C - ct * 128)):
            w = Wp[ct, c]
            vals = []
            for v in range(m):
                s = F[:, 0] * w[v, 0]
                for f in range(1, 6):
                    s = s + F[:, f] * w[v, f]
                vals.append((s + w[v, 6]) + 0.0)
            t = MS.pair_t_vals(tid, lambda v: vals[v], odr[:, 0], oor[:, 0], ddr[:, 0], tmin,
                               limit)
            hit |= live & (t < BIG)
            better = t < bt_run
            bt_run = torch.where(better, t, bt_run)
            be_run = torch.where(better, ct * 128 + c, be_run)
    if any_hit:
        return best_t, torch.where(live, torch.maximum(best_e, hit.to(best_e.dtype)), best_e)
    win = live & (bt_run < best_t)
    return torch.where(win, bt_run, best_t), torch.where(win, be_run, best_e)


@pytest.mark.parametrize("n_prims", [1, 16, 300])
@pytest.mark.parametrize("form", ["closest", "any_hit"])
def test_kernel7_order_is_mxup_plain(form, n_prims):
    any_hit = form == "any_hit"
    for name, tid in MXU_TYPES.items():
        g = port_group(tid, n_prims, 17 + tid)
        tab = MS.prepare_tables(g, "mxut")
        ro, rd, tmin, tmax, bt, be, occ = (torch.from_numpy(x) for x in sweep_rays(512, 18))
        state = (tmax, occ) if any_hit else (bt, be)
        args = (ro, rd, tmin, tmax, *state, any_hit)
        t_e, e_e = kernel7_emulated(tid, tab, *args)
        t_p, e_p = MS.mxup_plain(tid, g["rows"], tab, *args)
        assert torch.equal(t_e.view(torch.int32), t_p.view(torch.int32)), name
        assert torch.equal(e_e, e_p), name


def test_kernel7_wrapper_refuses_a_table_it_cannot_stage():
    g = port_group(MXU_TYPES["cone"], 300, 19)
    tab = MS.prepare_tables(g, "mxut")
    ro, rd, tmin, tmax, bt, be, _ = (torch.from_numpy(x) for x in sweep_rays(64, 20))
    args = (ro, rd, tmin, tmax, bt, be, False)
    Wp = tab["Wp"]
    shifted = torch.empty(Wp.numel() + 1)[1:].view(Wp.shape)
    shifted.copy_(Wp)
    with pytest.raises(ValueError, match="16-byte"):
        MS.mxup_cuda(g["tid"], g["rows"], dict(tab, Wp=shifted), *args)
    with pytest.raises(ValueError, match="tiles"):
        MS.mxup_cuda(g["tid"], g["rows"], dict(tab, C=4 * 128), *args)
    with pytest.raises(ValueError, match="Wp"):
        MS.mxup_cuda(g["tid"], g["rows"], dict(tab, Wp=tab["Wp"][:2]), *args)


# --------------------------------------------------------------------------
# the flat sweeps
# --------------------------------------------------------------------------

def run_port(fn, g, args, any_hit):
    ro, rd, tmin, tmax, bt, be, occ = (torch.from_numpy(x) for x in args)
    state = (tmax, occ) if any_hit else (bt, be)
    if fn == "mxu":
        DT.prepare(g, "mxu")
        return MS.mxu_query(g["tid"], g["rows"], g["mxu"], ro, rd, tmin, tmax, *state, any_hit)
    DT.prepare(g, "mxup")
    return MS.mxup_plain(g["tid"], g["rows"], g["mxut"], ro, rd, tmin, tmax, *state, any_hit)


@pytest.mark.parametrize("form", ["closest", "any_hit"])
@pytest.mark.parametrize("name", list(MXU_TYPES))
def test_routes_match_pine_group_query(name, form):
    import jax.numpy as jnp
    from pine_tpu.accel import mxu_sweep as JM

    tid, any_hit = MXU_TYPES[name], form == "any_hit"
    g = port_group(tid, 200, 30 + tid)
    args = sweep_rays(2048, 40 + tid)
    ro, rd, tmin, tmax, bt, be, occ = args
    state = (tmax, occ) if any_hit else (bt, be)
    t_j, e_j = JM.group_query(jax_group(g), *map(jnp.asarray, (ro, rd, tmin, tmax, *state)),
                              any_hit=any_hit)
    t_j, e_j = np.asarray(t_j), np.asarray(e_j)
    assert (e_j > 0).sum() > 100 if any_hit else (t_j < bt).sum() > 100, "must be hit"
    empty = ~((tmax if any_hit else bt) > tmin)
    assert empty.sum() > 100
    for fn in ("mxu", "mxup"):
        t_p, e_p = (x.numpy() for x in run_port(fn, g, args, any_hit))
        assert_agree(t_p, e_p, t_j, e_j, any_hit, f"{fn} {name} {form}")
        # an empty window passes the incoming state through, bit for bit
        np.testing.assert_array_equal(t_p[empty].view(np.int32), state[0][empty].view(np.int32))
        np.testing.assert_array_equal(e_p[empty], state[1][empty])


def test_route_chunks_change_nothing(monkeypatch):
    g = port_group(MXU_TYPES["cone"], 200, 5)
    args = sweep_rays(1000, 6)
    want = run_port("mxu", g, args, False)
    monkeypatch.setattr(MS, "ROUTE_PAIRS", 96 * 1000)  # 96 rays of 200 cones x 5 values
    monkeypatch.setattr(MS, "PLAIN_PAIRS", 96 * 1280)
    got = run_port("mxu", g, args, False)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    p_small = run_port("mxup", g, args, False)
    monkeypatch.undo()
    p_big = run_port("mxup", g, args, False)
    np.testing.assert_array_equal(p_small[0].numpy(), p_big[0].numpy())
    np.testing.assert_array_equal(p_small[1].numpy(), p_big[1].numpy())


def test_fp32_matmul_gives_the_callers_settings_back():
    # the settings are process-wide flags that CPU-only PyTorch holds too
    tf32, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        with MS.fp32_matmul(torch.device("cuda")):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        with MS.fp32_matmul(torch.device("cpu")):  # nothing to set off the card
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_mxu_form_refuses_a_layout_without_its_table():
    from test_torch_scdense import port_soup

    from pine_tpu_torch.accel import grid_traverse as GT

    (g,) = port_soup(300, 300)["groups"]
    DT.prepare(g, "grid")
    ro, rd, tmin, tmax, bt, be, _ = (torch.from_numpy(x) for x in sweep_rays(64, 3))
    with pytest.raises(ValueError, match="coefficient table"):
        GT.grid_plain(g["tid"], g["rows"], g["grid"], ro, rd, tmin, tmax, bt, be, False,
                      mxu=True)


def test_fused_kernel_interpret_matches_mxup_plain():
    """pine_tpu's kernel 7 (group_query_fused) in interpret mode on a cone
    group of two tiles, closest-hit: under a minute on the CPU."""
    import jax.numpy as jnp
    from pine_tpu.accel import mxu_sweep as JM

    g = port_group(MXU_TYPES["cone"], 150, 50)
    args = sweep_rays(1024, 51, held=False)
    ro, rd, tmin, tmax, bt, be, _ = args
    t0 = time.perf_counter()
    t_j, e_j = JM.group_query_fused(jax_group(g), *map(jnp.asarray, (ro, rd, tmin, tmax, bt, be)))
    t_j, e_j = np.asarray(t_j), np.asarray(e_j)
    assert time.perf_counter() - t0 < 60
    t_p, e_p = (x.numpy() for x in run_port("mxup", g, args, False))
    assert (t_j < 1e29).sum() > 100
    assert_agree(t_p, e_p, t_j, e_j, False, "fused kernel")


# --------------------------------------------------------------------------
# the MXU leaf forms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["closest", "any_hit"])
def test_grid_mxu_plain_matches_group_query(form):
    import jax.numpy as jnp
    from pine_tpu.accel import mxu_sweep as JM
    from test_torch_scdense import port_soup

    any_hit = form == "any_hit"
    (g,) = port_soup(3000, 3000)["groups"]
    DT.prepare(g, "grid_mxu")
    args = sweep_rays(2048, 61)
    ro, rd, tmin, tmax, bt, be, occ = args
    state = (tmax, occ) if any_hit else (bt, be)
    t_j, e_j = JM.group_query(jax_group(g), *map(jnp.asarray, (ro, rd, tmin, tmax, *state)),
                              any_hit=any_hit)
    t_p, e_p = DT.group_query(g, *(torch.from_numpy(x) for x in (ro, rd, tmin, tmax, *state)),
                              any_hit=any_hit, variant="grid_mxu")
    assert_agree(t_p.numpy(), e_p.numpy(), t_j, e_j, any_hit, "grid_mxu")
    # and the VPU grid form, by the same tolerance
    t_v, e_v = DT.group_query(g, *(torch.from_numpy(x) for x in (ro, rd, tmin, tmax, *state)),
                              any_hit=any_hit, variant="grid")
    assert_agree(t_p.numpy(), e_p.numpy(), t_v.numpy(), e_v.numpy(), any_hit, "grid")


# --------------------------------------------------------------------------
# the tensor-core leaf weighed for the grid kernel's MXU form, emulated
# --------------------------------------------------------------------------

def tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest,
    ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def fragment_index(n_super, m):
    """The weighed leaf's fragment layout of a supercell-major table
    (n_super*8, m*128), as indices into the flat table (-1: a zero pad):
    (n_super, 16 prim groups, tiles = ceil(m/2), 32 lanes, 4).  Tile j of
    group q is the 16x8 A operand of mma.sync.m16n8k8, W^T with rows 0-7
    value 2j of the group's eight prims and rows 8-15 value 2j+1, columns the
    eight features; lane 4g+c holds (g, c), (g+8, c), (g, c+4), (g+8, c+4),
    so its accumulator fragment holds all m values of prim g of the group
    for its rays."""
    tiles = (m + 1) // 2
    idx = torch.full((n_super, 8, 2 * tiles, 128), -1, dtype=torch.int64)
    idx[:, :, :m] = torch.arange(n_super * 8 * m * 128).reshape(n_super, 8, m, 128)
    # (si, k, j, half, q, p) -> (si, q, j, row = half*8 + p, k)
    a = idx.reshape(n_super, 8, tiles, 2, 16, 8).permute(0, 4, 2, 3, 5, 1)
    a = a.reshape(n_super, 16, tiles, 16, 8)
    g, c = torch.arange(32) // 4, torch.arange(32) % 4
    return torch.stack([a[..., g, c], a[..., g + 8, c], a[..., g, c + 4],
                        a[..., g + 8, c + 4]], -1)


def split_values(parts):
    """ordered_values' counterpart on the tensor cores: pair values of
    feature rows F (n, 8) and table columns W (8, K) from TF32 parts of both
    (``parts(x)``: a list of TF32 terms, largest first, summing to about x),
    the cross products of terms i, j with i + j < len(parts) taken smallest
    first, each an 8-term product sum accumulated in float32."""
    def values(F, W):
        fs, ws = parts(F), parts(W)
        pairs = [(i, j) for i in range(len(fs)) for j in range(len(ws)) if i + j < len(fs)]
        acc = torch.zeros(F.shape[0], W.shape[1])
        for i, j in sorted(pairs, key=lambda ij: -sum(ij)):
            for k in range(MT.RAY_FEATS):
                acc = acc + fs[i][:, k:k + 1] * ws[j][k]
        return acc
    return values


def split2(x):
    """3xTF32: hi + lo, giving hi*hi + hi*lo + lo*hi."""
    hi = tf32(x)
    return [hi, tf32(x - hi)]


def split3(x):
    """The exact three-way TF32 split: six products."""
    hi = tf32(x)
    mid = tf32(x - hi)
    return [hi, mid, tf32(x - hi - mid)]


@pytest.fixture(scope="module")
def terrain_queries():
    """The reduced terrain's grid_mxu queries (grid_plain with mxu) of one
    48x48, 4-spp, depth-3 render on the CPU, by ray set: primary (each
    sample's first closest-hit query), bounce (its other closest-hit
    queries) and shadow (any-hit)."""
    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    calls, real = [], GT.grid_plain

    def record(*a, **kw):
        calls.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a), kw))
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DT, "GRID_MAX_PRIMS", 1024)
        mp.setattr(GT, "grid_plain", record)
        scene = scenes.terrain((48, 48), 40)
        render_wavefront(scene.compile("cpu", mesh_kernel="mxu"), scene.camera, 48, 48,
                         BlueSampler(4), 4, 3)
    closest = [c for c in calls if not c[0][-1]]
    per_sample = len(closest) // 4
    return real, {"primary": closest[::per_sample],
                  "bounce": [c for k, c in enumerate(closest) if k % per_sample],
                  "shadow": [c for c in calls if c[0][-1]]}


def test_tensor_core_leaf_layout_and_emulation(terrain_queries):
    """The grid kernel's MXU form was to take its pair values from the tensor
    cores (mma.sync.m16n8k8 in TF32, the 3xTF32 split).  Its fragment layout
    is a permutation of build_mesh_tables's values, bit for bit.  Emulated on
    the reduced terrain, it puts more than GRID_MISMATCH_SHARE of a ray set's
    lanes outside the gate against grid_plain(..., mxu=True) (t to rtol 1e-5
    / atol 1e-6, ids and flags equal), so the kernel forms the values on the
    CUDA cores in the ordered FP32 sum instead (csrc/grid_traverse.cu).  The
    exact three-way split (six products) meets the gate: the lead for a
    later tensor-core leaf."""
    real, sets = terrain_queries
    assert [len(c) for c in sets.values()] == [4, 8, 8]
    tab = sets["primary"][0][0][2]["mxu"]
    Wm = tab["W"].flatten()
    idx = fragment_index(tab["W"].shape[0] // MT.RAY_FEATS, tab["m"])
    flat = idx[idx >= 0]
    assert torch.equal(flat.sort().values, torch.arange(Wm.numel()))
    frag = torch.where(idx >= 0, Wm[idx.clamp_min(0)], 0.0)
    back = torch.empty_like(Wm)
    back[flat] = frag[idx >= 0]
    assert torch.equal(back.view(torch.int32), Wm.view(torch.int32))

    shares = {}
    for rs, calls in sets.items():
        want = [real(*a, **kw) for a, kw in calls]
        for name, parts in (("3xtf32", split2), ("6xtf32", split3)):
            bad = lanes = 0
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(MS, "ordered_values", split_values(parts))
                for (a, kw), (t_p, e_p) in zip(calls, want):
                    t_k, e_k = real(*a, **kw)
                    close = torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6) | (t_k == t_p)
                    bad += int((~close | (e_k != e_p)).sum())
                    lanes += t_k.shape[0]
            shares[(name, rs)] = bad / lanes
    print(shares)
    assert max(shares[("3xtf32", rs)] for rs in sets) > GRID_MISMATCH_SHARE, shares
    assert max(shares[("6xtf32", rs)] for rs in sets) <= GRID_MISMATCH_SHARE, shares


def test_inst_mxu_plain_matches_inst_plain_and_xla_walk(monkeypatch):
    import jax.numpy as jnp
    from pine_tpu.accel import packet as JPK
    from test_torch_inst_kernel import both, field_rays

    from pine_tpu_torch.accel import inst_traverse as IT

    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    jacc, pacc = both("rock3x3")
    ro, rd, tmin, tmax = field_rays(1024, seed=71)
    j = [jnp.asarray(x) for x in (ro, rd, tmin)]
    p = [torch.from_numpy(x) for x in (ro, rd, tmin)]
    tmax2 = np.where(tmax > 0, 3.0, -1.0).astype(np.float32)
    t_j, e_j = (np.asarray(x) for x in JPK.packet_intersect(jacc, *j, jnp.asarray(tmax)))
    occ_j = np.asarray(JPK.packet_any_hit(jacc, *j, jnp.asarray(tmax2)))
    out = {}
    for kernel in (None, "mxu"):
        IT.route_inst(pacc["inst_groups"], kernel)
        out[kernel] = (
            *(x.numpy() for x in PPK.packet_intersect(pacc, *p, torch.from_numpy(tmax))),
            PPK.packet_any_hit(pacc, *p, torch.from_numpy(tmax2)).numpy().astype(np.int32))
    assert pacc["inst_groups"][0]["variant"] == "inst_mxu"
    t_m, e_m, o_m = out["mxu"]
    assert (t_j < 1e29).sum() > 200 and 50 < occ_j.sum() < len(occ_j) - 50
    for t, e, o, what in ((*out[None], "inst_plain"), (t_j, e_j, occ_j, "XLA walk")):
        assert_agree(t_m, e_m, t, e, False, what)
        assert (o_m == o).mean() >= HIT_SHARE, what


# --------------------------------------------------------------------------
# reduced renders through the MXU routes
# --------------------------------------------------------------------------

def render(scene, depth, **kernels):
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    cs = scene.compile("cpu", **kernels)
    img, stats = render_wavefront(cs, scene.camera, 32, 32, BlueSampler(4), 4, depth,
                                  return_stats=True)
    routes = [g["variant"] for g in cs.unified["groups"] + cs.unified["inst_groups"]]
    return img.numpy(), stats["traced_rays"], routes


@pytest.mark.parametrize("case", ["box mxup", "terrain mxu", "rock field mxu"])
def test_mxu_render_matches_default(case, monkeypatch):
    from pine_tpu_torch.scene import scene as scene_mod

    if case == "box mxup":
        scene, depth, kernels = scenes.cbox((32, 32), *REDUCED), 4, dict(small_kernel="mxup")
        routes = (["dense"] * 3, ["mxup", "dense", "mxup"])
    elif case == "terrain mxu":
        monkeypatch.setattr(DT, "GRID_MAX_PRIMS", 1024)
        scene, depth, kernels = scenes.terrain((32, 32), 40), 4, dict(mesh_kernel="mxu")
        routes = (["dense", "grid"], ["dense", "grid_mxu"])
    else:
        monkeypatch.setattr(scene_mod, "FLATTEN_LIMIT", 0)
        scene, depth, kernels = scenes.instanced((32, 32), 3, 12), 3, dict(inst_kernel="mxu")
        routes = (["dense", "dense", "inst"], ["dense", "dense", "inst_mxu"])
    want, rays_want, r_want = render(scene, depth)
    got, rays_got, r_got = render(scene, depth, **kernels)
    assert (r_want, r_got) == routes
    assert_renders_agree(got, want, rays_got, rays_want)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card_rays(n, seed):
    return [torch.from_numpy(x).cuda() for x in sweep_rays(n, seed)]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MXU_TYPES))
def test_kernel7_matches_plain_on_card(name):
    needs_card()
    tid = MXU_TYPES[name]
    g = port_group(tid, 300, 80 + tid, "cuda")
    DT.prepare(g, "mxup")
    ro, rd, tmin, tmax, bt, be, occ = _card_rays(8192, 81)
    for any_hit, state in ((False, (bt, be)), (True, (tmax, occ))):
        a = (g["tid"], g["rows"], g["mxut"], ro, rd, tmin, tmax, *state, any_hit)
        t_k, e_k = MS.mxup_cuda(*a)
        t_p, e_p = MS.mxup_plain(*a)
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_prims", [1, 16, 300, 424])
def test_kernel7_ragged_edges_match_plain_on_card(n_prims):
    """Every type with a table at n_prims (one tile, a partial last tile,
    four tiles) and 8,269 rays: not a multiple of a block's 128 rays, the
    last block holding 77."""
    needs_card()
    ro, rd, tmin, tmax, bt, be, occ = _card_rays(8192 + 77, 93)
    for name, tid in MXU_TYPES.items():
        g = port_group(tid, n_prims, 94 + tid, "cuda")
        DT.prepare(g, "mxup")
        for any_hit, state in ((False, (bt, be)), (True, (tmax, occ))):
            a = (g["tid"], g["rows"], g["mxut"], ro, rd, tmin, tmax, *state, any_hit)
            t_k, e_k = MS.mxup_cuda(*a)
            t_p, e_p = MS.mxup_plain(*a)
            assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)), (name, any_hit)
            assert torch.equal(e_k, e_p), (name, any_hit)


@pytest.mark.cuda
def test_kernel7_any_hit_occluded_in_the_first_tile_on_card():
    """424 spheres (four tiles), each ray aimed from 5 units out at one of
    the first 128 spheres' centres: every block leaves after its first tile,
    with the same flags as mxup_plain."""
    needs_card()
    g = port_group(MXU_TYPES["sphere"], 424, 95, "cuda")
    DT.prepare(g, "mxup")
    n = 4096 + 33
    rng = np.random.default_rng(96)
    cen = g["rows"][rng.integers(0, 128, n), 0:3]
    u = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).cuda()
    u = u / u.norm(dim=1, keepdim=True)
    ro, rd = (cen + 5.0 * u).contiguous(), (-u).contiguous()
    tmin = torch.full((n,), 1e-3, device="cuda")
    tmax = torch.full((n,), 1e30, device="cuda")
    occ = torch.zeros(n, dtype=torch.int32, device="cuda")
    a = (g["tid"], g["rows"], g["mxut"], ro, rd, tmin, tmax, tmax, occ, True)
    t_k, e_k = MS.mxup_cuda(*a)
    t_p, e_p = MS.mxup_plain(*a)
    assert bool((e_k == 1).all())
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)) and torch.equal(e_k, e_p)


@pytest.mark.cuda
def test_mxu_leaf_forms_match_plain_on_card():
    needs_card()
    from test_torch_scdense import port_soup

    from pine_tpu_torch.accel import grid_traverse as GT
    from pine_tpu_torch.accel import inst_traverse as IT
    from pine_tpu_torch.scene import shapes as PS

    (g,) = port_soup(3000, 3000, "cuda")["groups"]
    DT.prepare(g, "grid_mxu")
    ro, rd, tmin, tmax, bt, be, occ = _card_rays(8192, 91)
    for any_hit, state in ((False, (bt, be)), (True, (tmax, occ))):
        a = (g["tid"], g["rows"], g["grid_mxu"], ro, rd, tmin, tmax, *state, any_hit)
        t_k, e_k = GT.grid_cuda(*a, mxu=True)
        t_p, e_p = GT.grid_plain(*a, mxu=True)
        assert ((e_k != e_p) | ~torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6)).float().mean() \
            <= 1e-4
    rec = PPK.instancing_record(PS.Mesh(*scenes.make_rock(12)), scenes.rock_transforms(3),
                                np.arange(9))
    ig = IT.upload_inst_group(PPK.build_packet_accel([], [], [rec])["inst_groups"][0], "cuda")
    IT.route_inst([ig], "mxu")
    for any_hit, state in ((False, (bt, be)), (True, (tmax, occ))):
        a = (ig, ro, rd, tmin, tmax, *state, any_hit)
        t_k, e_k = IT.inst_cuda(*a, mxu=True)
        t_p, e_p = IT.inst_plain(*a, mxu=True)
        assert ((e_k != e_p) | ~torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6)).float().mean() \
            <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one live lane", "full warps", "mid-cell occluders",
                                  "shadow rays"])
def test_mxu_leaf_schedules_match_plain_on_card(case):
    from test_torch_grid_kernel import card_schedule_case

    card_schedule_case(case, "grid_mxu")
