"""The kernel lab (pine_tpu_torch/lab/) against the repository's
scripts_kernel_lab.py and scripts_cone_probe.py.

- ``synth_rays``: bit for bit the script's, for each ray set.
- ``build_cone_group``: the benchmark box's 424-row cone group, row for row
  by geometry id bit for bit the script's (pine_tpu's compiled group).
- ``probe_plain``, the plain version of the probe kernel
  (csrc/cone_probe.cu), for each of the seven variants on the reduced box's
  36-cone group (40 rows) and 1,024 coherent ``synth_rays`` rays, against
  the script's ``_variant_test`` applied in its per-row loop
  (scripts_cone_probe.py:105-112) in jax.numpy: t to rtol 1e-4 (XLA's CPU
  backend fuses multiply-adds), ids equal except where the two t of the
  differing rows tie within that tolerance.  And ``full`` against one
  interpret-mode call of the script's Pallas kernel (``_probe_call``).
- ``probe_plain("full")``: bit for bit the dense sweep's plain version
  (``dense_plain``) on every lane its group-box cull keeps.
- ``chain_query``: a chain of dependent queries ends where one query does.
- ``VARIANT_OPS``, each variant's bound: the FP32 operations its test makes
  per ray-row pair, counted on the plain version's torch calls.
- ``run_workload``: a route the group cannot take prints an error record;
  any other failure propagates.
- The premise of the probe kernel's early misses: every variant with a
  discriminant returns BIG wherever !(disc > 0), on random, grazing,
  zero-discriminant and NaN or infinite rays.

The GPU test holds the kernel to ``probe_plain`` on the card bit for bit
(rays that miss the group, NaN and infinite lanes, one-ray launches among
them) and skips without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.lab import cone_probe as CP
from pine_tpu_torch.lab import kernel_lab as KL

torch.set_num_threads(2)

N = 1024
RTOL = 1e-4


def reduced_box():
    import bench

    return (bench.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", "-0.3 ~ 0.1 ~ 0.3")
            .replace("0.0 ~ 0.1 ~ 2.0", "0.5 ~ 0.1 ~ 1.0"))


@pytest.fixture(scope="module")
def inputs():
    """The probe's inputs on the CPU: the reduced box's cone group, 1,024
    coherent rays."""
    rows, ro, rd, tmin, bt, be = CP.probe_inputs("cpu", N, "coherent", reduced_box())
    assert tuple(rows.shape) == (40, 12)
    return rows, ro, rd, tmin, bt, be


def jax_probe(name, rows, o, d, tmin, best_t, best_e):
    """scripts_cone_probe's per-row loop (:105-114) with its _variant_test."""
    import jax.numpy as jnp

    from scripts_cone_probe import _variant_test

    test = _variant_test(name)
    rows = jnp.asarray(rows.reshape(-1))
    width = 12
    o = tuple(jnp.asarray(o[:, k]) for k in range(3))
    d = tuple(jnp.asarray(d[:, k]) for k in range(3))
    tmin, best_t, best_e = jnp.asarray(tmin), jnp.asarray(best_t), jnp.asarray(best_e)
    acc = best_t
    for e in range(rows.shape[0] // width):
        tt = test(lambda c: rows[e * width + c], o, d, tmin, best_t)
        if name == "noselect":
            acc = acc + tt
        else:
            better = tt < best_t
            best_t = jnp.where(better, tt, best_t)
            best_e = jnp.where(better, e, best_e)
    bt = acc * 1e-30 + best_t if name == "noselect" else best_t
    return np.asarray(bt), np.asarray(best_e)


def assert_probe_agree(got, want, rows, ro, rd, tmin, variant):
    """t to rtol 1e-4; ids equal, or the two rows' t tie within that rtol."""
    (t_g, e_g), (t_w, e_w) = got, want
    t_g, e_g = t_g.numpy(), e_g.numpy()
    np.testing.assert_allclose(t_g, t_w, rtol=RTOL, atol=1e-6)
    diff = np.nonzero(e_g != e_w)[0]
    test = CP.variant_test(variant)
    big = torch.full((len(diff),), 1e30)
    lanes = torch.as_tensor(diff)

    def t_of(ids):
        out = []
        for k, e in zip(lanes.tolist(), ids):
            o = tuple(ro[k:k + 1, a] for a in range(3))
            d = tuple(rd[k:k + 1, a] for a in range(3))
            out.append(float(test(rows[int(e)].__getitem__, o, d, tmin[k:k + 1], big[:1])))
        return np.asarray(out)

    if len(diff):
        np.testing.assert_allclose(t_of(e_g[diff]), t_of(e_w[diff]), rtol=RTOL)
    assert len(diff) <= 0.01 * len(e_g), len(diff)


def test_synth_rays_bit_for_bit():
    import scripts_kernel_lab as SK

    lo = np.asarray([-1.05, -0.05, -0.05], np.float32)
    hi = np.asarray([1.05, 0.1, 1.95], np.float32)
    for mode in KL.RAYSETS:
        for n in (1000, 4096):
            o, d = KL.synth_rays(n, mode, lo, hi, seed=3)
            jo, jd = SK.synth_rays(n, mode, lo, hi, seed=3)
            assert o.dtype == jo.dtype == np.float32
            np.testing.assert_array_equal(o.view(np.int32), jo.view(np.int32))
            np.testing.assert_array_equal(d.view(np.int32), jd.view(np.int32))


def test_cone_group_matches_script():
    """The full box's 424-row cone group: the same geometries, each row bit
    for bit, and the same box of its prims."""
    import scripts_kernel_lab as SK

    jg, jlo, jhi = SK.build_cone_group()
    g, lo, hi = KL.build_cone_group("cpu")
    assert tuple(g["rows"].shape) == jg["rows_np"].shape == (424, 12)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    # rows by scene geometry: pine_tpu's ids through its ent_gidx, the port's
    # through the flattened arrays' (convert.scene_arrays orders them alike)
    import bench
    from pine_tpu.prl.interp import Interpreter

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import scene_arrays

    itp = Interpreter()
    itp.run(bench.CBOX_PRL, "<lab:cbox>")
    jcs = itp.get_var("scene").compile()
    (jg2,) = [x for x in jcs.unified["groups"] if x["rows_np"].shape[0] == 424]
    a = scene_arrays(scenes.prl_scene(scenes.CBOX_PRL))

    def by_gidx(rows, base, ent_gidx):
        return {int(e): rows[k] for k, e in enumerate(ent_gidx[base:base + 420])}

    jrows = by_gidx(jg2["rows_np"], jg2["base"], np.asarray(jcs.unified["ent_gidx"]))
    prows = by_gidx(g["rows"].numpy(), g["base"], a["ent_gidx"])
    assert jrows.keys() == prows.keys() and len(jrows) == 420
    for e in jrows:
        np.testing.assert_array_equal(prows[e].view(np.int32), jrows[e].view(np.int32))


@pytest.mark.parametrize("variant", CP.VARIANTS)
def test_probe_plain_matches_script(variant, inputs):
    rows, ro, rd, tmin, bt, be = inputs
    got = CP.probe_plain(variant, rows, ro, rd, tmin, bt, be)
    want = jax_probe(variant, rows.numpy(), ro.numpy(), rd.numpy(), tmin.numpy(), bt.numpy(),
                     be.numpy())
    assert_probe_agree(got, want, rows, ro, rd, tmin, variant)
    if variant in ("full", "inva"):  # the right answers hit the cones
        assert (got[0] < 1e29).sum() > 50


def test_probe_full_matches_interpret_kernel(inputs):
    """One interpret-mode call of the script's Pallas kernel (``full``)."""
    import jax.numpy as jnp

    from scripts_cone_probe import _probe_call

    rows, ro, rd, tmin, bt, be = inputs
    k = 128

    def prep(x):
        return jnp.asarray(np.asarray(x, np.float32).reshape(N // k, k))

    call = _probe_call("full", 12, rows.shape[0], N // k)
    out = call(jnp.asarray(rows.numpy().reshape(-1)),
               *(prep(ro[:, a]) for a in range(3)), *(prep(rd[:, a]) for a in range(3)),
               prep(tmin), prep(np.full(N, 1e30)), prep(bt),
               jnp.zeros((N // k, k), jnp.int32))
    want = (np.asarray(out[0]).reshape(-1), np.asarray(out[1]).reshape(-1))
    got = CP.probe_plain("full", rows, ro, rd, tmin, bt, be)
    assert_probe_agree(got, want, rows, ro, rd, tmin, "full")


def test_probe_full_is_the_dense_sweep(inputs):
    """``full`` is the dense kernel's sweep without its cull: bit for bit
    dense_plain on every lane the cull keeps, with a prepared running best."""
    rows, ro, rd, tmin, _, _ = inputs
    rng = np.random.default_rng(5)
    bt = torch.as_tensor(np.where(rng.random(N) < 0.3, rng.uniform(1, 4, N), 1e30)
                         .astype(np.float32))
    be = torch.as_tensor(rng.integers(0, 40, N).astype(np.int32))
    o_all, d_all, (g, lo, hi) = ro, rd, KL.build_cone_group("cpu", reduced_box())
    # half the rays start inside the group's box, so both outcomes of the cull occur
    o_all = o_all.clone()
    o_all[::2] = torch.as_tensor((lo + (hi - lo) * rng.random((N // 2, 3))).astype(np.float32))
    t_p, e_p = CP.probe_plain("full", rows, o_all, d_all, tmin, bt, be)
    t_d, e_d = DT.dense_plain(g["tid"], g["rows"], g["gbox"], o_all, d_all, tmin,
                              torch.full((N,), 1e30), bt, be, False)
    live = DT.cull_window(g["gbox"], tuple(o_all.T), tuple(d_all.T), tmin, None, bt, be, False)
    assert 0.1 * N < int(live.sum()) < N
    assert torch.equal(t_p[live].view(torch.int32), t_d[live].view(torch.int32))
    assert torch.equal(e_p[live], e_d[live])


def test_chain_query_is_one_query():
    g, lo, hi = KL.build_cone_group("cpu", reduced_box())
    o, d = KL.synth_rays(256, "incoherent", lo, hi)
    ro, rd = torch.as_tensor(o), torch.as_tensor(d)
    tmin, tmax = torch.full((256,), 1e-3), torch.full((256,), 1e30)
    one = DT.group_query(g, ro, rd, tmin, tmax, tmax, torch.zeros(256, dtype=torch.int32),
                         variant="dense")
    for variant in ("dense", "scdense"):
        DT.prepare(g, variant)
        chained = KL.chain_query(g, variant, ro, rd, tmin, tmax, chain=3)
        assert torch.equal(chained[0], one[0]) and torch.equal(chained[1], one[1])
    assert (one[0] < 1e29).any()


def test_probe_refuses_unknown_variant(inputs):
    with pytest.raises(ValueError, match="unknown probe variant"):
        CP.probe_plain("fast", *inputs)


# the arithmetic a bound counts (chip_smoke.py's TEST_OPS: add, sub, mul,
# div, sqrt, min, max and negation; compares and selects are not counted)
COUNTED_OPS = {"add", "sub", "mul", "div", "neg", "__add__", "__radd__", "__sub__",
               "__rsub__", "__mul__", "__rmul__", "__truediv__", "__rtruediv__", "__rdiv__",
               "__neg__", "sqrt", "clamp_min", "clamp_max", "minimum", "maximum"}


def counted_ops(fn, *args):
    """The counted arithmetic (COUNTED_OPS) of one call of ``fn``."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.n += getattr(func, "__name__", "") in COUNTED_OPS
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn(*args)
    return c.n


def random_pair():
    """A cone row and 8 rays: (row accessor, o, d)."""
    rng = np.random.default_rng(3)
    row = torch.as_tensor(rng.random(12, dtype=np.float32))
    o = tuple(torch.as_tensor(rng.random(8, dtype=np.float32)) for _ in range(3))
    d = tuple(torch.as_tensor(rng.random(8, dtype=np.float32)) for _ in range(3))
    return row.__getitem__, o, d


@pytest.mark.parametrize("variant", CP.VARIANTS)
def test_variant_ops_are_the_tests_own(variant):
    n = counted_ops(CP.variant_test(variant), *random_pair(), torch.zeros(8),
                    torch.full((8,), 1e30))
    # noselect also sums every t into its accumulator
    assert n + (variant == "noselect") == CP.VARIANT_OPS[variant]
    rows = torch.zeros(424, 12)
    full_ms, _ = CP.bound(N, rows)
    ms, by = CP.bound(N, rows, variant)
    assert by == "operations"
    assert ms == pytest.approx(full_ms * CP.VARIANT_OPS[variant] / CP.VARIANT_OPS["full"])


@pytest.mark.parametrize("variant", list(CP.EARLY_OPS))
def test_early_ops_are_the_discriminants_own(variant):
    """A pair that leaves at the early miss costs the discriminant's
    operations (noselect: and its running sum), and the bound charges the
    early-missing pairs that and the others the whole test."""
    n = counted_ops(CP._quadratic, *random_pair())
    assert n + (variant == "noselect") == CP.EARLY_OPS[variant]
    rows = torch.zeros(424, 12)
    pairs = N * 424
    for misses in (0, pairs // 3, pairs):
        ms, by = CP.bound(N, rows, variant, misses)
        ops = (pairs - misses) * CP.VARIANT_OPS[variant] + misses * CP.EARLY_OPS[variant]
        assert by == "operations"
        assert ms == pytest.approx(ops / CP.FP32_OPS_PER_S * 1e3)
    assert CP.bound(N, rows, "onefetch", pairs) == CP.bound(N, rows, "onefetch")


@pytest.mark.parametrize("field", ["cones 1x600", "spheres 24x24"])
def test_lattice_workloads(field):
    """kernel_lab's lattice groups and rays (chip_smoke.py phase 2d's and
    redesign_ab's lattice cases): the field is one lattice group, and the
    rays aimed at it hit it, closest-hit and any-hit."""
    from pine_tpu_torch.accel import lattice_traverse as LT
    from pine_tpu_torch.scene import shapes as S

    kind, shape = field.split()
    ni, nj = map(int, shape.split("x"))
    tid, spacing, size = (S.CONE, 1 / 256, 0.0025) if kind == "cones" else (S.SPHERE, 0.1, 0.04)
    g = KL.lattice_field("cpu", tid, ni, nj, spacing, size)
    assert g["lattice"] is not None and g["lat"]["slot"].shape[0] == ni * nj
    assert DT.group_variant(g) == "lattice"
    r = KL.lattice_rays(np.random.default_rng(41), "cpu", g, 4096)
    assert all(x.shape[0] == 4096 for x in r.values())
    for any_hit in (False, True):
        args = KL.ray_args(r, any_hit)
        _, e = LT.lattice_plain(g, *args, any_hit)
        assert int((e != args[5]).sum()) > 20


def test_lab_prints_refused_routes_and_raises_the_rest(monkeypatch, capsys):
    import json

    build = KL.build_cone_group
    monkeypatch.setattr(KL, "build_cone_group", lambda dev: build(dev, reduced_box()))
    monkeypatch.setattr(KL, "N_RAYS", 64)
    ran = []

    def refuse_bvh(g, variant, raysets, label):
        if variant == "bvh":
            raise DT.RouteRefused("the bvh route needs the group's SAH node arrays")
        ran.append(variant)

    monkeypatch.setattr(KL, "run_variant", refuse_bvh)
    KL.run_workload("cone420", "cpu")
    assert ran == [v for v in KL.WORKLOADS["cone420"] if v != "bvh"]
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["variant"], "SAH" in r["error"]) for r in recs] == [("bvh", True)]

    def fail(g, variant, raysets, label):
        raise RuntimeError("dense_traverse kernel launch failed: CUDA error 2")

    monkeypatch.setattr(KL, "run_variant", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        KL.run_workload("cone420", "cpu")


def test_bvh_route_on_a_group_without_nodes_is_refused():
    g, _, _ = KL.build_cone_group("cpu", reduced_box())
    g = dict(g, nodes=None)
    g.pop("bvh", None)
    with pytest.raises(DT.RouteRefused, match="SAH node arrays"):
        DT.prepare(g, "bvh")


def odd_rays(rows, n, seed):
    """Rays about the cone group: random, a quarter grazing a cone's side
    (aimed at a point on its rim, nearly level), every 16th with a zero
    direction (a discriminant of exactly zero) and every 32nd with a NaN or
    infinite origin or direction coordinate."""
    rng = np.random.default_rng(seed)
    lo, hi = rows[:, 0:3].min(0).values.numpy(), rows[:, 0:3].max(0).values.numpy()
    ro = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    q = n // 4
    apex = rows[rng.integers(0, rows.shape[0], q), 0:3].numpy()
    tgt = apex + np.stack([rng.uniform(-0.06, 0.06, q), rng.uniform(-0.05, 0.0, q),
                           rng.uniform(-0.06, 0.06, q)], 1)
    ro[-q:] = tgt + rng.normal(size=(q, 3)) * [1.0, 0.01, 1.0]
    rd[-q:] = tgt - ro[-q:]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::16] = 0.0
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    ro[1::32, 0] = bad[rng.integers(0, 3, len(ro[1::32]))]
    rd[17::32, 2] = bad[rng.integers(0, 3, len(rd[17::32]))]
    return torch.from_numpy(ro), torch.from_numpy(rd)


def discriminants(rows, ro, rd):
    """The cone test's discriminant of every (ray, row) pair, (n, rows),
    written out as csrc/prim_tests.cuh::test_cone rounds it."""
    o = tuple(ro[:, a, None] for a in range(3))
    d = tuple(rd[:, a, None] for a in range(3))

    def r(col):
        return rows[None, :, col]

    ox, oy, oz = o[0] - r(0), o[1] - r(1), o[2] - r(2)
    nx, ny, nz, A2 = r(3), r(4), r(5), r(6)
    dn = d[0] * nx + d[1] * ny + d[2] * nz
    on = ox * nx + oy * ny + oz * nz
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    od = ox * d[0] + oy * d[1] + oz * d[2]
    oo = ox * ox + oy * oy + oz * oz
    a = -A2 * dn * dn + dd
    b = 2.0 * (-A2 * on * dn + od)
    c = -A2 * on * on + oo
    return b * b - 4.0 * a * c


@pytest.mark.parametrize("rays", ["coherent", "grazing, zero-discriminant and NaN"])
def test_early_misses_count_the_pairs_that_leave(rays, inputs):
    """early_misses, which the probe's bound charges only the
    discriminant's operations, counts the pairs with !(disc > 0), NaN
    included."""
    rows = inputs[0]
    ro, rd = inputs[1:3] if rays == "coherent" else odd_rays(rows, 2048, 8)
    want = int((~(discriminants(rows, ro, rd) > 0.0)).sum())
    assert 0 < want < ro.shape[0] * rows.shape[0]
    assert CP.early_misses(rows, ro, rd) == want


@pytest.mark.parametrize("variant", [v for v in CP.VARIANTS if v != "onefetch"])
def test_probe_early_misses_are_exact(variant, inputs):
    """The probe kernel returns BIG where !(disc > 0) before the square root
    and divisions (``full`` and ``noselect`` through test_cone's EARLY
    form): each variant's own test gives BIG on every such pair already, so
    the early-miss form equals ``variant_test``.  ``onefetch`` has no
    discriminant and no early miss."""
    rows = inputs[0]
    ro, rd = odd_rays(rows, 2048, 8)
    tmin = torch.full((2048, 1), 1e-3)
    o = tuple(ro[:, a, None] for a in range(3))
    d = tuple(rd[:, a, None] for a in range(3))

    def r(col):
        return rows[None, :, col]

    t = CP.variant_test(variant)(r, o, d, tmin, torch.full((2048, 1), BIG_T))
    disc = discriminants(rows, ro, rd)
    early = ~(disc > 0.0)
    assert bool((disc == 0.0).any()) and bool(torch.isnan(disc).any())
    assert 0.1 < float(early.float().mean()) < 0.9
    assert bool((t[early] == 1e30).all())
    assert bool((t < 1e30).any()), "some pairs must hit"


BIG_T = 3e38  # a window that ends beyond every t


@pytest.mark.cuda
def test_probe_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    inputs = list(CP.probe_inputs(dev, 8192, "incoherent"))
    ro, rd = odd_rays(inputs[0].cpu(), 8192, 9)
    inputs[1][::2], inputs[2][::2] = ro[::2].to(dev), rd[::2].to(dev)
    for args in (inputs, [inputs[0], *(x[:1] for x in inputs[1:])],
                 [inputs[0], *(x[1:2] for x in inputs[1:])]):
        for variant in CP.VARIANTS:
            t_k, e_k = CP.probe_cuda(variant, *args)
            t_p, e_p = CP.probe_plain(variant, *args)
            torch.cuda.synchronize()
            assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)), variant
            assert torch.equal(e_k, e_p), variant
