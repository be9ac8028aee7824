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

The GPU test holds the kernel to ``probe_plain`` on the card bit for bit
and skips without one.
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


@pytest.mark.parametrize("variant", CP.VARIANTS)
def test_variant_ops_are_the_tests_own(variant):
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.n += getattr(func, "__name__", "") in COUNTED_OPS
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    row = torch.as_tensor(rng.random(12, dtype=np.float32))
    o = tuple(torch.as_tensor(rng.random(8, dtype=np.float32)) for _ in range(3))
    d = tuple(torch.as_tensor(rng.random(8, dtype=np.float32)) for _ in range(3))
    with Count() as c:
        CP.variant_test(variant)(row.__getitem__, o, d, torch.zeros(8), torch.full((8,), 1e30))
    # noselect also sums every t into its accumulator
    assert c.n + (variant == "noselect") == CP.VARIANT_OPS[variant]
    rows = torch.zeros(424, 12)
    full_ms, _ = CP.bound(N, rows)
    ms, by = CP.bound(N, rows, variant)
    assert by == "operations"
    assert ms == pytest.approx(full_ms * CP.VARIANT_OPS[variant] / CP.VARIANT_OPS["full"])


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


@pytest.mark.cuda
def test_probe_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    inputs = CP.probe_inputs(dev, 8192, "incoherent")
    for variant in CP.VARIANTS:
        t_k, e_k = CP.probe_cuda(variant, *inputs)
        t_p, e_p = CP.probe_plain(variant, *inputs)
        torch.cuda.synchronize()
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)), variant
        assert torch.equal(e_k, e_p), variant
