"""The cone-sweep probe: the dense kernel's cone sweep timed with parts of
its work taken out.  Counterpart of the repository's
``scripts_cone_probe.py`` (TPU kernel 9).

    python -m pine_tpu_torch.lab.cone_probe [variant ...]

The benchmark box's render spends its traversal in the dense sweep of its
424-row cone group.  This probe sweeps that group (``kernel_lab
.build_cone_group``) for PROBE_RAYS (65,536) coherent rays (``kernel_lab
.synth_rays``) with no group-box cull, in seven variants of the cone test
(csrc/cone_probe.cu lists them): ``full`` (the dense kernel's test and
select), ``inva`` (one reciprocal), ``nodiv``, ``nosqrt``, ``rawmath``,
``onefetch`` and ``noselect``.  All but ``full`` and ``inva`` are wrong on
purpose: they only time.

``probe_cuda`` launches the kernel; ``probe_plain`` is its plain PyTorch
version, the same per-row loop over the wavefront in the same rounded
arithmetic; ``probe`` takes the kernel for CUDA tensors and the plain
version for CPU tensors.

``main`` prints, per variant, one JSON line: ``per_call_ms`` over PROBE_CHAIN
(8) dependent launches, by CUDA events, min of 3 after a warm-up;
``ns_per_pair`` (per ray-row pair) and ``x_bound``, the time over the least
time the card could take for that variant's sweep (``bound``: the
variant's own FP32 operations per ray-row pair, VARIANT_OPS, at the H100's
FP32 rate, against the bytes of the rays and rows at its memory rate), and
``full_bound_ms``, the full sweep's bound, against which the variants'
times split the full sweep's; for ``inva``, ``max_dev_vs_full``, its
largest deviation from ``full`` on the lanes ``full`` hits.  It needs the
card; without one it exits with status 1.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

import torch

from pine_tpu_torch.accel.dense_traverse import BIG, _check, _test_cone

VARIANTS = ("full", "inva", "nodiv", "nosqrt", "rawmath", "onefetch", "noselect")
N_RAYS = int(os.environ.get("PROBE_RAYS", 65536))
CHAIN = int(os.environ.get("PROBE_CHAIN", 8))
# FP32 operations per ray-row pair of each variant's test (add, sub, mul,
# div, sqrt, min, max and negation; compares and selects not counted, as
# chip_smoke.py's TEST_OPS counts them): full is csrc/prim_tests.cuh::
# test_cone (56); inva one division and three products in place of two
# divisions and one product; nodiv products in place of the divisions;
# nosqrt a product in place of the max and square root; rawmath the
# polynomial and two sums; onefetch three differences, three products and
# two sums; noselect the full test and the running sum
VARIANT_OPS = {"full": 56, "inva": 57, "nodiv": 56, "nosqrt": 55, "rawmath": 47,
               "onefetch": 8, "noselect": 57}
FP32_OPS_PER_S = 67e12  # one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12

# kernel launches, counted where probe_cuda launches the kernel
LAUNCHES = dict.fromkeys(VARIANTS, 0)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _finish(t, ok, tmin, tmax):
    return torch.where(ok & (t > tmin) & (t < tmax), t, BIG)


def variant_test(name):
    """The cone test of variant ``name``: test(r, o, d, tmin, tmax) -> t, as
    scripts_cone_probe._variant_test writes it (``full`` and ``noselect``
    are dense_traverse's cone test itself)."""
    if name in ("full", "noselect"):
        return _test_cone
    if name == "onefetch":
        def onefetch(r, o, d, tmin, tmax):
            ax = r(0)
            t = (o[0] - ax) * d[0] + (o[1] - ax) * d[1] + (o[2] - ax) * d[2]
            return _finish(t, t > 0, tmin, tmax)
        return onefetch
    if name not in VARIANTS:
        raise ValueError(f"unknown probe variant {name!r}: one of {VARIANTS}")

    def cone(r, o, d, tmin, tmax):
        ax, ay, az = r(0), r(1), r(2)
        nx, ny, nz = r(3), r(4), r(5)
        A2, h = r(6), r(10)
        ox, oy, oz = o[0] - ax, o[1] - ay, o[2] - az
        dn = d[0] * nx + d[1] * ny + d[2] * nz
        on = ox * nx + oy * ny + oz * nz
        dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        od = ox * d[0] + oy * d[1] + oz * d[2]
        oo = ox * ox + oy * oy + oz * oz
        a = -A2 * dn * dn + dd
        b = 2.0 * (-A2 * on * dn + od)
        c = -A2 * on * on + oo
        disc = b * b - 4.0 * a * c
        if name == "rawmath":
            return _finish(disc + dn + od, disc > 0.0, tmin, tmax)
        sq = disc * 0.5 if name == "nosqrt" else torch.sqrt(torch.clamp_min(disc, 0.0))
        a_safe = torch.where(a == 0.0, 1e-6, a)
        if name == "nodiv":
            t0 = (-b - sq) * (2.0 * a_safe)  # a multiplication in place of the division
            t = torch.where(t0 < tmin, t0 + sq * a_safe, t0)
        elif name == "inva":
            inva = 0.5 / a_safe  # one reciprocal, both roots by multiplication
            t0 = (-b - sq) * inva
            t = torch.where(t0 < tmin, t0 + 2.0 * sq * inva, t0)
        else:  # nosqrt
            t0 = (-b - sq) / (2.0 * a_safe)
            t = torch.where(t0 < tmin, t0 + sq / a_safe, t0)
        height = on + t * dn
        ok = (disc > 0.0) & (height < 0.0) & (height >= -h)
        return _finish(t, ok, tmin, tmax)

    return cone


def probe_plain(variant, rows, ro, rd, tmin, best_t, best_e):
    """The probe's sweep in plain PyTorch: every row in order, no cull; the
    running best is each test's tmax -> (best_t, best_e)."""
    test = variant_test(variant)
    o = (ro[:, 0], ro[:, 1], ro[:, 2])
    d = (rd[:, 0], rd[:, 1], rd[:, 2])
    bt, be, acc = best_t, best_e, best_t
    for e in range(rows.shape[0]):
        tt = test(rows[e].__getitem__, o, d, tmin, bt)
        if variant == "noselect":
            acc = acc + tt  # keeps the test live without the select
        else:
            better = tt < bt
            bt = torch.where(better, tt, bt)
            be = torch.where(better, e, be)
    return (acc * 1e-30 + bt if variant == "noselect" else bt), be


def _library():
    from pine_tpu_torch import cuda_build

    fn = cuda_build.load("cone_probe").pine_cone_probe
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def probe_cuda(variant, rows, ro, rd, tmin, best_t, best_e):
    """Launch csrc/cone_probe.cu on the current stream."""
    n, dev = ro.shape[0], ro.device
    f32 = torch.float32
    _check(rows, f32, (rows.shape[0], 12), dev, "rows")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, torch.int32, (n,), dev, "best_e")
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}: one of {VARIANTS}")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=torch.int32, device=dev)
    err = _library()(
        VARIANTS.index(variant), rows.data_ptr(), rows.shape[1], rows.shape[0],
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), best_t.data_ptr(), best_e.data_ptr(),
        out_t.data_ptr(), out_e.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cone_probe kernel launch failed: CUDA error {err}")
    LAUNCHES[variant] += 1
    return out_t, out_e


def probe(variant, rows, ro, rd, tmin, best_t, best_e):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = probe_cuda if ro.is_cuda else probe_plain
    return fn(variant, rows, ro, rd, tmin, best_t, best_e)


def probe_inputs(device, n_rays=N_RAYS, rayset="coherent", src=None):
    """The probe's inputs on ``device``: the cone group's rows
    (``build_cone_group(device, src)``: the box's by default) and ``n_rays``
    rays of ``rayset``, tmin 1e-3, best_t BIG, best_e 0 -> (rows, ro, rd,
    tmin, best_t, best_e)."""
    from pine_tpu_torch.lab.kernel_lab import build_cone_group, synth_rays

    g, lo, hi = build_cone_group(device, src)
    o, d = synth_rays(n_rays, rayset, lo, hi)
    return (g["rows"], torch.as_tensor(o, device=device), torch.as_tensor(d, device=device),
            torch.full((n_rays,), 1e-3, device=device),
            torch.full((n_rays,), BIG, device=device),
            torch.zeros(n_rays, dtype=torch.int32, device=device))


def probe_chain(variant, rows, ro, rd, tmin, best_t, best_e, chain=CHAIN):
    """``chain`` dependent sweeps, each fed the last one's outputs, as the
    script chains them -> the last (best_t, best_e)."""
    bt, be = best_t, best_e
    for _ in range(chain):
        bt, be = probe(variant, rows, ro, rd, tmin, bt * 1.0 + 0.0, be * 0)
    return bt, be


def bound(n_rays, rows, variant="full"):
    """The least time of one sweep of ``variant`` on an H100 at 700 W -> (ms,
    "operations" or "bytes", whichever bounds it): the larger of its FP32
    operations (VARIANT_OPS per ray-row pair) over the FP32 rate and its
    bytes (each ray's o, d, tmin, best_t, best_e read and best_t, best_e
    written; the rows read once) over the memory rate."""
    ops_s = n_rays * rows.shape[0] * VARIANT_OPS[variant] / FP32_OPS_PER_S
    bytes_s = (n_rays * 11 * 4 + rows.numel() * 4) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def time_variant(variant, inputs, chain=CHAIN):
    """One variant on the card: a warm-up chain, then three timed chains ->
    (record, the last chain's outputs)."""
    rows, ro = inputs[0], inputs[1]
    out = probe_chain(variant, *inputs, chain=chain)
    torch.cuda.synchronize(ro.device)
    walls = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = probe_chain(variant, *inputs, chain=chain)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    ms = min(walls) / chain
    n, n_prims = ro.shape[0], rows.shape[0]
    b_ms, b_by = bound(n, rows, variant)
    rec = dict(variant=variant, n_prims=n_prims, rays=n, per_call_ms=ms,
               ns_per_pair=ms * 1e6 / (n * n_prims), bound_ms=b_ms, bound_by=b_by,
               x_bound=ms / b_ms, full_bound_ms=bound(n, rows)[0])
    return rec, out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    from pine_tpu_torch.core.place import resolve_device

    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"[Error] {e}")
        return 1
    variants = argv or list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        print(f"[Error] unknown variant {unknown}: one of {list(VARIANTS)}")
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "rays": N_RAYS,
                      "chain": CHAIN}), flush=True)
    inputs = probe_inputs(dev)
    ref_t = None
    for name in variants:
        rec, out = time_variant(name, inputs)
        if name == "full":
            ref_t = out[0]
        elif name == "inva" and ref_t is not None:
            hit = ref_t < BIG / 2
            rec["max_dev_vs_full"] = float(torch.where(hit, out[0] - ref_t, 0.0).abs().max())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
