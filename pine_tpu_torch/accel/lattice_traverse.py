"""Lattice traversal of one prim group: the host table, the kernel wrapper and
its plain version.

Counterpart of pine_tpu/accel/pallas_traverse.py's lattice kernel:
``_lattice_smem`` (here ``lattice_layout``), ``_make_lattice_kernel`` /
``_compiled_lattice_call`` (here csrc/lattice_traverse.cu through
``lattice_cuda``) and the lattice branch of ``pallas_group_query``.

A group that ``packet._detect_lattice`` found to be a regular 1-D or 2-D
lattice has rows affine in the lattice indices, row(i, j) = base + i*dU +
j*dV.  Each ray clips its window to the group box, projects the segment on
the dual basis (u = x.gu - u0 is i at the cell centres, v likewise j) and
marches it in n_seg windows, n_seg = ceil(max(|du|*seg/cap_u,
|dv|*seg/cap_v, 1)), at most ``max_seg``; in each window it tests the K x K
cells (K = 4, fewer for a narrow lattice) from floor(min(u) - r_u), clamped
to the lattice, rebuilding each candidate's row by arithmetic.  Closest-hit
keeps the first strictly nearer hit in (window, ki, kj) order and reports
the group's SAH row of the lattice index, ``slot_of_k[i*nj + j]``, on the
lanes whose t improved; any-hit stops at the first hit.  The contract is
``dense_traverse.group_query``'s.

``lattice_plain`` is the same march in plain PyTorch with the kernel's
association step by step (near + s*dt per window, each column rebuilt as
(base + fi*dU) + fj*dV), so on the card the two agree bit for bit.  The
rebuilt rows are float32 arithmetic while the group's table holds the model
evaluated in float64 and rounded (``_detect_lattice``'s snap), so against the
dense sweep of the same group t may differ by an ULP, and exact ties by id.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pine_tpu_torch.accel.dense_traverse import BIG, LAUNCHES, PRIM_TESTS, _check, _safe_inv

# FP32 operations (add, sub, mul, div, abs, min, max, floor, ceil) per ray of
# the march's set-up after the group-box clip, and per window (bounds in t,
# in u and v, and the first candidate cell); the row rebuild is not counted.
SETUP_OPS = 35
WINDOW_OPS = 22


def lattice_layout(lat, width, device):
    """The lattice model of a group as the kernel reads it, built once at
    compile time: ``latf`` float32 (3*width + 12,) [base | dU | dV | gu | gv |
    u0 v0 r_u r_v cap_u cap_v] (host numpy, and ``latf_t`` on ``device``),
    ``slot`` int32 (ni*nj,) on ``device`` (lattice index -> the group's row),
    and ``max_seg``, the windows that cover any chord through the group box."""
    base, dU, dV = (np.zeros(width, np.float32) for _ in range(3))
    pw = len(lat["base"])
    base[:pw], dU[:pw], dV[:pw] = lat["base"], lat["dU"], lat["dV"]
    tail = np.array([lat["u0"], lat["v0"], lat["r_u"], lat["r_v"], lat["cap_u"], lat["cap_v"]],
                    np.float32)
    latf = np.concatenate([base, dU, dV, np.asarray(lat["gu"], np.float32),
                           np.asarray(lat["gv"], np.float32), tail])
    span_u = (lat["ni"] - 1) + 2 * lat["r_u"]
    span_v = (lat["nj"] - 1) + 2 * lat["r_v"]
    return dict(
        ni=int(lat["ni"]), nj=int(lat["nj"]), K=int(lat["K"]), width=int(width), latf=latf,
        latf_t=torch.as_tensor(latf, device=device),
        slot=torch.as_tensor(np.asarray(lat["slot_of_k"], np.int32), device=device),
        max_seg=max(1, int(np.ceil(max(span_u / lat["cap_u"], span_v / lat["cap_v"])))),
    )


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def lattice_plain(g, ro, rd, tmin, tmax, best_t, best_e, any_hit, counts=None):
    """The lattice march in plain PyTorch (see module docstring), over the
    lanes still marching at each window.  With a ``counts`` dict, adds the
    lanes that passed the group-box clip, the windows marched and the prim
    tests run (any-hit: up to each lane's first hit, as the kernel stops
    there) to ``counts["live"]``, ``counts["windows"]`` and
    ``counts["tests"]``."""
    lay, gbox = g["lat"], g["gbox"]
    test = PRIM_TESTS[g["tid"]]
    lf = lay["latf_t"]
    w, ni, nj = lay["width"], lay["ni"], lay["nj"]
    ki_n, kj_n = min(lay["K"], ni), min(lay["K"], nj)
    o = [ro[:, a] for a in range(3)]
    d = [rd[:, a] for a in range(3)]
    lim = torch.where(best_e == 0, tmax, tmin - 1.0) if any_hit else best_t
    near, far = tmin, lim
    for a in range(3):
        inv = _safe_inv(d[a])
        t0 = (gbox[a] - o[a]) * inv
        t1 = (gbox[3 + a] - o[a]) * inv
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

    if any_hit:
        occ = best_e.clone()
    else:
        bt, k_best = best_t.clone(), torch.zeros_like(best_e)
    n_windows = n_tests = 0
    for s in range(lay["max_seg"]):
        act = (s < n_seg) & (occ == 0) if any_hit else s < n_seg
        idx = torch.nonzero(act).squeeze(1)
        if idx.numel() == 0:
            break  # n_seg only shrinks past s and occlusion only rises
        n_windows += idx.numel()
        oi, di, tmi = [x[idx] for x in o], [x[idx] for x in d], tmin[idx]
        ta = near[idx] + s * dt[idx]
        tb = near[idx] + (s + 1) * dt[idx]
        ua, ub = ou[idx] + ta * du[idx], ou[idx] + tb * du[idx]
        va, vb = ov[idx] + ta * dv[idx], ov[idx] + tb * dv[idx]
        i_lo = torch.clamp(torch.floor(torch.minimum(ua, ub) - r_u), -1e6, 1e6).to(torch.int32)
        j_lo = torch.clamp(torch.floor(torch.minimum(va, vb) - r_v), -1e6, 1e6).to(torch.int32)
        if any_hit:
            occ_i, limit = occ[idx], tmax[idx]
        else:
            bt_i, k_i = bt[idx], k_best[idx]
        for ki in range(ki_n):
            ii = torch.clamp(i_lo + ki, 0, ni - 1)
            fi = ii.to(torch.float32)
            for kj in range(kj_n):
                jj = torch.clamp(j_lo + kj, 0, nj - 1)
                fj = jj.to(torch.float32)

                def fetch(c, fi=fi, fj=fj):
                    return lf[c] + fi * lf[w + c] + fj * lf[2 * w + c]

                if any_hit:
                    n_tests += (occ_i == 0).sum()
                    tt = test(fetch, oi, di, tmi, limit)
                    occ_i = torch.maximum(occ_i, (tt < BIG).to(torch.int32))
                else:
                    tt = test(fetch, oi, di, tmi, bt_i)
                    better = tt < bt_i
                    bt_i = torch.where(better, tt, bt_i)
                    k_i = torch.where(better, ii * nj + jj, k_i)
        if any_hit:
            occ[idx] = occ_i
        else:
            n_tests += idx.numel() * ki_n * kj_n
            bt[idx], k_best[idx] = bt_i, k_i
    if counts is not None:
        counts["live"] = counts.get("live", 0) + int(live.sum())
        counts["windows"] = counts.get("windows", 0) + n_windows
        counts["tests"] = counts.get("tests", 0) + int(n_tests)
    if any_hit:
        return best_t, occ
    improved = bt < best_t
    slot = lay["slot"]
    return bt, torch.where(improved, slot[k_best.clamp(0, slot.shape[0] - 1).long()], best_e)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def bind(fn):
    """Give a library's ``pine_lattice_traverse`` its C signature."""
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _library():
    from pine_tpu_torch import cuda_build

    return bind(cuda_build.load("lattice_traverse").pine_lattice_traverse)


def lattice_cuda(g, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Launch csrc/lattice_traverse.cu on the current stream."""
    lay = g["lat"]
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    latf = lay["latf"]
    if latf.dtype != np.float32 or latf.shape != (3 * lay["width"] + 12,):
        raise ValueError(f"latf: want float32 ({3 * lay['width'] + 12},), got {latf.dtype} "
                         f"{latf.shape}")
    _check(lay["slot"], i32, (lay["ni"] * lay["nj"],), dev, "slot")
    _check(g["gbox"], f32, (6,), dev, "gbox")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        g["tid"], int(any_hit), latf.ctypes.data, lay["width"], lay["ni"], lay["nj"], lay["K"],
        lay["max_seg"], lay["slot"].data_ptr(), g["gbox"].data_ptr(), ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), best_t.data_ptr(), best_e.data_ptr(),
        out_t.data_ptr(), out_e.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lattice_traverse kernel launch failed: CUDA error {err}")
    LAUNCHES["lattice.any_hit" if any_hit else "lattice.closest"] += 1
    return out_t, out_e
