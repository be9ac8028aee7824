"""Supercell-culled dense traversal of one prim group: host tables, the kernel
wrapper and its plain version.

Counterpart of pine_tpu/accel/pallas_traverse.py's scdense kernel
(``_make_scdense_kernel`` / ``_compiled_scdense_call``, here
csrc/scdense_traverse.cu through ``scdense_cuda``), which ``pine_tpu`` runs
under ``PINE_SMALL_KERNEL=scdense`` and the port when
``CompiledScene.small_kernel`` (or ``mesh_kernel``) is "scdense".  Each ray
sweeps the group's rows in order, as the dense traversal does, but skips a
128-prim supercell whose box it cannot reach within its window, then each of
the supercell's eight 16-prim cells that fails the same test.  The window is
(tmin, running best) for closest-hit and (tmin, tmax) for any-hit, which
stops at the first hit.  The contract is ``dense_traverse.group_query``'s.

Tables (``scdense_layout``, uploaded once): ``sc_boxes`` float32 (n_super,
6) and ``cell_boxes`` (n_super * 8, 6), lo xyz and hi xyz of each supercell
and 16-prim cell of the group's leaf-order prim boxes; cells past the last
prim are the empty box.  ``cell_boxes`` equals the first n_super * 8 rows of
``_grid_layout``'s ``scd_cell_boxes``.

The kernel reads the rows padded to a multiple of 4 floats
(``dense_traverse.dense_rows``) and stages them with the boxes in shared
memory; a lane whose incoming window reaches no supercell box does nothing
in the sweep, so the kernel writes it back and sweeps the others
(csrc/scdense_traverse.cu).

``scdense_plain`` makes the same culls in the same order with the same slab
arithmetic (a supercell's cull against the best after the supercells before
it, a cell's against the best after the cells before it), and tests each
cell's rows in order against the running best, so on the card it and the
kernel agree on every lane, bit for bit, and on the CPU it equals the dense
sweep (``dense_plain``) on the tests' inputs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pine_tpu_torch.accel.dense_traverse import (
    BIG, LAUNCHES, PRIM_TESTS, _aligned, _check, _safe_inv, padded_width,
)
from pine_tpu_torch.accel.grid_traverse import SUPER, _boxes, _slab

SCD_CELL = 16  # prims per cull cell (pallas_traverse.SCD_CELL)


def scdense_layout(prim_aabbs, device):
    """The group's supercell and 16-prim cell boxes on ``device`` (see module
    docstring), built once."""
    boxes = np.asarray(prim_aabbs, np.float32)
    n_super = (len(boxes) + SUPER - 1) // SUPER
    return dict(
        n_prims=len(boxes), n_super=n_super,
        sc_boxes=torch.as_tensor(_boxes(boxes, SUPER, n_super), device=device),
        cell_boxes=torch.as_tensor(_boxes(boxes, SCD_CELL, n_super * (SUPER // SCD_CELL)),
                                   device=device),
    )


def scdense_plain(tid, rows, scd, ro, rd, tmin, tmax, best_t, best_e, any_hit, counts=None):
    """The supercell-culled sweep in plain PyTorch (see module docstring).
    With a ``counts`` dict, adds the slab tests and prim tests this call ran
    to ``counts["slabs"]`` and ``counts["tests"]`` (any-hit: up to each
    lane's first hit, where the kernel stops)."""
    test = PRIM_TESTS[tid]
    n_prims, n_super = scd["n_prims"], scd["n_super"]
    dev = ro.device
    inv = [_safe_inv(rd[:, a]) for a in range(3)]
    o = [ro[:, a] for a in range(3)]
    n_slabs = n_tests = 0
    if any_hit:
        occ = best_e.clone()
        active = (best_e == 0) & (tmax > tmin)
    else:
        cur_t, cur_e = best_t.clone(), best_e.clone()
    every = torch.arange(ro.shape[0], device=dev)
    cols = torch.arange(SCD_CELL, device=dev)

    def reach(box, idx):
        lim = tmax[idx] if any_hit else cur_t[idx]
        return idx[_slab(box, [x[idx] for x in o], [x[idx] for x in inv], tmin[idx], lim)]

    for si in range(n_super):
        lanes = every[active & (occ == 0)] if any_hit else every
        n_slabs += lanes.numel()
        lanes = reach(scd["sc_boxes"][si], lanes)
        for kc in range(SUPER // SCD_CELL):
            p0 = (si * (SUPER // SCD_CELL) + kc) * SCD_CELL
            if p0 >= n_prims or lanes.numel() == 0:
                break
            if any_hit:
                lanes = lanes[occ[lanes] == 0]
            n_slabs += lanes.numel()
            idx = reach(scd["cell_boxes"][p0 // SCD_CELL], lanes)
            if idx.numel() == 0:
                continue
            width = min(SCD_CELL, n_prims - p0)
            r = rows[p0:p0 + width]
            oi, di, tmi = ([x[idx, None] for x in o], [rd[idx, a, None] for a in range(3)],
                           tmin[idx, None])
            if any_hit:
                hit = test(lambda k: r[:, k], oi, di, tmi, tmax[idx, None]) < BIG
                first = torch.where(hit.any(1), hit.to(torch.int8).argmax(1), width - 1)
                n_tests += int((first + 1).sum())
                occ[idx] = torch.where(hit.any(1), 1, occ[idx])
                continue
            n_tests += idx.numel() * width
            # the rows in order against the running best: the lowest row of the
            # cell's minimum replaces the best on a strict <
            tt = test(lambda k: r[:, k], oi, di, tmi, cur_t[idx, None])
            tb = tt.min(1).values
            eb = torch.where(tt == tb[:, None], cols[:width], SCD_CELL).min(1).values
            better = tb < cur_t[idx]
            cur_t[idx] = torch.where(better, tb, cur_t[idx])
            cur_e[idx] = torch.where(better, (p0 + eb).to(cur_e.dtype), cur_e[idx])
    if counts is not None:
        counts["slabs"] = counts.get("slabs", 0) + n_slabs
        counts["tests"] = counts.get("tests", 0) + n_tests
    if any_hit:
        return best_t, occ
    return cur_t, cur_e


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def bind(fn):
    """Give a library's ``pine_scdense_traverse`` its C signature."""
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _library():
    from pine_tpu_torch import cuda_build

    return bind(cuda_build.load("scdense_traverse").pine_scdense_traverse)


def scdense_cuda(tid, rows, scd, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Launch csrc/scdense_traverse.cu on the current stream, over ``rows``
    padded as ``dense_traverse.dense_rows`` pads a group's."""
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    n_super = scd["n_super"]
    if rows.shape[0] < scd["n_prims"]:
        raise ValueError(f"rows: {rows.shape[0]} rows for {scd['n_prims']} prims")
    _check(rows, f32, (rows.shape[0], padded_width(tid)), dev, "rows")
    _aligned(rows, "rows")
    _check(scd["sc_boxes"], f32, (n_super, 6), dev, "sc_boxes")
    _check(scd["cell_boxes"], f32, (n_super * (SUPER // SCD_CELL), 6), dev, "cell_boxes")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        tid, int(any_hit), rows.data_ptr(), rows.shape[1], scd["n_prims"], n_super,
        scd["sc_boxes"].data_ptr(), scd["cell_boxes"].data_ptr(), ro.data_ptr(), rd.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), best_t.data_ptr(), best_e.data_ptr(), out_t.data_ptr(),
        out_e.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"scdense_traverse kernel launch failed: CUDA error {err}")
    LAUNCHES["scdense.any_hit" if any_hit else "scdense.closest"] += 1
    return out_t, out_e
