"""ctypes binding for the host C++ SAH builder (csrc/bvh_builder.cpp).

Counterpart of pine_tpu/accel/native_build.py.  The source is compiled with
the system C++ compiler at first use into
``build/pine_tpu_torch/libbvh_builder-<hash>.so`` at the root of the checkout
(the hash covers the source and the flags, as cuda_build does).  It is built
without ``-march=native`` and with ``-ffp-contract=off``, so no multiply-add
is fused and the tree is the same on every machine.  There is no silent
fallback: without a compiler ``build_sah_native`` raises (the numpy builder,
accel/bvh._build_sah, takes about a minute for 100k triangles).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from pine_tpu_torch.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "bvh_builder.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_lib = None


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libbvh_builder-{h}.so"


def _compiler():
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++ or c++) found: the SAH builder "
                           "csrc/bvh_builder.cpp needs one")
    return found


def load():
    """Build the library at first use (see module docstring) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building csrc/bvh_builder.cpp failed:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.pine_build_bvh.restype = ctypes.c_int32
    lib.pine_build_bvh.argtypes = [fp, fp, ctypes.c_int32, ip, fp, fp, ip, ip, ip]
    _lib = lib
    return lib


def build_sah_native(lo, hi):
    """-> (order (n,) int64, c_lower (m,2,3), c_upper, c_node, c_start, c_count)."""
    lib = load()
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = len(lo)
    order = np.empty(n, np.int32)
    c_lower = np.empty((n, 2, 3), np.float32)
    c_upper = np.empty((n, 2, 3), np.float32)
    c_node = np.empty((n, 2), np.int32)
    c_start = np.empty((n, 2), np.int32)
    c_count = np.empty((n, 2), np.int32)
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    m = lib.pine_build_bvh(
        lo.ctypes.data_as(fp), hi.ctypes.data_as(fp), n, order.ctypes.data_as(ip),
        c_lower.ctypes.data_as(fp), c_upper.ctypes.data_as(fp), c_node.ctypes.data_as(ip),
        c_start.ctypes.data_as(ip), c_count.ctypes.data_as(ip),
    )
    if m <= 0:
        raise ValueError(f"SAH build of {n} boxes failed (code {m})")
    return order.astype(np.int64), c_lower[:m], c_upper[:m], c_node[:m], c_start[:m], c_count[:m]
