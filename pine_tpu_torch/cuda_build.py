"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
into ``build/pine_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout,
at first use; the hash covers the source, the shared headers (csrc/*.cuh) and
the flags, so an edited source rebuilds.  Several sources build in parallel, one nvcc process each.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from pine_tpu_torch.core import profiler

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pine_tpu_torch"

# sm_90a for Hopper.  No --use_fast_math: the prim tests need IEEE division
# and square roots.  -fmad=false keeps every a*b+c as a rounded multiply and
# a rounded add, the same arithmetic as the plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_LOADED: dict[tuple, ctypes.CDLL] = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str, defines=()) -> Path:
    """The library of csrc/<name>.cu built with ``-D`` ``defines``."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names, timeout=900) -> dict:
    """Compile every source not yet built, all nvcc processes at once;
    ``names`` holds source names, or (name, defines) pairs for a source
    built with ``-D`` ``defines`` (the lab's variants).

    Returns {name or pair: build log (ptxas register and spill report)}."""
    with profiler.span("kernels.build", sources=len(names)):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for key in names:
            name, defs = (key, ()) if isinstance(key, str) else key
            out = library_path(name, defs)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defs), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[key] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
        logs = {}
        for key, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{key}:\n{log}")
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
            logs[key] = log
        return logs


def load(name: str, defines=()) -> ctypes.CDLL:
    key = (name, tuple(defines))
    if key not in _LOADED:
        with profiler.span("kernels.load", source=name):
            build([key])
            _LOADED[key] = ctypes.CDLL(str(library_path(*key)))
    return _LOADED[key]
