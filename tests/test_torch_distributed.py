"""Multi-process rendering (pine_tpu_torch/parallel) against the port's
single-process render and pine_tpu's sharded renders.

1. Two gloo processes on the CPU, wired by the PINE_* variables as
   tests/test_multihost.py starts its workers (``multihost.initialize``):
   the sample-sharded render (``render_multihost``) and the tile-sharded one
   of the small Cornell box (32x32, UniformSampler(4), depth 3) on both
   ranks alike, against the port's render_wavefront to atol 2e-4
   (tests/test_distributed.py's tolerance; measured: 6e-8 at most, on 16 %
   of the values, the sample sums' order (s0 + s1) + (s2 + s3) against the
   single process's ((s0 + s1) + s2) + s3), the tile-sharded film bit for
   bit (every lane's radiance is the same whichever process traces it, and
   the other rank adds zeros), and against pine_tpu's render_sample_sharded /
   render_tile_sharded on a 2-device mesh of the session's CPU devices by
   the render rule (97 % of pixels to 1e-3 relative or 1e-4 absolute,
   means to 1 %).  An spp the ranks do not divide is refused.
2. One process: ``initialize`` with no coordinator wires nothing, a
   world-size-1 group's sharded renders are render_wavefront's to the bit,
   and an unknown backend is refused.
3. ``dryrun_multichip(2)``: two spawned gloo ranks, their films equal and
   render_wavefront's.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_render import assert_renders_agree

torch.set_num_threads(2)

SIZE, SPP, DEPTH = 32, 4, 3

WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from pine_tpu_torch import scenes
from pine_tpu_torch.core.samplers import UniformSampler
from pine_tpu_torch.parallel import distributed as D, multihost

size, spp, depth, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
assert multihost.initialize(backend="gloo")
scene = scenes.small_cbox(size)
cs = scene.compile("cpu")
sample = multihost.render_multihost(cs, scene.camera, size, size, UniformSampler(spp), spp, depth)
tile = D.render_tile_sharded(cs, scene.camera, size, size, UniformSampler(spp), spp, depth)
try:
    D.render_sample_sharded(cs, scene.camera, size, size, UniformSampler(3), 3, depth)
    refused = False
except ValueError as e:
    refused = "must divide over 2 processes" in str(e)
np.savez(out, sample=sample.numpy(), tile=tile.numpy(), refused=refused)
torch.distributed.destroy_process_group()
"""


def port_reference(spp=SPP, size=SIZE):
    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene = scenes.small_cbox(size)
    return render_wavefront(scene.compile("cpu"), scene.camera, size, size,
                            UniformSampler(spp), spp, DEPTH).numpy()


def test_two_gloo_processes_match_single_and_pine_tpu(tmp_path):
    from pine_tpu_torch.parallel.distributed import free_port

    port = free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(SIZE), str(SPP), str(DEPTH), outs[r]],
        env=dict(os.environ, PYTHONPATH=root, PINE_COORDINATOR=f"localhost:{port}",
                 PINE_NUM_PROCS="2", PINE_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [np.load(o) for o in outs]
    for key in ("sample", "tile"):
        assert np.array_equal(got[0][key], got[1][key])  # every rank holds the whole film
    assert got[0]["refused"] and got[1]["refused"]

    ref = port_reference()
    for key in ("sample", "tile"):
        np.testing.assert_allclose(got[0][key], ref, rtol=0, atol=2e-4)
        assert np.isfinite(got[0][key]).all() and got[0][key].max() > 0
    assert np.array_equal(got[0]["tile"], ref)

    import __graft_entry__ as ge
    from pine_tpu.core.samplers import UniformSampler as JUniform
    from pine_tpu.parallel.distributed import (make_device_mesh, render_sample_sharded,
                                               render_tile_sharded)

    jscene = ge._build_cbox(SIZE)
    jcs, mesh = jscene.compile(), make_device_mesh(2)
    for key, fn in (("sample", render_sample_sharded), ("tile", render_tile_sharded)):
        want = np.asarray(fn(jcs, jscene.camera, SIZE, SIZE, JUniform(SPP), SPP, DEPTH, mesh))
        assert_renders_agree(got[0][key], want)


def test_one_process_group_and_wiring(monkeypatch):
    import torch.distributed as dist

    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.parallel import distributed as D, multihost

    for name in ("PINE_COORDINATOR", "PINE_NUM_PROCS", "PINE_PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(backend="gloo") is False
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.global_group()
    with pytest.raises(ValueError, match="backend must be one of"):
        D.make_process_group("mpi", 0, 1, "tcp://localhost:1")
    monkeypatch.setenv("PINE_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="PINE_NUM_PROCS"):
        multihost.initialize(backend="gloo")

    size, spp = 16, 2
    scene = scenes.small_cbox(size)
    cs = scene.compile("cpu")
    monkeypatch.setenv("PINE_COORDINATOR", f"localhost:{D.free_port()}")
    monkeypatch.setenv("PINE_NUM_PROCS", "1")
    monkeypatch.setenv("PINE_PROC_ID", "0")
    assert multihost.initialize(backend="gloo")
    try:
        assert multihost.global_group() is dist.group.WORLD
        ref = port_reference(spp, size)
        for fn in (multihost.render_multihost, D.render_sample_sharded, D.render_tile_sharded):
            img, st = fn(cs, scene.camera, size, size, UniformSampler(spp), spp, DEPTH,
                         return_stats=True)
            assert np.array_equal(img.numpy(), ref) and st["traced_rays"] > 0
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip():
    from pine_tpu_torch.parallel.distributed import dryrun_multichip

    sample, tile = dryrun_multichip(2)
    assert np.array_equal(sample, port_reference(2))
    assert np.array_equal(tile, port_reference(2))
