"""Multi-GPU rendering through torch.distributed.  Counterpart of
pine_tpu/parallel/distributed.py.

One process per card takes the place of ``shard_map`` over a mesh: every
rank compiles the whole scene on its own device (read-only after the build)
and runs the same wavefront loop (integrators/path.sample_sums) on its
share.

- **sample parallel** (``render_sample_sharded``): rank r of n renders
  samples r * spp/n ... (r+1) * spp/n - 1 of the whole film (pine_tpu's
  ``sample_index = dev * local_spp + i``), sums them, and the film is
  reduced by one ``all_reduce(SUM)`` and divided by spp.
- **film-tile parallel** (``render_tile_sharded``): rank r renders its H/n
  film rows for all spp, with no collective in the render; every rank then
  gets the whole film by one ``all_reduce(SUM)`` of a zero film with its own
  rows written in, which is exact (the other ranks add zeros).

``all_reduce`` is the one collective of both: gloo takes it on CUDA tensors
as well (its other collectives want CPU tensors), so two ranks can share a
card under gloo, which NCCL refuses.  The backend is the caller's to name
(``make_process_group``): "nccl" across cards, "gloo" on the CPU or for
ranks that share a card.  A failed initialization raises; no backend stands
in for another.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from pine_tpu_torch.integrators.path import sample_sums, tile_order

BACKENDS = ("nccl", "gloo")


def make_process_group(backend, rank, world_size, init_method):
    """Join the default process group (``init_method`` as
    ``tcp://host:port``) under ``backend`` -> the group.  The counterpart of
    pine_tpu's ``make_device_mesh``: each rank then compiles its scene on its
    own device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return dist.group.WORLD


def render_sample_sharded(cscene, cam, W, H, sampler, spp, max_depth, group=None,
                          return_stats=False):
    """Each rank renders spp/n samples of the whole film; the sums are
    reduced by one all_reduce and divided by spp -> the (H,W,3) mean on every
    rank, on the scene's device.  With return_stats=True also
    {"traced_rays": n}, this rank's own rays."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if spp % n:
        raise ValueError(f"spp {spp} must divide over {n} processes")
    local = spp // n
    perm = tile_order(W, H)
    flat, total = sample_sums(cscene, cam, W, H, sampler, range(r * local, (r + 1) * local),
                              max_depth, perm)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    img = (flat / spp)[torch.as_tensor(np.argsort(perm), device=cscene.device)].reshape(H, W, 3)
    return (img, {"traced_rays": int(total)}) if return_stats else img


def render_tile_sharded(cscene, cam, W, H, sampler, spp, max_depth, group=None,
                        return_stats=False):
    """Each rank renders its H/n film rows for all spp (its pixels in the
    film's tile order); one all_reduce of the film, zero outside each rank's
    rows, gives every rank the whole (H,W,3) mean, on the scene's device.
    With return_stats=True also {"traced_rays": n}, this rank's own rays."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if H % n:
        raise ValueError(f"film height {H} must divide over {n} processes")
    rows = H // n
    perm = tile_order(W, H)
    mine = perm[(perm // W >= r * rows) & (perm // W < (r + 1) * rows)]
    flat, total = sample_sums(cscene, cam, W, H, sampler, range(spp), max_depth, mine)
    film = torch.zeros(H * W, 3, device=cscene.device)
    film[torch.as_tensor(mine, device=cscene.device)] = flat / spp
    dist.all_reduce(film, op=dist.ReduceOp.SUM, group=group)
    img = film.reshape(H, W, 3)
    return (img, {"traced_rays": int(total)}) if return_stats else img


def free_port():
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_worker(rank, n_procs, port, size, out_dir):
    torch.set_num_threads(1)
    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import UniformSampler

    make_process_group("gloo", rank, n_procs, f"tcp://localhost:{port}")
    try:
        scene = scenes.small_cbox(size)
        cscene = scene.compile("cpu")
        sample = render_sample_sharded(cscene, scene.camera, size, size,
                                       UniformSampler(n_procs), n_procs, 3)
        tile = render_tile_sharded(cscene, scene.camera, size, size, UniformSampler(2), 2, 3)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), sample=sample.numpy(),
                 tile=tile.numpy())
    finally:
        dist.destroy_process_group()


DRYRUN_SIZE = 32  # the dry run's film edge, as __graft_entry__'s
DRYRUN_TIMEOUT = 300  # seconds a dry-run rank may take


def dryrun_multichip(n_procs):
    """The counterpart of the repository's ``__graft_entry__.dryrun_multichip``:
    ``n_procs`` gloo processes on the CPU (spawned), each rendering the small
    Cornell box (``scenes.small_cbox(DRYRUN_SIZE)``) sample-sharded
    (UniformSampler of n_procs samples) and tile-sharded (2 samples), depth
    3.  Every rank must hold the same finite films.  -> (sample-sharded,
    tile-sharded) films of rank 0, numpy (DRYRUN_SIZE, DRYRUN_SIZE, 3)."""
    import multiprocessing
    import tempfile

    size = DRYRUN_SIZE
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_dryrun_worker, args=(r, n_procs, port, size, tmp))
                 for r in range(n_procs)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(DRYRUN_TIMEOUT)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"dry-run ranks exited with {codes}")
        films = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(n_procs)]
        sample, tile = films[0]["sample"], films[0]["tile"]
    for f in films[1:]:
        if not (np.array_equal(f["sample"], sample) and np.array_equal(f["tile"], tile)):
            raise RuntimeError("the ranks' films differ")
    for img in (sample, tile):
        if img.shape != (size, size, 3) or not np.isfinite(img).all():
            raise RuntimeError(f"a dry-run film is not finite of shape {(size, size, 3)}")
    return sample, tile
