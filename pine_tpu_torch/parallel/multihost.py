"""Multi-host rendering.  Counterpart of pine_tpu/parallel/multihost.py.

The reference is single-node shared-memory only (core/parallel.h).  Across
hosts the program is the same as on one: ``initialize`` joins every
process to one torch.distributed group, each process renders its share of
the samples of the whole film, and the one collective is the film's
all_reduce (parallel/distributed.py).  The only traffic between hosts is
one film-sized all_reduce per render.

Env wiring (each process sets):
    PINE_COORDINATOR  host:port of process 0
    PINE_NUM_PROCS    total process count
    PINE_PROC_ID      this process's rank
"""
from __future__ import annotations

import os

import torch.distributed as dist

from pine_tpu_torch.parallel.distributed import make_process_group, render_sample_sharded


def initialize(coordinator_address=None, num_processes=None, process_id=None, backend="nccl"):
    """Join the process group from the arguments or the PINE_* variables
    (``init_method`` tcp://PINE_COORDINATOR) under ``backend``: "nccl" on
    the cards, "gloo" when the caller asks for the CPU.  -> True when wired,
    False when no coordinator is named (one process: nothing to wire)."""
    coordinator_address = coordinator_address or os.environ.get("PINE_COORDINATOR")
    num_processes = num_processes or _int_env("PINE_NUM_PROCS")
    process_id = process_id if process_id is not None else _int_env("PINE_PROC_ID")
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs PINE_NUM_PROCS and PINE_PROC_ID "
                         "(or num_processes and process_id)")
    make_process_group(backend, process_id, num_processes, f"tcp://{coordinator_address}")
    return True


def _int_env(name):
    v = os.environ.get(name)
    return None if v is None else int(v)


def global_group():
    """The group of every process of every host (pine_tpu's global mesh)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize first")
    return dist.group.WORLD


def render_multihost(cscene, cam, W, H, sampler, spp, max_depth, return_stats=False):
    """Sample-sharded render over every process; the film's all_reduce
    crosses the hosts.  Every process returns the whole film."""
    return render_sample_sharded(cscene, cam, W, H, sampler, spp, max_depth,
                                 group=global_group(), return_stats=return_stats)
