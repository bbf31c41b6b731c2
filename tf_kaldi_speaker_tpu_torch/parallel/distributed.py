"""Joining the launcher's processes, one per card, and per-rank data shares.

Counterpart of ``tf_kaldi_speaker_tpu/parallel/distributed.py``: JAX joins
hosts with ``jax.distributed.initialize`` and each host feeds its own
devices; here each rank is one process on one card (the counterpart of a
JAX process that holds one device), joined by ``torch.distributed`` from
the launcher's environment (``torchrun --nproc_per_node N``, or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``).

A failed join raises: nothing falls back to one process or to the CPU.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("tfks_torch.distributed")


def initialize(device="cuda", backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> torch.device:
    """Join the launcher's process group and return this rank's device.

    ``device``: ``cuda`` is ``cuda:LOCAL_RANK``; an indexed CUDA device or
    ``cpu`` is kept. ``backend``: ``nccl`` for a CUDA device and ``gloo``
    for the CPU unless given (two ranks on one card need ``gloo``: NCCL
    refuses them). ``timeout_s`` bounds every collective (torch's default
    when None).

    Without a launcher (``WORLD_SIZE`` unset or 1 and no ``MASTER_ADDR``)
    this is a no-op, as the JAX function is for one process with no
    coordinator; under a launcher a world of one joins a group of one, on
    which the trainers run no collective."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return dev
    if world == 1 and "MASTER_ADDR" not in os.environ:
        log.info("Single-process run; no process group.")
        return dev
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world, **kwargs)
    log.info("process group up (%s): rank %d/%d on %s", backend, dist.get_rank(),
             dist.get_world_size(), dev)
    return dev


def barrier(device) -> None:
    """Wait for every rank: an all-reduce of one value (on the CPU under
    gloo, on ``device`` under NCCL)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        where = torch.device(device) if dist.get_backend() == "nccl" else torch.device("cpu")
        dist.all_reduce(torch.zeros(1, device=where))


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_shard_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """Whether this is rank 0, the one that writes logs, summaries,
    checkpoints and the model dir's bookkeeping files."""
    return host_shard_info()[0] == 0


def per_host_batch(global_batch: int) -> int:
    n = host_shard_info()[1]
    assert global_batch % n == 0, "global batch must divide across ranks"
    return global_batch // n
