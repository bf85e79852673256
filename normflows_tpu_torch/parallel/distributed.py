"""Multi-process setup (port of ``normflows_tpu/parallel/distributed.py``).

One process a card: ``initialize_distributed`` joins the processes into one
``torch.distributed`` world, after which ``make_mesh`` spans every rank and
the steps of ``data_parallel`` work unchanged.  Under ``torchrun
--nproc_per_node=N`` it reads the launcher's environment; a single process
with neither arguments nor that environment stays a single process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.backend import resolve_device
from .mesh import backend_for

# what torchrun sets for every process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda",
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> torch.device:
    """Join this process to the world and return its device.

    With ``coordinator_address`` (``host:port`` of rank 0's store) the caller
    has said a world exists: ``num_processes`` ranks, this one
    ``process_id``, and a failed initialisation PROPAGATES (training on
    1/N of the data unawares is the worst failure).  Without it, the
    variables torchrun sets (:data:`TORCHRUN_ENV`) are read; where they are
    absent this is a single process and nothing happens.

    The backend follows ``device``: NCCL for ranks on cards, gloo on the CPU.
    ``backend="gloo"`` is for ranks that share one card, which NCCL
    refuses.  A rank's card is ``cuda:LOCAL_RANK`` (under an explicit
    address, ``process_id`` modulo the cards of the host).  ``timeout``
    (seconds) bounds the wait for the other ranks and every collective."""
    device = resolve_device(device)
    if dist.is_initialized():
        return _local_device(device)
    kwargs = {"backend": backend or backend_for(device)}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and "
                             "process_id")
        address = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        local = _local_rank(process_id, device)
        if device.type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(init_method=address, world_size=int(num_processes),
                                rank=int(process_id), **kwargs)
        return _local_device(device)
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return device
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(init_method="env://", **kwargs)
    return _local_device(device)


def _local_rank(process_id: int, device: torch.device) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return int(process_id) % torch.cuda.device_count() if device.type == "cuda" else 0


def _local_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    return torch.device("cuda", torch.cuda.current_device())


def world_size() -> int:
    """The processes of the world (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_local_batch(global_batch_size: int) -> int:
    """Per-process batch size: each process loads only its share of the
    data; a size the processes do not divide raises."""
    n = world_size()
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def local_device_batch(global_batch_size: int) -> int:
    """Per-device batch size on this process: one card a process, so the
    per-process size (and its check)."""
    return process_local_batch(global_batch_size)
