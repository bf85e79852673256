"""Device meshes and batch placement (port of ``normflows_tpu/parallel/mesh.py``).

Axis convention: ``data`` is the batch/sample axis, ``chain`` the
MCMC-chain/particle axis.  A mesh spans every process of the world, one card
(or one CPU process) a rank; model parameters are replicated, and the only
collective of a training step is the gradient average of
``parallel.data_parallel``.

Where the JAX package places one global array over the mesh, each rank here
holds plain tensors: the same parameters on every rank, and its own
contiguous block of rows of a batch (:func:`shard_batch`).  The rows of
rank r along an axis of size n are ``[r * b/n, (r + 1) * b/n)``, so that the
blocks stacked in rank order are the global batch.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.backend import resolve_device


def backend_for(device) -> str:
    """The process group's backend for ranks whose tensors lie on
    ``device``: NCCL for a card a rank, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(axis_shapes: Optional[dict] = None, devices="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the world; default ``{"data":
    world size}``.

    ``axis_shapes`` e.g. ``{"data": 4, "chain": 2}``; -1 means "fill with the
    remaining ranks", and a product other than the world size raises.
    ``devices`` is the device type of the ranks' tensors, ``"cuda"`` (a rank's
    card, ``cuda:LOCAL_RANK``) or ``"cpu"``.  Without a process group (a
    single process that ``initialize_distributed`` left alone) it starts a
    world of one on an in-memory store, which opens no socket."""
    device = resolve_device(devices)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if axis_shapes is None:
        axis_shapes = {"data": n}
    names = tuple(axis_shapes)
    sizes = [int(s) for s in axis_shapes.values()]
    if sizes.count(-1) > 1 or any(s < 1 and s != -1 for s in sizes):
        raise ValueError(f"mesh {axis_shapes}: each size is positive, or -1 once")
    fixed = math.prod(s for s in sizes if s != -1)
    sizes = [n // fixed if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} ranks")
    return init_device_mesh(device.type, tuple(sizes), mesh_dim_names=names)


@dataclass(frozen=True)
class BatchSharding:
    """A batch of ``ndim`` dimensions whose leading axis is split over the
    mesh axis ``axis``: each rank holds its contiguous block of rows (the
    JAX package's ``NamedSharding(mesh, P(axis, None, ...))``)."""

    mesh: DeviceMesh
    ndim: int
    axis: str = "data"

    @property
    def parts(self) -> int:
        """The ranks along ``axis``."""
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))

    @property
    def index(self) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.get_local_rank(self.axis)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``; an ``n`` that the
        ranks along ``axis`` do not divide raises."""
        if n % self.parts:
            raise ValueError(f"a batch of {n} does not split over the {self.parts} ranks "
                             f"of mesh axis {self.axis!r}")
        size = n // self.parts
        return slice(self.index * size, (self.index + 1) * size)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch ``x`` (a view)."""
        if x.dim() != self.ndim:
            raise ValueError(f"a sharding of {self.ndim}-d batches got a {x.dim()}-d one")
        return x[self.rows(x.shape[0])]


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: str = "data") -> BatchSharding:
    """The placement of an ``ndim``-d batch sharded on its leading axis over
    ``axis``, which ``NormalizingFlow.reverse_kld(z_sharding=...)`` takes."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, not {axis!r}")
    return BatchSharding(mesh, ndim, axis)


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous block of rows of the global batch ``x`` along
    ``axis`` (a view); a batch the axis does not divide raises."""
    return batch_sharding(mesh, x.dim(), axis).local(x)


def broadcast_(tensors, mesh: DeviceMesh):
    """Overwrite ``tensors`` in place with the first rank of ``mesh``'s,
    one broadcast for each dtype and device: their values flattened into one
    buffer, sent, and copied back."""
    src = int(mesh.mesh.flatten()[0])
    kinds = {}
    for t in tensors:
        kinds.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for members in kinds.values():
            flat = torch.cat([t.reshape(-1) for t in members])
            dist.broadcast(flat, src)
            offset = 0
            for t in members:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def replicate(tree, mesh: DeviceMesh):
    """A copy of ``tree`` (a module, a tensor, or dicts, lists and tuples of
    them) holding the first rank's values on every rank of ``mesh``: a
    module's parameters and buffers, and each tensor, in fresh storage that
    never aliases the caller's."""
    if isinstance(tree, nn.Module):
        out = copy.deepcopy(tree)
        broadcast_([*out.parameters(), *out.buffers()], mesh)
        return out
    if isinstance(tree, torch.Tensor):
        out = tree.detach().clone()
        broadcast_([out], mesh)
        return out
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    raise TypeError(f"replicate takes modules, tensors and containers of them, not a "
                    f"{type(tree).__name__}")
