"""Chain/particle parallelism for HAIS (port of ``normflows_tpu/parallel/chains.py``).

The chains advance in lockstep on the batch axis; here the chain axis is
split over the ranks as well, so that N cards run N times the chains at
constant wall time.  As the JAX package derives every chain's draws from one
key whatever the layout, every rank here makes the GLOBAL draws of the
sampler's documented order (``sampler.draw_noise``) from one generator
seeded alike, keeps its own chains' rows and runs ``sampler.from_noise`` on
them: the shards stacked in rank order are the single-process ``sample``'s
chains.  No collective runs until the caller reduces the weights.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .mesh import batch_sharding, replicate, shard_batch


def shard_chains(z: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This rank's chains of a state tensor (its leading axis): the chain
    axis is a batch axis, placed as :func:`shard_batch` places it."""
    return shard_batch(z, mesh, axis)


def _rows(tree, rows: slice):
    if isinstance(tree, torch.Tensor):
        return tree[rows]
    return type(tree)(_rows(t, rows) for t in tree)


def parallel_chain_sample(sampler: nn.Module, mesh: DeviceMesh, num_samples: int,
                          axis: str = "data"):
    """``run(generator_or_seed) -> (samples, log_w)``, this rank's block of
    ``num_samples`` chains of ``sampler`` (a copy holding rank 0's values,
    :func:`replicate`), without gradients.

    ``sampler`` draws through ``draw_noise(num_samples, generator=g)`` and
    maps the draws with ``from_noise`` (``sampling.HAIS``); a sampler
    without both raises.  ``run`` takes a ``torch.Generator`` on the
    sampler's device or an int seed for one."""
    missing = [name for name in ("draw_noise", "from_noise") if not hasattr(sampler, name)]
    if missing:
        raise TypeError(f"parallel_chain_sample: {type(sampler).__name__} has no "
                        f"{' or '.join(missing)}, so its chains cannot be drawn globally "
                        f"and run a block a rank")
    sampler = replicate(sampler, mesh)
    rows = batch_sharding(mesh, 1, axis).rows(num_samples)
    device = next(iter([*sampler.parameters(), *sampler.buffers()])).device

    @torch.no_grad()
    def run(generator_or_seed: Union[torch.Generator, int]):
        g = generator_or_seed
        if not isinstance(g, torch.Generator):
            g = torch.Generator(device).manual_seed(int(g))
        noise = sampler.draw_noise(num_samples, generator=g)
        return sampler.from_noise(*_rows(noise, rows))

    return run
