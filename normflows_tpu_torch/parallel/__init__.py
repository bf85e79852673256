"""Data and chain parallelism over processes (port of ``normflows_tpu.parallel``).

The JAX package shards global arrays over a device mesh and lets XLA insert
the collectives.  The port runs one process a card, joined by
``torch.distributed``: ``initialize_distributed`` (torchrun's environment,
or an explicit coordinator), ``make_mesh`` (a ``DeviceMesh`` over the
world), each rank holding its own rows of a batch (``shard_batch``,
``batch_sharding``) and the same parameters (``replicate``); the
data-parallel steps average the gradient with one collective a step, and
``parallel_chain_sample`` runs a block of chains a rank.  Tensor
parallelism and FSDP (``tensor_parallel``: sharded leaves as DTensors, the
collectives written out) and pipelining over flow layers (``pipeline``:
GPipe's schedule, hops as broadcasts between neighbouring stages) shard the
model itself.
"""

from .chains import parallel_chain_sample, shard_chains
from .data_parallel import make_data_parallel_step, make_eval_step, make_reverse_kld_step
from .distributed import initialize_distributed, local_device_batch, process_local_batch
from .mesh import batch_sharding, make_mesh, replicate, shard_batch
from .pipeline import make_pipeline_apply, make_pipeline_train_step
from .tensor_parallel import (fsdp_shardings, make_fsdp_step, make_tensor_parallel_step,
                              tp_shardings)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "batch_sharding",
    "make_data_parallel_step",
    "make_eval_step",
    "make_reverse_kld_step",
    "shard_chains",
    "parallel_chain_sample",
    "make_pipeline_apply",
    "make_pipeline_train_step",
    "tp_shardings",
    "fsdp_shardings",
    "make_tensor_parallel_step",
    "make_fsdp_step",
    "initialize_distributed",
    "local_device_batch",
    "process_local_batch",
]
