"""Data-parallel training of Real NVP on TwoMoons: the port of
``examples/data_parallel_training.py``.

    python -m normflows_tpu_torch.examples.data_parallel_training [--iters 1000]
        [--k 16] [--global-batch 4096] [--seed 0] [--device cuda]
    torchrun --nproc_per_node=N -m normflows_tpu_torch.examples.data_parallel_training ...

K masked affine layers on ``MLP([2, 64, 64, 2], init_zeros=True)`` nets
(the JAX script's model), forward KL with Adam(5e-4) on a global batch of
``--global-batch`` TwoMoons points a step, drawn from 2^16 points made once
from ``--seed``.  Under torchrun each process takes one card
(``cuda:LOCAL_RANK``) and its rows of every global batch
(``parallel.shard_batch``); ``parallel.make_data_parallel_step`` averages
the gradient over the processes with one collective a step.  As one process
the world is one rank.  Rank 0 prints the loss every 200 iterations, the
samples/s across the world, and a last JSON line with the numbers
unrounded.  ``--device cpu`` runs the ranks on the CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from .. import parallel
from ..distributions import TwoMoons
from .real_nvp_twomoons import build_model

POINTS = 2**16


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--global-batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = parallel.initialize_distributed(device=args.device)  # torchrun's, if any
    mesh = parallel.make_mesh(devices=args.device)
    try:
        return train(args, device, mesh)
    finally:
        dist.destroy_process_group()  # main ends the world it ran in


def train(args, device, mesh):
    """Train as the module docstring says on the ranks of ``mesh``; returns the
    model and the JSON record."""
    rank, world = dist.get_rank(), dist.get_world_size()
    parallel.process_local_batch(args.global_batch)  # a batch the ranks do not split raises
    if rank == 0:
        print(f"ranks: {world}  mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")

    model = build_model(args.k, device, torch.Generator().manual_seed(args.seed))
    state, step = parallel.make_data_parallel_step(
        model, torch.optim.Adam(model.parameters(), lr=5e-4),
        lambda m, x, generator: m.forward_kld(x), mesh)
    x_all = TwoMoons(device=device).sample(
        POINTS, generator=torch.Generator(device).manual_seed(args.seed + 1))

    losses = []
    t0 = time.perf_counter()
    for i in range(args.iters):
        s = (i * args.global_batch) % (POINTS - args.global_batch)
        state, metrics = step(state, parallel.shard_batch(x_all[s:s + args.global_batch], mesh))
        losses.append(float(metrics["loss"]))
        if rank == 0 and (i % 200 == 0 or i == args.iters - 1):
            print(f"iter {i:5d}  loss {losses[-1]:.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    rate = args.iters * args.global_batch / seconds
    record = {"ranks": world, "iters": args.iters, "k": args.k,
              "global_batch": args.global_batch, "seconds": seconds, "samples_per_s": rate,
              "first_loss": losses[0], "final_loss": losses[-1],
              "non_finite_steps": sum(1 for v in losses if v != v or abs(v) == float("inf")),
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if rank == 0:
        print(f"throughput: {rate:.0f} samples/s across {world} rank(s)")
        print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
