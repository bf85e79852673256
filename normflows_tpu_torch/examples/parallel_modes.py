"""Every parallel mode on one model, side by side: the port of
``examples/parallel_modes.py``.

    python -m normflows_tpu_torch.examples.parallel_modes [--device cuda]
    torchrun --nproc_per_node=N -m normflows_tpu_torch.examples.parallel_modes

The flagship's architecture cut to 4 circular AR RQ-spline layers of hidden
width 64 (8 bins) on the cylinder, one forward-KL step with Adam(1e-3) on a
batch of 64 target samples, through the data-parallel step (``{"data":
N}``), the tensor-parallel step (``{"data": N / t, "model": t}``, t = 2
where N is even, else 1), FSDP over the same model axis (the leaves of at
least 64 x 64 elements), the pipelined flows (``{"stage": s}``, s = N where
it divides the 4 layers, else 1; 8 microbatches) and the pipelined training
step; each mode's loss is printed beside the single-process loss.  Under
torchrun each process takes one card; as one process every mesh is one
rank.  Rank 0 prints one line a mode and a last JSON line with the losses
unrounded.  ``--device cpu`` runs the ranks on the CPU (gloo), which checks
the wiring here.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.distributed as dist

from .. import NormalizingFlow, distributions, flows, parallel
from ..training import make_train_step

K, HIDDEN, BATCH, MICRO, LR = 4, 64, 64, 8, 1e-3


def build_model(device, k=K, hidden=HIDDEN):
    base = distributions.UniformGaussian.create(2, [1], [1.0, 2 * math.pi], device=device)
    layers = [flows.CircularAutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(i), 2, 1, hidden, ind_circ=[1], num_bins=8,
        tail_bound=np.asarray([5.0, math.pi], np.float32), permute_mask=True, rng_seed=i,
        device=device) for i in range(k)]
    return NormalizingFlow.create(base, layers, p=distributions.GaussianVonMises(device=device),
                                  device=device)


def adam(params):
    return torch.optim.Adam(params, lr=LR)


def forward_kld(model, batch, generator):
    return model.forward_kld(batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = parallel.initialize_distributed(device=args.device)  # torchrun's, if any
    parallel.make_mesh(devices=args.device)  # a world of one without torchrun
    try:
        return run(args, device)
    finally:
        dist.destroy_process_group()  # main ends the world it ran in


def run(args, device):
    """The modes as the module docstring says; returns the JSON record."""
    n, rank = dist.get_world_size(), dist.get_rank()
    model = build_model(device)
    batch = model.p.sample(BATCH, generator=torch.Generator(device).manual_seed(args.seed))
    single = build_model(device)
    state, step = make_train_step(single, adam(single.parameters()), forward_kld)
    losses = {"single_process": float(step(state, batch)[1]["loss"])}

    mesh = parallel.make_mesh({"data": n}, devices=args.device)
    replica = build_model(device)
    state, step = parallel.make_data_parallel_step(replica, adam(replica.parameters()),
                                                   forward_kld, mesh)
    losses["data_parallel"] = float(step(state, parallel.shard_batch(batch, mesh))[1]["loss"])

    t = 2 if n % 2 == 0 else 1
    mesh = parallel.make_mesh({"data": n // t, "model": t}, devices=args.device)
    state, step = parallel.make_tensor_parallel_step(model, adam, forward_kld, mesh)
    state, metrics = step(state, parallel.shard_batch(batch, mesh))
    losses["tensor_parallel"] = float(metrics["loss"])
    sharded = sum(1 for p in state.model.parameters() if hasattr(p, "placements"))
    state, step = parallel.make_fsdp_step(model, adam, forward_kld, mesh, axis="model",
                                          min_size=HIDDEN * HIDDEN)
    losses["fsdp"] = float(step(state, parallel.shard_batch(batch, mesh))[1]["loss"])

    s = n if K % n == 0 else 1
    mesh = parallel.make_mesh({"stage": s, "data": n // s}, devices=args.device)
    pipe = parallel.make_pipeline_apply(model.flows, mesh, num_microbatches=MICRO,
                                        reverse=True)
    with torch.no_grad():
        z, log_det = pipe(batch)
        losses["pipeline"] = float(-torch.mean(model.q0.log_prob(z) + log_det))
    state, step = parallel.make_pipeline_train_step(model, adam, mesh,
                                                    num_microbatches=MICRO)
    losses["pipeline_train"] = float(step(state, batch)[1]["loss"])

    record = {"ranks": n, "model_axis": t, "stages": s, "tensor_parallel_sharded_leaves": sharded,
              "losses": losses,
              "largest_gap": max(abs(v - losses["single_process"]) for v in losses.values()),
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if rank == 0:
        for mode, loss in losses.items():
            print(f"{mode:17s} forward_kld {loss:.6f}")
        print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
