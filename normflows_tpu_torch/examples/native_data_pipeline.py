"""Feeding image training from the native C++ data pipeline: the port of
``examples/native_data_pipeline.py``.

    python -m normflows_tpu_torch.examples.native_data_pipeline [--iters 200]
        [--batch 256] [--workers 4] [--device cuda]
    torchrun --nproc_per_node=N -m normflows_tpu_torch.examples.native_data_pipeline ...

``data.NativeImageLoader``'s C++ threads do the dataloader's transform stack
(per-epoch shuffle, 255/256 scaling, uniform dequantisation jitter, logit)
off the Python thread, and ``data.prefetch_to_device`` copies each batch to
the card from pinned memory on a copy stream, two batches ahead of the step.
The model is the JAX script's small 2-level Glow (K = 4 blocks a level of
hidden 64, class-conditional bases) over logit-space synthetic uint8 images
(4,096 of 3 x 8 x 8, drawn with numpy), ActNorm initialised on the first
batch, trained by forward KL with Adamax(1e-3).  Under torchrun each rank
takes its rows of every global batch (``prefetch_to_device(...,
mesh=mesh)``) and ``parallel.make_data_parallel_step`` averages the
gradient.  Rank 0 prints the loss every 50 iterations, images/s end to end,
and a last JSON line with the numbers unrounded.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from ..data import NativeImageLoader, prefetch_to_device
from .glow_image import build_glow

SHAPE, CLASSES, IMAGES = (3, 8, 8), 10, 4096


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256, help="the global batch")
    ap.add_argument("--workers", type=int, default=4, help="the loader's C++ threads")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = parallel.initialize_distributed(device=args.device)
    mesh = parallel.make_mesh(devices=args.device)
    try:
        return train(args, device, mesh)
    finally:
        dist.destroy_process_group()  # main ends the world it ran in


def train(args, device, mesh):
    """Train from the loader as the module docstring says on the ranks of
    ``mesh``; returns the model and the JSON record."""
    rank = dist.get_rank()
    parallel.process_local_batch(args.batch)

    rng = np.random.default_rng(0)  # synthetic uint8 images
    images = rng.integers(0, 256, size=(IMAGES, *SHAPE), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, size=(IMAGES,), dtype=np.int64)
    loader = NativeImageLoader(images, labels, batch_size=args.batch, shuffle=True, seed=1,
                               num_workers=args.workers, jitter=True, logit=True, alpha=0.05)
    if rank == 0:
        print(f"native pipeline: {loader.is_native}, {loader.batches_per_epoch} batches/epoch")
    stream = prefetch_to_device(loader, size=2, device=device, mesh=mesh)

    model = build_glow(2, 4, 64, SHAPE, CLASSES, device=device)
    x0, y0, _ = next(stream)
    # ActNorm from this rank's rows of the first batch (all of it as one
    # process); the step then gives every rank rank 0's weights
    model.init_actnorm(x0, y0)
    state, step = parallel.make_data_parallel_step(
        model, torch.optim.Adamax(model.parameters(), lr=1e-3),
        lambda m, b, generator: m.forward_kld(b[0], b[1]), mesh)
    x, y, _ = next(stream)
    step(state, (x, y))  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.iters):
        x, y, epoch = next(stream)
        state, metrics = step(state, (x, y))
        losses.append(float(metrics["loss"]))
        if rank == 0 and i % 50 == 0:
            print(f"iter {i:4d} epoch {epoch} loss {losses[-1]:10.1f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    native = loader.is_native
    loader.close()
    rate = args.iters * args.batch / seconds
    record = {"iters": args.iters, "batch": args.batch, "ranks": dist.get_world_size(),
              "seconds": seconds, "images_per_s": rate, "first_loss": losses[0],
              "final_loss": losses[-1], "native": native,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if rank == 0:
        print(f"{args.iters} iters in {seconds:.2f}s - {rate:,.0f} images/s end-to-end")
        print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
