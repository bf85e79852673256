"""Circular neural spline flow on the cylinder (Gaussian-von Mises) target,
trained by reverse KL: the port of ``examples/nsf_cylinder.py``.

    python -m normflows_tpu_torch.examples.nsf_cylinder [--iters 10000] [--chunk 100] [--bf16]

12 circular autoregressive RQ-spline layers (MADE hidden 512, 10 bins,
tail bound [5, pi]) on a UniformGaussian base, Adam(5e-4) with cosine decay
over ``--iters``, 2^14 samples a step.  ``--chunk N`` (N > 1) runs N steps a
call as one step captured in a CUDA graph and replayed N times
(``training.make_step_chunk``), the counterpart of the JAX script's
``lax.scan``; ``--chunk 1`` runs one eager step a call.  It prints the loss
every 500 iterations, the wall time and samples/s of training, and KL(q||p)
on 2^16 fresh samples: the JAX script's lines; then one JSON line with
the same numbers unrounded, the last training loss and the seconds of the
first call (with ``--chunk``, the capture included).  ``--device cpu`` runs
it on the CPU, for a check of the wiring at a small ``--num-samples``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .. import NormalizingFlow, distributions, flows, training
from ..utils import set_compute_dtype

HELD_OUT = 2**16


def build_model(device, K=12, hidden=512, num_bins=10):
    base = distributions.UniformGaussian.create(2, [1], [1.0, 2 * math.pi], device=device)
    layers = [flows.CircularAutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(i), 2, 1, hidden, ind_circ=[1], num_bins=num_bins,
        tail_bound=np.asarray([5.0, math.pi], np.float32), permute_mask=True, rng_seed=i,
        device=device) for i in range(K)]
    return NormalizingFlow.create(base, layers,
                                  p=distributions.GaussianVonMises(device=device),
                                  device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--num-samples", type=int, default=2**14)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--bf16", action="store_true",
                    help="run the MADE matmuls in bfloat16")
    ap.add_argument("--chunk", type=int, default=1,
                    help=">1: run this many steps a call, one step captured in a "
                         "CUDA graph and replayed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.chunk > 1 and args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    model = build_model(device)
    if args.bf16:
        set_compute_dtype(model, "bfloat16")
    schedule = training.cosine_decay_schedule(args.lr, args.iters)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr,
                           capturable=device.type == "cuda")
    gen = torch.Generator(device=device).manual_seed(0)

    def loss_fn(model, batch, generator):
        return model.reverse_kld(args.num_samples, generator=generator)

    t0 = time.time()
    first = None
    if args.chunk > 1:
        state, chunk = training.make_step_chunk(model, opt, loss_fn, args.chunk,
                                                schedule=schedule)
        for c in range(args.iters // args.chunk):
            state, metrics = chunk(state, gen)
            loss = metrics["loss"][-1]
            i = (c + 1) * args.chunk - 1
            if (i + 1) % 500 < args.chunk or i == args.iters - 1:
                print(f"iter {i:5d}  reverse KLD {float(loss):.5f}")
            first = first or time.time() - t0
    else:
        state, step = training.make_train_step(model, opt, loss_fn)
        for i in range(args.iters):
            for group in opt.param_groups:
                group["lr"] = float(schedule(torch.tensor(i)))
            state, metrics = step(state, None, gen)
            loss = metrics["loss"]
            if i % 500 == 0 or i == args.iters - 1:
                print(f"iter {i:5d}  reverse KLD {float(loss):.5f}")
            first = first or time.time() - t0
    loss = float(loss)
    seconds = time.time() - t0
    print(f"training wall time: {seconds:.1f}s "
          f"({args.iters * args.num_samples / seconds:.0f} samples/s)")

    with torch.no_grad():
        z, log_q = model.sample(HELD_OUT, generator=torch.Generator(device=device).manual_seed(1))
        kl = float(torch.mean(log_q - model.p.log_prob(z)))
    print(f"final KL(q||p) estimate: {kl:.5f}")
    print(json.dumps({"kl": kl, "final_loss": loss, "seconds": seconds,
                      "samples_per_s": args.iters * args.num_samples / seconds,
                      "first_call_seconds": first, "iters": args.iters, "chunk": args.chunk,
                      "bf16": args.bf16, "num_samples": args.num_samples,
                      "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu"}))
    return kl


if __name__ == "__main__":
    main()
