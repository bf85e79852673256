"""Changing the base distribution: a Gaussian against a Gaussian-mixture base
for the same Real NVP on TwoMoons; the port of ``examples/change_base.py``
(the reference's examples/change_base_distribution.ipynb).

    python -m normflows_tpu_torch.examples.change_base [--iters 2000]
        [--chunk 100] [--layers 32] [--seed 0] [--device cuda] [--host-inputs]

The flows are ``--layers`` x (``AffineCouplingBlock`` on ``MLP([1, 64, 64,
2], init_zeros=True)``, then ``Permute(2, "swap")``), trained by forward KL
with Adam(5e-4) on batches of 512 drawn i.i.d. from 2^13 ``TwoMoons``
draws, twice: from ``DiagGaussian(2)``, and from a two-mode
``GaussianMixture`` with modes at (+-2, 0) and scale 0.3, which removes the
topological mismatch.  Training runs through
``training.make_chunked_train_step``, ``--chunk`` steps a call (one step
captured in a CUDA graph and replayed on a card), on data placed on the
device once.  ``--host-inputs`` draws the data on the CPU and every step's
batch indices with numpy from ``--seed``, so that a run replays on the CPU
and through the JAX package.

It reports each base's held-out NLL on 4,096 fresh TwoMoons draws; the last
line is one JSON record, unrounded.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import NormalizingFlow, distributions, flows, training
from ..nets import MLP

BATCH, LR, N_TRAIN, N_TEST = 512, 5e-4, 2**13, 4096
BASES = ("gaussian", "mixture")


def build_flows(num_layers, generator, device):
    layers = []
    for _ in range(num_layers):
        param_map = MLP.create(generator, [1, 64, 64, 2], init_zeros=True, device=device)
        layers.append(flows.AffineCouplingBlock.create(param_map))
        layers.append(flows.Permute.create(2, mode="swap", device=device))
    return layers


def build_base(base, device):
    if base == "gaussian":
        return distributions.DiagGaussian(2, device=device)
    if base == "mixture":
        return distributions.GaussianMixture(2, 2, loc=[[-2.0, 0.0], [2.0, 0.0]],
                                             scale=np.full((2, 2), 0.3), device=device)
    raise ValueError(f"base is one of {BASES}, not {base!r}")


def build_model(base, seed, device, num_layers=32):
    """The model on ``base``, its nets' weights drawn on the CPU from ``seed``."""
    layers = build_flows(num_layers, torch.Generator().manual_seed(seed), device)
    return NormalizingFlow.create(build_base(base, device), layers,
                                  p=distributions.TwoMoons(device=device), device=device)


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch)


def draws(n, seed, device):
    """``n`` TwoMoons draws from a generator seeded with ``seed`` on ``device``."""
    return distributions.TwoMoons(device=device).sample(
        n, generator=torch.Generator(device).manual_seed(seed))


def host_batches(x_train, iters, seed):
    """Every step's batch, (iters * BATCH, 2): i.i.d. rows of ``x_train``
    drawn with numpy from ``seed``."""
    idx = np.random.default_rng(seed).integers(0, x_train.shape[0], iters * BATCH)
    return x_train[torch.from_numpy(idx)]


def make_trainer(model, x_train, chunk, batches=None):
    """``(state, chunk_fn)``: Adam(5e-4) forward-KL steps, ``chunk`` a call,
    on i.i.d. batches of ``x_train`` or on ``batches``' windows in order."""
    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=LR, capturable=device.type == "cuda")
    if batches is None:
        return training.make_chunked_train_step(model, opt, forward_kld_loss, x_train, BATCH,
                                                chunk, shuffle=True)
    return training.make_chunked_train_step(model, opt, forward_kld_loss, batches, BATCH,
                                            chunk, shuffle=False)


def run(base, index, args, device):
    """Train the model on ``base`` (the ``index``-th, seeds offset by it);
    returns its record and the model."""
    seed = args.seed + index
    model = build_model(base, seed, device, args.layers)
    where = "cpu" if args.host_inputs else device
    x_train = draws(N_TRAIN, 100 + seed, where)
    x_test = draws(N_TEST, 999 + seed, where)
    batches = host_batches(x_train, args.iters, seed) if args.host_inputs else None
    state, chunk = make_trainer(model, x_train, args.chunk, batches)
    gen = torch.Generator(device).manual_seed(seed)
    losses, starts = [], []
    for _ in range(args.iters // args.chunk):
        starts.append(time.perf_counter())
        losses.append(chunk(state, gen)[1]["loss"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    end = time.perf_counter()
    losses = torch.cat(losses).cpu()
    calls = len(starts)
    steady_ms = (end - starts[1]) * 1e3 / ((calls - 1) * args.chunk) if calls > 1 else None
    with torch.no_grad():
        nll = float(-torch.mean(model.log_prob(x_test.to(device))))
    print(f"{base:9s} base: held-out NLL {nll:.4f}")
    return {"base": base, "held_out_nll": nll, "first": float(losses[0]),
            "last": float(losses[-1]), "non_finite_steps": int((~torch.isfinite(losses)).sum()),
            "seconds": end - starts[0], "steady_step_ms": steady_ms}, model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--base", nargs="+", default=list(BASES), choices=BASES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw the data on the CPU and the batches with numpy from --seed")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")
    device = torch.device(args.device)
    runs = [run(base, BASES.index(base), args, device)[0] for base in args.base]
    record = {"runs": runs, "iters": args.iters, "chunk": args.chunk, "layers": args.layers,
              "seed": args.seed, "host_inputs": args.host_inputs,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
