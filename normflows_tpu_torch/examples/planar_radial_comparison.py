"""Planar, radial and affine-coupling flows on the Rezende & Mohamed 2-D
energies: the port of ``examples/planar_radial_comparison.py``.

    python -m normflows_tpu_torch.examples.planar_radial_comparison [--iters 2000]
        [--k 16] [--prior NAME ...] [--kind planar radial affine] [--chunk 100]
        [--seed 0] [--device cuda] [--host-noise]

Each flow family (``--k`` ``Planar`` layers, ``Radial`` layers, or masked
affine couplings on ``MLP([2, 32, 2], init_zeros=True)`` nets) on a
``DiagGaussian(2)`` base trains against each prior of
``distributions.prior`` (wrapped as a target by :class:`PriorTarget`) by
reverse KL on 512 draws a step with ``Adam(1e-3)``, through
``training.make_step_chunk``: ``--chunk`` steps a call, one step captured in
a CUDA graph and replayed on a card.  The initial weights come from a
generator seeded from ``--seed`` (the JAX script's ``jax.random.fold_in``
keys), the draws from a generator on the device.  ``--host-noise`` draws
every step's base noise on the host from ``--seed`` instead (placed on the
device once; the same draws on any device), so that a run replays on the
CPU.

It prints, for each prior and family, the first and last loss and the
reverse KL estimate on 4,096 fresh draws; the last line is one JSON record
of them, unrounded.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch import nn

from .. import NormalizingFlow, distributions, flows, training
from ..nets import MLP

BATCH, EVAL_DRAWS, LR = 512, 4096, 1e-3
PRIORS = {
    "TwoModes": lambda: distributions.TwoModes(loc=2.0, scale=0.2),
    "Sinusoidal": lambda: distributions.Sinusoidal(scale=0.2, period=4.0),
    "Sinusoidal_gap": lambda: distributions.Sinusoidal_gap(scale=0.35, period=4.0),
    "Sinusoidal_split": lambda: distributions.Sinusoidal_split(scale=0.4, period=4.0),
    "Smiley": lambda: distributions.Smiley(scale=0.2),
}
KINDS = ("planar", "radial", "affine")


class PriorTarget(nn.Module):
    """A ``PriorDistribution`` as a target: ``log_prob(z, context=None)``."""

    def __init__(self, prior: nn.Module):
        super().__init__()
        self.prior = prior

    def log_prob(self, z, context=None):
        return self.prior.log_prob(z)


def build(kind, K, generator, device):
    """K layers of the family ``kind``, their weights from ``generator``."""
    if kind == "planar":
        return [flows.Planar((2,), generator=generator, device=device) for _ in range(K)]
    if kind == "radial":
        return [flows.Radial((2,), generator=generator, device=device) for _ in range(K)]
    if kind == "affine":
        b = torch.tensor([1.0, 0.0])
        layers = []
        for i in range(K):
            s = MLP.create(generator, [2, 32, 2], init_zeros=True, device=device)
            t = MLP.create(generator, [2, 32, 2], init_zeros=True, device=device)
            layers.append(flows.MaskedAffineFlow.create(b if i % 2 == 0 else 1 - b, t=t, s=s,
                                                        device=device))
        return layers
    raise ValueError(f"kind is one of {KINDS}, not {kind!r}")


def build_model(kind, prior, K, seed, device):
    """The model of ``kind`` on ``prior`` (a name of :data:`PRIORS`), its
    weights drawn on the CPU from ``seed``."""
    return NormalizingFlow.create(
        distributions.DiagGaussian.create(2, device=device),
        build(kind, K, torch.Generator().manual_seed(seed), device),
        p=PriorTarget(PRIORS[prior]()), device=device)


def reverse_kld_loss(model, batch, generator):
    return model.reverse_kld(BATCH, generator=generator)


def noise_kld_loss(model, eps, generator):
    """``reverse_kld`` on given base noise ``eps``: E_q[log q] - E_q[log p]
    at ``from_noise(eps)``."""
    z, log_q = model.from_noise(eps)
    return torch.mean(log_q) - torch.mean(model.p.log_prob(z))


def host_noise(iters, seed):
    """Every step's base noise, (iters * BATCH, 2), from numpy."""
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(iters * BATCH, 2)).astype(np.float32))


def make_trainer(model, chunk, noise=None):
    """``(state, chunk_fn)``: Adam(1e-3) reverse-KL steps, ``chunk`` a call;
    with ``noise`` (host draws), each step's window of it."""
    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=LR, capturable=device.type == "cuda")
    if noise is None:
        return training.make_step_chunk(model, opt, reverse_kld_loss, chunk)
    return training.make_chunked_train_step(model, opt, noise_kld_loss, noise, BATCH, chunk,
                                            shuffle=False)


@torch.no_grad()
def evaluate(model, seed, device):
    """The reverse KL estimate on EVAL_DRAWS fresh draws."""
    gen = torch.Generator(device).manual_seed(seed)
    return float(model.reverse_kld(EVAL_DRAWS, generator=gen))


def run(kind, prior, args, device):
    """Train one model as the module docstring says; returns its record."""
    model = build_model(kind, prior, args.k, args.seed, device)
    noise = host_noise(args.iters, args.seed + 1) if args.host_noise else None
    state, chunk = make_trainer(model, args.chunk, noise)
    gen = torch.Generator(device).manual_seed(args.seed + 2)
    losses = []
    t0 = time.time()
    for _ in range(args.iters // args.chunk):
        losses.append(chunk(state, gen)[1]["loss"])
    losses = torch.cat(losses).cpu()
    seconds = time.time() - t0
    kld = evaluate(model, args.seed + 3, device)
    print(f"{prior:18s} {kind:7s}  reverse KLD {float(losses[0]):8.3f} -> "
          f"{float(losses[-1]):8.3f}  (fresh draws {kld:8.4f})")
    return {"prior": prior, "kind": kind, "first": float(losses[0]),
            "last": float(losses[-1]), "eval_reverse_kld": kld,
            "non_finite_steps": int((~torch.isfinite(losses)).sum()),
            "seconds": seconds, "steps": args.iters}, model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--prior", nargs="+", default=list(PRIORS), choices=list(PRIORS))
    ap.add_argument("--kind", nargs="+", default=list(KINDS), choices=KINDS)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host-noise", action="store_true",
                    help="draw every step's base noise on the host from --seed")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")
    device = torch.device(args.device)
    runs = [run(kind, prior, args, device)[0] for prior in args.prior for kind in args.kind]
    record = {"runs": runs, "seed": args.seed, "k": args.k, "iters": args.iters,
              "chunk": args.chunk, "host_noise": args.host_noise,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
