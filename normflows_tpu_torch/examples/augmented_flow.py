"""Augmented normalizing flow on TwoMoons x N(0, I): the port of
``examples/augmented_flow.py`` (the reference's ``augmented_flow.ipynb``).

    python -m normflows_tpu_torch.examples.augmented_flow [--iters 2000] [--k 32]
        [--num-samples 1024] [--anneal-iters 1000] [--lr 1e-4] [--chunk 100]
        [--seed 0] [--host-inputs] [--device cuda]

The 2-D ``TwoMoons`` target is augmented with 2 independent Gaussian dims
(``TwoIndependent(TwoMoons, DiagGaussian(2, fixed))``).  A 4-D flow of
``--k`` x (``MaskedAffineFlow`` with s and t nets ``MLP([4, 16, 4],
init_zeros=True)``, masks [1, 1, 0, 0] and [0, 0, 1, 1] in turn, +
``ActNorm(4)``) on a trainable ``DiagGaussian(4)`` learns it by annealed
reverse KL on ``--num-samples`` base draws a step: the loss is E_q[log q] -
beta E_q[log p] with beta = min(1, 0.01 + step / anneal_iters).  The
ActNorm layers are initialised from 128 base draws of a sampling pass
(``init_actnorm_sampling``), made on the host from ``--seed`` before the
first step.  Training runs through ``training.make_step_chunk`` with
``torch.optim.Adam(lr, weight_decay=1e-6)``, the coupled L2 of the JAX
script's ``optax.chain(add_decayed_weights(1e-6), adam(lr))``: ``--chunk``
steps a call, one step captured in a CUDA graph and replayed on a card.
Beta is computed on the device from the chunk's step count inside each
step (:func:`beta_of`), so that each replay of the graph takes its own; the
base draws come from the chunk's generator on the device.
``--host-inputs`` draws every step's base noise on the host from numpy at
``--seed`` instead (:func:`host_inputs`), so that a run can be replayed
through the JAX package (``replay`` in
``tests/test_torch_reference_examples.py``).  A step whose loss is not
finite keeps the parameters and Adam's state (the JAX script zeroes the
gradients and still takes Adam's step); the record counts such steps.

Then it prints the JAX script's numbers for 2^14 model draws (base noise
drawn on the host from ``--seed``): the standard coordinates' mean radius
(the moons' ring is at 2) and the augmented coordinates' std (1 for N(0,
I)), and a last JSON line with them unrounded.  ``--device cpu`` runs it
on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import NormalizingFlow, distributions, flows, training
from ..nets import MLP
from ._common import host_normal, run_chunks, step_inputs, training_record

LATENT, INIT_SAMPLES, DRAWS = 4, 128, 2**14


def build_model(device, K=32, seed=0):
    """The JAX script's model, its ActNorm layers not yet initialised; layer
    pair i's nets are drawn from a CPU generator seeded ``seed * 1000 +
    i``."""
    b = torch.tensor([1.0] * (LATENT // 2) + [0.0] * (LATENT // 2))
    layers = []
    for i in range(K):
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        s = MLP.create(gen, [LATENT, 4 * LATENT, LATENT], init_zeros=True, device=device)
        t = MLP.create(gen, [LATENT, 4 * LATENT, LATENT], init_zeros=True, device=device)
        layers.append(flows.MaskedAffineFlow.create(b if i % 2 == 0 else 1 - b, t=t, s=s,
                                                    device=device))
        layers.append(flows.ActNorm.create(LATENT, device=device))
    target = distributions.TwoIndependent(
        distributions.TwoMoons(device=device),
        distributions.DiagGaussian.create(2, trainable=False, device=device), device=device)
    q0 = distributions.DiagGaussian.create(LATENT, device=device)
    return NormalizingFlow.create(q0, layers, p=target, device=device)


def initialised_model(device, K=32, seed=0):
    """:func:`build_model` with its ActNorm layers initialised from
    ``INIT_SAMPLES`` base draws of a sampling pass, made on the CPU from a
    generator seeded ``seed + 8`` (so that every device starts alike)."""
    host = build_model("cpu", K, seed).init_actnorm_sampling(
        INIT_SAMPLES, generator=torch.Generator().manual_seed(seed + 8))
    if torch.device(device).type == "cpu":
        return host
    model = build_model(device, K, seed)
    model.load_state_dict(host.state_dict())
    return model


def beta_of(step, anneal_iters):
    """min(1, 0.01 + step / anneal_iters) for the device step count
    ``step``, in float64 as the JAX script computes it on the host, then
    float32."""
    return torch.clamp(0.01 + step.to(torch.float64) / anneal_iters, max=1.0).float()


def host_inputs(iters, num_samples, seed):
    """Every step's base noise, drawn on the host from numpy at ``seed``:
    a tensor (iters, num_samples, 4)."""
    return host_normal(seed + 7, iters, num_samples, LATENT)


def annealed_reverse_kld(model, eps, beta):
    """The reverse KL of ``model.reverse_kld(beta=beta)`` on the base's unit
    draws ``eps``."""
    z, log_q = model.from_noise(eps)
    return torch.mean(log_q) - beta * torch.mean(model.p.log_prob(z))


def make_chunk(model, lr, num_samples, anneal_iters, chunk, inputs=None):
    """``(state, chunk_fn)`` of :func:`training.make_step_chunk`: the
    annealed reverse KL on ``num_samples`` base draws a step, made on the
    model's device with the chunk's generator, or taken from ``inputs``
    (:func:`host_inputs`) at the step's index; beta from the step count
    (:func:`beta_of`)."""
    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=1e-6,
                           capturable=device.type == "cuda")
    if inputs is None:
        def batch_fn(step, generator):
            return beta_of(step, anneal_iters)

        def loss_fn(m, beta, generator):
            return m.reverse_kld(num_samples, beta=beta, generator=generator)
    else:
        pick = step_inputs((inputs,), device)

        def batch_fn(step, generator):
            return beta_of(step, anneal_iters), pick(step, generator)

        def loss_fn(m, batch, generator):
            return annealed_reverse_kld(m, batch[1], batch[0])
    return training.make_step_chunk(model, opt, loss_fn, chunk, batch_fn)


def evaluate(model, seed):
    """The mean radius of the standard coordinates and the std of the
    augmented ones, of 2^14 draws from base noise drawn on the host."""
    device = next(model.parameters()).device
    with torch.no_grad():
        z, _ = model.from_noise(host_normal(seed + 1, DRAWS, LATENT).to(device))
    return {"standard_mean_radius": float(torch.linalg.vector_norm(z[:, :2], dim=1).mean()),
            "augmented_std": float(z[:, 2:].std(correction=0)),
            "draws_finite": bool(torch.isfinite(z).all())}


def main(argv=None):
    """Train and evaluate as the module docstring says, printing its lines;
    returns the trained model and the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--num-samples", type=int, default=1024)
    ap.add_argument("--anneal-iters", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw every step's base noise on the host from the seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    model = initialised_model(device, args.k, args.seed)
    inputs = host_inputs(args.iters, args.num_samples, args.seed) if args.host_inputs else None
    state, chunk = make_chunk(model, args.lr, args.num_samples, args.anneal_iters,
                              args.chunk, inputs)
    gen = torch.Generator(device).manual_seed(args.seed + 3)
    losses, timing = run_chunks(state, chunk, args.iters, args.chunk, gen, "loss", 200)
    record = training_record(losses, timing, args.num_samples, args.chunk, args.seed,
                             args.host_inputs, device)
    record.update(evaluate(model, args.seed), k=args.k, anneal_iters=args.anneal_iters)
    print("standard-coord mean radius:", record["standard_mean_radius"])
    print("augmented-coord std:", record["augmented_std"])
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
