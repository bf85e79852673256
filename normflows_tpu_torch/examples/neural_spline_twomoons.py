"""Autoregressive neural spline flow on TwoMoons: the port of
``examples/neural_spline_twomoons.py`` (the reference's
``neural_spline_flow.ipynb``).

    python -m normflows_tpu_torch.examples.neural_spline_twomoons [--iters 3000]
        [--k 16] [--hidden 128] [--batch 512] [--lr 1e-3] [--chunk 100] [--seed 0]
        [--host-inputs] [--device cuda]

``--k`` x (``AutoregressiveRationalQuadraticSpline(2, 2, hidden)``, 8 bins,
linear tails at 3, the MADE's last layer at zero + ``LULinearPermute(2)``,
its permutation drawn from the layer's generator) on a fixed
``DiagGaussian(2)`` learn ``TwoMoons`` by forward KL on a pool of 2^13
target points drawn on the host from ``--seed`` and placed on the device
once, ``--batch`` points a step at random indices drawn on the device
(``training.make_chunked_train_step(..., shuffle=True)``: ``--chunk`` steps
a call, one step captured in a CUDA graph and replayed on a card), with
``torch.optim.Adam(lr, weight_decay=1e-5)``, the coupled L2 of the JAX
script's ``optax.chain(add_decayed_weights(1e-5), adam(lr))``.
``--host-inputs`` draws every step's indices on the host from numpy at
``--seed`` instead (:func:`host_inputs`), so that a run can be replayed
through the JAX package (``replay`` in
``tests/test_torch_reference_examples.py``).  A step whose loss is not
finite keeps the parameters and Adam's state (the JAX script zeroes the
gradients and still takes Adam's step); the record counts such steps.

Then it prints the JAX script's numbers, the held-out NLL on 4,096 target
points and the mean radius of 4,096 model draws (the moons' ring is at 2),
both drawn on the host from ``--seed`` (:func:`held_out`), and a last JSON
line with them unrounded.  ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import NormalizingFlow, distributions, flows, training
from ._common import host_normal, run_chunks, step_inputs, training_record

POOL, HELD_OUT = 2**13, 4096


def build_model(device, K=16, hidden=128, seed=0):
    """The JAX script's model; layer pair i's weights and permutation are
    drawn from a CPU generator seeded ``seed * 1000 + i``."""
    layers = []
    for i in range(K):
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        layers.append(flows.AutoregressiveRationalQuadraticSpline.create(
            gen, 2, 2, hidden, device=device))
        layers.append(flows.LULinearPermute.create(2, generator=gen, device=device))
    q0 = distributions.DiagGaussian.create(2, trainable=False, device=device)
    return NormalizingFlow.create(q0, layers, p=distributions.TwoMoons(device=device),
                                  device=device)


def pool(seed):
    """The 2^13 training points, drawn on the CPU from ``seed``."""
    return distributions.TwoMoons(device="cpu").sample(
        POOL, generator=torch.Generator().manual_seed(seed + 1))


def host_inputs(iters, batch, seed):
    """Every step's pool indices, drawn on the host from numpy at ``seed``:
    an int64 tensor (iters, batch)."""
    return torch.from_numpy(np.random.default_rng(seed + 7).integers(0, POOL, (iters, batch)))


def held_out(seed):
    """``(x, eps)`` on the CPU: 4,096 target points and the base's unit
    draws of 4,096 model samples."""
    x = distributions.TwoMoons(device="cpu").sample(
        HELD_OUT, generator=torch.Generator().manual_seed(seed + 2))
    return x, host_normal(seed + 3, HELD_OUT, 2)


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch)


def make_chunk(model, lr, batch, chunk, data, indices=None):
    """``(state, chunk_fn)``: forward KL on ``batch`` points of ``data`` a
    step, at indices drawn on the device with the chunk's generator, or
    taken from ``indices`` (:func:`host_inputs`) at the step's index."""
    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=1e-5,
                           capturable=device.type == "cuda")
    if indices is None:
        return training.make_chunked_train_step(model, opt, forward_kld_loss, data, batch,
                                                chunk, shuffle=True)
    data = data.to(device)
    pick = step_inputs((indices,), device)
    return training.make_step_chunk(model, opt, forward_kld_loss, chunk,
                                    lambda step, gen: data.index_select(0, pick(step, gen)))


def evaluate(model, seed):
    """The held-out NLL and the draws' mean radius (:func:`held_out`)."""
    device = next(model.parameters()).device
    x, eps = (t.to(device) for t in held_out(seed))
    with torch.no_grad():
        nll = float(-torch.mean(model.log_prob(x)))
        z, _ = model.from_noise(eps)
    return {"held_out_nll": nll,
            "mean_radius": float(torch.linalg.vector_norm(z, dim=1).mean()),
            "draws_finite": bool(torch.isfinite(z).all())}


def main(argv=None):
    """Train and evaluate as the module docstring says, printing its lines;
    returns the trained model and the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw every step's indices on the host from the seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    model = build_model(device, args.k, args.hidden, args.seed)
    indices = host_inputs(args.iters, args.batch, args.seed) if args.host_inputs else None
    state, chunk = make_chunk(model, args.lr, args.batch, args.chunk, pool(args.seed), indices)
    gen = torch.Generator(device).manual_seed(args.seed + 4)
    losses, timing = run_chunks(state, chunk, args.iters, args.chunk, gen, "forward KLD")
    record = training_record(losses, timing, args.batch, args.chunk, args.seed,
                             args.host_inputs, device)
    record.update(evaluate(model, args.seed), k=args.k, hidden=args.hidden)
    print("held-out NLL:", record["held_out_nll"])
    print("sample mean radius:", record["mean_radius"], "(two-moons ~2.0)")
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
