"""Circular neural spline flow on a 2-D target with one circular coordinate:
the port of ``examples/circular_nsf.py`` (the reference's
``circular_nsf.ipynb``).

    python -m normflows_tpu_torch.examples.circular_nsf [--iters 20000] [--k 20]
        [--hidden 128] [--batch 1024] [--lr 1e-4] [--chunk 100] [--seed 0]
        [--host-inputs] [--device cuda]

A ``UniformGaussian(2, [1], scale=[1, 2 pi])`` base and ``--k``
``CircularAutoregressiveRationalQuadraticSpline(2, 1, hidden, [1],
tail_bound=[5, pi], permute_mask=True)`` layers (8 bins; the MADE's last
layer starts at zero) learn the notebook's bimodal R x S^1 target
(:func:`sample_target`) by forward KL on ``--batch`` draws a step, with
``torch.optim.AdamW(lr, weight_decay=1e-4)`` (decoupled, as
``optax.adamw``), through ``training.make_step_chunk``: ``--chunk`` steps a
call, one step captured in a CUDA graph and replayed on a card.  Each step
draws its batch from the target on the device inside the step (the chunk's
``batch_fn`` with its generator), so no step copies anything from the host.
``--host-inputs`` draws every step's batch on the host from numpy at
``--seed`` before training instead (:func:`host_inputs`), so that a run can
be replayed on another device and through the JAX package (``replay`` in
``tests/test_torch_reference_examples.py``).  A step whose loss is not
finite keeps the parameters and AdamW's state (the JAX script zeroes the
gradients and still takes the optimizer's step); the record counts such
steps.

Then it prints the JAX script's numbers: the held-out forward KL on 2^13
target points and the share of 50,000 model draws whose circular
coordinate lies in [-pi, pi], both drawn on the host from ``--seed``
(:func:`held_out`), and a last JSON line with them unrounded.
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from .. import NormalizingFlow, distributions, flows, training
from ._common import run_chunks, step_inputs, training_record

HELD_OUT, DRAWS = 2**13, 50_000
SCALE = (1.0, 2 * math.pi)
TAIL_BOUND = (5.0, math.pi)


def build_model(device, K=20, hidden=128, seed=0):
    """The JAX script's model; layer i's weights are drawn from a CPU
    generator seeded ``seed * 1000 + i``."""
    base = distributions.UniformGaussian.create(2, [1], SCALE, device=device)
    layers = [flows.CircularAutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(seed * 1000 + i), 2, 1, hidden, [1],
        tail_bound=np.asarray(TAIL_BOUND, np.float32), permute_mask=True, device=device)
        for i in range(K)]
    return NormalizingFlow.create(base, layers, device=device)


def target_noise(n, generator=None, device="cpu"):
    """The draws :func:`sample_target` transforms: ``s`` (n, 2) normal,
    ``c`` (n, 2), ``u`` (n, 1) and ``flip`` (n, 1) uniform on [0, 1)."""
    return (torch.randn(n, 2, generator=generator, device=device),
            torch.rand(n, 2, generator=generator, device=device),
            torch.rand(n, 1, generator=generator, device=device),
            torch.rand(n, 1, generator=generator, device=device))


def host_target_noise(n, rng):
    """:func:`target_noise` from a numpy generator, on the CPU."""
    return tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((n, 2), dtype=np.float32), rng.random((n, 2), dtype=np.float32),
        rng.random((n, 1), dtype=np.float32), rng.random((n, 1), dtype=np.float32)))


def sample_target(n, generator=None, device="cpu", noise=None):
    """The notebook's ``Target.sample``, the JAX script's ``sample_target``:
    dim 0 a two-component Gaussian mixture on R, dim 1 an arccos-shaped
    bimodal density wrapped onto [-pi, pi).  ``noise`` (:func:`target_noise`)
    gives the draws; without it they come from ``generator``."""
    s, c, u, flip = target_noise(n, generator, device) if noise is None else noise
    s = torch.where(c > 0.6, 0.3 * s - 0.5, s + 1.3)
    s_ = torch.arccos(2 * u - 1)
    s_ = torch.where(flip > 0.3, -s_, s_)
    circ = torch.remainder(s_ + 1, 2 * math.pi) - math.pi
    return torch.cat([s[:, :1], circ], dim=1)


def host_inputs(iters, batch, seed):
    """Every step's batch, drawn on the host from numpy at ``seed``: a
    tensor (iters, batch, 2)."""
    n = iters * batch
    x = sample_target(n, noise=host_target_noise(n, np.random.default_rng(seed + 7)))
    return x.view(iters, batch, 2)


def held_out(seed):
    """``(x, eps)`` on the CPU from numpy at ``seed``: 2^13 target points
    and the base's unit draws of 50,000 model samples (dim 0 normal, dim 1
    uniform on [0, 1), the base's ``noise_spec``)."""
    x = sample_target(HELD_OUT,
                      noise=host_target_noise(HELD_OUT, np.random.default_rng(seed + 1)))
    rng = np.random.default_rng(seed + 2)
    eps = np.stack([rng.standard_normal(DRAWS, dtype=np.float32),
                    rng.random(DRAWS, dtype=np.float32)], axis=1)
    return x, torch.from_numpy(eps)


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch)


def make_chunk(model, lr, batch, chunk, inputs=None):
    """``(state, chunk_fn)`` of :func:`training.make_step_chunk`: forward KL
    on ``batch`` target draws a step, made on the model's device with the
    chunk's generator, or taken from ``inputs`` (:func:`host_inputs`) at the
    step's index."""
    device = next(model.parameters()).device
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4,
                            capturable=device.type == "cuda")
    if inputs is None:
        def batch_fn(step, generator):
            return sample_target(batch, generator, device)
    else:
        batch_fn = step_inputs((inputs,), device)
    return training.make_step_chunk(model, opt, forward_kld_loss, chunk, batch_fn)


def evaluate(model, seed):
    """The held-out forward KL and the in-range share of the draws
    (:func:`held_out`)."""
    device = next(model.parameters()).device
    x, eps = (t.to(device) for t in held_out(seed))
    with torch.no_grad():
        nll = float(model.forward_kld(x))
        z, _ = model.from_noise(eps)
    return {"held_out_forward_kld": nll,
            "in_range": float(torch.mean((z[:, 1].abs() <= math.pi + 1e-4).float())),
            "draws_finite": bool(torch.isfinite(z).all())}


def main(argv=None):
    """Train and evaluate as the module docstring says, printing its lines;
    returns the trained model and the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2**10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw every step's batch on the host from the seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    model = build_model(device, args.k, args.hidden, args.seed)
    inputs = host_inputs(args.iters, args.batch, args.seed) if args.host_inputs else None
    state, chunk = make_chunk(model, args.lr, args.batch, args.chunk, inputs)
    gen = torch.Generator(device).manual_seed(args.seed + 3)
    losses, timing = run_chunks(state, chunk, args.iters, args.chunk, gen, "forward_kld",
                                 max(1, args.iters // 10))
    record = training_record(losses, timing, args.batch, args.chunk, args.seed,
                             args.host_inputs, device)
    record.update(evaluate(model, args.seed), k=args.k, hidden=args.hidden)
    print(f"held-out forward_kld {record['held_out_forward_kld']:.4f}")
    print(f"circular-coord samples within [-pi, pi]: {100 * record['in_range']:.2f}%")
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
