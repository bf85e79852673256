"""A residual flow on two moons: the port of ``examples/residual_twomoons.py``.

    python -m normflows_tpu_torch.examples.residual_twomoons [--iters 20000] [--k 16]
        [--batch 512] [--lr 3e-4] [--chunk 100] [--seed 0] [--device cuda]

``--k`` blocks of (``Residual`` of a ``LipschitzMLP([2, 128, 128, 2],
lipschitz_const=0.9, init_zeros=True)`` with ``reduce_memory=True``, then
``ActNorm``) on a ``DiagGaussian(2)`` base, ActNorm set from the first
batch (``init_actnorm``), trained by forward KL on 2^14 points of
``make_moons`` placed on the device once, ``--batch`` a step in the JAX
script's sequential windows, with ``torch.optim.AdamW(lr, weight_decay=1e-5)``
(``capturable`` on the card) and 50 power-iteration steps on every
induced-norm layer after each update (``update_lipschitz_iters=50``),
through ``training.make_chunked_train_step``: ``--chunk`` steps a call, one
step captured in a CUDA graph and replayed on a card.  Under capture each
block's Neumann series runs ``n_power_series_max`` terms (``flows.residual``);
eagerly, on the CPU, to the sampled horizon.

Every input is drawn on the host from ``--seed`` (:func:`inputs`): the
weights, the data and 2,048 held-out points, so that a run replays on the
CPU and through the JAX package (``replay`` in
``tests/test_torch_residual.py``).  The estimator's draws come from a
generator on the device seeded from ``--seed``.

It prints the forward KL every 500 iterations and the training wall time,
then, in eval mode (the brute-force 2-D log-det), the mean log q on the
first 2,048 training points (the JAX script's number) and on the held-out
points, and 2,048 draws' fixed-point steps.  The last line is one JSON
record of these numbers, unrounded.  ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import NormalizingFlow, distributions, flows, training
from ..nets import LipschitzMLP

DATA, HELD_OUT = 2**14, 2048
LIPSCHITZ_ITERS = 50


def make_moons(rng, n, noise=0.1):
    """``sklearn.datasets.make_moons``'s two half circles, ``noise`` Gaussian
    jitter, rows in a random order; float32, from the numpy generator."""
    n_out = n // 2
    n_in = n - n_out
    t_out, t_in = np.linspace(0, np.pi, n_out), np.linspace(0, np.pi, n_in)
    outer = np.stack([np.cos(t_out), np.sin(t_out)], axis=1)
    inner = np.stack([1 - np.cos(t_in), 1 - np.sin(t_in) - 0.5], axis=1)
    x = np.concatenate([outer, inner])
    x = x + noise * rng.normal(size=x.shape)
    return x[rng.permutation(n)].astype(np.float32)


def build_model(K, device, generator=None, hidden=128):
    """K blocks of (Residual(LipschitzMLP([2, hidden, hidden, 2], 0.9,
    init_zeros=True), reduce_memory=True), ActNorm((2,)))."""
    layers = []
    for _ in range(K):
        net = LipschitzMLP([2, hidden, hidden, 2], lipschitz_const=0.9, init_zeros=True,
                           generator=generator, device=device)
        layers.append(flows.Residual(net, reduce_memory=True))
        layers.append(flows.ActNorm((2,), device=device))
    return NormalizingFlow.create(distributions.DiagGaussian.create(2, device=device), layers,
                                  p=distributions.TwoMoons(device=device), device=device)


def inputs(K, seed, device="cpu", hidden=128):
    """The run's inputs from ``seed``: the model (its weights drawn on the
    CPU, placed on ``device``), 2^14 training points and 2,048 held-out ones
    (CPU tensors).  Returns ``(model, x_all, x_held_out)``; ActNorm is not
    set yet."""
    model = build_model(K, device, torch.Generator().manual_seed(seed), hidden)
    x_all = torch.from_numpy(make_moons(np.random.default_rng(seed + 1), DATA))
    x_held_out = torch.from_numpy(make_moons(np.random.default_rng(seed + 2), HELD_OUT))
    return model, x_all, x_held_out


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch, generator=generator)


def set_train(model, train: bool):
    """Every ``Residual`` layer in training (True) or eval mode."""
    for flow in model.flows:
        if isinstance(flow, flows.Residual):
            flow.set_train(train)
    return model


def main(argv=None):
    """Train and evaluate as the module docstring says, printing its lines;
    returns the trained model and the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    model, x_all, x_held_out = inputs(args.k, args.seed, device, args.hidden)
    model.init_actnorm(x_all[:args.batch].to(device))
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-5,
                            capturable=device.type == "cuda")
    state, chunk = training.make_chunked_train_step(
        model, opt, forward_kld_loss, x_all, args.batch, args.chunk, shuffle=False,
        update_lipschitz_iters=LIPSCHITZ_ITERS)
    gen = torch.Generator(device).manual_seed(args.seed + 3)
    losses = []
    t0 = time.time()
    first_call = None
    for c in range(args.iters // args.chunk):
        state, metrics = chunk(state, gen)
        losses.append(metrics["loss"])
        for j in range(args.chunk):
            i = c * args.chunk + j
            if i % 500 == 0 or i == args.iters - 1:
                print(f"iter {i:5d}  forward KLD {float(losses[-1][j]):.4f}")
        if first_call is None:
            first_call = time.time() - t0
    losses = torch.cat(losses).cpu()
    seconds = time.time() - t0
    print(f"training wall time: {seconds:.1f}s "
          f"({args.iters * args.batch / seconds:.0f} samples/s)")

    set_train(model, False)
    with torch.no_grad():
        train_log_q = float(torch.mean(model.log_prob(x_all[:HELD_OUT].to(device))))
        log_q = float(torch.mean(model.log_prob(x_held_out.to(device))))
        z, _ = model.sample(HELD_OUT, generator=torch.Generator(device).manual_seed(
            args.seed + 4))
    steps = [int(f.iresblock.last_inverse["steps"]) for f in model.flows
             if isinstance(f, flows.Residual)]
    print("eval mean log-likelihood on training points:", train_log_q)
    print("eval mean log-likelihood on held-out points:", log_q)
    steady = (seconds - first_call) / (args.iters - args.chunk) * 1e3 \
        if args.iters > args.chunk else None
    record = {"final_kld": float(losses[-1]), "train_log_q": train_log_q,
              "held_out_log_q": log_q,
              "loss_mean_first_100": float(losses[:100].mean()),
              "loss_mean_last_100": float(losses[-100:].mean()),
              "losses_every_100": losses[::100].tolist(),
              "non_finite_steps": int((~torch.isfinite(losses)).sum()),
              "samples_finite": bool(torch.isfinite(z).all()),
              "sample_radius": float(torch.mean(torch.linalg.vector_norm(z, dim=1))),
              "fixed_point_steps": steps,
              "seconds": seconds, "first_chunk_seconds": first_call,
              "steady_step_ms": steady,
              "samples_per_s": args.iters * args.batch / seconds,
              "seed": args.seed, "iters": args.iters, "k": args.k, "batch": args.batch,
              "chunk": args.chunk, "hidden": args.hidden,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"}
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
