"""Conditional neural spline flow on a context-dependent Gaussian target: the
port of ``examples/conditional_flow.py``, trained and then sampled.

    python -m normflows_tpu_torch.examples.conditional_flow [--iters 5000]
        [--batch 128] [--lr 3e-4] [--chunk 100] [--seed 0] [--host-inputs]
        [--device cuda]

A ``ConditionalNormalizingFlow`` of 4 x (``AutoregressiveRationalQuadraticSpline``
on 2 features, 2 residual blocks of hidden 128, a context of 4 features, 8
bins, linear tails at 3 + ``LULinearPermute``) on a fixed ``DiagGaussian(2)``
learns p(x | context), where context = concat(mean ~ N(0, I), std ~ U(0.5,
1)) and x | context ~ N(mean, diag(std^2)) (``ConditionalDiagGaussianTarget``).
It trains by forward KL on batches of ``--batch`` with
``torch.optim.Adam(lr, weight_decay=1e-5)``, the coupled L2 of the JAX
script's ``optax.chain(add_decayed_weights(1e-5), adam(lr))``, through
``training.make_step_chunk``: ``--chunk`` steps a call, one step captured in
a CUDA graph and replayed on a card, each step drawing its contexts and
its x on the device inside the graph.  ``--host-inputs`` draws every step's
context and x on the host from ``--seed`` before training instead
(:func:`host_inputs`), so that a run can be replayed on another device and
through the JAX package (``replay`` in ``tests/test_torch_conditional.py``).
A step whose loss is not finite keeps the parameters and Adam's state (the
JAX script zeroes the gradients and still takes Adam's step); the record
counts such steps.

Then it reports the held-out KL(p||q) on 2^16 fresh (context, x) pairs
drawn on the host from ``--seed`` (the mean of log p(x|c) - log q(x|c)),
and the mean and std of 4,096 draws at the JAX script's context [0.3, 0.9,
0.6, 0.6] (targets [0.3, 0.9] and [0.6, 0.6]).  The last line is one JSON
record of these numbers, unrounded.  ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import ConditionalNormalizingFlow, distributions, flows, training

CONTEXT = 4
HELD_OUT, DRAWS = 2**16, 4096
SAMPLE_CONTEXT = (0.3, 0.9, 0.6, 0.6)


def build_model(device, K=4, hidden=128, seed=0):
    """The JAX script's model; layer i's weights and permutation are drawn
    from a CPU generator seeded ``seed * 1000 + i``."""
    layers = []
    for i in range(K):
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        layers.append(flows.AutoregressiveRationalQuadraticSpline.create(
            gen, 2, 2, hidden, num_context_channels=CONTEXT, device=device))
        layers.append(flows.LULinearPermute.create(2, generator=gen, device=device))
    q0 = distributions.DiagGaussian.create(2, trainable=False, device=device)
    target = distributions.ConditionalDiagGaussianTarget(device=device)
    return ConditionalNormalizingFlow.create(q0, layers, p=target, device=device)


def sample_context(batch, generator=None, device="cpu"):
    """context = concat(mean ~ N(0, I), std ~ U(0.5, 1)), (batch, 4)."""
    mean = torch.randn(batch, 2, generator=generator, device=device)
    std = 0.5 + 0.5 * torch.rand(batch, 2, generator=generator, device=device)
    return torch.cat([mean, std], dim=-1)


def draw_pairs(target, batch, generator=None, device="cpu"):
    """``(context, x)``: ``batch`` contexts and one draw of ``target`` for
    each."""
    context = sample_context(batch, generator, device)
    return context, target.sample(batch, context, generator=generator)


def host_inputs(iters, batch, seed):
    """Every step's ``(context, x)``, drawn on the CPU from ``seed``:
    tensors (iters, batch, 4) and (iters, batch, 2)."""
    context, x = draw_pairs(distributions.ConditionalDiagGaussianTarget(device="cpu"),
                            iters * batch, torch.Generator().manual_seed(seed + 7))
    return context.view(iters, batch, CONTEXT), x.view(iters, batch, 2)


def held_out_pairs(seed):
    """2^16 (context, x) pairs drawn on the CPU from ``seed``."""
    return draw_pairs(distributions.ConditionalDiagGaussianTarget(device="cpu"), HELD_OUT,
                      torch.Generator().manual_seed(seed + 1))


def make_chunk(model, lr, batch, chunk, inputs=None):
    """``(state, chunk_fn)`` of :func:`training.make_step_chunk`: forward
    KL on ``batch`` pairs a step, drawn on the model's device with the
    chunk's generator, or taken from ``inputs`` (:func:`host_inputs`, placed
    on the device) at the step's index."""
    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=1e-5,
                           capturable=device.type == "cuda")
    if inputs is None:
        def loss_fn(m, _, generator):
            context, x = draw_pairs(m.p, batch, generator, device)
            return m.forward_kld(x, context)

        return training.make_step_chunk(model, opt, loss_fn, chunk)
    context_all, x_all = (t.to(device) for t in inputs)

    def batch_fn(step, generator):
        i = step.reshape(1)
        return context_all.index_select(0, i)[0], x_all.index_select(0, i)[0]

    def loss_fn(m, pair, generator):
        return m.forward_kld(pair[1], pair[0])

    return training.make_step_chunk(model, opt, loss_fn, chunk, batch_fn)


def evaluate(model, seed):
    """Held-out KL(p||q) and the draws' moments at :data:`SAMPLE_CONTEXT`."""
    device = next(model.parameters()).device
    context, x = (t.to(device) for t in held_out_pairs(seed))
    with torch.no_grad():
        kl = float(torch.mean(model.p.log_prob(x, context) - model.log_prob(x, context)))
        ctx = torch.tensor([SAMPLE_CONTEXT], device=device).expand(DRAWS, CONTEXT)
        z, _ = model.sample(DRAWS, context=ctx,
                            generator=torch.Generator(device).manual_seed(seed + 2))
    return {"held_out_kl": kl, "sample_mean": z.mean(0).tolist(),
            "sample_std": z.std(0, correction=0).tolist(),
            "draws_finite": bool(torch.isfinite(z).all())}


def main(argv=None):
    """Train and evaluate as the module docstring says, printing its lines;
    returns the trained model and the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw every step's context and x on the host from the seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    model = build_model(device, seed=args.seed)
    inputs = host_inputs(args.iters, args.batch, args.seed) if args.host_inputs else None
    state, chunk = make_chunk(model, args.lr, args.batch, args.chunk, inputs)
    gen = torch.Generator(device).manual_seed(args.seed + 3)
    losses = []
    t0 = time.time()
    for c in range(args.iters // args.chunk):
        state, metrics = chunk(state, gen)
        losses.append(metrics["loss"])
        for j in range(args.chunk):
            i = c * args.chunk + j
            if i % 500 == 0 or i == args.iters - 1:
                print(f"iter {i:5d}  forward KLD {float(losses[-1][j]):.4f}")
    losses = torch.cat(losses).cpu()
    seconds = time.time() - t0
    print(f"training wall time: {seconds:.1f}s "
          f"({args.iters * args.batch / seconds:.0f} samples/s)")
    record = evaluate(model, args.seed)
    print(f"held-out KL(p||q): {record['held_out_kl']:.5f}")
    print("sample mean:", [round(v, 3) for v in record["sample_mean"]], "(target [0.3, 0.9])")
    print("sample std: ", [round(v, 3) for v in record["sample_std"]], "(target [0.6, 0.6])")
    record.update({
        "final_kld": float(losses[-1]), "losses_every_100": losses[::100].tolist(),
        "non_finite_steps": int((~torch.isfinite(losses)).sum()), "seconds": seconds,
        "step_ms": 1e3 * seconds / args.iters, "seed": args.seed, "iters": args.iters,
        "batch": args.batch, "chunk": args.chunk,
        "host_inputs": args.host_inputs,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"})
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
