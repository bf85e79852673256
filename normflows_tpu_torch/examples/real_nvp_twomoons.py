"""Real NVP on the TwoMoons target, the README's first model: the port of
``examples/real_nvp_twomoons.py``, trained and then served.

    python -m normflows_tpu_torch.examples.real_nvp_twomoons [--iters 4000] [--k 32]
        [--batch 512] [--lr 5e-4] [--chunk 100] [--seed 0] [--bundle DIR] [--no-serve]

``--k`` masked affine coupling layers (``MaskedAffineFlow``, s and t nets
``MLP([2, 64, 64, 2], init_zeros=True)``, alternating masks) on a
``DiagGaussian(2)`` base, trained by forward KL on 2^16 ``TwoMoons`` samples
placed on the device once, ``--batch`` a step in the JAX script's order
(sequential windows, ``shuffle=False``), with
``torch.optim.AdamW(lr, weight_decay=1e-5)`` (decoupled, as
``optax.adamw``) through ``training.make_chunked_train_step``: ``--chunk``
steps a call, one step captured in a CUDA graph and replayed on a card.
Every input is drawn on the host from ``--seed`` (:func:`inputs`): the
weights, the data and the held-out points are the same on any device, so
a run on the card can be replayed on the CPU, and through the JAX package
(``replay`` in ``tests/test_torch_realnvp.py``).

It prints the forward KLD every 500 iterations and the training wall time,
then the mean log q on the first 4096 training points (the JAX script's
number) and on 4096 held-out TwoMoons samples, writes a serving bundle
(``serving.save_bundle``, into ``--bundle`` or a temporary directory),
loads it and serves 4096 draws, whose mean radius it prints (the target's
ring is at 2; with ``--no-serve``, 4096 draws of the live model).  The last
line is one JSON record of these numbers, unrounded.  ``--device cpu``
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from .. import NormalizingFlow, distributions, flows, serving, training
from ..nets import MLP

DATA, HELD_OUT = 2**16, 4096


def build_model(K, device, generator=None):
    """The README's Real NVP: K masked affine layers, masks [1, 0] and
    [0, 1] in turn, each with s and t nets [2, 64, 64, 2] whose last layer
    starts at zero (the identity flow)."""
    b = torch.tensor([1.0, 0.0])
    layers = []
    for i in range(K):
        s = MLP.create(generator, [2, 64, 64, 2], init_zeros=True, device=device)
        t = MLP.create(generator, [2, 64, 64, 2], init_zeros=True, device=device)
        layers.append(flows.MaskedAffineFlow.create(b if i % 2 == 0 else 1 - b, t=t, s=s,
                                                    device=device))
    return NormalizingFlow.create(distributions.DiagGaussian.create(2, device=device),
                                  layers, p=distributions.TwoMoons(device=device),
                                  device=device)


def inputs(K, seed, device="cpu"):
    """The run's inputs, drawn on the CPU from ``seed``: the model's
    weights (:func:`build_model`, placed on ``device``), 2^16 TwoMoons
    training points and 4096 held-out ones (on the CPU).  Returns
    ``(model, x_all, x_held_out)``."""
    model = build_model(K, device, torch.Generator().manual_seed(seed))
    moons = distributions.TwoMoons(device="cpu")
    x_all = moons.sample(DATA, generator=torch.Generator().manual_seed(seed + 1))
    x_held_out = moons.sample(HELD_OUT, generator=torch.Generator().manual_seed(seed + 2))
    return model, x_all, x_held_out


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch)


def main(argv=None):
    """Train, evaluate and serve as the module docstring says, printing its
    lines; returns the trained model and the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--bundle", default=None, help="directory of the serving bundle")
    ap.add_argument("--no-serve", action="store_true",
                    help="write no bundle; the radius is the live model's")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    model, x_all, x_held_out = inputs(args.k, args.seed, device)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-5,
                            capturable=device.type == "cuda")
    state, chunk = training.make_chunked_train_step(model, opt, forward_kld_loss, x_all,
                                                    args.batch, args.chunk, shuffle=False)
    losses = []
    t0 = time.time()
    for c in range(args.iters // args.chunk):
        state, metrics = chunk(state)
        losses.append(metrics["loss"])
        for j in range(args.chunk):
            i = c * args.chunk + j
            if i % 500 == 0 or i == args.iters - 1:
                print(f"iter {i:5d}  forward KLD {float(losses[-1][j]):.4f}")
    losses = torch.cat(losses).cpu()
    seconds = time.time() - t0
    print(f"training wall time: {seconds:.1f}s "
          f"({args.iters * args.batch / seconds:.0f} samples/s)")

    with torch.no_grad():
        train_log_q = float(torch.mean(model.log_prob(x_all[:HELD_OUT].to(device))))
        log_q = float(torch.mean(model.log_prob(x_held_out.to(device))))
        if args.no_serve:
            z, _ = model.sample(HELD_OUT,
                                generator=torch.Generator(device).manual_seed(args.seed + 3))
    print("mean log q(x) on target samples:", train_log_q)
    print("mean log q(x) on held-out target samples:", log_q)
    export_seconds = None
    if not args.no_serve:
        path = args.bundle or tempfile.mkdtemp(prefix="real_nvp_bundle_")
        t1 = time.time()
        serving.save_bundle(model, path, HELD_OUT, (2,))
        export_seconds = time.time() - t1
        z, _ = serving.load_bundle(path).sample(args.seed + 3)
    radius = float(torch.mean(torch.linalg.vector_norm(z, dim=1)))
    print("sample ring radius (target = 2):", radius)
    record = {"final_kld": float(losses[-1]), "train_log_q": train_log_q,
              "held_out_log_q": log_q, "ring_radius": radius,
              "losses_every_100": losses[::100].tolist(),
              "non_finite_steps": int((~torch.isfinite(losses)).sum()),
              "seconds": seconds, "samples_per_s": args.iters * args.batch / seconds,
              "export_seconds": export_seconds, "bundle": None if args.no_serve else path,
              "seed": args.seed, "iters": args.iters, "k": args.k, "batch": args.batch,
              "chunk": args.chunk,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"}
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
