"""The flow-VAE on binarized digits: the port of ``examples/vae_flow.py``
(the reference's examples/vae.py: Planar K = 10, latent 40, MNIST geometry).

    python -m normflows_tpu_torch.examples.vae_flow [--epochs 15] [--k 10]
        [--latent 40] [--batch 256] [--lr 1e-3] [--seed 0] [--device cuda]
        [--data-npz FILE] [--host-inputs]

The encoder is ``NNDiagGaussian`` on ``MLP([784, 512, 256, 2 * latent])``,
the decoder ``NNBernoulliDecoder`` on ``MLP([latent, 256, 512, 784])``, the
prior a trainable ``DiagGaussian(latent)``, and ``--k`` ``Planar`` layers
transform the encoder's samples (``--k 0`` is the plain VAE,
``examples.plain_vae``).  The weights are drawn on the CPU from ``--seed``.

The data are 2^14 synthetic binarized digits (:func:`synthetic_digits`,
numpy from ``--seed``), or the array ``x`` (N, 784) of a local
``--data-npz`` file.  The last HELD_OUT rows are held out.  Training
minimises -ELBO = -mean(log p - log q) with Adam(``--lr``) on batches of
``--batch`` rows drawn i.i.d. from the other rows, through
``training.make_chunked_train_step``: one epoch (N // batch steps) a call,
one step captured in a CUDA graph on a card, the batch indices and the
encoder's noise drawn inside it.  ``--host-inputs`` draws every step's rows
and encoder noise on the host from ``--seed`` instead, so that a run
replays on the CPU and through the JAX package.

It reports each epoch's mean -ELBO and, at the end, the held-out -ELBO on
one fixed draw of the encoder's noise (numpy from ``--seed``); the last line
is one JSON record, unrounded.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import NormalizingFlowVAE, distributions, flows, training
from ..nets import MLP

N_DIGITS, HELD_OUT, NUM_SAMPLES = 2**14, 1024, 1


def synthetic_digits(n, seed, d=784):
    """Random low-rank Bernoulli patterns (the JAX script's): 16 prototypes
    sigmoid(3 N(0, 1)) of width ``d``, a prototype drawn for each row, then
    Bernoulli pixels; float32 (n, d)."""
    rng = np.random.default_rng(seed)
    protos = 1.0 / (1.0 + np.exp(-3.0 * rng.normal(size=(16, d))))
    idx = rng.integers(0, 16, n)
    return (rng.uniform(size=(n, d)) < protos[idx]).astype(np.float32)


def build_vae(d, latent, k, seed, device):
    """The flow-VAE with its weights drawn on the CPU from ``seed``: the
    encoder's net, then the decoder's, then the planar flows'."""
    gen = torch.Generator().manual_seed(seed)
    encoder = MLP.create(gen, [d, 512, 256, 2 * latent], device=device)
    decoder = MLP.create(gen, [latent, 256, 512, d], device=device)
    layers = [flows.Planar((latent,), generator=gen, device=device) for _ in range(k)]
    return NormalizingFlowVAE.create(distributions.DiagGaussian(latent, device=device),
                                     distributions.NNDiagGaussian(encoder), layers,
                                     distributions.NNBernoulliDecoder(decoder))


def neg_elbo(model, x, generator=None, noise=None):
    _, log_q, log_p = model(x, NUM_SAMPLES, generator=generator, noise=noise)
    return -torch.mean(log_p - log_q)


def loss_fn(model, batch, generator):
    return neg_elbo(model, batch, generator)


def host_loss_fn(model, batch, generator):
    x, eps = batch
    return neg_elbo(model, x, noise=eps)


def host_inputs(x_train, steps, batch, latent, seed):
    """``steps`` steps' rows (i.i.d. indices) and encoder noise, drawn with
    numpy from ``seed``, stacked: (steps * batch, d) and (steps * batch,
    NUM_SAMPLES, latent)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, x_train.shape[0], (steps, batch)).reshape(-1)
    eps = rng.normal(size=(steps * batch, NUM_SAMPLES, latent)).astype(np.float32)
    return x_train[idx], torch.from_numpy(eps)


def eval_noise(latent, seed):
    """The held-out evaluation's encoder noise (HELD_OUT, NUM_SAMPLES, latent)."""
    rng = np.random.default_rng(seed + 1000)
    return torch.from_numpy(rng.normal(size=(HELD_OUT, NUM_SAMPLES, latent)).astype(np.float32))


def make_trainer(model, x_train, batch, lr, chunk, inputs=None):
    """``(state, chunk_fn)``: Adam(``lr``) -ELBO steps, ``chunk`` a call, on
    i.i.d. batches of ``x_train`` (or, with ``inputs`` from
    :func:`host_inputs`, on their windows in order)."""
    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=device.type == "cuda")
    if inputs is None:
        return training.make_chunked_train_step(model, opt, loss_fn, x_train, batch, chunk,
                                                shuffle=True)
    return training.make_chunked_train_step(model, opt, host_loss_fn, inputs, batch, chunk,
                                            shuffle=False)


def load_data(args):
    if args.data_npz:
        return torch.from_numpy(np.asarray(np.load(args.data_npz)["x"], np.float32))
    print("no --data-npz given; using synthetic binarized digits")
    return torch.from_numpy(synthetic_digits(N_DIGITS, args.seed))


@torch.no_grad()
def held_out_neg_elbo(model, x_held, latent, seed):
    device = next(model.parameters()).device
    return float(neg_elbo(model, x_held.to(device), noise=eval_noise(latent, seed).to(device)))


def parse(argv=None, k=10):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--latent", type=int, default=40)
    ap.add_argument("--k", type=int, default=k, help="planar layers (0: the plain VAE)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data-npz", type=str, default=None,
                    help="a local .npz file holding x (N, 784)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw every step's rows and encoder noise on the host from --seed")
    return ap.parse_args(argv)


def main(argv=None, k=10):
    args = parse(argv, k)
    device = torch.device(args.device)
    x_all = load_data(args)
    x_train, x_held = x_all[:-HELD_OUT], x_all[-HELD_OUT:]
    steps_per_epoch = x_all.shape[0] // args.batch
    model = build_vae(x_all.shape[1], args.latent, args.k, args.seed, device)
    inputs = None
    if args.host_inputs:
        inputs = host_inputs(x_train, args.epochs * steps_per_epoch, args.batch, args.latent,
                             args.seed + 1)
    state, chunk = make_trainer(model, x_train, args.batch, args.lr, steps_per_epoch, inputs)
    gen = torch.Generator(device).manual_seed(args.seed + 2)
    losses, starts = [], []
    for epoch in range(args.epochs):
        starts.append(time.perf_counter())
        losses.append(chunk(state, gen)[1]["loss"])
        print(f"epoch {epoch:3d}  -ELBO {float(losses[-1].mean()):.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    end = time.perf_counter()
    losses = torch.cat(losses).cpu()
    # the first call warms up and captures: the steady step leaves it out
    steady_ms = ((end - starts[1]) * 1e3 / ((args.epochs - 1) * steps_per_epoch)
                 if args.epochs > 1 else None)
    held = held_out_neg_elbo(model, x_held, args.latent, args.seed)
    print(f"held-out -ELBO {held:.4f}; training wall time {end - starts[0]:.1f}s")
    record = {"k": args.k, "latent": args.latent, "epochs": args.epochs,
              "steps": args.epochs * steps_per_epoch, "batch": args.batch,
              "first_loss": float(losses[0]),
              "last_epoch_loss": float(losses[-steps_per_epoch:].mean()),
              "held_out_neg_elbo": held,
              "non_finite_steps": int((~torch.isfinite(losses)).sum()),
              "seconds": end - starts[0], "steady_step_ms": steady_ms,
              "samples_per_s": args.batch / (steady_ms / 1e3) if steady_ms else None,
              "host_inputs": args.host_inputs, "seed": args.seed,
              "data": args.data_npz or "synthetic_digits",
              "device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"}
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
