"""Learn a 2-D density given by image intensities: the port of
``examples/image_density.py`` (the reference's ``image.ipynb``).

    python -m normflows_tpu_torch.examples.image_density [--iters 4000] [--k 32]
        [--batch 512] [--lr 1e-4] [--chunk 100] [--seed 0] [--image-npy FILE]
        [--host-inputs] [--device cuda]

An image's intensities make an unnormalised density on [-3, 3]^2
(``ImagePrior``): by default a procedural grayscale smiley
(:func:`smiley_image`, the JAX script's), or any (H, W) array saved with
numpy (``--image-npy``).  A pool of 2^16 points is drawn from it by
rejection on the device (on the host from numpy's seed with
``--host-inputs``), and ``--k`` ``MaskedAffineFlow`` layers with s and t
nets ``MLP([2, 64, 64, 2], init_zeros=True)`` (masks [0, 1] and [1, 0] in
turn) on a trainable ``DiagGaussian(2)`` learn it by forward KL on
``--batch`` points a step, taken from the pool in the JAX script's
sequential windows (``training.make_chunked_train_step(...,
shuffle=False)``: ``--chunk`` steps a call, one step captured in a CUDA
graph and replayed on a card), with ``torch.optim.AdamW(lr,
weight_decay=1e-4)`` (decoupled, as ``optax.adamw``).  A step whose loss
is not finite keeps the parameters and AdamW's state (the JAX script has no
guard); the record counts such steps.  ``--host-inputs`` makes the run
replayable through the JAX package (``replay`` in
``tests/test_torch_reference_examples.py``).

Then it prints the JAX script's numbers, the held-out mean log q on 8,192
target points and the share of 8,192 model draws that land on bright
pixels (above 0.1 of the brightest), both drawn on the host from
``--seed`` (:func:`held_out`), and a last JSON line with them unrounded.
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import NormalizingFlow, distributions, flows, training
from ..nets import MLP
from ._common import host_normal, run_chunks, training_record

POOL, HELD_OUT = 2**16, 8192


def smiley_image(n=200):
    """Procedural grayscale smiley on an (n, n) grid over [-3, 3]^2."""
    xs = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(xs, xs)  # row = y (imshow convention), col = x
    yy = -yy
    r = np.sqrt(xx**2 + yy**2)
    face = np.exp(-0.5 * ((r - 2.4) / 0.18) ** 2)
    eyes = np.exp(-0.5 * (((xx - 0.9) ** 2 + (yy - 0.9) ** 2)) / 0.06) + np.exp(
        -0.5 * (((xx + 0.9) ** 2 + (yy - 0.9) ** 2)) / 0.06)
    mouth_r = np.sqrt(xx**2 + (yy + 0.2) ** 2)
    mouth = np.exp(-0.5 * ((mouth_r - 1.3) / 0.15) ** 2) * (yy < -0.7)
    return np.clip(face + eyes + mouth, 0.0, 1.0)


def build_model(device, K=32, seed=0):
    """The JAX script's model; layer i's nets are drawn from a CPU generator
    seeded ``seed * 1000 + i``."""
    b = torch.tensor([0.0, 1.0])
    layers = []
    for i in range(K):
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        s = MLP.create(gen, [2, 64, 64, 2], init_zeros=True, device=device)
        t = MLP.create(gen, [2, 64, 64, 2], init_zeros=True, device=device)
        layers.append(flows.MaskedAffineFlow.create(b if i % 2 == 0 else 1 - b, t=t, s=s,
                                                    device=device))
    return NormalizingFlow.create(distributions.DiagGaussian.create(2, device=device), layers,
                                  device=device)


def host_sample(target, n, rng):
    """``n`` draws of ``target`` (an ``ImagePrior`` on the CPU) by its
    rejection rounds, each round's uniforms from the numpy generator
    ``rng``."""
    buf = torch.zeros(n, 2)
    count = torch.zeros((), dtype=torch.int64)
    while int(count) < n:
        z_ = torch.from_numpy(rng.random((n, 2), dtype=np.float32))
        prob = torch.from_numpy(rng.random(n, dtype=np.float32))
        buf, count = target.accept_round(buf, count, z_, prob)
    return buf


def training_pool(image, seed, device, host_inputs):
    """The 2^16 training points: drawn by rejection on ``device`` with a
    generator seeded ``seed + 1``, or on the host from numpy at ``seed``."""
    if host_inputs:
        return host_sample(distributions.ImagePrior.create(image, device="cpu"), POOL,
                           np.random.default_rng(seed + 1))
    target = distributions.ImagePrior.create(image, device=device)
    return target.sample(POOL, generator=torch.Generator(device).manual_seed(seed + 1))


def held_out(image, seed):
    """``(x, eps)`` on the CPU from numpy at ``seed``: 8,192 target points
    and the base's unit draws of 8,192 model samples."""
    x = host_sample(distributions.ImagePrior.create(image, device="cpu"), HELD_OUT,
                    np.random.default_rng(seed + 2))
    return x, host_normal(seed + 3, HELD_OUT, 2)


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch)


def make_chunk(model, lr, batch, chunk, data):
    """``(state, chunk_fn)``: forward KL on ``batch`` points of ``data`` a
    step, in sequential windows."""
    device = next(model.parameters()).device
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4,
                            capturable=device.type == "cuda")
    return training.make_chunked_train_step(model, opt, forward_kld_loss, data, batch, chunk,
                                            shuffle=False)


def bright_share(target, z):
    """The share of the points ``z`` whose pixel of ``target`` (an
    ``ImagePrior``) is brighter than 0.1, points off the image clamped to
    its edge, as the JAX script counts them."""
    z_ = torch.clamp((z - target.shift) / target.scale, 0.0, 1.0)
    ind = (z_ * (target._size() - 1)).to(torch.int64)
    return float(torch.mean((target.image[ind[:, 0], ind[:, 1]] > 0.1).float()))


def evaluate(model, image, seed):
    """The held-out mean log q and the draws' bright-pixel share
    (:func:`held_out`)."""
    device = next(model.parameters()).device
    x, eps = (t.to(device) for t in held_out(image, seed))
    with torch.no_grad():
        log_q = float(torch.mean(model.log_prob(x)))
        z, _ = model.from_noise(eps)
    target = distributions.ImagePrior.create(image, device=device)
    return {"held_out_log_q": log_q, "bright_share": bright_share(target, z),
            "draws_finite": bool(torch.isfinite(z).all())}


def main(argv=None):
    """Train and evaluate as the module docstring says, printing its lines;
    returns the trained model and the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--chunk", type=int, default=100, help="steps a call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image-npy", default=None,
                    help="optional (H, W) grayscale array; defaults to a procedural smiley")
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw the pool on the host from the seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters % args.chunk:
        raise SystemExit("--iters must divide by --chunk")

    device = torch.device(args.device)
    image = np.load(args.image_npy) if args.image_npy else smiley_image()
    model = build_model(device, args.k, args.seed)
    data = training_pool(image, args.seed, device, args.host_inputs)
    state, chunk = make_chunk(model, args.lr, args.batch, args.chunk, data)
    losses, timing = run_chunks(state, chunk, args.iters, args.chunk, label="forward KLD")
    record = training_record(losses, timing, args.batch, args.chunk, args.seed,
                             args.host_inputs, device)
    record.update(evaluate(model, image, args.seed), k=args.k)
    print("held-out mean log q(x):", record["held_out_log_q"])
    print(f"model samples on bright pixels: {record['bright_share']:.3f}")
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
