"""Class-conditional multiscale Glow on images: the port of
``examples/glow_image.py`` (the reference's glow notebook: CIFAR-10
geometry, L = 3 levels of K = 16 blocks, hidden 256, batch 128, Adamax).

    python -m normflows_tpu_torch.examples.glow_image [--iters 1000] [--L 3]
        [--K 16] [--hidden 256] [--batch 128] [--lr 1e-3] [--bf16] [--chunked]
        [--large-batch-recipe] [--data-npz FILE] [--seed 0] [--device cuda]
        [--host-inputs] [--image-size 32] [--classes 10] [--images 8192]

Without ``--data-npz`` the images are synthetic, drawn with numpy from
``--seed`` (:func:`synthetic_images`: class-dependent smooth fields
quantised to 256 levels, the structure of the JAX package's generators), at
the CIFAR-10 geometry unless ``--image-size`` / ``--classes`` / ``--images``
say otherwise.  A ``.npz`` with ``x`` (N, 3, H, W; uint8 or [0, 1]) and
``y`` (N,) trains on real data.  The last 1,024 images are held out.

The model (:func:`build_glow`) draws its weights from ``--seed``, so that
the JAX package can replay a run on the same weights
(``tests/test_torch_multiscale.py``).  Each step dequantises its batch
(``Scale(255/256)`` then ``Jitter(1/256)``) and takes one forward-KL step
with ``torch.optim.Adamax(lr, weight_decay=1e-5)``, the L2-coupled Adamax of
the JAX script's ``optax.chain(add_decayed_weights(1e-5), adamax(lr))``,
after ActNorm's data-dependent initialisation on the first batch.
``--chunked`` trains through ``training.make_chunked_train_step``: the
training images on the device, 10 steps a call (a window sliding over
them), one step captured in a CUDA graph and replayed on a card, the
jitter drawn inside it; without it, ``training.make_train_step`` takes one
eager step a call.  ``--host-inputs`` draws every step's dequantised batch
on the host from the seed before training (:func:`host_inputs`), so that a
run replays on another device and through the JAX package; it holds
iters x batch images in memory.  ``--large-batch-recipe`` is the JAX
script's: batch 512, bf16 and a warmup-cosine learning rate peaking at
6e-3 (``training.warmup_cosine_decay_schedule``).  ``--bf16`` runs the
convolutions in bfloat16 (``utils.set_compute_dtype``).

A step whose loss is not finite keeps the parameters and Adamax's state
(the JAX script zeroes the gradients and still takes Adamax's step, which
moves the parameters by its momentum); the record counts such steps.

The last line is one JSON record: the held-out bits/dim (the JAX script's
NaN-skipping mean), ``losses_every_100``, ``non_finite_steps``, the
training's steps and images a second, and whether 8 draws at temperature
0.7 are finite.  ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .. import MultiscaleFlow, distributions, flows, training
from ..utils import preprocessing, set_compute_dtype

CHUNK = 10  # steps a call of the chunked trainer, as the JAX script's
HELD_OUT = 1024
WEIGHT_DECAY = 1e-5
RECIPE = {"batch": 512, "peak_lr": 6e-3, "end_fraction": 0.05}
SCALE = preprocessing.Scale(255.0 / 256.0)
JITTER = preprocessing.Jitter(1.0 / 256.0)


def build_glow(L=3, K=16, hidden=256, input_shape=(3, 32, 32), num_classes=10, *,
               device="cuda", seed=0):
    """The reference notebook's model: level i has K ``GlowBlock``s on C *
    2^(L+1-i) channels (channel split, affine with a sigmoid scale, LU 1x1
    convolutions) and a ``Squeeze``; a ``Merge`` between levels; a
    ``ClassCondDiagGaussian`` base a level.  Block (i, j) draws its weights
    from a CPU generator seeded ``seed * 1000 + i * K + j``."""
    C, H, W = input_shape
    q0, merges, levels = [], [], []
    for i in range(L):
        cs = C * 2 ** (L + 1 - i)
        level = [flows.GlowBlock.create(torch.Generator().manual_seed(seed * 1000 + i * K + j),
                                        cs, hidden, split_mode="channel", scale=True,
                                        device=device) for j in range(K)]
        level.append(flows.Squeeze())
        levels.append(level)
        if i > 0:
            merges.append(flows.Merge())
            latent = (C * 2 ** (L - i), H // 2 ** (L - i), W // 2 ** (L - i))
        else:
            latent = (C * 2 ** (L + 1), H // 2**L, W // 2**L)
        q0.append(distributions.ClassCondDiagGaussian.create(latent, num_classes,
                                                             device=device))
    return MultiscaleFlow.create(q0, levels, merges)


def synthetic_images(n, shape=(3, 32, 32), num_classes=10, seed=0):
    """``(x, y)``: ``n`` float32 images in [0, 1] quantised to 256 levels,
    and their int64 labels, drawn with numpy from ``seed``.  Each class is a
    sum of four products sin(f h + p) cos(f' w + p') a channel, its
    frequencies U(0.5, 3) and phases U(0, 2 pi), scaled to [0, 1] over the
    image (the JAX package's generators)."""
    C, H, W = shape
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n)
    freqs = rng.uniform(0.5, 3.0, size=(num_classes, C, 4, 2))
    phase = rng.uniform(0, 2 * np.pi, size=(num_classes, C, 4, 2))
    h = np.linspace(0, 2 * np.pi, H)[:, None]
    w = np.linspace(0, 2 * np.pi, W)[None, :]
    classes = np.zeros((num_classes, C, H, W), np.float32)
    for c in range(num_classes):
        f, p = freqs[c], phase[c]
        img = sum(np.sin(f[:, k, 0, None, None] * h + p[:, k, 0, None, None])
                  * np.cos(f[:, k, 1, None, None] * w + p[:, k, 1, None, None])
                  for k in range(4))
        classes[c] = (img - img.min()) / (img.max() - img.min() + 1e-6)
    x = np.round(classes[y] * 255.0) / 255.0
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y.astype(np.int64))


def dequantise(x, generator=None):
    """``Jitter(1/256)(Scale(255/256)(x))``, the noise from ``generator``."""
    return JITTER(SCALE(x), generator)


def windows(iters, batch, n_train):
    """Each step's first image: the chunked trainer's sliding window."""
    return [(i * batch) % (n_train - batch + 1) for i in range(iters)]


def host_inputs(x_train, y_train, iters, batch, seed):
    """Every step's dequantised batch and labels, drawn on the CPU from
    ``seed``: tensors (iters, batch, C, H, W) and (iters, batch)."""
    gen = torch.Generator().manual_seed(seed + 3)
    xs = torch.stack([dequantise(x_train[s:s + batch], gen)
                      for s in windows(iters, batch, x_train.shape[0])])
    ys = torch.stack([y_train[s:s + batch] for s in windows(iters, batch, x_train.shape[0])])
    return xs, ys


def held_out_inputs(x, y, seed):
    """The last :data:`HELD_OUT` images dequantised on the CPU from ``seed``,
    and their labels."""
    return dequantise(x[-HELD_OUT:], torch.Generator().manual_seed(seed + 9)), y[-HELD_OUT:]


def init_inputs(x_train, y_train, batch, seed):
    """ActNorm's initialisation batch: the first ``batch`` training images,
    dequantised on the CPU from ``seed``."""
    return dequantise(x_train[:batch], torch.Generator().manual_seed(seed + 8)), y_train[:batch]


def bits_per_dim(model, x, y, batch=256):
    """The JAX script's held-out bits/dim: the mean of nll / log 2 / dims + 8
    over the rows whose nll is not NaN, evaluated ``batch`` rows a call."""
    device = next(model.parameters()).device
    with torch.no_grad():
        nll = torch.cat([-model.log_prob(x[i:i + batch].to(device), y[i:i + batch].to(device))
                         for i in range(0, x.shape[0], batch)]).cpu().double().numpy()
    dims = math.prod(x.shape[1:])
    return float(np.nansum(nll / np.log(2) / dims + 8) / np.sum(~np.isnan(nll)))


def make_optimizer(model, lr):
    device = next(model.parameters()).device
    return torch.optim.Adamax(model.parameters(), lr=lr, weight_decay=WEIGHT_DECAY,
                              capturable=device.type == "cuda")


def make_chunk(model, lr, batch, x_train, y_train, inputs=None, schedule=None,
               chunk=CHUNK):
    """``(state, chunk_fn)``: ``chunk`` Adamax steps a call.  Each step
    takes its window of ``x_train`` on the device and jitters it with the
    chunk's generator, or takes ``inputs`` (:func:`host_inputs`) at the
    step's index."""
    opt = make_optimizer(model, lr)
    if inputs is None:
        def loss_fn(m, b, generator):
            return m.forward_kld(dequantise(b[0], generator), b[1])

        return training.make_chunked_train_step(model, opt, loss_fn, (x_train, y_train), batch,
                                                chunk, shuffle=False, schedule=schedule)
    device = next(model.parameters()).device
    xs, ys = (t.to(device) for t in inputs)

    def batch_fn(step, generator):
        i = step.reshape(1)
        return xs.index_select(0, i)[0], ys.index_select(0, i)[0]

    return training.make_step_chunk(model, opt, lambda m, b, g: m.forward_kld(b[0], b[1]),
                                    chunk, batch_fn, schedule)


def load_data(args):
    if args.data_npz:
        data = np.load(args.data_npz)
        x = torch.as_tensor(data["x"], dtype=torch.float32)
        if float(x.max()) > 1.5:
            x = x / 255.0
        return x, torch.as_tensor(data["y"], dtype=torch.int64)
    return synthetic_images(args.images, (3, args.image_size, args.image_size),
                            args.classes, args.seed)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--L", type=int, default=3)
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batch", type=int, default=None, help="default 128")
    ap.add_argument("--lr", type=float, default=None, help="Adamax's, default 1e-3")
    ap.add_argument("--data-npz", type=str, default=None)
    ap.add_argument("--bf16", action="store_true", help="convolutions in bfloat16")
    ap.add_argument("--chunked", action="store_true",
                    help="training images on the device, 10 steps a call, one step "
                         "captured in a CUDA graph")
    ap.add_argument("--large-batch-recipe", action="store_true",
                    help="batch 512, bf16, warmup-cosine lr peaking at 6e-3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host-inputs", action="store_true",
                    help="draw every step's dequantised batch on the host from the seed")
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--images", type=int, default=8192, help="synthetic images drawn")
    args = ap.parse_args(argv)
    if args.large_batch_recipe:
        clashes = [f for f, given in (("--batch", args.batch), ("--lr", args.lr))
                   if given is not None]
        if clashes:
            ap.error(f"--large-batch-recipe fixes {', '.join(clashes)} (batch 512, "
                     "warmup-cosine lr peaking at 6e-3): drop one or the other")
        args.batch, args.bf16 = RECIPE["batch"], True
    args.batch = 128 if args.batch is None else args.batch
    args.lr = 1e-3 if args.lr is None else args.lr
    if args.chunked and (args.iters < CHUNK or args.iters % CHUNK):
        ap.error(f"--chunked runs {CHUNK} steps a call: --iters must be a positive "
                 f"multiple of {CHUNK} (got {args.iters})")
    return args


def main(argv=None):
    """Train and evaluate as the module docstring says, printing its lines;
    returns the trained model and the JSON record."""
    args = parse(argv)
    device = torch.device(args.device)
    x, y = load_data(args)
    x_train, y_train = x[:-HELD_OUT], y[:-HELD_OUT]
    n_dims = math.prod(x.shape[1:])
    model = build_glow(args.L, args.K, args.hidden, tuple(x.shape[1:]),
                       int(y.max()) + 1 if args.data_npz else args.classes, device=device,
                       seed=args.seed)
    if args.bf16:
        set_compute_dtype(model, "bfloat16")
    xi, yi = init_inputs(x_train, y_train, args.batch, args.seed)
    model.init_actnorm(xi.to(device), yi.to(device))
    schedule = None
    if args.large_batch_recipe:
        warmup = min(50, max(1, args.iters // 10))
        schedule = training.warmup_cosine_decay_schedule(
            0.0, RECIPE["peak_lr"], warmup, args.iters,
            RECIPE["peak_lr"] * RECIPE["end_fraction"])
    gen = torch.Generator(device).manual_seed(args.seed + 4)
    inputs = host_inputs(x_train, y_train, args.iters, args.batch, args.seed) \
        if args.host_inputs else None
    losses, chunk_seconds = [], []
    t0 = time.time()
    if args.chunked:
        state, chunk = make_chunk(model, args.lr, args.batch, x_train, y_train, inputs,
                                  schedule)
        for c in range(args.iters // CHUNK):
            t1 = time.time()
            state, metrics = chunk(state, gen)
            losses.append(metrics["loss"].cpu())  # the chunk's one host read
            chunk_seconds.append(time.time() - t1)
            if (c * CHUNK) % 100 == 0 or c == args.iters // CHUNK - 1:
                i = (c + 1) * CHUNK - 1
                loss = float(losses[-1][-1])
                print(f"iter {i:5d}  nll {loss:9.1f}  bits/dim "
                      f"{loss / np.log(2) / n_dims + 8:.4f}")
    else:
        opt = make_optimizer(model, args.lr)
        state, step = training.make_train_step(
            model, opt, lambda m, b, g: m.forward_kld(b[0], b[1]))
        starts = windows(args.iters, args.batch, x_train.shape[0])
        for i in range(args.iters):
            if schedule is not None:
                for group in opt.param_groups:
                    group["lr"] = float(schedule(torch.tensor(i)))
            if inputs is not None:
                batch = (inputs[0][i].to(device), inputs[1][i].to(device))
            else:
                s = starts[i]
                batch = (dequantise(x_train[s:s + args.batch].to(device), gen),
                         y_train[s:s + args.batch].to(device))
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].reshape(1).cpu())
            if i % 100 == 0 or i == args.iters - 1:
                loss = float(losses[-1][0])
                print(f"iter {i:5d}  nll {loss:9.1f}  bits/dim "
                      f"{loss / np.log(2) / n_dims + 8:.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.time() - t0
    losses = torch.cat(losses)
    print(f"training wall time: {seconds:.1f}s")
    xe, ye = held_out_inputs(x, y, args.seed)
    bpd = bits_per_dim(model, xe, ye)
    print(f"eval bits/dim: {bpd:.4f}")
    with torch.no_grad():
        xs, _ = model.sample(8, temperature=0.7,
                             generator=torch.Generator(device).manual_seed(args.seed + 10))
    finite = bool(torch.isfinite(xs).all())
    print("sampled images:", tuple(xs.shape), "finite:", finite)
    # the first chunk captures the step: the steady rate leaves it out
    steady = sum(chunk_seconds[1:]) / (len(chunk_seconds) - 1) / CHUNK \
        if len(chunk_seconds) > 1 else seconds / args.iters
    record = {
        "held_out_bits_per_dim": bpd, "losses_every_100": losses[::100].tolist(),
        "final_loss": float(losses[-1]),
        "non_finite_steps": int((~torch.isfinite(losses)).sum()),
        "loss_mean_first_100": float(losses[:100].mean()),
        "loss_mean_last_100": float(losses[-100:].mean()),
        "seconds": seconds, "steps_per_s": args.iters / seconds,
        "images_per_s": args.iters * args.batch / seconds,
        "steady_step_ms": 1e3 * steady, "steady_images_per_s": args.batch / steady,
        "samples_finite": finite, "seed": args.seed, "iters": args.iters,
        "batch": args.batch, "lr": args.lr, "L": args.L, "K": args.K, "hidden": args.hidden,
        "image_shape": list(x.shape[1:]), "bf16": args.bf16, "chunked": args.chunked,
        "host_inputs": args.host_inputs, "large_batch_recipe": args.large_batch_recipe,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(record))
    return model, record


if __name__ == "__main__":
    main()
