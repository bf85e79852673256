"""A stochastic normalizing flow and Hamiltonian annealed importance sampling
on TwoMoons: the port of ``examples/snf_hais.py``.

    python -m normflows_tpu_torch.examples.snf_hais [--chains 4096] [--seed 0]
        [--device cuda] [--reps 5]

The SNF (the SNF paper's setup, arXiv:2002.06707) interleaves 4 masked
affine couplings on ``MLP([2, 64, 2], init_zeros=True)`` nets with
Metropolis–Hastings layers (a ``DiagGaussianProposal`` of scale 0.3, 5
steps) toward ``TwoMoons``, from a ``DiagGaussian(2)`` base; it draws
``--snf-samples`` samples.  HAIS anneals from ``DiagGaussian(2)`` to
``TwoMoons`` over ``betas = linspace(1, 0, 32)`` (30 HMC rungs of 10
leapfrog steps, step size 0.2, log mass 0) with ``--chains`` chains, and
estimates the target's log normaliser, the effective sample size and the
weighted posterior mean.  As the JAX script shards the chains over a device
mesh, the chains go through ``parallel.parallel_chain_sample``: under
``torchrun --nproc_per_node=N`` each rank runs its block of the chains on
its card, and the estimates are made from every rank's chains, gathered;
as one process the world is one rank.

A rank's draw runs eagerly, and on a card also captured once in a CUDA
graph (the generator registered with it, so that each replay draws anew)
and replayed: the counterpart of the JAX package's one jitted ladder.  Both
times are reported, each the host median of ``--reps`` calls ending in a
synchronise.  Rank 0 prints; the last line is one JSON record, unrounded.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import NormalizingFlow, distributions, flows, parallel
from ..nets import MLP
from ..sampling import HAIS

SNF_LAYERS, SNF_HIDDEN, MH_SCALE, MH_STEPS = 4, 64, 0.3, 5
HMC_LEAPFROG, HMC_STEP = 3, 0.2  # the SNF's HMC variant
BETAS, LEAPFROG, STEP_SIZE = 32, 10, 0.2


def build_snf(device, seed=0, mcmc="mh", target=None):
    """The SNF, its coupling nets' weights drawn on the CPU from ``seed``;
    ``mcmc="hmc"`` puts an HMC layer (HMC_LEAPFROG leapfrog steps, learnable
    step size and mass) where each MH layer stands.  ``target`` (TwoMoons
    by default) is the model's ``p`` and every MCMC layer's target."""
    if mcmc not in ("mh", "hmc"):
        raise ValueError(f"mcmc is 'mh' or 'hmc', not {mcmc!r}")
    target = distributions.TwoMoons(device=device) if target is None else target
    gen = torch.Generator().manual_seed(seed)
    b = torch.tensor([1.0, 0.0])
    layers = []
    for i in range(SNF_LAYERS):
        s = MLP.create(gen, [2, SNF_HIDDEN, 2], init_zeros=True, device=device)
        t = MLP.create(gen, [2, SNF_HIDDEN, 2], init_zeros=True, device=device)
        layers.append(flows.MaskedAffineFlow.create(b if i % 2 == 0 else 1 - b, t=t, s=s,
                                                    device=device))
        if mcmc == "mh":
            layers.append(flows.MetropolisHastings(
                target, distributions.DiagGaussianProposal((2,), MH_SCALE, device=device),
                MH_STEPS))
        else:
            layers.append(flows.HamiltonianMonteCarlo(
                target, HMC_LEAPFROG, np.full(2, math.log(HMC_STEP)), np.zeros(2),
                device=device))
    return NormalizingFlow.create(distributions.DiagGaussian(2, device=device), layers,
                                  p=target, device=device)


def build_hais(device, betas=BETAS, leapfrog=LEAPFROG):
    """The JAX script's ladder: ``betas`` inverse temperatures from 1 to 0."""
    return HAIS.create(np.linspace(1.0, 0.0, betas), distributions.DiagGaussian(2, device=device),
                       distributions.TwoMoons(device=device), leapfrog,
                       np.full(2, STEP_SIZE), np.zeros(2), device=device)


def estimates(samples, log_w):
    """log Z (logsumexp(log_w) - log n), the ESS (1 / sum w^2 of the
    normalised weights), the weighted posterior mean, and the delta-method
    standard error of log Z (std(w) / (mean(w) sqrt(n)))."""
    log_w = log_w.double()
    n = log_w.shape[0]
    w = torch.softmax(log_w, 0)
    u = torch.exp(log_w - log_w.max())
    return {"log_z": float(torch.logsumexp(log_w, 0) - math.log(n)),
            "ess": float(1.0 / torch.sum(w**2)),
            "posterior_mean": [float(v) for v in torch.sum(w[:, None] * samples.double(), 0)],
            "log_z_se": float(u.std() / (u.mean() * math.sqrt(n))),
            "finite_weights": bool(torch.isfinite(log_w).all())}


def two_moons_log_z(h=0.002, bound=5.0):
    """TwoMoons' log normaliser by quadrature (the midpoint rule on an ``h``
    grid over [-bound, bound]^2), with numpy, a band of rows at a time."""
    x = np.arange(-bound + h / 2, bound, h)
    total = 0.0
    for rows in np.array_split(x, max(1, x.size // 500)):
        z0, z1 = np.meshgrid(rows, x, indexing="ij")
        a = np.abs(z0)
        norm = np.hypot(z0, z1)
        log_p = (-0.5 * ((norm - 2.0) / 0.2) ** 2 - 0.5 * ((a - 2.0) / 0.3) ** 2
                 + np.log1p(np.exp(-4.0 * a / 0.09)))
        total += float(np.exp(log_p).sum())
    return math.log(total * h * h)


def captured(fn, generator):
    """``fn`` captured once in a CUDA graph after two warm-up calls on a side
    stream, ``generator`` registered with it; returns ``(replay, outputs)``,
    the outputs' tensors refilled by every replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


def host_ms(fn, reps, device):
    """Host median of ``reps`` calls of ``fn``, each ending in a synchronise."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=4096)
    ap.add_argument("--betas", type=int, default=BETAS, help="rungs + 2")
    ap.add_argument("--snf-samples", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5, help="timed calls of each route")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = parallel.initialize_distributed(device=args.device)  # torchrun's, if any
    mesh = parallel.make_mesh(devices=args.device)
    try:
        return sample_and_estimate(args, device, mesh)
    finally:
        dist.destroy_process_group()  # main ends the world it ran in


def sample_and_estimate(args, device, mesh):
    """The SNF's draws and HAIS across the ranks of ``mesh``, as the module
    docstring says; returns the JSON record (every rank's)."""
    rank = dist.get_rank()
    snf = build_snf(device, args.seed)
    gen = torch.Generator(device).manual_seed(args.seed + 1)
    with torch.no_grad():
        z, log_q = snf.sample(args.snf_samples, generator=gen)
    snf_record = {"samples": args.snf_samples,
                  "mean_norm": float(torch.linalg.vector_norm(z, dim=1).mean()),
                  "finite": bool(torch.isfinite(z).all() and torch.isfinite(log_q).all())}
    if rank == 0:
        print(f"SNF samples: {tuple(z.shape)} mean |z|: {snf_record['mean_norm']:.4f}")

    hais = build_hais(device, args.betas)
    chains = parallel.parallel_chain_sample(hais, mesh, args.chains)
    gen = torch.Generator(device).manual_seed(args.seed + 2)

    def draw():
        return chains(gen)

    samples, log_w = gathered(draw())
    record = {"chains": args.chains, "ranks": dist.get_world_size(),
              "rungs": len(hais.layers), "leapfrog": LEAPFROG, **estimates(samples, log_w),
              "eager_ms": host_ms(draw, args.reps, device)}
    if device.type == "cuda":
        replay, (c_samples, c_log_w) = captured(draw, gen)
        replay()
        record["captured"] = estimates(*gathered((c_samples, c_log_w)))
        record["captured_ms"] = host_ms(replay, args.reps, device)
    rate = args.chains * record["rungs"] * LEAPFROG / (record["eager_ms"] / 1e3)
    out = {"snf": snf_record, "hais": record, "seed": args.seed,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if rank == 0:
        print(f"HAIS: {args.chains} chains x {record['rungs']} HMC stages in "
              f"{record['eager_ms']:.1f} ms eager ({rate:.0f} leapfrog-chain-steps/s)"
              + (f", {record['captured_ms']:.2f} ms captured" if "captured_ms" in record
                 else ""))
        print(f"log Z estimate: {record['log_z']:.4f}   ESS: {record['ess']:.0f}")
        print("posterior mean estimate:", record["posterior_mean"])
        print(json.dumps(out))
    return out


def gathered(shards):
    """Every rank's block of chains, stacked in rank order, on every rank."""
    out = []
    for t in shards:
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        out.append(torch.cat(parts))
    return out


if __name__ == "__main__":
    main()
