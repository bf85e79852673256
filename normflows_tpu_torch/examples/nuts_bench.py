"""NUTS throughput and ESS/s on the cylinder target: the port of
``examples/nuts_bench.py``.

    python -m normflows_tpu_torch.examples.nuts_bench [--chains N] [--tiny] [--device cuda]

The iterative multinomial NUTS (``sampling.NUTS``: every chain in
lock-step, masked lanes) on ``distributions.GaussianVonMises`` (dim 2,
``step_size=0.2`` before adaptation, ``max_depth=8``), 1,024 and 4,096
chains.  Two runs that differ only in ``num_steps`` (64 and 256, after 200
warm-up transitions) are differenced, which cancels the shared warm-up and
the set-up, giving the time of a sampling transition over all chains.  The
ESS is Geyer's initial positive sequence per chain and coordinate on the
longer run (the circular coordinate embedded as cos / sin), summed over
chains, the least over coordinates.  Beside the JAX script's keys, each
line has ``kernels_per_transition`` (the CUDA kernels of a sampling
transition under torch.profiler; null on the CPU),
``host_reads_per_transition`` (the sampler's reads of the device, a
doubling's "is any lane active" and the subtree checks, over the longer
run's sampling steps), ``busy_share`` (``--profiled`` transitions from the
last draw at the tuned step and mass, timed, then run again from the same
state and generator seed under the profiler: their kernels' device time
over the timed run's wall time) and the leaf steps run a transition.  On a card each leaf
is a replayed CUDA graph.  ``--tiny`` checks the wiring: 64 chains, 8 / 24
steps after 8, ``max_depth`` 6.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import distributions
from ..sampling import NUTS


def ess_1d(x):
    """Geyer initial-positive-sequence ESS for one chain (1-D numpy)."""
    n = len(x)
    x = x - x.mean()
    acov = np.correlate(x, x, mode="full")[n - 1:] / n
    if acov[0] == 0:
        return float(n)
    rho = acov / acov[0]
    # sum of adjacent pairs must stay positive (initial positive sequence)
    pair = rho[1:-1:2] + rho[2::2]
    k = np.argmax(pair <= 0) if np.any(pair <= 0) else len(pair)
    tau = 1.0 + 2.0 * rho[1:1 + 2 * k].sum()
    return float(n / max(tau, 1e-9))


def total_ess(samples):
    """Sum ESS over chains for each embedded coordinate; return the minimum
    across coordinates (the conservative choice).  samples: (S, C, dim)."""
    s = np.asarray(samples, np.float64)
    coords = [s[..., 0], np.cos(s[..., 1]), np.sin(s[..., 1])]
    return min(sum(ess_1d(c[:, j]) for j in range(c.shape[1])) for c in coords)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_run(nuts, chains, steps, adapt, seed, device):
    """Seconds of one ``sample`` ending in a synchronise, and its output."""
    gen = torch.Generator(device).manual_seed(seed)
    sync(device)
    t0 = time.perf_counter()
    samples, info = nuts.sample(chains, steps, num_adapt=adapt, generator=gen)
    sync(device)
    return time.perf_counter() - t0, samples, info


def transitions_profile(nuts, z, step_size, inv_mass, count, device):
    """``count`` transitions from ``z``, run twice from the same state and
    generator seed, so the same work: timed alone (a synchronise before and
    after), then under torch.profiler.  A transition's CUDA kernels, their
    device ms, the wall ms of the timed run, its leaf steps and host reads
    (None off a card)."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    def transitions():
        gen = torch.Generator(device).manual_seed(1)
        x, leaves, reads = z, 0, 0
        for _ in range(count):
            x, _ = nuts.transition(x, step_size, generator=gen, inv_mass=inv_mass)
            leaves, reads = leaves + nuts.leaves, reads + nuts.host_reads
        sync(device)
        return leaves, reads

    sync(device)
    t0 = time.perf_counter()
    leaves, reads = transitions()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = transitions()
    if again != (leaves, reads):
        raise RuntimeError(f"the profiled transitions ran other work: {again} against "
                           f"{(leaves, reads)} leaves and host reads")
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"transitions": count, "kernels": sum(e.count for e in kernels) / count,
            "device_ms": device_ms / count, "wall_ms": wall_ms / count,
            "busy_share": device_ms / wall_ms, "leaves": leaves / count,
            "host_reads": reads / count}


def run(chains, short, long_, adapt, max_depth, device, seed=0, profiled=4):
    """One JSON record (the JAX script's keys, unrounded, and the port's)."""
    nuts = NUTS.create(distributions.GaussianVonMises(device=device), 2, step_size=0.2,
                       max_depth=max_depth, device=device)
    timed_run(nuts, chains, 2, 2, seed + 1, device)  # warm-up: the first calls' set-up
    t_short, _, _ = timed_run(nuts, chains, short, adapt, seed, device)
    t_long, samples, info = timed_run(nuts, chains, long_, adapt, seed, device)
    per_step = (t_long - t_short) / (long_ - short)
    ess = total_ess(samples.cpu().numpy())
    x = samples.reshape(-1, 2).double()
    prof = transitions_profile(nuts, samples[-1], info["step_size"], info["inv_mass"],
                               profiled, device)
    return {
        "sampler": "NUTS",
        "target": "GaussianVonMises cylinder",
        "chains": chains,
        "steps_timed": long_,
        "ms_per_transition_all_chains": per_step * 1e3,
        "chain_transitions_per_sec": chains / per_step,
        "min_total_ess": ess,
        "ess_per_sec": ess / (per_step * long_),
        "divergence_rate": float(info["divergence_rate"]),
        "tuned_step_size": float(info["step_size"]),
        "mean_depth": float(info["mean_depth"]),
        "kernels_per_transition": None if prof is None else prof["kernels"],
        "host_reads_per_transition": info["host_reads"] / long_,
        "busy_share": None if prof is None else prof["busy_share"],
        "profiled_transitions": prof,
        "leaves_per_transition": info["leaves_total"] / info["transitions"],
        "num_adapt": adapt,
        "steps_short": short,
        "max_depth": max_depth,
        "seconds_short": t_short,
        "seconds_long": t_long,
        "moments": {"mean_x0": float(x[:, 0].mean()), "std_x0": float(x[:, 0].std()),
                    "mean_cos": float(torch.cos(x[:, 1] - 3.0 * x[:, 0]).mean())},
        "device": str(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profiled", type=int, default=4,
                    help="transitions profiled for the kernels and the busy share")
    args = ap.parse_args(argv)
    chains = [64] if args.tiny else ([args.chains] if args.chains else [1024, 4096])
    short, long_, adapt = (8, 24, 8) if args.tiny else (64, 256, 200)
    records = []
    for n in chains:
        records.append(run(n, short, long_, adapt, 6 if args.tiny else 8, args.device,
                           profiled=args.profiled))
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
