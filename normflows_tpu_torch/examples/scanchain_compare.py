"""The flagship's training step, unrolled against one ``ScanChain`` of its
12 layers: the port of ``examples/scanchain_compare.py``.

    python -m normflows_tpu_torch.examples.scanchain_compare [--iters 30] [--device cuda]

12 circular autoregressive RQ-spline layers (MADE hidden 512, 10 bins) on a
UniformGaussian base, GaussianVonMises target, bf16 MADE products, reverse
KL on 2^14 samples, Adam(5e-4) (capturable on a card).  Both variants
start from the same weights.  One JSON row a variant: the time to the
first step (an eager step from a fresh model, the kernels' build excluded:
they are built once, before), ms a step eager (``training.make_train_step``,
the host median of ``--iters`` steps) and as a captured chunk
(``training.make_step_chunk``: ``--iters`` steps a call, the call's host
time over ``--iters``, after the capture), samples/s of the chunk, the
planar kernel launches of an eager step (the wrappers' counters) and, on a
card, the CUDA kernels of a replayed step (torch.profiler, a chunk of 10
over 10).  ``--device cpu --num-samples 256 --iters 2 --hidden 16`` checks
the wiring.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import ScanChain, training
from ..ops import cuda_build, spline_cuda
from ..utils import set_compute_dtype
from .nsf_cylinder import build_model


def variants(device, hidden):
    unrolled = build_model(device, hidden=hidden)
    scan = build_model(device, hidden=hidden)
    scan.flows = torch.nn.ModuleList([ScanChain.create(list(scan.flows))])
    for m in (unrolled, scan):
        set_compute_dtype(m, "bfloat16")
    return {"unrolled": unrolled, "scan_chain": scan}


def make_optimizer(model, device):
    return torch.optim.Adam(model.parameters(), lr=5e-4,
                            capturable=torch.device(device).type == "cuda")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def loss_fn(num_samples):
    return lambda model, batch, gen: model.reverse_kld(num_samples, generator=gen)


def replayed_kernels(chunk, state, gen, steps):
    from torch.profiler import ProfilerActivity, profile

    sync("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk(state, gen)
        sync("cuda")
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host) / steps


def measure(name, hidden, num_samples, iters, device):
    cuda = torch.device(device).type == "cuda"
    model = variants(device, hidden)[name]
    state, step = training.make_train_step(model, make_optimizer(model, device),
                                           loss_fn(num_samples))
    gen = torch.Generator(device).manual_seed(0)
    sync(device)
    t0 = time.perf_counter()
    spline_cuda.LAUNCHES = spline_cuda.BACKWARD_LAUNCHES = 0
    step(state, None, gen)
    sync(device)
    first_s = time.perf_counter() - t0
    launches = spline_cuda.LAUNCHES + spline_cuda.BACKWARD_LAUNCHES
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step(state, None, gen)
        sync(device)
        times.append(time.perf_counter() - t0)
    eager_ms = float(np.median(times)) * 1e3
    model = variants(device, hidden)[name]
    cstate, chunk = training.make_step_chunk(model, make_optimizer(model, device),
                                             loss_fn(num_samples), iters)
    t0 = time.perf_counter()
    _, out = chunk(cstate, gen)  # the warm-up and the capture
    sync(device)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, out = chunk(cstate, gen)
    loss = out["loss"].float().cpu().numpy()
    chunk_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = None
    if cuda:
        kstate, kchunk = training.make_step_chunk(
            variants(device, hidden)[name], make_optimizer(model, device),
            loss_fn(num_samples), 10)
        kchunk(kstate, gen)
        kernels = replayed_kernels(kchunk, kstate, gen, 10)
    return {"variant": name, "K": 12, "hidden": hidden, "num_samples": num_samples,
            "time_to_first_step_s": first_s, "ms_per_step_eager": eager_ms,
            "chunk_first_call_s": capture_s, "ms_per_step_chunk": chunk_ms,
            "samples_per_sec": num_samples / (chunk_ms / 1e3),
            "planar_launches_per_step": launches, "kernels_per_step_replayed": kernels,
            "loss_last": float(loss[-1]), "device": str(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--num-samples", type=int, default=2**14)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        cuda_build.build([spline_cuda.SOURCE])
    rows = []
    for name in ("unrolled", "scan_chain"):
        rows.append(measure(name, args.hidden, args.num_samples, args.iters, args.device))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
