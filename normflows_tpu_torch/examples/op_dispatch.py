"""Host cost of one call of each kernel's wrapper, operand checks and
operator dispatch included.

    python -m normflows_tpu_torch.examples.op_dispatch [--reps 400] [--turns 5]
        [--device cuda]

Every kernel on a model's path is reached through its wrapper
(``spline_cuda.rqs_transposed``, ``spline_flat.unconstrained_rqs_dyncodes``,
``made_fused.fused_resmade`` and their backward), which checks its operands
and calls the kernel's operator (``ops.backend.kernel_op``).  The script
calls each wrapper only through its public name, so that a copy of it run
from another checkout of the package times that checkout's wrappers (the
way to hold two versions against each other in one call).

A call's time is the mean over ``--reps`` calls timed with CUDA events (on
the CPU, the wall clock), the same reading as ``chip_smoke.py``'s
``call_ms``: on the card, host time wherever the host is slower than the
kernel.  Inputs are the sizes of the models' paths: the planar spline at
2 x 2^14, the flat spline at 4096 (the sliced inverse's), the fused MADE at
256 x 8 features, hidden 128 (small, so that the host's part shows).  A
forward wrapper is timed with autograd on (inputs that need no gradient)
and under ``torch.inference_mode()``, as in serving; a backward wrapper
with autograd on.  One JSON line per kernel: the median over the turns of
its µs a call, then a line with the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops import backend, made_fused, spline_cuda, spline_flat


def _cases(device):
    """``{kernel: wrapper call}`` at the paths' sizes, from a seeded
    generator."""
    rng = np.random.default_rng(0)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    F, B, K = 2, 2**14, 10
    x = t(rng.uniform(-4, 4, (F, B)))
    p = t(0.5 * rng.normal(size=(F * (3 * K + 1), B)))
    yb, lb = t(rng.normal(size=(F, B))), t(rng.normal(size=(F, B)))
    codes, bounds = [1, 2], [5.0, float(np.pi)]
    planar = (codes, bounds, True, 1e-3, 1e-3, 1e-3)
    N, Kf = 4096, 8
    slab = t(0.5 * rng.normal(size=(3 * Kf + 1, N)))
    flat = (t(rng.uniform(-3.5, 3.5, N)), slab[:Kf], slab[Kf:2 * Kf], slab[2 * Kf:],
            t(np.ones(N), np.int32), t(np.full(N, 3.0)))
    fyb, flb = t(rng.normal(size=N)), t(rng.normal(size=N))
    Bm, Fm, H, R, P = 256, 8, 128, 1, 8 * 31
    made = [t(0.1 * rng.normal(size=s)) for s in (
        (Bm, Fm), (H, Fm), (H,), (R, H, H), (R, H), (R, H, H), (R, H), (P, H), (P,))]
    g = t(rng.normal(size=(Bm, P)))
    return {
        "rqs_transposed": lambda: spline_cuda.rqs_transposed(x, p, *planar[:3]),
        "rqs_transposed_backward":
            lambda: spline_cuda.rqs_transposed_backward(x, p, yb, lb, *planar[:3]),
        "rqs_flat": lambda: spline_flat.unconstrained_rqs_dyncodes(*flat, True),
        "rqs_flat_backward":
            lambda: spline_flat.unconstrained_rqs_dyncodes_backward(*flat, fyb, flb, True),
        "fused_resmade": lambda: made_fused.fused_resmade(*made),
        "fused_resmade_backward": lambda: made_fused.fused_resmade_backward(*made, g),
    }


def _us(fn, reps, cuda):
    """Mean µs a call over ``reps`` calls after a warm-up."""
    for _ in range(3):
        fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = backend.resolve_device(args.device)
    cuda = device.type == "cuda"
    cases = _cases(device)
    times = {}
    for _ in range(args.turns):
        for kernel, fn in cases.items():
            # a backward kernel runs in training, never in inference mode
            modes = ("grad_mode",) if kernel.endswith("_backward") else \
                ("grad_mode", "inference_mode")
            for mode in modes:
                with torch.inference_mode(mode == "inference_mode"):
                    us = _us(fn, args.reps, cuda)
                times.setdefault(kernel, {}).setdefault(mode, []).append(us)
    records = []
    for kernel, by_mode in times.items():
        record = {"kernel": kernel, "device": str(device), "reps": args.reps,
                  "turns": args.turns,
                  "us": {mode: statistics.median(v) for mode, v in by_mode.items()},
                  "us_each_turn": by_mode}
        records.append(record)
        print(json.dumps(record), flush=True)
    card = "cpu"
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}))
    return records


if __name__ == "__main__":
    main()
