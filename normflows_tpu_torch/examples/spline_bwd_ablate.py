"""Spline backward ablation on the card: the port of
``examples/spline_bwd_ablate.py``.

    python -m normflows_tpu_torch.examples.spline_bwd_ablate [--tiny] [--device cpu] [--seed 0]

It times the four variants of the flat spline backward
(``ops/spline_ablate.VARIANTS``: the bin search alone, plus the pull-back of
the rational-quadratic map, the shipped backward, and the whole-block
pull-back that keeps every bin's residuals) on the inputs of the JAX
script's ``run_variant``: N = 2^14 samples x 2 features = 32,768 elements,
K = 10 bins, the inverse direction, every tail circular at pi, unit
cotangents, x ~ N(0, 1) and logits ~ 0.1 N(0, 1), drawn with numpy from
``--seed``.

Each mode prints one JSON line ``{"mode", "n", "ms", "bound_ms", "device"}``.
``ms`` is the device time of one launch: 64 launches, rotating over 16
input sets (75 MB, more than the 50 MB L2), captured in one CUDA graph and
replayed (the card's counterpart of the JAX script's long-minus-short scan
difference); ``bound_ms`` is the least
time the card could take, the bytes the variant must move over 3.35 TB/s
against its operations over 67 TFLOP/s (H100 SXM, NVIDIA's data sheet).
On the CPU (``--device cpu``) it runs the plain versions once, for a check
of the wiring, and ``ms`` is null: a CPU run measures no device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math

import numpy as np
import torch

from ..ops import backend, spline_ablate, splines

N_SAMPLES, FEATURES, BINS = 2**14, 2, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
INPUT_SETS, REPS, REPLAYS = 16, 64, 5


def make_inputs(n, seed, device, K=BINS):
    """run_variant's inputs, from the numpy generator: x (n,) ~ N(0, 1),
    uw, uh (K, n) and ud (K+1, n) ~ 0.1 N(0, 1), circular codes at pi, unit
    cotangents."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    uw, uh = (0.1 * rng.normal(size=(2, K, n))).astype(np.float32)
    ud = (0.1 * rng.normal(size=(K + 1, n))).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    codes = torch.full((n,), splines.TAIL_CIRCULAR, dtype=torch.int32, device=device)
    bounds = torch.full((n,), math.pi, device=device)
    ones = torch.ones(n, device=device)
    return to(x), to(uw), to(uh), to(ud), codes, bounds, ones, ones.clone()


def bound(mode, n, K=BINS):
    """Least time of one launch in ms, what bounds it, and its bytes: each
    element reads x, code, bound and 3K+1 parameters (and ybar, lbar, which
    sel_only does not need) and writes xg and 3K+1 planes.  Operations per
    element as chip_smoke.py's flat_bound counts them: the selection
    21K + 28, the pull-back of the map 130, the scatters 24K + 10(K+1)."""
    words = (3 + (3 * K + 1)) + (0 if mode == "sel_only" else 2) + (1 + (3 * K + 1))
    ops = 21 * K + 28 + {"sel_only": 0, "sel_post": 130}.get(
        mode, 130 + 24 * K + 10 * (K + 1))
    t_bytes, t_ops = words * 4 * n / HBM_BYTES_PER_S, ops * n / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        words * 4 * n


def device_ms(mode, sets, inverse=True):
    """Device time of one launch in ms: REPS launches over the input sets in
    one CUDA graph, replayed REPLAYS times between two events."""
    rotation = itertools.cycle(sets)

    def call():
        return spline_ablate.run_variant(mode, *next(rotation), inverse=inverse)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * REPS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="2^9 samples x 2 features, for a quick check of the wiring")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = backend.resolve_device(args.device)
    n = (2**9 if args.tiny else N_SAMPLES) * FEATURES
    on_card = device.type == "cuda"
    sets = [make_inputs(n, args.seed + i, device) for i in range(INPUT_SETS if on_card else 1)]
    records = []
    for mode in spline_ablate.VARIANTS:
        out = spline_ablate.run_variant(mode, *sets[0], inverse=True)
        if not all(bool(torch.isfinite(t).all()) for t in out):
            raise SystemExit(f"spline_bwd_ablate: {mode} gave a non-finite output")
        record = {"mode": mode, "n": n, "ms": device_ms(mode, sets) if on_card else None,
                  "bound_ms": bound(mode, n)[0], "device": str(device)}
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
