#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``normflows_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from the sources
in the checkout, holds each against its plain PyTorch version, drives the
flagship model (12 circular autoregressive RQ-spline layers of hidden width
512, 10 bins) at full width through its serving path (2^14 samples per
request) and its training step (reverse KL and Adam(5e-4) on 2^14 samples),
in float32 and bfloat16, times kernels, requests and steps, and prints one
JSON line per phase: device, build, kernel, main_path, times_kernel,
times_requests, kernel_backward, train_path, times_train, kernels.  The last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without a
CUDA card, or without the package beside it, it exits non-zero before
printing anything.  It imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"

# flagship (bench.py / __graft_entry__.py of the JAX package)
LAYERS, HIDDEN, BINS, BLOCKS = 12, 512, 10, 1
SCALE = [1.0, 2 * math.pi]
TAIL_BOUND = [5.0, math.pi]
CODES = (1, 2)  # TAIL_LINEAR, TAIL_CIRCULAR
N = 2**14
N_CPU = 2**12

# Kernel vs plain version: the JAX package's own bars (tests/test_pallas.py),
# |a - b| <= atol + rtol * |b| with atol = rtol = 2e-5 on outputs and 2e-4 on
# log-dets.  Raw parameters are drawn with std 0.5, near the scale of the
# flagship MADE's output at init (~0.3): at std 1 some bins get slopes so
# small that float32 rounding alone, in either version, passes the bars.
Y_TOL, LD_TOL, PARAM_STD = 2e-5, 2e-4, 0.5
# inverse(forward(x)) == x: two evaluations, the inverse amplifying rounding
# by 1/slope; the JAX package's round-trip bar (tests/helpers.py)
RT_TOL, RT_LD_TOL = 1e-4, 1e-3
# sample's log_q against log_prob of the samples, median over 2^14, f32:
# both directions see the same MADE parameters, so what is left is the
# spline's inverse/forward rounding through 12 layers.
LOGQ_F32 = 1e-3
# bf16: a layer's MADE input differs between the two directions by the
# float32 rounding of the layers after it, and where that flips the bf16
# rounding of a parameter (one bf16 step is ~4e-3 relative; the batch-1 and
# batch-2^14 GEMMs of the two directions round apart too), that element's
# log-det moves by up to ~0.1.  Most elements see no flip, so the median
# stays small; its bar is ten times the f32 one.
LOGQ_BF16 = 1e-2
# card against CPU, f32, same weights, 2^12 samples: matmuls summed in
# another order and the kernel against the plain spline, through 12 layers,
# each within 2e-5 / 2e-4: 1e-3 atol + rtol on values and log-densities.
CPU_TOL = 1e-3
# Backward kernel against its plain version (autograd through the plain
# spline): the JAX package's gradient bars (tests/test_pallas.py), atol = rtol.
G_TOL = 2e-3
# One f32 training step, card against CPU, same weights and base draws,
# 2^12 samples: each gradient leaf within 2e-3 of its norm (the gradient bar
# above, taken over a leaf), the loss within CPU_TOL.
STEP_G_TOL = 2e-3
N_TRAIN_CPU = 2**12
LR = 5e-4  # bench.py's Adam
TRAIN_STEPS = 200

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def excess(a, b, atol, rtol):
    """Largest |a - b| - (atol + rtol |b|); <= 0 passes."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, with CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time of one ``fn`` in ms: ``reps`` calls captured in one CUDA
    graph, so that no host work stands between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / (replays * reps)


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median wall time of ``fn`` ending in a synchronise, in ms."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def planar_inputs(rng, B, inside=False):
    """x_t (2, B), ~20% outside +-bound on both dims (or all inside), and
    params_t (62, B), both from the numpy generator."""
    bounds = np.asarray(TAIL_BOUND, np.float32)[:, None]
    reach = 0.999 if inside else 1.25
    x = (rng.uniform(-reach, reach, (2, B)) * bounds).astype(np.float32)
    p = (PARAM_STD * rng.normal(size=(2 * (3 * BINS + 1), B))).astype(np.float32)
    return torch.from_numpy(x).to(DEVICE), torch.from_numpy(p).to(DEVICE)


def build_flagship(device, init_identity=False):
    import normflows_tpu_torch as nft

    base = nft.distributions.UniformGaussian.create(2, [1], SCALE, device=device)
    layers = [nft.flows.CircularAutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(SEED + i), 2, BLOCKS, HIDDEN, ind_circ=[1],
        num_bins=BINS, tail_bound=np.asarray(TAIL_BOUND, np.float32),
        permute_mask=True, rng_seed=i, init_identity=init_identity, device=device)
        for i in range(LAYERS)]
    return nft.NormalizingFlow.create(
        base, layers, p=nft.distributions.GaussianVonMises(device=device), device=device)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, matmul_allow_tf32=tf32)
    if tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 is True: float32 "
                         "matmuls would run in TF32")
    return smi


def phase_build():
    from normflows_tpu_torch.ops import spline_cuda

    info = spline_cuda.build(force=True)
    ptxas = [line for line in info["ptxas"].splitlines()
             if "registers" in line or "spill" in line or "smem" in line]
    emit("build", source=str(spline_cuda.SOURCE.relative_to(REPO)),
         seconds=info["seconds"], ptxas=ptxas)


def phase_kernel():
    """The kernel against its plain version on the same CUDA tensors."""
    from normflows_tpu_torch.ops import spline_cuda as sc

    rng = np.random.default_rng(SEED)
    errs = {}
    for B in (N, N + 37):
        for inverse in (False, True):
            x, p = planar_inputs(rng, B)
            y, ld = sc.rqs_transposed(x, p, CODES, TAIL_BOUND, inverse)
            sync()
            yr, ldr = sc.rqs_transposed_reference(x, p, CODES, TAIL_BOUND, inverse)
            d = "inverse" if inverse else "forward"
            e = {"max_abs_y": float((y - yr).abs().max()),
                 "max_abs_ld": float((ld - ldr).abs().max()),
                 "excess_y": excess(y, yr, Y_TOL, Y_TOL),
                 "excess_ld": excess(ld, ldr, LD_TOL, LD_TOL),
                 "finite": bool(torch.isfinite(y).all() and torch.isfinite(ld).all())}
            errs[f"{d}_B{B}"] = e
            if not e["finite"] or e["excess_y"] > 0 or e["excess_ld"] > 0:
                emit("kernel", ok=False, errors=errs)
                raise SystemExit(f"kernel disagrees with its plain version ({d}, B={B})")
    # round trip inside the bounds, through the kernel both ways
    x, p = planar_inputs(rng, N + 37, inside=True)
    y, ld_f = sc.rqs_transposed(x, p, CODES, TAIL_BOUND, False)
    x2, ld_i = sc.rqs_transposed(y, p, CODES, TAIL_BOUND, True)
    sync()
    rt = {"excess_x": excess(x2, x, RT_TOL, RT_TOL),
          "max_abs_ld_sum": float((ld_f + ld_i).abs().max())}
    ok = rt["excess_x"] <= 0 and rt["max_abs_ld_sum"] <= RT_LD_TOL
    emit("kernel", ok=ok, errors=errs, round_trip=rt,
         bars={"y": [Y_TOL, Y_TOL], "ld": [LD_TOL, LD_TOL], "param_std": PARAM_STD})
    if not ok:
        raise SystemExit("kernel round trip inverse(forward(x)) != x")
    return errs


def drive(model, what, expect_launches, fn):
    """Run one main-path phase with the launch count set to 0 just before
    it; fail unless the kernel was launched exactly ``expect_launches``
    times."""
    from normflows_tpu_torch.ops import spline_cuda

    spline_cuda.LAUNCHES = 0
    out = fn()
    sync()
    launches = spline_cuda.LAUNCHES
    if launches != expect_launches:
        raise SystemExit(f"{what}: the kernel was launched {launches} times, "
                         f"expected {expect_launches}")
    return out, launches


def phase_main_path():
    from normflows_tpu_torch.utils import set_compute_dtype

    model = build_flagship(DEVICE)
    results, launches = {}, {"forward": 0, "inverse": 0}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with torch.inference_mode():
            (x, log_q), n_inv = drive(model, f"sample {dtype}", 2 * LAYERS,
                                      lambda: model.sample(N, generator=gen))
            lp, n_fwd = drive(model, f"log_prob {dtype}", LAYERS,
                              lambda: model.log_prob(x))
        launches["inverse"] += n_inv
        launches["forward"] += n_fwd
        finite = all(bool(torch.isfinite(t).all()) for t in (x, log_q, lp))
        gap = (lp - log_q).abs()
        r = {"sample_launches": n_inv, "log_prob_launches": n_fwd, "finite": finite,
             "shape": list(x.shape), "circular_in_bounds":
                 bool((x[:, 1].abs() <= math.pi + 1e-5).all()),
             "median_abs_logq_gap": float(gap.median()),
             "max_abs_logq_gap": float(gap.max()),
             "mean_log_q": float(log_q.mean())}
        bar = LOGQ_F32 if dtype == "float32" else LOGQ_BF16
        results[dtype] = r
        if not (finite and r["circular_in_bounds"] and tuple(x.shape) == (N, 2)
                and r["median_abs_logq_gap"] <= bar):
            emit("main_path", ok=False, results=results)
            raise SystemExit(f"main path ({dtype}) failed its checks")
        if dtype == "float32":
            results["cpu"] = against_cpu(model, x)
    emit("main_path", ok=True, results=results,
         bars={"logq_f32": LOGQ_F32, "logq_bf16": LOGQ_BF16, "cpu": CPU_TOL})
    return model, launches


def against_cpu(model, x):
    """The same model on the CPU (plain spline, same weights) on 2^12 of the
    samples and on 2^12 base draws, f32."""
    cpu = build_flagship("cpu")
    cpu.load_state_dict(model.state_dict())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    with torch.inference_mode():
        xs = x[:N_CPU]
        lp_card = model.log_prob(xs).cpu()
        lp_cpu = cpu.log_prob(xs.cpu())
        z = model.q0.sample(N_CPU, generator=gen)
        xf_card, ld_card = model.forward_and_log_det(z)
        xf_cpu, ld_cpu = cpu.forward_and_log_det(z.cpu())
    r = {"excess_log_prob": excess(lp_card, lp_cpu, CPU_TOL, CPU_TOL),
         "max_abs_log_prob": float((lp_card - lp_cpu).abs().max()),
         "excess_forward_x": excess(xf_card.cpu(), xf_cpu, CPU_TOL, CPU_TOL),
         "max_abs_forward_x": float((xf_card.cpu() - xf_cpu).abs().max()),
         "excess_forward_ld": excess(ld_card.cpu(), ld_cpu, CPU_TOL, CPU_TOL),
         "max_abs_forward_ld": float((ld_card.cpu() - ld_cpu).abs().max())}
    if max(r["excess_log_prob"], r["excess_forward_x"], r["excess_forward_ld"]) > 0:
        emit("main_path", ok=False, cpu=r)
        raise SystemExit("the model on the card disagrees with the model on the CPU")
    return r


def phase_times(model):
    from normflows_tpu_torch.ops import spline_cuda as sc

    rng = np.random.default_rng(SEED + 2)
    # 16 input sets of 4.46 MB each (71 MB > the 50 MB L2): each launch reads
    # its inputs from device memory, as after the MADE's GEMM has moved on
    sets = [planar_inputs(rng, N) for _ in range(16)]
    kernel, call, plain = {}, {}, {}
    for inverse in (False, True):
        d = "inverse" if inverse else "forward"
        for times, fn, timer, reps in ((kernel, sc.rqs_transposed, graph_ms, 64),
                                       (call, sc.rqs_transposed, cuda_ms, 400),
                                       (plain, sc.rqs_transposed_reference, cuda_ms, 20)):
            rotation = itertools.cycle(sets)
            times[d] = timer(
                lambda: fn(*next(rotation), CODES, TAIL_BOUND, inverse), reps=reps)
    F, P = 2, 2 * (3 * BINS + 1)
    bytes_moved = (F + P + 2 * F) * N * 4  # x, params read once; y, ld written
    # per element: softmax max 2(K-1), exp-sum 6K, search 13K, slopes ~10,
    # rational-quadratic map ~30 operations
    ops = (2 * (BINS - 1) + 6 * BINS + 13 * BINS + 40) * F * N
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    emit("times_kernel", kernel_ms=kernel, call_ms=call, plain_ms=plain,
         bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, ops=ops, batch=N,
         note="kernel_ms: device time, 64 launches in one CUDA graph, inputs "
         "rotated through 71 MB; call_ms and plain_ms: CUDA events over a loop "
         "of calls (the wrapper's host work included)")
    return kernel, plain, bound_ms, bound_by


def phase_requests(model):
    from normflows_tpu_torch.utils import set_compute_dtype

    requests = {}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with torch.inference_mode():
            x, _ = model.sample(N, generator=gen)
            r = {}
            for what, fn in (("sample", lambda: model.sample(N, generator=gen)),
                             ("log_prob", lambda: model.log_prob(x))):
                ms = host_ms(fn, reps=20)
                prof = profile(fn)
                r[what] = {"ms": ms, "samples_per_s": N / (ms / 1e3), "profile": prof,
                           "busy_share_of_median": prof["device_ms"] / ms}
        requests[dtype] = r
    emit("times_requests", requests=requests, batch=N,
         note="ms: host median of 20 requests, each ending in a synchronise; "
         "profile: one request under torch.profiler, device time summed over "
         "its CUDA kernels, busy_share = that over the profiled wall time; "
         "busy_share_of_median: the same device time over the unprofiled median")
    return requests


def profile(fn, top=6):
    """One call under torch.profiler: wall time, device time of its kernels,
    their share of the wall time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a range named on the host (Optimizer.step#Adam.step) shows up on the
    # device too, spanning its kernels: count kernels only
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    heavy = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in heavy]}


def cotangents(rng, B):
    """ybar, lbar (2, B) from the numpy generator."""
    yb, lb = rng.normal(size=(2, 2, B)).astype(np.float32)
    return torch.from_numpy(yb).to(DEVICE), torch.from_numpy(lb).to(DEVICE)


def phase_kernel_backward():
    """The backward kernel against its plain version on the same CUDA
    tensors: B = 2^14 and 2^14 + 37, both directions, ~20% of the inputs
    outside the bounds, and one case whose derivative logits are all 0."""
    from normflows_tpu_torch.ops import spline_cuda as sc

    rng = np.random.default_rng(SEED + 3)
    errs = {}
    for B, zero_slopes in ((N, False), (N + 37, False), (N + 37, True)):
        for inverse in (False, True):
            x, p = planar_inputs(rng, B)
            if zero_slopes:
                p.view(2, 3 * BINS + 1, B)[:, 2 * BINS:] = 0.0
            yb, lb = cotangents(rng, B)
            dx, dp = sc.rqs_transposed_backward(x, p, yb, lb, CODES, TAIL_BOUND, inverse)
            sync()
            dxr, dpr = sc.rqs_transposed_backward_reference(
                x, p, yb, lb, CODES, TAIL_BOUND, inverse)
            d = "inverse" if inverse else "forward"
            e = {"max_abs_dx": float((dx - dxr).abs().max()),
                 "max_abs_dparams": float((dp - dpr).abs().max()),
                 "excess_dx": excess(dx, dxr, G_TOL, G_TOL),
                 "excess_dparams": excess(dp, dpr, G_TOL, G_TOL),
                 "finite": bool(torch.isfinite(dx).all() and torch.isfinite(dp).all())}
            errs[f"{d}_B{B}" + ("_zero_slopes" if zero_slopes else "")] = e
            if not e["finite"] or e["excess_dx"] > 0 or e["excess_dparams"] > 0:
                emit("kernel_backward", ok=False, errors=errs)
                raise SystemExit(f"backward kernel disagrees with its plain version "
                                 f"({d}, B={B}, zero slopes {zero_slopes})")
    emit("kernel_backward", ok=True, errors=errs, bars={"dx": [G_TOL, G_TOL],
                                                        "dparams": [G_TOL, G_TOL]})
    return errs


class Draws(torch.nn.Module):
    """Stands in for a model's base distribution: hands out one fixed draw
    ``(z, log_q)``, and the real base's log_prob."""

    def __init__(self, base, z, log_q):
        super().__init__()
        self.base = base
        self.z, self.log_q = z, log_q

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        return self.z.clone(), self.log_q.clone()

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


def reverse_kld_loss(num_samples):
    return lambda model, batch, generator: model.reverse_kld(num_samples,
                                                             generator=generator)


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch)


def drive_train(what, fn, fwd, bwd):
    """One training phase with both launch counts set to 0 just before it;
    fail unless the kernels ran exactly ``fwd`` and ``bwd`` times."""
    from normflows_tpu_torch.ops import spline_cuda

    spline_cuda.LAUNCHES = spline_cuda.BACKWARD_LAUNCHES = 0
    out = fn()
    sync()
    got = (spline_cuda.LAUNCHES, spline_cuda.BACKWARD_LAUNCHES)
    if got != (fwd, bwd):
        raise SystemExit(f"{what}: {got[0]} forward and {got[1]} backward kernel "
                         f"launches, expected {fwd} and {bwd}")
    return out, got


def phase_train_path():
    """(a) one f32 step on the card against the CPU, (b) exact launch counts
    of a reverse-KL and a forward-KL step at 2^14, (c) 200 bf16 steps from
    bench.py's init: finite, and the loss falls."""
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    results = {"card_vs_cpu": step_against_cpu()}
    launches = {"backward_forward": 0, "backward_inverse": 0}

    model = build_flagship(DEVICE, init_identity=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(N))
    (_, m), (fwd, bwd) = drive_train("reverse_kld step", lambda: step(state, None, gen),
                                     2 * LAYERS, 2 * LAYERS)
    launches["backward_inverse"] += bwd
    with torch.no_grad():
        x, _ = model.sample(N, generator=gen)
    fstate, fstep = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                    forward_kld_loss)
    (_, mf), (ffwd, fbwd) = drive_train("forward_kld step", lambda: fstep(fstate, x, gen),
                                        LAYERS, LAYERS)
    launches["backward_forward"] += fbwd
    results["launches_per_step"] = {
        "reverse_kld": {"forward": fwd, "backward": bwd, "loss": float(m["loss"])},
        "forward_kld": {"forward": ffwd, "backward": fbwd, "loss": float(mf["loss"])}}
    if not (m["finite"] and mf["finite"]):
        emit("train_path", ok=False, results=results)
        raise SystemExit("a full-width f32 training step gave a non-finite loss")

    model = set_compute_dtype(build_flagship(DEVICE, init_identity=True), "bfloat16")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(N))
    losses = []

    def train():
        for _ in range(TRAIN_STEPS):
            _, metrics = step(state, None, gen)
            losses.append(metrics["loss"])

    t0 = time.perf_counter()
    _, (tfwd, tbwd) = drive_train(f"{TRAIN_STEPS} bf16 steps", train,
                                  2 * LAYERS * TRAIN_STEPS, 2 * LAYERS * TRAIN_STEPS)
    seconds = time.perf_counter() - t0
    launches["backward_inverse"] += tbwd
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    results["bf16_training"] = {
        "steps": TRAIN_STEPS, "seconds": seconds, "all_finite": bool(np.isfinite(losses).all()),
        "mean_first_20": first, "mean_last_20": last, "max_loss": float(losses.max()),
        "max_loss_step": int(losses.argmax()), "losses": losses.tolist(),
        "forward_launches": tfwd, "backward_launches": tbwd}
    ok = results["bf16_training"]["all_finite"] and last < first
    emit("train_path", ok=ok, results=results,
         bars={"loss": [CPU_TOL, CPU_TOL], "gradient_norm": STEP_G_TOL})
    if not ok:
        raise SystemExit("bf16 training: a loss was not finite or the loss did not fall")
    return launches


def step_against_cpu():
    """One f32 reverse-KL step, make_train_step + Adam, on the card and on
    the CPU from the same weights and the same 2^12 base draws."""
    from normflows_tpu_torch.training import make_train_step

    card = build_flagship(DEVICE)
    cpu = build_flagship("cpu")
    cpu.load_state_dict(card.state_dict())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    z, log_q = card.q0.sample_and_log_prob(N_TRAIN_CPU, generator=gen)
    card.q0 = Draws(card.q0, z, log_q)
    cpu.q0 = Draws(cpu.q0, z.cpu(), log_q.cpu())
    out = {}
    for where, model in (("card", card), ("cpu", cpu)):
        state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                      reverse_kld_loss(N_TRAIN_CPU))
        t0 = time.perf_counter()
        _, metrics = step(state, None)
        if where == "card":
            sync()
        out[where] = (float(metrics["loss"]), time.perf_counter() - t0,
                      {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (loss_card, s_card, g_card), (loss_cpu, s_cpu, g_cpu) = out["card"], out["cpu"]
    rel = {n: float((g_card[n] - g_cpu[n]).norm() / (g_cpu[n].norm() + 1e-12))
           for n in g_cpu if float(g_cpu[n].norm()) > 0}
    worst = max(rel, key=rel.get)
    r = {"samples": N_TRAIN_CPU, "loss_card": loss_card, "loss_cpu": loss_cpu,
         "excess_loss": excess(torch.tensor(loss_card), torch.tensor(loss_cpu),
                               CPU_TOL, CPU_TOL),
         "leaves": len(g_cpu), "worst_leaf": worst, "worst_relative_norm": rel[worst],
         "zero_leaves_equal": all(bool((g_card[n] == 0).all()) for n in g_cpu
                                  if n not in rel),
         "seconds_card_first_step": s_card, "seconds_cpu": s_cpu}
    if r["excess_loss"] > 0 or rel[worst] > STEP_G_TOL or not r["zero_leaves_equal"]:
        emit("train_path", ok=False, card_vs_cpu=r)
        raise SystemExit("the training step on the card disagrees with the CPU")
    return r


def phase_times_train():
    """Step time and samples/s (host median of 20 steps, each ending in a
    synchronise), the profiler's view of one step, in f32 and bf16; and the
    backward kernel's own times at 2^14."""
    from normflows_tpu_torch.ops import spline_cuda as sc
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    model = build_flagship(DEVICE, init_identity=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    steps = {}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                      reverse_kld_loss(N))
        fn = lambda: step(state, None, gen)  # noqa: E731
        ms = host_ms(fn, reps=20)
        prof = profile(fn, top=8)
        steps[dtype] = {"ms": ms, "samples_per_s": N / (ms / 1e3), "profile": prof,
                        "busy_share_of_median": prof["device_ms"] / ms}

    rng = np.random.default_rng(SEED + 7)
    # 16 input sets of 4.33 MB read each (69 MB > the 50 MB L2)
    sets = [(*planar_inputs(rng, N), *cotangents(rng, N)) for _ in range(16)]
    kernel, call, plain = {}, {}, {}
    for inverse in (False, True):
        d = "inverse" if inverse else "forward"
        for times, fn, timer, reps in (
                (kernel, sc.rqs_transposed_backward, graph_ms, 64),
                (call, sc.rqs_transposed_backward, cuda_ms, 400),
                (plain, sc.rqs_transposed_backward_reference, cuda_ms, 20)):
            rotation = itertools.cycle(sets)
            times[d] = timer(
                lambda: fn(*next(rotation), CODES, TAIL_BOUND, inverse), reps=reps)
    F, P = 2, 2 * (3 * BINS + 1)
    # x, params, ybar, lbar read once; dx, dparams written once
    bytes_moved = (4 * F + 2 * P) * N * 4
    # per element: the forward's selection (~21 K + 28), the pull-back of
    # the rational-quadratic map (~130), the softmax scatter (~12 a bin and
    # logit row) and the slope scatter (~10 a knot)
    ops = (21 * BINS + 28 + 130 + 24 * BINS + 10 * (BINS + 1)) * F * N
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    emit("times_train", steps=steps, batch=N, backward_kernel={
        "kernel_ms": kernel, "call_ms": call, "plain_ms": plain, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": bytes_moved, "ops": ops},
        note="ms: host median of 20 reverse-KL + Adam steps from bench.py's init, "
        "each ending in a synchronise; profile: one step under torch.profiler; "
        "kernel_ms: device time, 64 launches in one CUDA graph, inputs rotated "
        "through 69 MB; call_ms and plain_ms: CUDA events over a loop of calls")
    return kernel, plain, bound_ms, bound_by


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import normflows_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port beside this script: {exc}",
              file=sys.stderr)
        return 2
    torch.manual_seed(SEED)

    smi = phase_device()
    phase_build()
    errs = phase_kernel()
    model, launches = phase_main_path()
    kernel_ms, plain_ms, bound_ms, bound_by = phase_times(model)
    phase_requests(model)
    del model
    bwd_errs = phase_kernel_backward()
    bwd_launches = phase_train_path()
    bwd_kernel_ms, bwd_plain_ms, bwd_bound_ms, bwd_bound_by = phase_times_train()

    kernels = []
    for d in ("forward", "inverse"):
        worst = [e for k, e in errs.items() if k.startswith(d)]
        kernels.append({
            "name": f"rqs_transposed_{d}",
            "route": "cuda",
            "source": "normflows_tpu_torch/csrc/rqs_transposed.cu",
            "replaces": "normflows_tpu/ops/spline_pallas.py:559",
            "launches": launches[d],
            "max_abs_err": max(e["max_abs_y"] for e in worst),
            "max_abs_err_logdet": max(e["max_abs_ld"] for e in worst),
            "ms": kernel_ms[d],
            "plain_ms": plain_ms[d],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    for d in ("forward", "inverse"):
        worst = [e for k, e in bwd_errs.items() if k.startswith(d)]
        kernels.append({
            "name": f"rqs_transposed_backward_{d}",
            "route": "cuda",
            "source": "normflows_tpu_torch/csrc/rqs_transposed.cu",
            "replaces": "normflows_tpu/ops/spline_pallas.py:591",
            "launches": bwd_launches[f"backward_{d}"],
            "max_abs_err": max(max(e["max_abs_dx"], e["max_abs_dparams"]) for e in worst),
            "max_abs_err_dx": max(e["max_abs_dx"] for e in worst),
            "max_abs_err_dparams": max(e["max_abs_dparams"] for e in worst),
            "ms": bwd_kernel_ms[d],
            "plain_ms": bwd_plain_ms[d],
            "bound_ms": bwd_bound_ms,
            "bound_by": bwd_bound_by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
