"""Tracing, profiling and cost reporting (port of
``normflows_tpu/utils/profiling.py``).

* :func:`trace`, :func:`step_trace` and :func:`annotate`: named spans
  (``torch.profiler.record_function``) that show in a profile beside the
  kernels; outside a profile they cost a few microseconds and record nothing.
* :func:`start_trace` / :func:`stop_trace` / :func:`capture`: a
  ``torch.profiler.profile`` of the host and, on a card, the device, written
  as a Chrome trace into a log directory.
* :func:`chip_peak_flops`: the card's dense bf16 peak, for MFU ratios.
* :func:`cost_report`: a callable's FLOPs by
  ``torch.utils.flop_counter.FlopCounterMode``.
* :func:`benchmark`: ms a call, CUDA events on a card (wall clock on the
  CPU), each timed run fenced by ``torch.cuda.synchronize``.
* :class:`Meter`: a streaming samples/s and metric meter for training loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Mapping, Optional

import torch

# Dense bf16 tensor-core peak FLOP/s of a card, by a substring of
# torch.cuda.get_device_name (first match wins): NVIDIA's data sheets
PEAK_BF16_FLOPS = (
    ("H100 SXM", 989.4e12),
    ("H100 80GB HBM3", 989.4e12),  # the SXM part, as nvidia-smi names it
    ("H100 NVL", 835.5e12),
    ("H100 PCIe", 756.5e12),
)


def trace(name: str):
    """Context manager: a named span in the profile around the block."""
    return torch.profiler.record_function(name)


def step_trace(name: str, step_num: Optional[int] = None):
    """A step's span, ``name`` suffixed with ``step_num`` where given."""
    return torch.profiler.record_function(name if step_num is None else f"{name}#{step_num}")


def annotate(name: Optional[str] = None) -> Callable:
    """Decorator: run ``fn`` inside a span named ``name`` (default: its name)."""

    def deco(fn: Callable) -> Callable:
        label = name or getattr(fn, "__name__", "fn")

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", label)
        wrapped.__doc__ = fn.__doc__
        return wrapped

    return deco


_ACTIVE: list = []


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(logdir: str, **kwargs) -> None:
    """Begin a profile of the host and, on a card, the device; ``kwargs``
    go to ``torch.profiler.profile``.  :func:`stop_trace` writes it."""
    if _ACTIVE:
        raise RuntimeError("a trace is already running: stop_trace() first")
    prof = torch.profiler.profile(activities=_activities(), **kwargs)
    prof.start()
    _ACTIVE.append((prof, logdir))


def stop_trace() -> str:
    """End the running profile and write it as a Chrome trace into its
    ``logdir``; returns the file's path."""
    if not _ACTIVE:
        raise RuntimeError("no trace is running: start_trace(logdir) first")
    prof, logdir = _ACTIVE.pop()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def capture(logdir: str, **kwargs):
    """``with capture(logdir): step(...)``: a scoped start/stop_trace."""
    start_trace(logdir, **kwargs)
    try:
        yield
    finally:
        stop_trace()


def chip_peak_flops(device=None) -> float:
    """Dense bf16 peak FLOP/s of ``device`` (default: the current card), by
    its name; NaN on the CPU or an unknown card, so that an MFU ratio comes
    out NaN rather than against a wrong peak."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return float("nan")
    name = torch.cuda.get_device_name(device)
    for tag, peak in PEAK_BF16_FLOPS:
        if tag in name:
            return peak
    return float("nan")


def cost_report(fn: Callable, *args, **kwargs) -> Mapping[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode``: its
    ``flops`` (the matrix products and convolutions torch counts), by
    operator under ``by_operator``.  torch counts no memory traffic, so
    ``bytes_accessed`` and ``arithmetic_intensity`` are None."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": None,
            "arithmetic_intensity": None, "by_operator": by_op}


def _fence(device_type: str):
    if device_type == "cuda":
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              items_per_call: Optional[int] = None, device=None,
              **kwargs) -> Mapping[str, float]:
    """ms a call of ``fn(*args, **kwargs)`` over ``iters`` calls after
    ``warmup``: CUDA events where ``device`` (default: a card when there is
    one) is a card, the wall clock otherwise, fenced by a synchronise before
    and after.  With ``items_per_call`` (a batch size) it also gives
    ``items_per_sec``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    for _ in range(max(1, warmup)):
        fn(*args, **kwargs)
    _fence(kind)
    if kind == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        _fence(kind)
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    result = {"ms_per_iter": ms, "iters": float(iters)}
    if items_per_call:
        result["items_per_sec"] = items_per_call / (ms / 1e3)
    return result


class Meter:
    """Streaming samples/s and scalar metric meter for training loops.

    Host-side: call :meth:`update` after each step with the number of
    samples processed, read :attr:`rate` at any time; pass metric values
    only where the caller has synchronised anyway (every log interval)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.reset()

    def reset(self) -> None:
        self._times: list[float] = []
        self._counts: list[int] = []
        self.history: dict[str, list[float]] = {}
        self.steps = 0

    def update(self, num_items: int = 0, **metrics: float) -> None:
        now = time.perf_counter()
        self._times.append(now)
        self._counts.append(num_items)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._counts.pop(0)
        self.steps += 1
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))

    @property
    def rate(self) -> float:
        """Items/s over the trailing window."""
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        n = sum(self._counts[1:])
        return n / dt if dt > 0 else 0.0

    def last(self, name: str) -> float:
        return self.history[name][-1]

    def mean(self, name: str, last_n: Optional[int] = None) -> float:
        vals = self.history[name]
        if last_n:
            vals = vals[-last_n:]
        return sum(vals) / len(vals)
