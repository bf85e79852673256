"""The port's ``utils.profiling`` and ``utils.cache`` on the CPU: ``Meter``,
``benchmark`` on the wall clock, ``trace`` / ``annotate`` as spans (no-ops
outside a profile, named ones inside), a Chrome trace written by
``capture``, ``chip_peak_flops`` NaN without a card, ``cost_report``'s FLOPs
of a known matmul, and ``enable_compilation_cache`` pointing the kernel
build directory (and refusing once a kernel library is loaded elsewhere)."""

import math
import os
from pathlib import Path

import pytest
import torch

from normflows_tpu_torch.ops import cuda_build
from normflows_tpu_torch.utils import cache, enable_compilation_cache, profiling


def test_meter():
    m = profiling.Meter(window=3)
    for i in range(5):
        m.update(10, loss=float(i))
    assert m.steps == 5 and m.last("loss") == 4.0
    assert m.mean("loss") == 2.0 and m.mean("loss", last_n=2) == 3.5
    assert m.rate > 0.0
    m.reset()
    assert m.rate == 0.0 and m.steps == 0


def test_benchmark_on_the_cpu():
    calls = []
    r = profiling.benchmark(lambda x: calls.append(x) or x * 2, torch.ones(3), iters=5,
                            warmup=2, items_per_call=3, device="cpu")
    assert len(calls) == 7 and r["iters"] == 5.0
    assert r["ms_per_iter"] > 0 and r["items_per_sec"] == pytest.approx(
        3 / (r["ms_per_iter"] / 1e3))


def test_trace_and_annotate_are_spans(tmp_path):
    @profiling.annotate("my_span")
    def f(x):
        """doc"""
        return x + 1

    assert f.__name__ == "f" and f.__doc__ == "doc"
    with profiling.trace("outside"), profiling.step_trace("step", 3):
        assert int(f(torch.ones(())) ) == 2  # no profile: a no-op span
    with profiling.capture(str(tmp_path)):
        with profiling.trace("inside"):
            f(torch.ones(4))
    files = list(Path(tmp_path).glob("trace_*.json"))
    assert len(files) == 1
    text = files[0].read_text()
    assert "inside" in text and "my_span" in text
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()


def test_chip_peak_flops_nan_on_the_cpu():
    assert math.isnan(profiling.chip_peak_flops("cpu"))
    if not torch.cuda.is_available():
        assert math.isnan(profiling.chip_peak_flops())


def test_cost_report_counts_a_matmul():
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    r = profiling.cost_report(torch.matmul, a, b)
    assert r["flops"] == 2 * 8 * 16 * 32
    assert r["bytes_accessed"] is None and r["arithmetic_intensity"] is None


def test_enable_compilation_cache_points_the_build(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    target = tmp_path / "kernels"
    assert enable_compilation_cache(str(target)) == str(target.resolve())
    assert cuda_build.BUILD_DIR == target.resolve() and target.is_dir()
    lib = cuda_build._target(cuda_build.CSRC / "rqs_transposed.cu")
    assert lib.parent == target.resolve()

    class Loaded:  # a library loaded from elsewhere
        _name = str(tmp_path / "elsewhere" / "libx.so")

    cuda_build._LIBS["x"] = Loaded()
    with pytest.raises(RuntimeError, match="already loaded"):
        enable_compilation_cache(str(target))
    monkeypatch.setenv("HOME", str(tmp_path))
    cuda_build._LIBS.clear()
    assert enable_compilation_cache() == os.path.join(str(tmp_path.resolve()), ".cache",
                                                      "normflows_tpu_torch")
    assert cache.enable_compilation_cache is enable_compilation_cache
