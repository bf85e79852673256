"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and becomes one shared
library in ``normflows_tpu_torch/_build/`` (listed in ``.gitignore``), built
for ``sm_90a`` at first use.  A library's name carries a hash of its source,
of every header in ``csrc/`` and of the flags, so an edit builds anew.
:func:`build` starts one ``nvcc`` for each source that needs it, all at
once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
# no --use_fast_math / -ftz=true: the kernels' 1e-38 guard is a subnormal
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(source: Path) -> Path:
    """The library that ``source`` builds into."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(sources, force: bool = False) -> dict:
    """Compile every source of ``sources`` whose library is missing (all of
    them with ``force``), one ``nvcc`` each, started together.

    Returns ``{source: {"path", "seconds", "ptxas"}}``; ``ptxas`` holds the
    compiler's register / shared-memory / spill report of a fresh build (""
    otherwise) and ``seconds`` its wall time."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for source in map(Path, sources):
        lib = _target(source)
        if lib.exists() and not force:
            out[source] = {"path": lib, "seconds": 0.0, "ptxas": ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((source, lib, tmp, proc, time.perf_counter()))
    failed = []
    for source, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{source.name}: nvcc failed with code {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
        ptxas = "\n".join(line.strip() for line in log.splitlines()
                          if "ptxas" in line or "spill" in line)
        out[source] = {"path": lib, "seconds": seconds, "ptxas": ptxas}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(source: Path, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if need be, with the
    ``argtypes`` of ``signatures`` (``{function name: argtypes}``) set and
    an ``int`` result (the CUDA error code)."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build([source])[source]["path"]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib
