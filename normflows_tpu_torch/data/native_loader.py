"""ctypes binding and Python API of the native C++ data pipeline (port of
``normflows_tpu/data/native_loader.py``).

The shared library (``csrc/nf_dataloader.cpp`` of this package, a copy of
the JAX package's: the same producer) is compiled on first use with ``g++
-O3 -std=c++17 -shared -fPIC -pthread`` into ``_build/`` (listed in
``.gitignore``), its name keyed by a hash of the source and the flags, as
``ops.cuda_build`` keys the kernels.  A build that fails raises with the
compiler's output: there is no silent fallback.  The plain numpy producer
runs only when asked (``force_numpy=True``); it is the JAX package's numpy
path, so the two packages' plain batches agree bit for bit as well.

Transform semantics match the reference dataloader stack (reference
utils/preprocessing.py:4-57): ``x -> x/255 * scale + U(0, 1/256)`` then
``logit(alpha + (1 - alpha) x)``.

:func:`prefetch_to_device` stands where the JAX package calls
``jax.device_put``: on a card it copies each batch into pinned host memory
and from there to the card with ``non_blocking=True`` on a copy stream,
``size`` batches in flight, each with an event that the consuming stream
waits on.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.backend import resolve_device
from ..ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "nf_dataloader.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIBS: dict = {}


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(("g++", *GXX_FLAGS)).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def _build(source: Path) -> Path:
    """Compile ``source`` unless its library exists; a failed build raises
    with the compiler's output."""
    lib = _target(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"the native data loader needs g++ to build {source}: {exc}") \
            from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native data loader failed ({' '.join(cmd)}), "
                           f"code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib


def _library() -> ctypes.CDLL:
    """The loaded library of :data:`SOURCE`, built first if need be."""
    source = Path(SOURCE)
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(_build(source)))
        lib.nf_loader_create.restype = ctypes.c_void_p
        lib.nf_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int,
        ]
        lib.nf_loader_next.restype = ctypes.c_int64
        lib.nf_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p]
        lib.nf_loader_batches_per_epoch.restype = ctypes.c_int64
        lib.nf_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.nf_loader_destroy.restype = None
        lib.nf_loader_destroy.argtypes = [ctypes.c_void_p]
        _LIBS[source] = lib
        return lib


def native_available() -> bool:
    """True if the C++ pipeline builds and loads here (building it if need
    be); :class:`NativeImageLoader` raises the build's error itself."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


class NativeImageLoader:
    """Multithreaded image-batch pipeline over an in-memory uint8 dataset.

    Parameters mirror the reference's DataLoader + transform stack:

    Args:
        images: uint8 array or CPU tensor ``(n, ...)`` (e.g. ``(n, C, H, W)``).
        labels: optional integer array or tensor ``(n,)``.
        batch_size: items per batch.
        shuffle: per-epoch Fisher-Yates shuffle (deterministic in ``seed``).
        seed: RNG seed; batches are bit-identical for a given
            (seed, epoch, batch index) regardless of thread count.
        num_workers: producer threads (native path only).
        scale / jitter / logit / alpha: the dequantization transform
            ``logit(alpha + (1-alpha) * (u8/255 * scale + U(0,1/256)))``;
            disable pieces to get raw normalized batches.
        prefetch: bounded queue depth of pre-transformed batches.
        force_numpy: run the plain numpy producer (the JAX package's), which
            shuffles and jitters with numpy's generators, single-threaded.

    Iterating yields ``(x, y, epoch)`` with ``x`` a float32 CPU tensor
    ``(batch, ...)`` and ``y`` an int64 one or None: an infinite stream over
    reshuffled epochs (take ``batches_per_epoch`` steps for one epoch).
    """

    def __init__(self, images, labels=None, batch_size: int = 128, *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, scale: float = 255.0 / 256.0,
                 jitter: bool = True, logit: bool = True, alpha: float = 0.05,
                 prefetch: int = 4, force_numpy: bool = False):
        images = np.asarray(images)
        if images.dtype != np.uint8:
            raise TypeError(f"images must be uint8, not {images.dtype}")
        images = np.ascontiguousarray(images)
        if labels is not None:
            labels = np.ascontiguousarray(np.asarray(labels), dtype=np.int64)
            if labels.shape[0] != images.shape[0]:
                raise ValueError("labels/images length mismatch")
        if images.shape[0] < batch_size:
            raise ValueError("dataset smaller than one batch")
        self._images = images  # keep alive: the native side borrows the buffer
        self._labels = labels
        self.item_shape = images.shape[1:]
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.scale = float(scale)
        self.jitter = bool(jitter)
        self.logit = bool(logit)
        self.alpha = float(alpha)
        self.batches_per_epoch = images.shape[0] // self.batch_size
        self._handle = None
        self._lib = None if force_numpy else _library()
        if self._lib is not None:
            self._handle = self._lib.nf_loader_create(
                images.ctypes.data_as(ctypes.c_void_p),
                labels.ctypes.data_as(ctypes.c_void_p) if labels is not None else None,
                images.shape[0], int(np.prod(self.item_shape)), self.batch_size,
                self.seed, int(num_workers), int(self.shuffle), 1,
                self.scale, int(self.jitter), int(self.logit), self.alpha,
                int(prefetch),
            )
            if not self._handle:
                raise RuntimeError("nf_loader_create refused its arguments")
        self._np_ticket = 0  # the numpy producer's position

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    # ---------------------------------------------------------- numpy path
    def _np_batch(self, ticket: int):
        epoch, bidx = divmod(ticket, self.batches_per_epoch)
        rng = np.random.default_rng((self.seed, epoch, 0xA5A5A5A5))
        perm = (rng.permutation(self._images.shape[0]) if self.shuffle
                else np.arange(self._images.shape[0]))
        rows = perm[bidx * self.batch_size:(bidx + 1) * self.batch_size]
        x = self._images[rows].astype(np.float64) / 255.0 * self.scale
        if self.jitter:
            jrng = np.random.default_rng((self.seed, epoch, bidx + 17))
            x = x + jrng.random(x.shape) / 256.0
        if self.logit:
            xp = self.alpha + (1.0 - self.alpha) * x
            x = np.log(xp / (1.0 - xp))
        y = torch.from_numpy(self._labels[rows]) if self._labels is not None else None
        return torch.from_numpy(x.astype(np.float32)), y, epoch

    # ---------------------------------------------------------- native path
    def _native_batch(self):
        x = torch.empty((self.batch_size, *self.item_shape), dtype=torch.float32)
        y = (torch.empty((self.batch_size,), dtype=torch.int64)
             if self._labels is not None else None)
        epoch = ctypes.c_int64(0)
        count = self._lib.nf_loader_next(
            self._handle, ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(y.data_ptr()) if y is not None else None,
            ctypes.byref(epoch))
        if count < 0:
            raise StopIteration
        return x, y, int(epoch.value)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, Optional[torch.Tensor], int]]:
        return self

    def __next__(self):
        if self._handle is not None:
            return self._native_batch()
        out = self._np_batch(self._np_ticket)
        self._np_ticket += 1
        return out

    def close(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.nf_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def prefetch_to_device(iterator, size: int = 2, device="cuda", mesh=None):
    """Overlap host batch production with the copies to the device.

    Wraps any iterator of ``(x, y, epoch)`` host batches (e.g.
    :class:`NativeImageLoader`; ``y`` may be None) and yields them on
    ``device``.  On a card, ``size`` batches are in flight: each is copied
    into a pinned host buffer, then to the card with ``non_blocking=True``
    on a copy stream, and an event recorded after the copy is waited on by
    the stream that is current when the batch is yielded (the device
    tensors are recorded on that stream for the allocator).  A pinned
    buffer is written again only after its last copy's event has completed.
    On the CPU the batches pass through, with no pinning and no stream.

    With ``mesh`` (``parallel.make_mesh``), each rank receives its own rows
    of every global batch, labels included, as ``parallel.shard_batch``
    gives them along ``"data"``; only those rows are copied."""
    from ..parallel.mesh import shard_batch

    device = resolve_device(device)
    if size < 1:
        raise ValueError(f"size must be at least 1, got {size}")

    def local(t):
        if t is None:
            return None
        t = torch.as_tensor(t)
        return t if mesh is None else shard_batch(t, mesh)

    it = iter(iterator)
    if device.type != "cuda":
        for x, y, epoch in it:
            yield local(x).to(device), None if y is None else local(y).to(device), epoch
        return

    stream = torch.cuda.Stream(device)
    slots = [{"pinned": [], "event": None} for _ in range(size)]
    queue = collections.deque()
    count = 0

    def put(batch):
        nonlocal count
        x, y, epoch = batch
        slot = slots[count % size]
        count += 1
        if slot["event"] is not None:
            slot["event"].synchronize()  # its buffers' last copy is done
        host = [local(t) for t in (x, y) if t is not None]
        pinned = slot["pinned"]
        if [(p.shape, p.dtype) for p in pinned] != [(t.shape, t.dtype) for t in host]:
            pinned[:] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in host]
        for p, t in zip(pinned, host):
            p.copy_(t)
        with torch.cuda.stream(stream):
            out = [p.to(device, non_blocking=True) for p in pinned]
            slot["event"] = torch.cuda.Event()
            slot["event"].record(stream)
        queue.append((out, y is not None, epoch, slot["event"]))

    def take():
        out, labelled, epoch, event = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for t in out:
            t.record_stream(consumer)
        return out[0], out[1] if labelled else None, epoch

    try:
        while True:
            while len(queue) < size:
                put(next(it))
            yield take()
    except StopIteration:
        while queue:
            yield take()
