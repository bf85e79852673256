"""Data loading (port of ``normflows_tpu.data``): the native (C++) image
pipeline and the copies to the card.

A multithreaded C++ producer (shuffle, dequantisation jitter, logit) makes
float32 host batches off the Python thread, and ``prefetch_to_device`` copies
them to the card from pinned memory on a copy stream, ahead of the step that
takes them.
"""

from .native_loader import NativeImageLoader, native_available, prefetch_to_device

__all__ = ["NativeImageLoader", "native_available", "prefetch_to_device"]
