"""Device rule and kernel dispatch, in one place.

* Every constructor takes ``device=``, which defaults to ``"cuda"``;
  :func:`resolve_device` raises when CUDA is asked for and absent.  Nothing
  moves a tensor to the CPU on its own.
* A kernel wrapper asks :func:`use_kernel` about its input: a CPU tensor takes
  the kernel's plain PyTorch version, a CUDA tensor launches the kernel (or the
  wrapper raises).  There is no switch that sends a CUDA tensor to the plain
  version; a caller that wants it calls the plain function by name.
* Every kernel on a model's path is a ``torch.library`` operator of the
  namespace :data:`NAMESPACE` (:func:`kernel_op`): a CUDA implementation
  (the launch), a CPU implementation (the plain version), a fake one that
  gives the output shapes for a symbolic batch, and the op's autograd.  So
  ``torch.export`` keeps each launch as one opaque node; importing the
  module that registers an op is what a loaded program needs.
* The fused MADE (``ops/made_fused.py``) is opt-in, as in the JAX package:
  :func:`set_made_fusion` turns it on for every MADE whose pass passes
  ``made_fused.fusable``.  The flag picks the fused path, not the device:
  on a CUDA tensor that path launches the kernels, on a CPU tensor it runs
  their plain versions.
"""

from __future__ import annotations

import contextlib
import re

import torch

_MADE_FUSION = False
NAMESPACE = "normflows_tpu_torch"


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "normflows_tpu_torch: device='cuda' was requested but CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"normflows_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False on a
    build without CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def trace_graph(fn, *example):
    """``fn`` as an FX graph of ATen ops and the port's operators, traced on
    the real tensors ``example`` with grad mode off (``make_fx``), the
    tensors it reads held in the graph.  A gradient it takes
    (``torch.autograd.grad``) is traced into the graph's backward ops, so
    that an exported program can call it: ``torch.export`` cannot trace
    ``torch.autograd.grad`` (the program holds a fake constant), nor can the
    bodies of its loops (``scan``, ``while_loop``), which call such graphs
    instead.  The graph holds the shapes of ``example``, and any Python
    branch ``fn`` takes on their values."""
    from torch.fx.experimental.proxy_tensor import make_fx

    with torch.no_grad():  # varargs: make_fx would count fn's defaulted arguments
        return make_fx(lambda *args: fn(*args))(*example)


def count_launch(counts, backward: bool, inverse: bool):
    """Add one to ``counts[backward][inverse]`` on the device, when
    ``counts`` (a wrapper's ``DEVICE_LAUNCHES``: None, or an int64 (2, 2)
    tensor on the card) is set.  The add runs in the launch's stream: under
    a CUDA graph's capture it is captured beside the launch, so it counts
    every replay, where the Python counters tick only at the capture.  The
    tensor must outlive every graph captured while it was set."""
    if counts is not None:
        counts[int(backward), int(inverse)].add_(1)


def set_made_fusion(enabled: bool):
    """Turn the fused MADE on or off for every later MADE pass (off by
    default; the counterpart of ``set_made_fusion`` in the JAX package)."""
    global _MADE_FUSION
    _MADE_FUSION = bool(enabled)


def made_fusion_enabled() -> bool:
    return _MADE_FUSION


def kernel_op(name: str, schema: str, *, cpu, cuda, fake, backward=None,
              setup_context=None):
    """Register the operator ``NAMESPACE::name`` with
    ``torch.library.custom_op`` and return its overload.

    ``schema`` is its signature without the name, ``"(Tensor x, ...) ->
    (Tensor, Tensor)"`` (``Tensor(a!)`` for an argument the op writes in
    place).  ``cuda`` launches the kernel on CUDA tensors, ``cpu`` runs its
    plain version, ``fake`` returns empty outputs of the right shapes and
    reads no data.  With ``backward``, ``setup_context(ctx, inputs, output)``
    saves what ``backward(ctx, *grads)`` needs, and ``backward`` returns one
    gradient (or None) per input.  An implementation runs below autograd
    (see :func:`autograd_inside_op`)."""
    mutated = tuple(re.findall(r"Tensor\(a!\)\??\s+(\w+)", schema))
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=mutated,
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    if backward is not None:
        op.register_autograd(backward, setup_context=setup_context)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


_AUTOGRAD_KEYS = (torch._C.DispatchKey.AutogradCPU, torch._C.DispatchKey.AutogradCUDA,
                  torch._C.DispatchKey.AutogradOther, torch._C.DispatchKey.ADInplaceOrView)


@contextlib.contextmanager
def autograd_inside_op():
    """Autograd turned back on for the block, for an operator's plain
    implementation that takes ``torch.autograd.grad`` of a plain forward
    (the plain backward versions): the dispatcher runs an operator's
    implementation below its autograd, with autograd's dispatch keys
    excluded, so that its own ops record no graph.  (``torch.func.vjp``
    would need no private call, but ``torch.library.opcheck``'s schema test
    cannot read its wrapped tensors.)"""
    excluded = torch._C._dispatch_tls_local_exclude_set()
    for key in _AUTOGRAD_KEYS:
        excluded = excluded.remove(key)
    with torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                         excluded), torch.enable_grad():
        yield
