"""Device rule and kernel dispatch, in one place.

* Every constructor takes ``device=``, which defaults to ``"cuda"``;
  :func:`resolve_device` raises when CUDA is asked for and absent.  Nothing
  moves a tensor to the CPU on its own.
* A kernel wrapper asks :func:`use_kernel` about its input: a CPU tensor takes
  the kernel's plain PyTorch version, a CUDA tensor launches the kernel (or the
  wrapper raises).  There is no switch that sends a CUDA tensor to the plain
  version; a caller that wants it calls the plain function by name.
* The fused MADE (``ops/made_fused.py``) is opt-in, as in the JAX package:
  :func:`set_made_fusion` turns it on for every MADE whose pass passes
  ``made_fused.fusable``.  The flag picks the fused path, not the device:
  on a CUDA tensor that path launches the kernels, on a CPU tensor it runs
  their plain versions.
"""

from __future__ import annotations

import torch

_MADE_FUSION = False


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
