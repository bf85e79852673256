"""Mixed-precision control (port of ``normflows_tpu/utils/precision.py``).

Flows keep float32 state for invertibility; the parameter-net matmuls, where
the operations are, may run in bfloat16.  ``set_compute_dtype(model,
"bfloat16")`` sets the compute dtype of every ``Linear``, ``MaskedLinear``
and ``Conv2d`` in the model.  Unlike the JAX version, which returns a copy, it changes the
model in place (and returns it).  Every layer of a MADE is a ``Linear`` (the
first and final ``MaskedLinear`` and both of each residual block's), so a
MADE's layers always share one compute dtype, as the fused MADE's gate
(``ops/made_fused.fusable``) asks; ``"float32"`` is a dtype of its own
there, which that gate refuses, as the JAX package's does.
"""

from __future__ import annotations

import torch

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def set_compute_dtype(model, dtype):
    """``dtype``: "bfloat16", "float32", None (full precision) or a
    ``torch.dtype``.  Returns ``model``."""
    from ..nets.cnn import Conv2d
    from ..nets.mlp import Linear  # MaskedLinear is a Linear

    dt = dtype if isinstance(dtype, torch.dtype) else _DTYPES[dtype]
    for module in model.modules():
        if isinstance(module, (Linear, Conv2d)):
            module.compute_dtype = dt
    return model
