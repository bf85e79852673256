"""Binary feature masks (port of ``normflows_tpu/utils/masks.py``).

Each returns a float32 tensor on the CPU, as the JAX package returns a
float32 array: the coupling layers read a mask on the host, to build their
index buffers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _midpoint(features: int) -> int:
    return features // 2 if features % 2 == 0 else features // 2 + 1


def create_alternating_binary_mask(features: int, even: bool = True) -> torch.Tensor:
    """1 at even (or, with ``even=False``, odd) positions."""
    idx = torch.arange(features)
    return ((idx % 2 == 0) if even else (idx % 2 == 1)).to(torch.float32)


def create_mid_split_binary_mask(features: int) -> torch.Tensor:
    """1 on the first half (rounded up) of the features."""
    return (torch.arange(features) < _midpoint(features)).to(torch.float32)


def create_random_binary_mask(features: int, generator: Optional[torch.Generator] = None,
                              seed: int = 0) -> torch.Tensor:
    """1 on a random half (rounded up) of the features.

    The permutation comes from ``generator`` or, without one, from numpy's
    ``default_rng(seed)``, where the JAX package draws it from
    ``jax.random.key(seed)``: the same seed gives another mask of the same
    kind."""
    if generator is not None:
        perm = torch.randperm(features, generator=generator)
    else:
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(features))
    mask = torch.zeros(features)
    mask[perm[:_midpoint(features)]] = 1.0
    return mask
