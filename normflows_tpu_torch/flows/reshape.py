"""Feature-splitting and squeeze flows (port of
``normflows_tpu/flows/reshape.py``): ``Split``, ``Merge`` and ``Squeeze``.

The checkerboard split gathers the elements of one parity of the summed
trailing indices (the reference's parity recursion) with index tensors made
once per event shape; its inverse scatters them back.  Like the JAX
package's, it asks for an even last dimension.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

from ..core.flow import Flow, zero_log_det_like_z

MODES = ("channel", "channel_inv", "checkerboard", "checkerboard_inv")


@functools.lru_cache(maxsize=None)
def _checkerboard(event_shape: tuple, mode: str, device) -> tuple:
    """``(idx1, idx2, scatter)`` on ``device`` for a flattened event of
    ``event_shape``: ``z1`` takes the odd-parity elements (the even ones with
    ``"checkerboard_inv"``), ``z2`` the rest, and ``cat([z1, z2])[:,
    scatter]`` puts them back.  Made outside ``torch.export``'s fake
    tensors, so that an exported program holds them as constants."""
    parity = (np.sum(np.indices(event_shape), axis=0) % 2).reshape(-1)
    sel = 0 if "inv" in mode else 1
    idx1 = np.nonzero(parity == sel)[0]
    idx2 = np.nonzero(parity == 1 - sel)[0]
    scatter = np.zeros(parity.size, dtype=np.int64)
    scatter[idx1] = np.arange(idx1.size)
    scatter[idx2] = idx1.size + np.arange(idx2.size)
    with torch.inference_mode(False), unset_fake_temporarily():
        return tuple(torch.as_tensor(a, device=device) for a in (idx1, idx2, scatter))


class Split(Flow):
    """Split features into two sets; forward: z -> [z1, z2].

    Modes: ``"channel"`` (z1 the first ceil(C/2) of axis 1), ``"channel_inv"``
    (the halves swapped), ``"checkerboard"`` and ``"checkerboard_inv"``."""

    def __init__(self, mode: str = "channel"):
        super().__init__()
        if mode not in MODES:
            raise NotImplementedError(f"Mode {mode} is not implemented.")
        self.mode = mode

    def forward(self, z, context=None, *, generator=None):
        if self.mode in ("channel", "channel_inv"):
            h = (z.shape[1] + 1) // 2
            first, second = z[:, :h], z[:, h:]
            z1, z2 = (first, second) if self.mode == "channel" else (second, first)
        else:
            idx1, idx2, _ = _checkerboard(tuple(z.shape[1:]), self.mode, z.device)
            z_flat = z.reshape(z.shape[0], -1)
            z1 = z_flat[:, idx1].reshape(*z.shape[:-1], -1)
            z2 = z_flat[:, idx2].reshape(*z.shape[:-1], -1)
        return [z1, z2], zero_log_det_like_z(z)

    def inverse(self, zpair, context=None, *, generator=None):
        z1, z2 = zpair
        if self.mode == "channel":
            z = torch.cat([z1, z2], dim=1)
        elif self.mode == "channel_inv":
            z = torch.cat([z2, z1], dim=1)
        else:
            shape = (*z1.shape[:-1], 2 * z1.shape[-1])
            _, _, scatter = _checkerboard(tuple(shape[1:]), self.mode, z1.device)
            z_flat = torch.cat([z1.reshape(z1.shape[0], -1), z2.reshape(z2.shape[0], -1)],
                               dim=1)
            z = z_flat[:, scatter].reshape(shape)
        return z, zero_log_det_like_z(z)


class Merge(Split):
    """``Split`` with forward and inverse interchanged."""

    def forward(self, z, context=None, *, generator=None):
        return super().inverse(z, context)

    def inverse(self, z, context=None, *, generator=None):
        return super().forward(z, context)


class Squeeze(Flow):
    """Glow's multiscale squeeze on NCHW tensors: ``forward`` (sampling) is
    depth-to-space, (C, H, W) -> (C/4, 2H, 2W); ``inverse`` (density) is
    space-to-depth, each 2 x 2 block into 4 channels."""

    def forward(self, z, context=None, *, generator=None):
        b, c, h, w = z.shape
        z = z.reshape(b, c // 4, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
        z = z.reshape(b, c // 4, 2 * h, 2 * w)
        return z, zero_log_det_like_z(z)

    def inverse(self, z, context=None, *, generator=None):
        b, c, h, w = z.shape
        z = z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
        z = z.reshape(b, 4 * c, h // 2, w // 2)
        return z, zero_log_det_like_z(z)
