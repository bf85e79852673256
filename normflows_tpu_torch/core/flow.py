"""Bijector protocol and composition (port of ``normflows_tpu/core/flow.py``).

Every flow maps ``z`` of shape ``(batch, *event_shape)`` to a tensor of the
same shape plus a ``(batch,)`` log|det|.  ``forward`` is the latent -> data
(sampling) direction; ``inverse`` is data -> latent (density).  Flows are
``nn.Module``s, so ``flow(z)`` is ``flow.forward(z)``.

Both take ``generator=``, a ``torch.Generator``: the port's stand-in for the
JAX package's per-call ``key``.  A flow whose parameter net has dropout runs
it where a generator is passed (``utils.nn.net_dropout_active``); other
flows take it and do not use it.  ``NormalizingFlow`` passes it on by the
JAX package's rules (see ``core/facades.py``).
"""

from __future__ import annotations

import torch
from torch import nn


def zero_log_det_like_z(z):
    """(batch,) zeros matching z's batch dim, dtype and device."""
    return torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


def sum_except_batch(x, num_batch_dims: int = 1):
    """Sum over all but the leading batch dims."""
    dims = tuple(range(num_batch_dims, x.dim()))
    return x.sum(dim=dims) if dims else x


class Flow(nn.Module):
    """Abstract bijector: ``forward`` and ``inverse`` return ``(z_out, log_det)``."""

    def forward(self, z, context=None, *, generator=None):
        raise NotImplementedError("forward not implemented for this flow")

    def inverse(self, z, context=None, *, generator=None):
        raise NotImplementedError("inverse not implemented for this flow")

    def data_dep_init(self, z, context=None):
        """Data-dependent initialisation (ActNorm's) from a density-direction
        batch ``z``: sets this flow's tensors in place and returns its
        ``inverse`` of ``z``.  The default has nothing to set."""
        return self.inverse(z, context)[0]


def forward_data_dep_init(flow, z, context=None):
    """Data-dependent initialisation from a sampling-direction batch ``z``:
    the flow's ``data_dep_init_forward`` where it has one, else its
    ``forward``; returns the flow's output."""
    if hasattr(flow, "data_dep_init_forward"):
        return flow.data_dep_init_forward(z, context)
    return flow.forward(z, context)[0]


class Reverse(Flow):
    """Swap a flow's forward and inverse passes."""

    def __init__(self, flow: Flow):
        super().__init__()
        self.flow = flow

    def forward(self, z, context=None, *, generator=None):
        return self.flow.inverse(z, context, generator=generator)

    def inverse(self, z, context=None, *, generator=None):
        return self.flow.forward(z, context, generator=generator)

    def data_dep_init(self, z, context=None):
        return forward_data_dep_init(self.flow, z, context)


class Composite(Flow):
    """Chain of flows applied first-to-last in forward."""

    def __init__(self, flows):
        super().__init__()
        self.flows = nn.ModuleList(flows)

    def forward(self, z, context=None, *, generator=None):
        log_det = zero_log_det_like_z(z)
        for flow in self.flows:
            z, ld = flow.forward(z, context, generator=generator)
            log_det = log_det + ld
        return z, log_det

    def inverse(self, z, context=None, *, generator=None):
        log_det = zero_log_det_like_z(z)
        for flow in reversed(self.flows):
            z, ld = flow.inverse(z, context, generator=generator)
            log_det = log_det + ld
        return z, log_det

    def data_dep_init(self, z, context=None):
        for flow in reversed(self.flows):
            z = flow.data_dep_init(z, context)
        return z


class Identity(Flow):
    """No-op bijector."""

    def forward(self, z, context=None, *, generator=None):
        return z, zero_log_det_like_z(z)

    def inverse(self, z, context=None, *, generator=None):
        return z, zero_log_det_like_z(z)
