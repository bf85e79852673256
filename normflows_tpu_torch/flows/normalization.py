"""ActNorm and BatchNorm flows (port of ``normflows_tpu/flows/normalization.py``).

``ActNorm`` is an ``AffineConstFlow`` with a data-dependent initialisation,
run once, explicitly, before training (``NormalizingFlow.init_actnorm``,
``MultiscaleFlow.init_actnorm``), as in the JAX package, where the reference
initialises lazily on the first batch.  ``data_dep_init`` whitens a
density-direction batch, ``data_dep_init_forward`` a sampling-direction one;
both set ``s``, ``t`` and the bool buffer ``initialized`` in place.  The
statistics are taken over the batch and every axis where ``s`` is 1, the
std with ``ddof=1`` and the log-scale as log(std + 1e-6).
"""

from __future__ import annotations

import torch

from ..core.flow import Flow
from ..ops.backend import resolve_device
from .affine.coupling import AffineConstFlow


class ActNorm(AffineConstFlow):
    """``AffineConstFlow`` with ``data_dep_init`` / ``data_dep_init_forward``.

    ``initialized`` is data-dependent state, not a weight: ``interop``
    copies it from a JAX model (``state_buffers``)."""

    state_buffers = ("initialized",)

    def __init__(self, shape, *, device="cuda"):
        super().__init__(shape, device=device)
        self.register_buffer("initialized",
                             torch.zeros((), dtype=torch.bool, device=resolve_device(device)))

    @classmethod
    def create(cls, shape, *, device="cuda"):
        return cls(shape, device=device)

    def _batch_dims(self, z):
        """The batch axis and every axis where ``s`` broadcasts."""
        return (0, *(i + 1 for i, si in enumerate(self.s.shape[1:]) if si == 1))

    def _whiten(self, z, density: bool):
        dims = self._batch_dims(z)
        std = torch.std(z, dim=dims, keepdim=True, correction=1)
        mean = torch.mean(z, dim=dims, keepdim=True)
        with torch.no_grad():
            if density:
                self.s.copy_(torch.log(std + 1e-6))
                self.t.copy_(mean)
            else:
                s = -torch.log(std + 1e-6)
                self.s.copy_(s)
                self.t.copy_(-mean * torch.exp(s))
            self.initialized.fill_(True)

    def data_dep_init(self, z, context=None):
        """Whiten with a density-direction batch; returns ``inverse(z)``."""
        self._whiten(z, density=True)
        return self.inverse(z, context)[0]

    def data_dep_init_forward(self, z, context=None):
        """Whiten with a sampling-direction batch; returns ``forward(z)``."""
        self._whiten(z, density=False)
        return self.forward(z, context)[0]


class BatchNorm(Flow):
    """Whitening by the batch's statistics, forward only; the statistics
    carry no gradient (the reference's "without considering the
    derivatives of the batch statistics")."""

    def __init__(self, eps: float = 1e-10):
        super().__init__()
        self.eps = eps

    def forward(self, z, context=None, *, generator=None):
        with torch.no_grad():
            mean = torch.mean(z, dim=0, keepdim=True)
            std = torch.std(z, dim=0, keepdim=True, correction=1)
        var_eps = std**2 + self.eps
        z_ = (z - mean) / torch.sqrt(var_eps)
        return z_, (-0.5 * torch.sum(torch.log(var_eps))).expand(z.shape[0])
