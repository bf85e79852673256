"""Permutation and LU-parameterised linear flows (port of ``_LULinear``,
``_Permutation``, ``_RandomPermutation`` and ``LULinearPermute`` in
``normflows_tpu/flows/mixing.py``).

As in the JAX package, the LU path never forms an inverse: the forward is two
triangular products, the inverse two triangular solves
(``torch.linalg.solve_triangular``), and the log-det reads off U's diagonal.
Tensor names are the JAX leaves' (``permutation.permutation``,
``linear.lower_entries``, ...), so that ``interop.load_jax_leaves`` carries a
JAX model across by name.  The permutation is drawn at random, from a
``torch.Generator`` here and from a JAX key there, so it is a buffer that
``load_jax_leaves`` copies rather than holds for equality.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import unset_fake_temporarily

from ..core.flow import Flow, zero_log_det_like_z
from ..ops import splines
from ..ops.backend import resolve_device


@functools.lru_cache(maxsize=None)
def _triangle_indices(n: int, device) -> tuple:
    """Row and column indices of the strictly lower and the strictly upper
    triangle of an (n, n) matrix, in numpy's ``tril_indices`` /
    ``triu_indices`` order (the JAX package's), on ``device``; made outside
    ``torch.export``'s fake tensors, so that an exported program holds them
    as constants."""
    with torch.inference_mode(False), unset_fake_temporarily():
        return tuple(torch.as_tensor(np.stack(idx), device=device)
                     for idx in (np.tril_indices(n, k=-1), np.triu_indices(n, k=1)))


class _LULinear(Flow):
    """LU-parameterised dense linear bijector with bias: ``forward`` applies
    W = L U (+ bias); ``inverse`` is two triangular solves.  L has a unit
    diagonal, U the diagonal softplus(d) + eps."""

    def __init__(self, features: int, identity_init: bool = True, eps: float = 1e-3, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        n_tri = (features - 1) * features // 2
        if identity_init:
            lower = torch.zeros(n_tri)
            upper = torch.zeros(n_tri)
            diag = torch.full((features,), float(np.log(np.exp(1 - eps) - 1)))
        else:
            stdv = 1.0 / np.sqrt(features)
            lower, upper, diag = (torch.empty(n).uniform_(-stdv, stdv, generator=generator)
                                  for n in (n_tri, n_tri, features))
        self.lower_entries = nn.Parameter(lower.to(device))
        self.upper_entries = nn.Parameter(upper.to(device))
        self.unconstrained_upper_diag = nn.Parameter(diag.to(device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.features = features
        self.eps = eps

    def _lower_upper(self):
        n = self.features
        (lr, lc), (ur, uc) = _triangle_indices(n, self.bias.device)
        eye = torch.eye(n, dtype=self.bias.dtype, device=self.bias.device)
        zeros = torch.zeros_like(eye)
        lower = zeros.index_put((lr, lc), self.lower_entries) + eye
        upper = zeros.index_put((ur, uc), self.upper_entries) + torch.diag(self.upper_diag)
        return lower, upper

    @property
    def upper_diag(self):
        return splines.softplus(self.unconstrained_upper_diag) + self.eps

    def logabsdet(self):
        return torch.sum(torch.log(self.upper_diag))

    def forward(self, z, context=None, *, generator=None):
        """outputs = L (U z) + bias."""
        lower, upper = self._lower_upper()
        out = z @ upper.T
        out = out @ lower.T + self.bias
        return out, self.logabsdet().expand(z.shape[0])

    def inverse(self, z, context=None, *, generator=None):
        lower, upper = self._lower_upper()
        rhs = (z - self.bias).T
        y = torch.linalg.solve_triangular(lower, rhs, upper=False, unitriangular=True)
        x = torch.linalg.solve_triangular(upper, y, upper=True)
        return x.T, (-self.logabsdet()).expand(z.shape[0])


class _Permutation(Flow):
    """Fixed index permutation on axis ``dim``."""

    def __init__(self, permutation: torch.Tensor, dim: int = 1):
        super().__init__()
        self.register_buffer("permutation", permutation)
        self.dim = dim

    def forward(self, z, context=None, *, generator=None):
        z = torch.index_select(z, self.dim, self.permutation)
        return z, zero_log_det_like_z(z)

    def inverse(self, z, context=None, *, generator=None):
        z = torch.index_select(z, self.dim, torch.argsort(self.permutation))
        return z, zero_log_det_like_z(z)


class _RandomPermutation(_Permutation):
    """A permutation drawn from ``generator``; ``load_jax_leaves`` copies it
    from a JAX model (whose key draws another one) rather than holding it
    for equality."""

    random_buffers = ("permutation",)

    def __init__(self, features: int, dim: int = 1, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        device = resolve_device(device)
        super().__init__(torch.randperm(features, generator=generator).to(device), dim)


class LULinearPermute(Flow):
    """Fixed permutation + LU linear, as in NSF models: ``forward`` (latent ->
    data) is the linear inverse then the permutation's inverse; ``inverse``
    the permutation then the linear."""

    def __init__(self, num_channels: int, identity_init: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.permutation = _RandomPermutation(num_channels, generator=generator,
                                              device=device)
        self.linear = _LULinear(num_channels, identity_init=identity_init,
                                generator=generator, device=device)

    @classmethod
    def create(cls, num_channels: int, identity_init: bool = True,
               generator: Optional[torch.Generator] = None, *, device="cuda"):
        """``generator`` draws the permutation and, without
        ``identity_init``, the LU entries (it takes the place of the JAX
        ``key``; ``None`` uses torch's default generator)."""
        return cls(num_channels, identity_init, generator=generator, device=device)

    def forward(self, z, context=None, *, generator=None):
        z, log_det = self.linear.inverse(z, context)
        z, _ = self.permutation.inverse(z, context)
        return z, log_det

    def inverse(self, z, context=None, *, generator=None):
        z, _ = self.permutation.forward(z, context)
        z, log_det = self.linear.forward(z, context)
        return z, log_det
