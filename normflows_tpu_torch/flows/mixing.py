"""Permutations and invertible linear flows (port of
``normflows_tpu/flows/mixing.py``): ``Permute``, Glow's
``Invertible1x1Conv`` and the 1-D ``InvertibleAffine`` (dense or LU), and
``_LULinear``, ``_Permutation``, ``_RandomPermutation`` and
``LULinearPermute``.

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


class Permute(Flow):
    """Channel permutation along axis 1: ``"shuffle"`` (a fixed random one,
    drawn from ``generator``) or ``"swap"`` (the two halves exchanged)."""

    random_buffers = ("perm", "inv_perm")

    def __init__(self, num_channels: int, mode: str = "shuffle", *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if mode not in ("shuffle", "swap"):
            raise NotImplementedError(f"The mode {mode} is not implemented.")
        device = resolve_device(device)
        perm = inv_perm = None
        if mode == "shuffle":
            perm = torch.randperm(num_channels, generator=generator).to(device)
            inv_perm = torch.argsort(perm)
        self.register_buffer("perm", perm)
        self.register_buffer("inv_perm", inv_perm)
        self.num_channels = num_channels
        self.mode = mode

    @classmethod
    def create(cls, num_channels: int, mode: str = "shuffle",
               generator: Optional[torch.Generator] = None, *, device="cuda"):
        return cls(num_channels, mode, generator=generator, device=device)

    def forward(self, z, context=None, *, generator=None):
        if self.mode == "shuffle":
            z = torch.index_select(z, 1, self.perm)
        else:
            h = self.num_channels // 2
            z = torch.cat([z[:, h:], z[:, :h]], dim=1)
        return z, zero_log_det_like_z(z)

    def inverse(self, z, context=None, *, generator=None):
        if self.mode == "shuffle":
            z = torch.index_select(z, 1, self.inv_perm)
        else:
            h = (self.num_channels + 1) // 2
            z = torch.cat([z[:, h:], z[:, :h]], dim=1)
        return z, zero_log_det_like_z(z)


def _channel_matmul(W, z):
    """(C, C) ``W`` applied over the channel axis of an NCHW or NC tensor."""
    if z.dim() == 2:
        return z @ W.T
    return torch.einsum("ij,bj...->bi...", W, z)


def _tri_solve_channel(L, U, z):
    """Solve (L U) x = z over the channel axis (NCHW or NC): two
    triangular solves on the (C, B*H*W) right-hand side."""
    if z.dim() == 2:
        rhs = z.T
    else:
        rhs = z.movedim(1, 0).reshape(z.shape[1], -1)
    y = torch.linalg.solve_triangular(L, rhs, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(U, y, upper=True)
    if z.dim() == 2:
        return x.T
    return x.reshape(z.shape[1], z.shape[0], *z.shape[2:]).movedim(0, 1)


class _LUConvBase(Flow):
    """An invertible (C, C) matrix W over the channel axis, dense (``W``) or
    as W = P L U (``use_lu``: ``P`` a permutation, ``L`` unit lower, ``U``
    strictly upper plus the diagonal sign_S exp(log_S)), drawn as a random
    orthogonal matrix.  ``forward`` (sampling) applies W^-1 (two triangular
    solves with LU), ``inverse`` (density) applies W; the log-det counts
    every spatial position.

    ``P`` and ``sign_S`` are buffers that the LU factorisation of a random
    matrix makes: ``interop`` copies them from a JAX model.  Without LU the
    weight ``W`` is the only tensor; with LU there is none named ``W``."""

    random_buffers = ("P", "sign_S")

    def __init__(self, num_channels: int, use_lu: bool = False, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        Q = torch.linalg.qr(torch.randn(num_channels, num_channels, generator=generator))[0]
        self.num_channels, self.use_lu = num_channels, use_lu
        if use_lu:
            P, L, U = torch.linalg.lu(Q)
            S = torch.diagonal(U)
            self.register_buffer("P", P.to(device))
            self.L = nn.Parameter(L.to(device))
            self.register_buffer("sign_S", torch.sign(S).to(device))
            self.log_S = nn.Parameter(torch.log(torch.abs(S)).to(device))
            self.U = nn.Parameter(torch.triu(U, diagonal=1).to(device))
        else:
            self.W = nn.Parameter(Q.to(device))

    @classmethod
    def create(cls, num_channels: int, use_lu: bool = False,
               generator: Optional[torch.Generator] = None, *, device="cuda"):
        """``generator`` draws the random orthogonal init (the JAX ``key``)."""
        return cls(num_channels, use_lu, generator=generator, device=device)

    def _lu_factors(self):
        eye = torch.eye(self.num_channels, dtype=self.L.dtype, device=self.L.device)
        L = torch.tril(self.L, diagonal=-1) + eye
        U = torch.triu(self.U, diagonal=1) + torch.diag(self.sign_S * torch.exp(self.log_S))
        return L, U

    def _weight(self):
        """W and log|det W|."""
        if self.use_lu:
            L, U = self._lu_factors()
            return self.P @ L @ U, torch.sum(self.log_S)
        return self.W, torch.linalg.slogdet(self.W)[1]

    @staticmethod
    def _spatial(z):
        n = 1
        for s in z.shape[2:]:
            n *= s
        return float(n)

    def _apply_forward(self, z):
        """W^-1 z and its log-det (sampling direction)."""
        if self.use_lu:
            L, U = self._lu_factors()
            # W = P L U, so W^-1 z = U^-1 L^-1 P^T z
            z_ = _tri_solve_channel(L, U, _channel_matmul(self.P.T, z))
            log_det = -torch.sum(self.log_S)
        else:
            z_ = _channel_matmul(torch.linalg.inv_ex(self.W).inverse, z)
            log_det = -torch.linalg.slogdet(self.W)[1]
        return z_, log_det * self._spatial(z_)

    def _apply_inverse(self, z):
        """W z and its log-det (density direction)."""
        W, log_det = self._weight()
        z_ = _channel_matmul(W, z)
        return z_, log_det * self._spatial(z_)


class Invertible1x1Conv(_LUConvBase):
    """Glow's invertible 1x1 convolution on NCHW tensors."""

    def forward(self, z, context=None, *, generator=None):
        z_, log_det = self._apply_forward(z)
        return z_, log_det.expand(z.shape[0])

    def inverse(self, z, context=None, *, generator=None):
        z_, log_det = self._apply_inverse(z)
        return z_, log_det.expand(z.shape[0])


class InvertibleAffine(_LUConvBase):
    """The 1-D invertible linear map x -> x W (right multiplication, as the
    reference): ``inverse`` (density) applies W, ``forward`` solves for
    W^-1."""

    def __init__(self, num_channels: int, use_lu: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(num_channels, use_lu, generator=generator, device=device)

    @classmethod
    def create(cls, num_channels: int, use_lu: bool = True,
               generator: Optional[torch.Generator] = None, *, device="cuda"):
        return cls(num_channels, use_lu, generator=generator, device=device)

    def forward(self, z, context=None, *, generator=None):
        W, log_det = self._weight()
        z_ = torch.linalg.solve(W.T, z.T).T
        return z_, (-log_det).expand(z.shape[0])

    def inverse(self, z, context=None, *, generator=None):
        W, log_det = self._weight()
        return z @ W, log_det.expand(z.shape[0])


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
