"""Base distributions (port of ``normflows_tpu/distributions/base.py``):
``BaseDistribution``, ``DiagGaussian``, ``ConditionalDiagGaussian``,
``Uniform``, ``UniformGaussian``, and the class-conditional
``ClassCondDiagGaussian`` and ``GlowBase`` of the multiscale image models
(their context is a label vector, or a one-hot / soft (B, C) batch), and
``AffineGaussian``, ``GaussianMixture`` and ``GaussianPCA``.

Sampling draws from an explicit ``torch.Generator`` (``generator=``, on the
distribution's device; ``None`` uses torch's default generator), where the
JAX package takes a PRNG key.  Contract:

    sample_and_log_prob(num_samples, context=None, *, generator=None) -> (z, log_p)
    log_prob(z, context=None) -> (batch,)
    sample(num_samples, context=None, *, generator=None) -> z

Each base splits a draw from its transform:
``noise_spec`` names each index of its noise (``noise_shape``, the event's
shape unless a base says otherwise) by its unit draw (``"normal"``, or
``"uniform"`` on [0, 1)), :func:`draw_noise` draws it, and
``from_noise(eps) -> (z, log_p)`` maps it; ``sample_and_log_prob`` is the
two in turn.  A program that takes the noise as its input (the exported
sampler of ``serving``) gives the samples of a generator's draws.  A
class-conditional base given no labels draws them first
(:func:`draw_labels`), then the noise.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.backend import resolve_device

LOG2PI = math.log(2.0 * math.pi)


def _tuple_shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def draw_noise(noise_spec, event_shape, num_samples: int, *,
               generator: Optional[torch.Generator] = None, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Unit draws (num_samples, *event_shape) by ``noise_spec``, one entry
    per event index (row-major): ``torch.rand`` for the ``"uniform"``
    indices, then ``torch.randn`` for the ``"normal"`` ones, each from
    ``generator`` as one (num_samples, count) draw, placed at their indices
    in ascending order."""
    spec = list(noise_spec)
    if set(spec) - {"normal", "uniform"}:
        raise ValueError(f"noise_spec entries are 'normal' or 'uniform', got {spec}")
    shape = (num_samples, *event_shape)
    kw = dict(generator=generator, dtype=dtype, device=device)
    if "uniform" not in spec:
        return torch.randn(shape, **kw)
    if "normal" not in spec:
        return torch.rand(shape, **kw)
    uniform = [i for i, k in enumerate(spec) if k == "uniform"]
    normal = [i for i, k in enumerate(spec) if k == "normal"]
    u = torch.rand(num_samples, len(uniform), **kw)
    g = torch.randn(num_samples, len(normal), **kw)
    # columns placed by slicing, no index tensor: no host-to-device copy,
    # which a CUDA graph's capture (a chunk's reverse-KL step) refuses
    columns = {**{i: u[:, k] for k, i in enumerate(uniform)},
               **{i: g[:, k] for k, i in enumerate(normal)}}
    return torch.stack([columns[i] for i in range(len(spec))], dim=-1).reshape(shape)


def draw_one(kind: str, shape, params=(), *, generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device="cpu") -> torch.Tensor:
    """One draw of ``shape`` from ``generator``: ``"normal"``, ``"uniform"``
    (on [0, 1)), ``"geometric"`` (on {1, 2, ...}, ``params = (p,)``, in the
    default dtype) or ``"poisson"`` (``params = (rate,)``, float32)."""
    shape = tuple(shape)
    if kind == "normal":
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    if kind == "uniform":
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)
    if kind == "geometric":
        return torch.empty(shape, device=device).geometric_(params[0], generator=generator)
    if kind == "poisson":
        rate = torch.full(shape, params[0], dtype=torch.float32, device=device)
        return torch.poisson(rate, generator=generator)
    raise ValueError(f"a draw is 'normal', 'uniform', 'geometric' or 'poisson', not {kind!r}")


def draw_layout(layout: dict, *, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cpu") -> tuple:
    """The draws of one drawing flow layer or of a sampler's rungs, by its
    ``layout`` (what a serving manifest records): ``layout["draws"]``, a
    list of ``[kind, shape, *params]`` (:func:`draw_one`) drawn in turn,
    that ``layout["repeat"]`` times where it is set (a layer's steps, a
    ladder's rungs), each draw then stacked on a new leading axis.  One
    tensor a draw of the list."""
    draws, repeat = layout["draws"], layout.get("repeat")

    def once():
        return [draw_one(kind, shape, params, generator=generator, dtype=dtype, device=device)
                for kind, shape, *params in draws]

    if repeat is None:
        return tuple(once())
    rows = [once() for _ in range(repeat)]
    return tuple(torch.stack(column) for column in zip(*rows))


def one_hot(y, num_classes: int, dtype=torch.float32):
    """Integer labels (batch,) as one-hot rows (batch, num_classes); a (batch,
    C) tensor (already one-hot, or soft) is cast to ``dtype``."""
    if y.dim() == 1 and not y.is_floating_point():
        return torch.nn.functional.one_hot(y.long(), num_classes).to(dtype)
    return y.to(dtype)


def draw_labels(num_samples: int, num_classes: int, *,
                generator: Optional[torch.Generator] = None, device="cpu") -> torch.Tensor:
    """``num_samples`` labels uniform on [0, num_classes), int64, from
    ``generator``: every label a class-conditional model draws."""
    return torch.randint(0, num_classes, (num_samples,), generator=generator, device=device)


class BaseDistribution(nn.Module):
    """Abstract base: a module's ``forward`` is ``sample_and_log_prob``."""

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def log_prob(self, z, context=None):
        raise NotImplementedError

    def from_noise(self, eps, context=None):
        """``(z, log_p)`` of the unit draws ``eps`` (:func:`draw_noise` by
        ``self.noise_spec``); a base that has no such split raises."""
        raise NotImplementedError(f"{type(self).__name__} has no noise_spec")

    @property
    def noise_shape(self):
        """The shape of one draw's noise: the event's."""
        return tuple(self.event_shape)

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        z, _ = self.sample_and_log_prob(num_samples, context, generator=generator)
        return z

    def forward(self, num_samples: int = 1, context=None, *,
                generator: Optional[torch.Generator] = None):
        return self.sample_and_log_prob(num_samples, context, generator=generator)


class DiagGaussian(BaseDistribution):
    """Diagonal Gaussian with trainable ``loc`` / ``log_scale`` (buffers when
    ``trainable=False``)."""

    def __init__(self, shape, trainable: bool = True, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.shape = _tuple_shape(shape)
        self.d = int(np.prod(self.shape))
        self.temperature: Optional[float] = None
        loc = torch.zeros(1, *self.shape, device=device)
        log_scale = torch.zeros(1, *self.shape, device=device)
        if trainable:
            self.loc = nn.Parameter(loc)
            self.log_scale = nn.Parameter(log_scale)
        else:
            self.register_buffer("loc", loc)
            self.register_buffer("log_scale", log_scale)

    @classmethod
    def create(cls, shape, trainable: bool = True, *, device="cuda"):
        return cls(shape, trainable, device=device)

    def _log_scale(self):
        if self.temperature is None:
            return self.log_scale
        return self.log_scale + math.log(self.temperature)

    @property
    def event_shape(self):
        return self.shape

    @property
    def noise_spec(self):
        return ("normal",) * self.d

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        eps = draw_noise(self.noise_spec, self.shape, num_samples, generator=generator,
                         dtype=self.loc.dtype, device=self.loc.device)
        return self.from_noise(eps, context)

    def from_noise(self, eps, context=None):
        log_scale = self._log_scale()
        z = self.loc + torch.exp(log_scale) * eps
        dims = tuple(range(1, len(self.shape) + 1))
        log_p = -0.5 * self.d * LOG2PI - torch.sum(log_scale + 0.5 * eps**2, dim=dims)
        return z, log_p

    def log_prob(self, z, context=None):
        log_scale = self._log_scale()
        dims = tuple(range(1, len(self.shape) + 1))
        return -0.5 * self.d * LOG2PI - torch.sum(
            log_scale + 0.5 * ((z - self.loc) / torch.exp(log_scale)) ** 2, dim=dims)


class ConditionalDiagGaussian(BaseDistribution):
    """Diagonal Gaussian whose mean and log-scale are the two halves of
    ``context_encoder(context)`` (a module, such as ``nets.MLP``): one
    Gaussian a context row."""

    def __init__(self, shape, context_encoder: nn.Module):
        super().__init__()
        self.shape = _tuple_shape(shape)
        self.d = int(np.prod(self.shape))
        self.context_encoder = context_encoder

    @classmethod
    def create(cls, shape, context_encoder):
        return cls(shape, context_encoder)

    @property
    def event_shape(self):
        return self.shape

    @property
    def noise_spec(self):
        return ("normal",) * self.d

    def _params(self, context):
        out = self.context_encoder(context)
        split = out.shape[-1] // 2
        return out[..., :split], out[..., split:]

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        eps = draw_noise(self.noise_spec, self.shape, num_samples, generator=generator,
                         dtype=context.dtype, device=context.device)
        return self.from_noise(eps, context)

    def from_noise(self, eps, context=None):
        mean, log_scale = self._params(context)
        z = mean + torch.exp(log_scale) * eps
        dims = tuple(range(1, len(self.shape) + 1))
        log_p = -0.5 * self.d * LOG2PI - torch.sum(log_scale + 0.5 * eps**2, dim=dims)
        return z, log_p

    def log_prob(self, z, context=None):
        mean, log_scale = self._params(context)
        dims = tuple(range(1, len(self.shape) + 1))
        return -0.5 * self.d * LOG2PI - torch.sum(
            log_scale + 0.5 * ((z - mean) / torch.exp(log_scale)) ** 2, dim=dims)


class Uniform(BaseDistribution):
    """Uniform on the box [low, high]^shape; log-density -inf outside it."""

    def __init__(self, shape, low: float = -1.0, high: float = 1.0, *, device="cuda"):
        super().__init__()
        self.shape = _tuple_shape(shape)
        self.d = int(np.prod(self.shape))
        self.low, self.high = float(low), float(high)
        self.device = resolve_device(device)

    @classmethod
    def create(cls, shape, low=-1.0, high=1.0, *, device="cuda"):
        return cls(shape, low, high, device=device)

    @property
    def event_shape(self):
        return self.shape

    @property
    def noise_spec(self):
        return ("uniform",) * self.d

    @property
    def log_prob_val(self) -> float:
        return -self.d * math.log(self.high - self.low)

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        eps = draw_noise(self.noise_spec, self.shape, num_samples, generator=generator,
                         device=self.device)
        return self.from_noise(eps, context)

    def from_noise(self, eps, context=None):
        """``z = low + (high - low) * eps``."""
        z = self.low + (self.high - self.low) * eps
        return z, torch.full((eps.shape[0],), self.log_prob_val, dtype=eps.dtype,
                             device=eps.device)

    def log_prob(self, z, context=None):
        out = ((z < self.low) | (z > self.high)).reshape(z.shape[0], -1).any(dim=-1)
        return torch.where(out, -math.inf, self.log_prob_val).to(z.dtype)


class UniformGaussian(BaseDistribution):
    """Per-index mix of uniform and Gaussian dims: the ``ind`` dims are
    uniform of width ``scale[i]`` centred at 0, the rest Gaussian with std
    ``scale[i]``.  The circular-NSF base."""

    def __init__(self, ndim: int, ind, scale=None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if isinstance(ind, int):
            ind = [ind]
        ind = np.asarray(ind, np.int64).reshape(-1)
        rest = np.asarray([i for i in range(ndim) if i not in set(ind.tolist())],
                          np.int64)
        perm = np.concatenate([ind, rest])
        inv_perm = np.zeros(ndim, np.int64)
        inv_perm[perm] = np.arange(ndim)
        scale = np.ones(ndim, np.float32) if scale is None else np.asarray(scale, np.float32)
        self.ndim = ndim
        # the uniform indices on the host; their draws are placed in
        # ascending order (draw_noise)
        self.ind_host = tuple(int(i) for i in ind)
        self.register_buffer("ind", torch.as_tensor(ind, device=device))
        self.register_buffer("ind_", torch.as_tensor(rest, device=device))
        self.register_buffer("inv_perm", torch.as_tensor(inv_perm, device=device))
        self.register_buffer("scale", torch.as_tensor(scale, device=device))

    @classmethod
    def create(cls, ndim: int, ind, scale=None, *, device="cuda"):
        return cls(ndim, ind, scale, device=device)

    @property
    def event_shape(self):
        return (self.ndim,)

    @property
    def noise_spec(self):
        uniform = set(self.ind_host)
        return tuple("uniform" if i in uniform else "normal" for i in range(self.ndim))

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        eps = draw_noise(self.noise_spec, (self.ndim,), num_samples, generator=generator,
                         device=self.scale.device)
        return self.from_noise(eps, context)

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        z, _ = self.sample_and_log_prob(num_samples, context, generator=generator)
        return z

    def from_noise(self, eps, context=None):
        """The uniform indices' draws centred (eps - 0.5), then every index
        scaled: ``z = scale * eps'``."""
        z = torch.cat([eps[..., self.ind] - 0.5, eps[..., self.ind_]], dim=-1)
        z = self.scale * z[..., self.inv_perm]
        return z, self.log_prob(z, context)

    def log_prob(self, z, context=None):
        log_p_u = -torch.sum(torch.log(self.scale[self.ind]))
        zg = z[..., self.ind_] / self.scale[self.ind_]
        log_p_g = torch.sum(
            -0.5 * LOG2PI - torch.log(self.scale[self.ind_]) - 0.5 * zg**2, dim=-1)
        return log_p_u + log_p_g


class ClassCondDiagGaussian(BaseDistribution):
    """A diagonal Gaussian per class: ``loc`` and ``log_scale`` (*shape,
    num_classes), the context a label vector (or a one-hot batch) picking
    each row's parameters by a (*shape, C) @ (C, B) product.  ``temperature``
    (None or a float, set in place) scales the std."""

    def __init__(self, shape, num_classes: int, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.shape = _tuple_shape(shape)
        self.d = int(np.prod(self.shape))
        self.num_classes = num_classes
        self.temperature: Optional[float] = None
        self.loc = nn.Parameter(torch.zeros(*self.shape, num_classes, device=device))
        self.log_scale = nn.Parameter(torch.zeros(*self.shape, num_classes, device=device))

    @classmethod
    def create(cls, shape, num_classes: int, *, device="cuda"):
        return cls(shape, num_classes, device=device)

    @property
    def event_shape(self):
        return self.shape

    @property
    def noise_spec(self):
        return ("normal",) * self.d

    def _params(self, y):
        y_onehot = one_hot(y, self.num_classes, self.loc.dtype)
        loc = torch.movedim(self.loc @ y_onehot.T, -1, 0)
        log_scale = torch.movedim(self.log_scale @ y_onehot.T, -1, 0)
        if self.temperature is not None:
            log_scale = log_scale + math.log(self.temperature)
        return loc, log_scale

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        y = context
        if y is None:
            y = draw_labels(num_samples, self.num_classes, generator=generator,
                            device=self.loc.device)
        eps = draw_noise(self.noise_spec, self.shape, y.shape[0], generator=generator,
                         dtype=self.loc.dtype, device=self.loc.device)
        return self.from_noise(eps, y)

    def from_noise(self, eps, context=None):
        loc, log_scale = self._params(context)
        z = loc + torch.exp(log_scale) * eps
        dims = tuple(range(1, len(self.shape) + 1))
        log_p = -0.5 * self.d * LOG2PI - torch.sum(log_scale + 0.5 * eps**2, dim=dims)
        return z, log_p

    def log_prob(self, z, context=None):
        loc, log_scale = self._params(context)
        dims = tuple(range(1, len(self.shape) + 1))
        return -0.5 * self.d * LOG2PI - torch.sum(
            log_scale + 0.5 * ((z - loc) / torch.exp(log_scale)) ** 2, dim=dims)


class GlowBase(BaseDistribution):
    """Glow's base: a Gaussian with one mean and log-scale a channel, each
    reparameterised as ``v * exp(v_logs * logscale_factor)``, plus per-class
    offsets (``loc_cc``, ``log_scale_cc``, (num_classes, C)) with
    ``num_classes``; ``temperature`` as in ``ClassCondDiagGaussian``."""

    def __init__(self, shape, num_classes: Optional[int] = None,
                 logscale_factor: float = 3.0, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.shape = _tuple_shape(shape)
        self.d = int(np.prod(self.shape))
        self.num_pix = int(np.prod(self.shape[1:]))
        self.num_classes = num_classes
        self.logscale_factor = logscale_factor
        self.temperature: Optional[float] = None
        pshape = (1, self.shape[0]) + (1,) * (len(self.shape) - 1)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device))

        self.loc, self.loc_logs = zeros(*pshape), zeros(*pshape)
        self.log_scale, self.log_scale_logs = zeros(*pshape), zeros(*pshape)
        cc = num_classes is not None
        self.loc_cc = zeros(num_classes, self.shape[0]) if cc else None
        self.log_scale_cc = zeros(num_classes, self.shape[0]) if cc else None

    @classmethod
    def create(cls, shape, num_classes: Optional[int] = None, logscale_factor: float = 3.0,
               *, device="cuda"):
        return cls(shape, num_classes, logscale_factor, device=device)

    @property
    def event_shape(self):
        return self.shape

    @property
    def noise_spec(self):
        return ("normal",) * self.d

    def _params(self, y):
        loc = self.loc * torch.exp(self.loc_logs * self.logscale_factor)
        log_scale = self.log_scale * torch.exp(self.log_scale_logs * self.logscale_factor)
        if self.num_classes is not None and y is not None:
            y_onehot = one_hot(y, self.num_classes, self.loc.dtype)
            cshape = (-1, self.shape[0]) + (1,) * (len(self.shape) - 1)
            loc = loc + (y_onehot @ self.loc_cc).reshape(cshape)
            log_scale = log_scale + (y_onehot @ self.log_scale_cc).reshape(cshape)
        if self.temperature is not None:
            log_scale = log_scale + math.log(self.temperature)
        return loc, log_scale

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        y = context
        if self.num_classes is not None:
            if y is None:
                y = draw_labels(num_samples, self.num_classes, generator=generator,
                                device=self.loc.device)
            num_samples = y.shape[0]
        eps = draw_noise(self.noise_spec, self.shape, num_samples, generator=generator,
                         dtype=self.loc.dtype, device=self.loc.device)
        return self.from_noise(eps, y)

    def from_noise(self, eps, context=None):
        loc, log_scale = self._params(context)
        z = loc + torch.exp(log_scale) * eps
        dims = tuple(range(1, len(self.shape) + 1))
        log_p = (-0.5 * self.d * LOG2PI - self.num_pix * torch.sum(log_scale, dim=dims)
                 - 0.5 * torch.sum(eps**2, dim=dims))
        return z, log_p

    def log_prob(self, z, context=None):
        loc, log_scale = self._params(context)
        dims = tuple(range(1, len(self.shape) + 1))
        return (-0.5 * self.d * LOG2PI - self.num_pix * torch.sum(log_scale, dim=dims)
                - 0.5 * torch.sum(((z - loc) / torch.exp(log_scale)) ** 2, dim=dims))


class AffineGaussian(BaseDistribution):
    """N(0, I) pushed through ``transform``: an ``AffineConstFlow`` of
    ``affine_shape``, or with ``num_classes`` a ``CCAffineConst`` whose
    per-class offsets the labels pick.  ``temperature`` (None or a float,
    set in place, as ``MultiscaleFlow.set_temperature`` does) scales the
    unit Gaussian.  Given no labels, it draws them first, then the noise."""

    def __init__(self, shape, affine_shape, num_classes: Optional[int] = None, *,
                 device="cuda"):
        super().__init__()
        from ..flows.affine.coupling import AffineConstFlow, CCAffineConst

        self.shape = _tuple_shape(shape)
        self.d = int(np.prod(self.shape))
        self.num_classes = num_classes
        self.temperature: Optional[float] = None
        self.transform = (AffineConstFlow(affine_shape, device=device) if num_classes is None
                          else CCAffineConst(affine_shape, num_classes, device=device))

    @classmethod
    def create(cls, shape, affine_shape, num_classes: Optional[int] = None, *, device="cuda"):
        return cls(shape, affine_shape, num_classes, device=device)

    @property
    def event_shape(self):
        return self.shape

    @property
    def noise_spec(self):
        return ("normal",) * self.d

    def _log_scale(self) -> float:
        return math.log(self.temperature) if self.temperature is not None else 0.0

    def _context(self, y):
        if self.num_classes is None:
            return ()
        return (one_hot(y, self.num_classes, self.transform.s.dtype),)

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        y, t = context, self.transform.s
        if self.num_classes is not None:
            if y is None:
                y = draw_labels(num_samples, self.num_classes, generator=generator,
                                device=t.device)
            num_samples = y.shape[0]
        eps = draw_noise(self.noise_spec, self.shape, num_samples, generator=generator,
                         dtype=t.dtype, device=t.device)
        return self.from_noise(eps, y)

    def from_noise(self, eps, context=None):
        log_scale = self._log_scale()
        dims = tuple(range(1, len(self.shape) + 1))
        log_p = (-0.5 * self.d * LOG2PI - self.d * log_scale
                 - 0.5 * torch.sum(eps**2, dim=dims))
        z, log_det = self.transform.forward(math.exp(log_scale) * eps, *self._context(context))
        return z, log_p - log_det

    def log_prob(self, z, context=None):
        z, log_p = self.transform.inverse(z, *self._context(context))
        log_scale = self._log_scale()
        z = z / math.exp(log_scale)
        dims = tuple(range(1, len(self.shape) + 1))
        return (log_p - self.d * log_scale - 0.5 * self.d * LOG2PI
                - 0.5 * torch.sum(z**2, dim=dims))


class GaussianMixture(BaseDistribution):
    """A mixture of ``n_modes`` diagonal Gaussians in ``dim`` dimensions:
    ``loc`` and ``log_scale`` (1, n_modes, dim), ``weight_scores`` (1,
    n_modes), the log of the normalised ``weights``; buffers where
    ``trainable=False``.  Without ``loc`` the modes' centres are drawn
    ~ N(0, 1) on the CPU from ``generator``.

    A draw's noise (``noise_shape`` (dim + 1,)) is a uniform ``u``, then
    ``dim`` standard normals: the mode is the inverse CDF of the cumulative
    softmax weights at ``u`` (``searchsorted``), where the JAX package draws
    it with ``jax.random.categorical``.  The law is the same; the draws
    differ.  This one captures in a CUDA graph and replays from noise."""

    def __init__(self, n_modes: int, dim: int, loc=None, scale=None, weights=None,
                 trainable: bool = True, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.n_modes, self.dim, self.trainable = n_modes, dim, trainable
        loc = torch.randn(n_modes, dim, generator=generator) if loc is None \
            else torch.as_tensor(loc, dtype=torch.float32)
        scale = torch.ones(n_modes, dim) if scale is None \
            else torch.as_tensor(scale, dtype=torch.float32)
        weights = torch.ones(n_modes) if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        weights = weights / torch.sum(weights)
        tensors = {"loc": loc.reshape(1, n_modes, dim),
                   "log_scale": torch.log(scale).reshape(1, n_modes, dim),
                   "weight_scores": torch.log(weights)[None]}
        for name, value in tensors.items():
            value = value.float().to(device)
            if trainable:
                setattr(self, name, nn.Parameter(value))
            else:
                self.register_buffer(name, value)

    @classmethod
    def create(cls, n_modes, dim, loc=None, scale=None, weights=None, trainable=True, *,
               generator=None, device="cuda"):
        return cls(n_modes, dim, loc, scale, weights, trainable, generator=generator,
                   device=device)

    @property
    def event_shape(self):
        return (self.dim,)

    @property
    def noise_shape(self):
        return (self.dim + 1,)

    @property
    def noise_spec(self):
        return ("uniform",) + ("normal",) * self.dim

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        eps = draw_noise(self.noise_spec, self.noise_shape, num_samples, generator=generator,
                         dtype=self.loc.dtype, device=self.loc.device)
        return self.from_noise(eps, context)

    def from_noise(self, eps, context=None):
        """``eps`` (num_samples, dim + 1): the mode's uniform, then the
        normals."""
        cdf = torch.cumsum(torch.softmax(self.weight_scores[0], 0), 0)
        mode = torch.searchsorted(cdf, eps[:, :1].contiguous(), right=True)[:, 0]
        mode = torch.clamp(mode, max=self.n_modes - 1)  # the cumulative sum may end below 1
        z = eps[:, 1:] * torch.exp(self.log_scale[0, mode]) + self.loc[0, mode]
        return z, self.log_prob(z)

    def log_prob(self, z, context=None):
        log_weights = torch.log(torch.softmax(self.weight_scores, 1))
        eps = (z[:, None, :] - self.loc) / torch.exp(self.log_scale)
        log_p = (-0.5 * self.dim * LOG2PI + log_weights - 0.5 * torch.sum(eps**2, 2)
                 - torch.sum(self.log_scale, 2))
        return torch.logsumexp(log_p, 1)


class GaussianPCA(BaseDistribution):
    """A low-rank Gaussian z = eps W + loc, eps ~ N(0, I) of ``latent_dim``
    (``noise_shape``), covariance W^T W + sigma^2 I.  Its normaliser takes
    ``slogdet``, as the JAX package's fix of the reference's ``det`` does.
    ``W`` is drawn ~ N(0, 1) on the CPU from ``generator``."""

    def __init__(self, dim: int, latent_dim: Optional[int] = None, sigma: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.latent_dim = dim if latent_dim is None else latent_dim
        self.loc = nn.Parameter(torch.zeros(1, dim, device=device))
        self.W = nn.Parameter(torch.randn(self.latent_dim, dim, generator=generator).to(device))
        self.log_sigma = nn.Parameter(torch.tensor(math.log(sigma), device=device))

    @classmethod
    def create(cls, dim, latent_dim=None, sigma: float = 0.1, *, generator=None,
               device="cuda"):
        return cls(dim, latent_dim, sigma, generator=generator, device=device)

    @property
    def event_shape(self):
        return (self.dim,)

    @property
    def noise_shape(self):
        return (self.latent_dim,)

    @property
    def noise_spec(self):
        return ("normal",) * self.latent_dim

    def _log_prob_centered(self, z_):
        sig = self.W.T @ self.W + torch.exp(2.0 * self.log_sigma) * torch.eye(
            self.dim, dtype=self.W.dtype, device=self.W.device)
        _, logdet = torch.linalg.slogdet(sig)
        sol = torch.linalg.solve(sig, z_.T).T
        return -0.5 * self.dim * LOG2PI - 0.5 * logdet - 0.5 * torch.sum(z_ * sol, dim=1)

    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        eps = draw_noise(self.noise_spec, self.noise_shape, num_samples, generator=generator,
                         dtype=self.loc.dtype, device=self.loc.device)
        return self.from_noise(eps, context)

    def from_noise(self, eps, context=None):
        z_ = eps @ self.W
        return z_ + self.loc, self._log_prob_centered(z_)

    def log_prob(self, z, context=None):
        return self._log_prob_centered(z - self.loc)
