"""Residual flows (i-ResNet / residual flow; port of
``normflows_tpu/flows/residual.py``).

A block maps y = x + g(x) with a contractive net g (``nets.lipschitz``).  Its
log-det log|det(I + J_g)| is estimated by a power series of vector-Jacobian
products (Hutchinson's trace with a Gaussian probe), truncated by a russian
roulette: a random horizon n, and coefficients 1{n >= k} / P(N >= k) that
keep the estimate unbiased.  The estimators:

* :func:`basic_logdet_estimator`: the series, every term differentiable;
* :func:`neumann_logdet_estimator`: the Neumann gradient estimator, the
  series detached and one differentiable pullback of its sum; a static cap
  of terms, the coefficients 0 beyond the horizon;
* :func:`neumann_logdet_estimator_dynamic`: the same to the sampled horizon
  itself, the training default.  **An eager call loops exactly to the
  horizon**, read on the host.  **A step captured in a CUDA graph runs a
  fixed ``n_power_series_max`` terms** (``cap``): a graph cannot loop a
  number of times each replay draws anew.  The coefficients are 0 beyond
  the horizon, so below the cap the two forms agree bit for bit; the series
  stops short only where the horizon exceeds the cap (at the defaults, one
  block in 0.5^22, ~2.4e-7).  :data:`CAPPED` counts those calls on the
  device where it is set.

Randomness: the horizon, then the probe, from one ``torch.Generator`` (the
JAX package splits its key in two), through :func:`draw_horizon` and
:func:`draw_probe`, which tests feed the JAX package's draws through.  A
stochastic log-det without a generator raises, as JAX's without a key; the
deterministic modes (``exact_trace`` with a fixed ``n_power_series``, the
2-D brute force) need none.

``grad_in_forward`` (``Residual``'s ``reduce_memory``) rematerialises the
Neumann estimators (:class:`_Remat`): the forward keeps no graph, the
backward recomputes g and the differentiable pullback from the block's
input and the detached series it saved.  The training mode is
``nn.Module.train()`` / ``.eval()`` (``Residual.set_train`` names the same
switch): in eval mode a 2-D block takes the brute-force Jacobian, any other
20 exact terms under a static cap of ``n_power_series_max + 18``.

The inverse is the fixed point x = y - g(x), iterated on the device in
blocks of :data:`FIXED_POINT_BLOCK` steps, each step frozen once the
JAX package's stopping test fails, with one host read a block: the same x as
a test a step.

:meth:`Residual.program` is the layer's sampling direction in the form an
exported program takes: the fixed point a ``while_loop`` (the JAX
package's ``lax.while_loop``), its steps those of the eager loop, over a
traced graph of g; the log-det a traced graph (its pullbacks are
``torch.autograd.grad``, which ``torch.export`` cannot trace), its draws
the program's inputs, a dynamic series run to ``n_power_series_max``
terms (the capture rule above).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.flow import Flow, sum_except_batch
from ..distributions.base import draw_one
from ..ops.backend import capturing, trace_graph

FIXED_POINT_BLOCK = 10  # fixed-point steps between host reads
FIXED_POINT_MAX = 1000  # the JAX package's cap (residual.py:253)
# None, or an int64 0-d tensor on the card: each capped estimator call adds
# whether its horizon exceeded the cap (a captured add counts every replay)
CAPPED = None


# ---------------------------------------------------------------------------
# draws and power-series coefficients


def draw_horizon(generator, n_dist, geom_p: float, lamb, n_samples, device):
    """The russian roulette's horizons, (n_samples,) float32: geometric(p)
    on {1, 2, ...} or Poisson(lamb)."""
    if n_dist == "geometric":
        return draw_one("geometric", (n_samples,), (geom_p,), generator=generator, device=device)
    if n_dist == "poisson":  # lamb stays on the device: no host read under a capture
        return torch.poisson(lamb.expand(n_samples).float(), generator=generator)
    raise NotImplementedError(n_dist)


def draw_probe(generator, shape, dtype, device):
    """Hutchinson's Gaussian probe."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _geometric_1mcdf(p, ks, offset):
    """P(N >= k) for a geometric(p) horizon shifted by ``offset``."""
    k_eff = torch.clamp(ks - offset, min=1)
    out = (1.0 - p) ** torch.clamp(k_eff - 1, min=0)
    return torch.where(ks <= offset, 1.0, out)


def _poisson_1mcdf(lamb, ks, offset, kmax):
    """P(N >= k) for a Poisson(lamb) horizon shifted by ``offset``."""
    i = torch.arange(1, kmax + 1, device=ks.device)
    fact = torch.tensor([float(math.factorial(j)) for j in range(1, kmax + 1)],
                        device=ks.device)
    csum = torch.cumsum(lamb**i / fact, 0)
    k_eff = torch.clamp(ks - offset, min=1)
    partial = torch.where(k_eff >= 2, csum[torch.clamp(k_eff - 2, min=0)], 0.0)
    out = 1.0 - torch.exp(-lamb) * (1.0 + partial)
    return torch.where(ks <= offset, 1.0, out)


def _ratio(indicator, rcdf):
    """indicator / P(N >= k), and 0 where no horizon reaches the term: far
    into a Poisson tail the float32 P(N >= k) rounds to 0 (the JAX package's
    to 0 or just below it), where 0 / 0 would be NaN."""
    return torch.where(indicator > 0, indicator / rcdf, 0.0)


def _series_coeffs(n, n_dist, geom_p, lamb, n_exact_terms, kmax):
    """The coefficients of terms k = 1..kmax from drawn horizons ``n``
    capped at ``kmax - n_exact_terms``."""
    ks = torch.arange(1, kmax + 1, device=n.device)
    if n_dist == "geometric":
        rcdf = _geometric_1mcdf(geom_p, ks, n_exact_terms)
    elif n_dist == "poisson":
        rcdf = _poisson_1mcdf(lamb, ks, n_exact_terms, kmax)
    else:
        raise NotImplementedError(n_dist)
    n = torch.clamp(n, max=kmax - n_exact_terms)
    indicator = torch.mean((n[None, :] >= (ks[:, None] - n_exact_terms)).float(), dim=1)
    return _ratio(indicator, rcdf)


def _rr_coeff(k, n_arr, offset, n_dist, geom_p, lamb):
    """The uncapped russian-roulette coefficient of term ``k`` (1-indexed;
    an int or an int tensor of terms): E_n[1{n >= k - offset}] /
    P(N >= k - offset), the Poisson tail by the regularised incomplete gamma
    function."""
    m = torch.as_tensor(k, device=n_arr.device) - offset
    ind = torch.mean((n_arr >= m[..., None]).float(), dim=-1)
    if n_dist == "geometric":
        rcdf = torch.where(m <= 0, 1.0, (1.0 - geom_p) ** torch.clamp(m - 1, min=0))
    else:
        rcdf = torch.where(m <= 0, 1.0,
                           torch.special.gammainc(torch.clamp(m, min=1).float(), lamb))
    return _ratio(ind, rcdf)


# ---------------------------------------------------------------------------
# log-det estimators: ``g_fn`` is the block's net, ``x`` its input


def _leaf_or_graph(x):
    """``x`` where it carries a graph (so that earlier layers stay on it),
    else a leaf copy that requires grad: the pullbacks differentiate w.r.t.
    it."""
    return x if x.requires_grad else x.detach().requires_grad_(True)


def _pullback(gx, x, v, create_graph=False):
    return torch.autograd.grad(gx, x, v, retain_graph=True, create_graph=create_graph)[0]


def basic_logdet_estimator(g_fn, x, vareps, coeffs, kmax):
    """Hutchinson's power series, every term differentiable: returns
    ``(g(x), logdet)``."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = _leaf_or_graph(x)
        gx = g_fn(xs)
        vjp = vareps
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for k in range(1, kmax + 1):
            vjp = _pullback(gx, xs, vjp, create)
            tr = sum_except_batch(vjp * vareps)
            logdet = logdet + ((-1.0) ** (k + 1) / k) * coeffs[k - 1] * tr
    return (gx, logdet) if create else (gx.detach(), logdet.detach())


def _static_series(coeffs, kmax):
    def series(gx, xs, vareps):
        vjp, nv = vareps, vareps
        for k in range(1, kmax + 1):
            vjp = _pullback(gx, xs, vjp)
            nv = nv + ((-1.0) ** k) * coeffs[k - 1] * vjp
        return nv
    return series


def _dynamic_series(n_arr, offset, n_dist, geom_p, lamb, cap):
    """The detached series to the horizon ``offset + max(n_arr)``, read on
    the host; with ``cap``, ``cap`` terms whatever the horizon."""
    def series(gx, xs, vareps):
        k_end = offset + int(n_arr.max()) if cap is None else cap
        coeffs = _rr_coeff(torch.arange(1, k_end + 1, device=xs.device), n_arr, offset,
                           n_dist, geom_p, lamb)
        if cap is not None and CAPPED is not None:
            CAPPED.add_((offset + n_arr.max() > cap).long())
        vjp, acc = vareps, vareps
        for k in range(1, k_end + 1):
            vjp = _pullback(gx, xs, vjp)
            acc = acc + (1.0 if k % 2 == 0 else -1.0) * coeffs[k - 1] * vjp
        return acc
    return series


def _neumann(g_fn, x, vareps, series):
    """``(g(x), logdet)`` of the Neumann gradient estimator: the detached
    series ``series(gx, x, vareps)``, then one differentiable pullback of
    it."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = _leaf_or_graph(x)
        gx = g_fn(xs)
        nv = series(gx, xs, vareps).detach()
        vjp_jac = _pullback(gx, xs, nv, create)
    logdet = sum_except_batch(vjp_jac * vareps)
    return (gx, logdet) if create else (gx.detach(), logdet.detach())


def neumann_logdet_estimator(g_fn, x, vareps, coeffs, kmax):
    """The Neumann gradient estimator under a static cap of ``kmax`` terms:
    its value is vareps^T J (sum_k (-1)^k c_k J^k) vareps with the series
    detached; its gradient is the unbiased log-det gradient."""
    return _neumann(g_fn, x, vareps, _static_series(coeffs, kmax))


def neumann_logdet_estimator_dynamic(g_fn, x, vareps, n_arr, offset, n_dist, geom_p, lamb,
                                     cap: Optional[int] = None):
    """The Neumann gradient estimator to the sampled horizon ``offset +
    max(n_arr)`` (exactly unbiased; the horizon read on the host), or, with
    ``cap``, under ``cap`` terms (see the module docstring)."""
    return _neumann(g_fn, x, vareps, _dynamic_series(n_arr, offset, n_dist, geom_p, lamb, cap))


class _Remat(torch.autograd.Function):
    """A Neumann estimator rematerialised: ``forward`` keeps no graph and
    saves the block's input, the probe and the detached series; ``backward``
    recomputes g and the one differentiable pullback from them, then
    differentiates both outputs w.r.t. the input and ``params`` (g's)."""

    @staticmethod
    def forward(ctx, g_fn, series, x, vareps, *params):
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            gx = g_fn(xs)
            nv = series(gx, xs, vareps).detach()
            vjp_jac = _pullback(gx, xs, nv)
        ctx.g_fn = g_fn
        ctx.save_for_backward(x, vareps, nv)
        return gx.detach(), sum_except_batch(vjp_jac * vareps)

    @staticmethod
    def backward(ctx, grad_g, grad_logdet):
        x, vareps, nv = ctx.saved_tensors
        wanted = ctx.needs_input_grad[4:]
        params = [p for p, w in zip(ctx.g_fn.parameters(), wanted) if w]
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            gx = ctx.g_fn(xs)
            logdet = sum_except_batch(_pullback(gx, xs, nv, create_graph=True) * vareps)
            grads = torch.autograd.grad((gx, logdet), (xs, *params), (grad_g, grad_logdet),
                                        allow_unused=True)
        by_param = iter(grads[1:])
        return (None, None, grads[0] if ctx.needs_input_grad[2] else None, None,
                *(next(by_param) if w else None for w in wanted))


def _rematerialised(g_fn, x, vareps, series):
    return _Remat.apply(g_fn, series, x, vareps, *g_fn.parameters())


def batch_jacobian(g_fn, x):
    """Per-sample Jacobians (B, d, d) of ``g_fn`` at ``x``, a row a
    pullback: g acts on each sample alone, so the pullback of output
    coordinate i's one-hot cotangent over the batch is row i of every
    sample's Jacobian.  With grad mode on it keeps its graph (differentiable
    in x and g's tensors).  Reverse mode, where ``torch.func.jacfwd`` would
    do: a symbolic-batch program traces these pullbacks and not jacfwd's
    forward mode."""
    b, d = x.shape[0], math.prod(x.shape[1:])
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = _leaf_or_graph(x)
        gx = g_fn(xs).reshape(b, d)
        eye = torch.eye(d, dtype=gx.dtype, device=gx.device)
        rows = [_pullback(gx, xs, eye[i].expand(b, d), create).reshape(b, d)
                for i in range(d)]
    jac = torch.stack(rows, 1)
    return jac if create else jac.detach()


# ---------------------------------------------------------------------------


class iResBlock(nn.Module):
    """The invertible residual block y = x + g(x), ``nnet`` being g."""

    def __init__(self, nnet: nn.Module, geom_p: float = 0.5, lamb: float = 2.0,
                 n_power_series: Optional[int] = None, exact_trace: bool = False,
                 brute_force: bool = False, n_samples: int = 1, n_exact_terms: int = 2,
                 n_dist: str = "geometric", neumann_grad: bool = True,
                 grad_in_forward: bool = False, n_power_series_max: int = 24):
        super().__init__()
        device = next(iter(nnet.parameters())).device
        self.nnet = nnet
        logit = torch.tensor(math.log(geom_p) - math.log(1.0 - geom_p), dtype=torch.float32)
        self.register_buffer("geom_p_logit", logit.to(device))
        self.register_buffer("lamb", torch.tensor(lamb, dtype=torch.float32, device=device))
        # the horizon's draw takes p as a number: sigmoid of the float32 logit
        self.geom_p = float(torch.sigmoid(logit))
        self.n_samples, self.n_power_series = n_samples, n_power_series
        self.exact_trace, self.brute_force = exact_trace, brute_force
        self.n_exact_terms, self.n_dist = n_exact_terms, n_dist
        self.neumann_grad, self.grad_in_forward = neumann_grad, grad_in_forward
        self.n_power_series_max = n_power_series_max
        self.last_inverse = None

    @classmethod
    def create(cls, nnet, geom_p=0.5, lamb=2.0, n_power_series=None, exact_trace=False,
               brute_force=False, n_samples=1, n_exact_terms=2, n_dist="geometric",
               neumann_grad=True, grad_in_forward=False, n_power_series_max=24):
        return cls(nnet, geom_p, lamb, n_power_series, exact_trace, brute_force, n_samples,
                   n_exact_terms, n_dist, neumann_grad, grad_in_forward, n_power_series_max)

    # -- transport ---------------------------------------------------------
    def apply_forward(self, x, logpx, generator=None, noise=None):
        """y = x + g(x), logpy = logpx - logdet."""
        g, logdetgrad = self._logdetgrad(x, generator, noise)
        return x + g, logpx - logdetgrad

    def apply_inverse(self, y, logpy, generator=None, noise=None):
        """x with x + g(x) = y, by fixed-point iteration; logpy + logdet."""
        x = self._inverse_fixed_point(y)
        _, logdetgrad = self._logdetgrad(x, generator, noise)
        return x, logpy + logdetgrad

    @torch.no_grad()
    def _inverse_fixed_point(self, y, atol=1e-5, rtol=1e-5):
        """The JAX package's loop (residual.py:247-262): x_0 = y - g(y), then
        x_{i+1} = y - g(x_i) while any (x_i - x_{i-1})^2 / tol >= 1, at most
        1,000 steps.  Each step here is taken where the test holds and
        frozen where it failed (``where``), so that the test is read once a
        block of FIXED_POINT_BLOCK steps; ``last_inverse`` notes the steps
        taken (a device tensor) and the host reads.  No gradient flows
        through it, as none does through JAX's ``while_loop``."""
        tol = atol + torch.abs(y) * rtol
        x_prev, x = y, y - self.nnet(y)
        steps = torch.zeros((), dtype=torch.int64, device=y.device)
        issued, reads = 0, 0
        while issued < FIXED_POINT_MAX:
            for _ in range(min(FIXED_POINT_BLOCK, FIXED_POINT_MAX - issued)):
                go = torch.any((x - x_prev) ** 2 / tol >= 1.0)
                x_prev, x = torch.where(go, x, x_prev), torch.where(go, y - self.nnet(x), x)
                steps += go
                issued += 1
            reads += 1
            if not bool(torch.any((x - x_prev) ** 2 / tol >= 1.0)):
                break
        self.last_inverse = {"steps": steps, "host_reads": reads}
        return x

    # -- log-det -----------------------------------------------------------
    def log_det_draws(self) -> bool:
        """Whether the current mode's estimator draws (roulette or probe);
        the facades hand a generator to flows holding such a block."""
        roulette = not (self.training and self.n_power_series is not None)
        return roulette or not self.exact_trace

    def _brute_force_2d(self, shape) -> bool:
        return (self.brute_force or not self.training) and len(shape) == 2 and shape[1] == 2

    def _draw_kinds(self, shape) -> tuple:
        """What a log-det at inputs of ``shape`` draws, in order: the
        russian roulette's ``"horizon"`` and Hutchinson's ``"probe"``, or
        some of them, or nothing."""
        if self._brute_force_2d(shape) or not self.log_det_draws():
            return ()
        if (self.training and self.n_power_series is None and self.neumann_grad
                and not self.exact_trace):
            return ("horizon", "probe")
        roulette = () if self.training and self.n_power_series is not None else ("horizon",)
        return roulette + (() if self.exact_trace else ("probe",))

    def noise_layout(self, shape) -> Optional[dict]:
        """The layout of a log-det's draws at inputs of ``shape``
        (``distributions.base.draw_layout``), None where it draws nothing."""
        kinds = self._draw_kinds(shape)
        if not kinds:
            return None
        param = self.geom_p if self.n_dist == "geometric" else float(self.lamb)
        return {"repeat": None, "draws": [
            [self.n_dist, [self.n_samples], param] if k == "horizon" else ["normal", list(shape)]
            for k in kinds]}

    def draw_noise(self, shape, *, generator=None, dtype=torch.float32, device="cpu") -> tuple:
        """A log-det's draws at inputs of ``shape``, through
        :func:`draw_horizon` and :func:`draw_probe`: its ``noise=``."""
        return tuple(
            draw_horizon(generator, self.n_dist, self.geom_p, self.lamb, self.n_samples, device)
            if k == "horizon" else draw_probe(generator, tuple(shape), dtype, device)
            for k in self._draw_kinds(shape))

    def _logdetgrad(self, x, generator=None, noise=None, capped=False):
        """``(g(x), logdet |d(x + g(x)) / dx|)``, its draws from
        ``generator`` or given as ``noise`` (:meth:`draw_noise`'s); with
        ``capped``, a dynamic series runs ``n_power_series_max`` terms, as
        under a CUDA graph's capture."""
        g_fn = self.nnet
        if self._brute_force_2d(x.shape):
            g = g_fn(x)
            jac = batch_jacobian(g_fn, x)
            dets = (jac[:, 0, 0] + 1) * (jac[:, 1, 1] + 1) - jac[:, 0, 1] * jac[:, 1, 0]
            return g, torch.log(torch.abs(dets))
        kinds = self._draw_kinds(x.shape)
        if kinds and noise is None and generator is None:
            raise ValueError(
                "iResBlock log-det estimation is stochastic (russian-roulette truncation "
                "/ Hutchinson trace); pass a torch.Generator, e.g. "
                "model.log_prob(x, generator=torch.Generator(device).manual_seed(step)). "
                "For a deterministic path use exact_trace=True with a fixed "
                "n_power_series, or brute_force=True in 2-D.")
        if noise is None:
            noise = self.draw_noise(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        drawn = dict(zip(kinds, noise, strict=True))
        n_arr, vareps = drawn.get("horizon"), drawn.get("probe")
        geom_p = torch.sigmoid(self.geom_p_logit)

        if (self.training and self.n_power_series is None and self.neumann_grad
                and not self.exact_trace):
            cap = self.n_power_series_max if capped or capturing() else None
            series = _dynamic_series(n_arr, self.n_exact_terms, self.n_dist, geom_p,
                                     self.lamb, cap)
            if self.grad_in_forward:
                return _rematerialised(g_fn, x, vareps, series)
            return _neumann(g_fn, x, vareps, series)

        if self.training and self.n_power_series is not None:
            kmax = self.n_power_series
            coeffs = torch.ones(kmax, device=x.device)
        else:
            n_exact = self.n_exact_terms if self.training else 20
            kmax = self.n_power_series_max + (0 if self.training else 18)
            coeffs = _series_coeffs(n_arr, self.n_dist, geom_p, self.lamb, n_exact, kmax)

        if self.exact_trace:
            g = g_fn(x)
            jac = batch_jacobian(g_fn, x)
            logdet = torch.diagonal(jac, dim1=1, dim2=2).sum(-1)
            jac_k = jac
            for k in range(2, kmax + 1):
                jac_k = torch.einsum("bij,bjk->bik", jac, jac_k)
                logdet = logdet + ((-1.0) ** (k + 1) / k) * coeffs[k - 1] * \
                    torch.diagonal(jac_k, dim1=1, dim2=2).sum(-1)
            return g, logdet

        if self.training and self.neumann_grad:
            series = _static_series(coeffs, kmax)
            if self.grad_in_forward:
                return _rematerialised(g_fn, x, vareps, series)
            return _neumann(g_fn, x, vareps, series)
        return basic_logdet_estimator(g_fn, x, vareps, coeffs, kmax)


class Residual(Flow):
    """A residual-flow layer.  With ``reverse=True`` (the default) the map
    x + g(x) is the density direction (``inverse``), so that ``forward``
    (sampling) runs the fixed-point iteration; both directions return the
    negated block log-det."""

    def __init__(self, net: nn.Module, reverse: bool = True, reduce_memory: bool = True,
                 geom_p: float = 0.5, lamb: float = 2.0, n_power_series: Optional[int] = None,
                 exact_trace: bool = False, brute_force: bool = False, n_samples: int = 1,
                 n_exact_terms: int = 2, n_dist: str = "geometric",
                 n_power_series_max: int = 24):
        super().__init__()
        self.iresblock = iResBlock(
            net, n_samples=n_samples, n_exact_terms=n_exact_terms, neumann_grad=reduce_memory,
            grad_in_forward=reduce_memory, exact_trace=exact_trace, geom_p=geom_p, lamb=lamb,
            n_power_series=n_power_series, brute_force=brute_force, n_dist=n_dist,
            n_power_series_max=n_power_series_max)
        self.reverse = reverse

    @classmethod
    def create(cls, net, reverse=True, reduce_memory=True, geom_p=0.5, lamb=2.0,
               n_power_series=None, exact_trace=False, brute_force=False, n_samples=1,
               n_exact_terms=2, n_dist="geometric", n_power_series_max=24):
        return cls(net, reverse, reduce_memory, geom_p, lamb, n_power_series, exact_trace,
                   brute_force, n_samples, n_exact_terms, n_dist, n_power_series_max)

    def forward(self, z, context=None, *, generator=None, noise=None):
        """The sampling direction; ``noise`` replays the block's log-det
        draws (:meth:`iResBlock.draw_noise`)."""
        zeros = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        block = self.iresblock
        if self.reverse:
            z, log_det = block.apply_inverse(z, zeros, generator, noise)
        else:
            z, log_det = block.apply_forward(z, zeros, generator, noise)
        return z, -log_det

    def noise_layout(self, shape) -> Optional[dict]:
        """The layout of the sampling direction's draws on a batch of
        ``shape``, None where it draws nothing."""
        return self.iresblock.noise_layout(shape)

    def draw_noise(self, shape, *, generator=None, dtype=torch.float32, device="cpu") -> tuple:
        return self.iresblock.draw_noise(shape, generator=generator, dtype=dtype, device=device)

    def program(self, shape, dtype=torch.float32, device="cpu") -> "_ResidualProgram":
        """The sampling direction on batches of ``shape`` in the form an
        exported program takes (see the module docstring)."""
        return _ResidualProgram(self, shape, dtype, device)

    def inverse(self, z, context=None, *, generator=None):
        zeros = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        block = self.iresblock
        if self.reverse:
            z, log_det = block.apply_forward(z, zeros, generator)
        else:
            z, log_det = block.apply_inverse(z, zeros, generator)
        return z, -log_det

    def set_train(self, train: bool) -> "Residual":
        """The JAX package's name for ``train(train)``; returns the layer."""
        return self.train(train)

    # data-dependent init passes transport only: no log-det, no draws
    def data_dep_init(self, z, context=None):
        if self.reverse:
            return z + self.iresblock.nnet(z)
        return self.iresblock._inverse_fixed_point(z)

    def data_dep_init_forward(self, z, context=None):
        if self.reverse:
            return self.iresblock._inverse_fixed_point(z)
        return z + self.iresblock.nnet(z)


def _fixed_point_program(net, y, atol=1e-5, rtol=1e-5):
    """:meth:`iResBlock._inverse_fixed_point` as a ``while_loop``: the JAX
    package's loop, each step the eager loop's (``net`` a traced graph of
    g)."""
    from torch._higher_order_ops import while_loop

    tol = atol + torch.abs(y) * rtol

    def go(i, x_prev, x):
        return (i < FIXED_POINT_MAX) & torch.any((x - x_prev) ** 2 / tol >= 1.0)

    def step(i, x_prev, x):
        return i + 1, x.clone(), y - net(x)  # a loop's body returns no input itself

    start = (torch.zeros((), dtype=torch.int64, device=y.device), y, y - net(y))
    return while_loop(go, step, start)[2]


class _ResidualProgram(nn.Module):
    """A residual layer's sampling direction on batches of one shape, as a
    program runs it: g and the block's log-det (its draws given, a dynamic
    series capped) graphs traced at that shape."""

    def __init__(self, flow: Residual, shape, dtype, device):
        super().__init__()
        block = flow.iresblock
        self.reverse = flow.reverse
        x = torch.zeros(shape, dtype=dtype, device=device)
        draws = block.draw_noise(shape, generator=torch.Generator(device).manual_seed(0),
                                 dtype=dtype, device=device)
        self.net = trace_graph(block.nnet, x)
        self.log_det = trace_graph(
            lambda x, *noise: block._logdetgrad(x, noise=noise, capped=True), x, *draws)

    def forward(self, z, context=None, *, noise=()):
        zeros = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        if self.reverse:
            x = _fixed_point_program(self.net, z)
            _, log_det = self.log_det(x, *noise)
            return x, -(zeros + log_det)
        g, log_det = self.log_det(z, *noise)
        return z + g, -(zeros - log_det)
