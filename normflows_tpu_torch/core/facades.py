"""Model facades (port of ``NormalizingFlow``, ``ConditionalNormalizingFlow``,
``ClassCondFlow`` and ``MultiscaleFlow`` in ``normflows_tpu/core/facades.py``).

``forward`` is latent -> data (sampling); ``inverse`` is data -> latent
(density).  Every method takes ``context`` and hands it to the base, to
every flow and, in the reverse objectives, to the target.

Randomness is a ``torch.Generator`` passed as ``generator=``, where the JAX
version takes a key, and the dropout of the flows' parameter nets follows
the JAX package's rule, method by method:

* ``forward``, ``forward_and_log_det``, ``inverse``, ``inverse_and_log_det``,
  ``log_prob`` and ``forward_kld`` hand the flows the caller's generator:
  dropout acts only when one is passed;
* ``sample``, ``sample_and_log_prob``, ``reverse_kld`` and
  ``reverse_alpha_div`` always draw, so where a net has
  ``dropout_probability > 0``, or a residual block's log-det estimator is
  stochastic, the flows get the generator (torch's default one for the
  device when the caller passes None) and dropout acts.

One generator serves the base and every layer in turn, where the JAX
package splits its key into one per layer.  The detached second pass of
``reverse_kld(score_fn=False)`` and of ``reverse_alpha_div(dreg=True)``
gives each layer the generator's state at that layer's first pass, as the
JAX package reuses each layer's key.

ActNorm layers are initialised once, explicitly, from data: ``init_actnorm``
(a density-direction batch; ``MultiscaleFlow`` walks its levels in reverse
through the merges' ``inverse``) or ``init_actnorm_sampling`` (the model's
own draws), in place, as the JAX package's functional passes do.

An MCMC layer (``flows.MetropolisHastings``, ``flows.HamiltonianMonteCarlo``)
draws on every call: the methods that always draw hand it the generator,
and the others hand it the caller's, without which it raises, as the JAX
layers raise without a key.  ``from_noise`` takes the base's noise only and
refuses a model with such a layer.

``NormalizingFlowVAE`` is the flow-VAE: an encoder ``q0``, flows on its
samples, a prior and an optional decoder.

``MultiscaleFlow`` (Glow's multiscale architecture) takes a class label
``y`` where its bases are class-conditional; ``sample`` with ``y=None``
draws the labels first (``distributions.base.draw_labels``), then each
level's noise, from the generator.  Its temperature is set in place
(``set_temperature``), where the JAX package returns a new model;
``sample(..., temperature=t)`` sets it for the call and restores the
bases' own after it.

Persistence (facades.py:220-335 of the JAX package): ``save`` and
:func:`save_model` pickle a :func:`compact_copy` of the model with
``torch.save``, ``NormalizingFlow.load`` and :func:`load_model` rebuild it,
and :func:`load_params_like` copies a saved model's tensors into an existing one, each converted to the model
tensor's dtype, naming the first name or shape that differs.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..distributions.base import draw_labels, draw_noise
from ..flows.stochastic import mcmc_layers
from ..ops.backend import resolve_device
from .flow import forward_data_dep_init, zero_log_det_like_z


def _default_generator(device) -> torch.Generator:
    """torch's default generator of ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator


class _LogProb(nn.Module):
    """A flow's ``log_prob`` as a module's ``forward``, so that
    ``torch.func.functional_call`` can run it on other parameters.  With
    ``states`` (one generator state a layer), each layer's inverse draws
    from ``generator`` set to its state."""

    def __init__(self, flow: nn.Module):
        super().__init__()
        self.flow = flow

    def forward(self, x, context=None, generator=None, states=None):
        if states is None:
            return self.flow.log_prob(x, context)
        log_q = zero_log_det_like_z(x)
        for flow, state in zip(reversed(self.flow.flows), reversed(states)):
            generator.set_state(state)
            x, ld = flow.inverse(x, context, generator=generator)
            log_q = log_q + ld
        return log_q + self.flow.q0.log_prob(x, context)


class _Saved:
    """``save`` / ``load`` of a whole model."""

    def save(self, path: str):
        """Pickle the whole model (its classes by import path, every tensor
        where it lies) with ``torch.save``, as :func:`compact_copy` gives
        it: no storage beyond the model's own tensors goes into the file."""
        save_model(self, path)

    @classmethod
    def load(cls, path: str):
        """Rebuild a model written by :meth:`save`; a file that holds
        another class raises ``TypeError``.  This unpickles the file, which
        can run code: load only files this program wrote."""
        obj = load_model(path)
        if not isinstance(obj, cls):
            raise TypeError(f"checkpoint at {path} contains {type(obj).__name__}, "
                            f"not {cls.__name__}")
        return obj


class NormalizingFlow(_Saved, nn.Module):
    """Base distribution ``q0``, flow chain ``flows`` and optional target ``p``."""

    def __init__(self, q0: nn.Module, flows, p: Optional[nn.Module] = None):
        super().__init__()
        self.q0 = q0
        self.flows = nn.ModuleList(flows)
        self.p = p

    @classmethod
    def create(cls, q0, flows, p=None, *, device="cuda"):
        """Raises if a tensor of ``q0`` or ``flows`` lies off ``device``."""
        device = resolve_device(device)
        model = cls(q0, flows, p)
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if t.device.type != device.type:
                raise ValueError(f"NormalizingFlow.create: {name} lies on {t.device}, "
                                 f"not on {device}")
        return model

    def _draws(self) -> bool:
        """Whether a flow now draws: a block of a flow's net has
        ``dropout_probability > 0``, a residual block's log-det
        estimator is stochastic in its current mode
        (``iResBlock.log_det_draws``), or the flow is an MCMC layer (whose
        ``log_det_draws`` always holds).
        The modules that carry either are found by a search of every module
        (~0.3 ms of host time on the flagship), made again whenever
        ``self.flows`` holds other flows than at the last search; their
        settings are read at every call, as the flows read them.  A net
        swapped inside a flow after a call is not seen."""
        flows = tuple(self.flows)
        found = self.__dict__.get("_drawing_modules")
        if found is None or found[0] != flows:
            found = (flows, [m for m in self.flows.modules()
                             if hasattr(m, "dropout_probability")
                             or hasattr(m, "log_det_draws")])
            self.__dict__["_drawing_modules"] = found
        return any(m.log_det_draws() if hasattr(m, "log_det_draws")
                   else m.dropout_probability > 0.0 for m in found[1])

    def _drawing(self, generator, device) -> Optional[torch.Generator]:
        """The generator the flows get in a method that always draws: the
        caller's, or the device's default one, where a flow draws (dropout,
        a residual block's estimator); None otherwise."""
        if not self._draws():
            return None
        return generator if generator is not None else _default_generator(device)

    # ---- transport -------------------------------------------------------
    def forward(self, z, context=None, *, generator: Optional[torch.Generator] = None):
        """Latent -> data, dropping the log-det."""
        for flow in self.flows:
            z, _ = flow.forward(z, context, generator=generator)
        return z

    def forward_and_log_det(self, z, context=None, *,
                            generator: Optional[torch.Generator] = None):
        log_det = zero_log_det_like_z(z)
        for flow in self.flows:
            z, ld = flow.forward(z, context, generator=generator)
            log_det = log_det + ld
        return z, log_det

    def inverse(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        """Data -> latent, dropping the log-det."""
        for flow in reversed(self.flows):
            x, _ = flow.inverse(x, context, generator=generator)
        return x

    def inverse_and_log_det(self, x, context=None, *,
                            generator: Optional[torch.Generator] = None):
        log_det = zero_log_det_like_z(x)
        for flow in reversed(self.flows):
            x, ld = flow.inverse(x, context, generator=generator)
            log_det = log_det + ld
        return x, log_det

    # ---- densities -------------------------------------------------------
    def log_prob(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        z, log_q = self.inverse_and_log_det(x, context, generator=generator)
        return log_q + self.q0.log_prob(z, context)

    def _draw(self, num_samples, context, generator, states=None):
        """Base draws through the flows: ``(x, log_q)``; with ``states`` (a
        list), the flows' generator state before each layer is appended."""
        z, log_q = self.q0.sample_and_log_prob(num_samples, context, generator=generator)
        return self._through_flows(z, log_q, context, generator, states)

    def _through_flows(self, z, log_q, context, generator, states=None):
        """Base draws ``(z, log_q)`` through the flows (see :meth:`_draw`)."""
        g = self._drawing(generator, z.device)
        for flow in self.flows:
            if states is not None and g is not None:
                states.append(g.get_state())
            z, ld = flow.forward(z, context, generator=g)
            log_q = log_q - ld
        return z, log_q

    def _log_q_detached(self, z, context, generator, states):
        """log q at ``z`` through a copy of the model whose parameters are
        detached (its gradient reaches the parameters only through ``z``),
        each layer's dropout drawn as in its first pass."""
        detached = {f"flow.{name}": p.detach() for name, p in self.named_parameters()}
        g = self._drawing(generator, z.device)
        if g is None:
            return torch.func.functional_call(_LogProb(self), detached, (z, context))
        after = g.get_state()
        log_q = torch.func.functional_call(_LogProb(self), detached, (z, context),
                                           {"generator": g, "states": states})
        g.set_state(after)
        return log_q

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        """Returns ``(x, log_q)``: samples and their log-density."""
        return self._draw(num_samples, context, generator)

    # distribution-protocol alias: a flow serves wherever a base
    # distribution does
    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        return self.sample(num_samples, context, generator=generator)

    def drawing_flows(self, num_samples: int) -> list:
        """``(index, layout)`` of each flow that draws in the sampling
        direction on ``num_samples`` draws (an MCMC layer; a residual layer
        whose log-det draws in its mode), in order, its layout that of
        ``distributions.base.draw_layout``.  The layers keep the base's
        event shape."""
        shape = (num_samples, *self.q0.noise_shape)
        found = []
        for i, flow in enumerate(self.flows):
            layout = flow.noise_layout(shape) if hasattr(flow, "noise_layout") else None
            if layout is not None:
                found.append((i, layout))
        return found

    def draw_noise(self, num_samples: int, *, generator: Optional[torch.Generator] = None):
        """``(eps, layer_noise)``, every draw of :meth:`sample` in its order:
        the base's noise (by its ``noise_spec``), then one tuple a drawing
        flow (:meth:`drawing_flows`), from the generator the flows get (the
        device's default one where ``generator`` is None).
        ``from_noise(eps, layer_noise=layer_noise)`` is then ``sample(n,
        generator=g)``."""
        ref = next(iter([*self.q0.parameters(), *self.q0.buffers()]))
        eps = draw_noise(self.q0.noise_spec, self.q0.noise_shape, num_samples,
                         generator=generator, dtype=ref.dtype, device=ref.device)
        drawing = self.drawing_flows(num_samples)
        g = self._drawing(generator, ref.device) if drawing else None
        shape = (num_samples, *self.q0.noise_shape)
        return eps, [self.flows[i].draw_noise(shape, generator=g, dtype=ref.dtype,
                                              device=ref.device) for i, _ in drawing]

    def from_noise(self, eps, context=None, layer_noise=None):
        """``(x, log_q)`` of :meth:`sample` with the draws given: ``eps``
        (num_samples, *event) is the base's noise, drawn by its
        ``noise_spec`` (``distributions.base.draw_noise``), and
        ``layer_noise`` one tuple a flow that draws (:meth:`drawing_flows`:
        an MCMC layer's moves, a residual layer's log-det), so that
        ``sample(n, generator=g)`` is ``from_noise(eps, layer_noise=noise)``
        for ``eps, noise = draw_noise(n, generator=g)``.  What
        ``serving.export_sampler`` exports.  Dropout stays off."""
        drawing = dict(self.drawing_flows(eps.shape[0])) if layer_noise is not None else {}
        if layer_noise is None and mcmc_layers(self.flows):
            raise ValueError("from_noise of a model with an MCMC layer takes every layer's "
                             "draws: pass layer_noise (draw_noise gives them)")
        if len(drawing) != len(layer_noise or ()):
            raise ValueError(f"layer_noise holds {len(layer_noise)} entries; this model's "
                             f"flows draw at {len(drawing)} layers (drawing_flows)")
        noises = iter(layer_noise or ())
        z, log_q = self.q0.from_noise(eps, context)
        for i, flow in enumerate(self.flows):
            if i in drawing:
                z, ld = flow.forward(z, context, noise=next(noises))
            else:
                z, ld = flow.forward(z, context)
            log_q = log_q - ld
        return z, log_q

    # ---- training objectives --------------------------------------------
    def forward_kld(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        """-E_p[log q(x)], the maximum-likelihood loss."""
        return -torch.mean(self.log_prob(x, context, generator=generator))

    def reverse_kld(self, num_samples: int = 1, context=None, beta: float = 1.0,
                    score_fn: bool = True, z_sharding=None, *,
                    generator: Optional[torch.Generator] = None):
        """E_q[log q] - beta E_q[log p] on ``num_samples`` draws of the model.

        ``score_fn=False`` drops the score-function term (sticking the landing,
        Roeder et al. 2017): log q is computed again at the sampled z through
        a copy of the model whose parameters are detached, so its gradient
        reaches the parameters only through z.

        ``z_sharding`` (``parallel.batch_sharding(mesh, z.dim(), axis)``)
        splits the sample axis over the ranks: every rank draws the GLOBAL
        ``num_samples`` base draws from ``generator`` (seeded alike on every
        rank), keeps its own rows (and those of a context with a row a
        sample) and runs its part of the flow; the result is the mean over
        this rank's rows, and its mean over the ranks (what
        ``parallel.make_reverse_kld_step`` averages) is the loss on the
        global draws.  Draws of the flows themselves (dropout, stochastic
        layers) are made for this rank's rows."""
        states = [] if not score_fn else None
        z, log_q = self.q0.sample_and_log_prob(num_samples, context, generator=generator)
        if z_sharding is not None:
            rows = z_sharding.rows(num_samples)
            z, log_q = z_sharding.local(z), log_q[rows]
            if context is not None and context.shape[0] == num_samples:
                context = context[rows]
        z, log_q = self._through_flows(z, log_q, context, generator, states)
        if not score_fn:
            log_q = self._log_q_detached(z, context, generator, states)
        log_p = self.p.log_prob(z) if context is None else self.p.log_prob(z, context)
        return torch.mean(log_q) - beta * torch.mean(log_p)

    def reverse_alpha_div(self, num_samples: int = 1, alpha: float = 1.0, dreg: bool = False,
                          context=None, *, generator: Optional[torch.Generator] = None):
        """The alpha-divergence loss on ``num_samples`` draws of the model:
        sign(alpha - 1) logsumexp(alpha (log p - log q)); with ``dreg``, the
        doubly reparameterised gradient estimator (Tucker et al. 2019), whose
        log q is that of a detached copy of the model, as in
        :meth:`reverse_kld`."""
        states = [] if dreg else None
        z, log_q = self._draw(num_samples, context, generator, states)
        log_p = self.p.log_prob(z)
        if not dreg:
            return float(np.sign(alpha - 1)) * torch.logsumexp(alpha * (log_p - log_q), 0)
        w_const = torch.exp(log_p - log_q).detach()
        log_q = self._log_q_detached(z, context, generator, states)
        w = torch.exp(log_p - log_q)
        w_alpha = w_const**alpha
        w_alpha = w_alpha / torch.mean(w_alpha)
        weights = (1 - alpha) * w_alpha + alpha * w_alpha**2
        return -alpha * torch.mean(weights * torch.log(w))

    # ---- data-dependent init (ActNorm) -----------------------------------
    @torch.no_grad()
    def init_actnorm(self, x, context=None):
        """One density-direction pass over ``x`` that initialises every
        ActNorm layer from the data it meets, in place; returns the model."""
        for flow in reversed(self.flows):
            x = flow.data_dep_init(x, context)
        return self

    @torch.no_grad()
    def init_actnorm_sampling(self, num_samples: int = 128, context=None, *,
                              generator: Optional[torch.Generator] = None):
        """The same from a sampling-direction pass of ``num_samples`` base
        draws (the initialisation a model trained by reverse KL takes)."""
        z, _ = self.q0.sample_and_log_prob(num_samples, context, generator=generator)
        for flow in self.flows:
            z = forward_data_dep_init(flow, z, context)
        return self


class ConditionalNormalizingFlow(NormalizingFlow):
    """A flow conditioned on a context, which every method hands to the
    base, to every layer and, in ``reverse_kld``, to the target's
    ``log_prob``.  ``NormalizingFlow`` already does all of that; the class
    mirrors the JAX package's API."""


class ClassCondFlow(_Saved, nn.Module):
    """A flow whose class label ``y`` conditions only the base ``q0``."""

    def __init__(self, q0: nn.Module, flows):
        super().__init__()
        self.q0 = q0
        self.flows = nn.ModuleList(flows)

    @classmethod
    def create(cls, q0, flows):
        return cls(q0, flows)

    def log_prob(self, x, y):
        log_q = zero_log_det_like_z(x)
        z = x
        for flow in reversed(self.flows):
            z, ld = flow.inverse(z)
            log_q = log_q + ld
        return log_q + self.q0.log_prob(z, y)

    def forward_kld(self, x, y):
        return -torch.mean(self.log_prob(x, y))

    def from_noise(self, eps, y):
        """``(x, log_q)`` of the base's unit draws ``eps`` at labels ``y``."""
        z, log_q = self.q0.from_noise(eps, y)
        for flow in self.flows:
            z, ld = flow.forward(z)
            log_q = log_q - ld
        return z, log_q

    def sample(self, num_samples: int = 1, y=None, *,
               generator: Optional[torch.Generator] = None):
        """``(x, log_q)``; without ``y`` the base draws the labels."""
        z, log_q = self.q0.sample_and_log_prob(num_samples, y, generator=generator)
        for flow in self.flows:
            z, ld = flow.forward(z)
            log_q = log_q - ld
        return z, log_q


class MultiscaleFlow(_Saved, nn.Module):
    """Glow / Real NVP's multiscale architecture: ``q0`` one base a level
    (level 0 the innermost), ``flows`` one list of flows a level, ``merges``
    the ``Merge`` flows between levels, an optional data-space
    ``transform`` (``transforms.Logit``), and ``class_cond``: whether the
    bases take the class label ``y``."""

    def __init__(self, q0, flows, merges, transform: Optional[nn.Module] = None,
                 class_cond: bool = True):
        super().__init__()
        self.q0 = nn.ModuleList(q0)
        self.flows = nn.ModuleList(nn.ModuleList(level) for level in flows)
        self.merges = nn.ModuleList(merges)
        self.transform = transform
        self.class_cond = class_cond

    @classmethod
    def create(cls, q0, flows, merges, transform=None, class_cond: bool = True):
        return cls(q0, flows, merges, transform, class_cond)

    @property
    def num_levels(self) -> int:
        return len(self.q0)

    @property
    def noise_levels(self):
        """``(noise_spec, event_shape)`` of each level's base."""
        return [(tuple(q.noise_spec), tuple(q.event_shape)) for q in self.q0]

    def _context(self, y):
        return y if self.class_cond else None

    def _base_tensor(self):
        """A tensor of the bases (a parameter, or a buffer of a fixed base):
        where and in which dtype their draws are made."""
        return next(iter([*self.q0.parameters(), *self.q0.buffers()]))

    # ---- transport -------------------------------------------------------
    def forward_and_log_det(self, z_list):
        """The latents of every level -> data, and the log-det."""
        log_det = zero_log_det_like_z(z_list[0])
        z = None
        for i in range(self.num_levels):
            if i == 0:
                z = z_list[0]
            else:
                z, ld = self.merges[i - 1].forward([z, z_list[i]])
                log_det = log_det + ld
            for flow in self.flows[i]:
                z, ld = flow.forward(z)
                log_det = log_det + ld
        if self.transform is not None:
            z, ld = self.transform.forward(z)
            log_det = log_det + ld
        return z, log_det

    def inverse_and_log_det(self, x):
        """Data -> the latents of every level (level 0 first), and the
        log-det."""
        log_det = zero_log_det_like_z(x)
        if self.transform is not None:
            x, ld = self.transform.inverse(x)
            log_det = log_det + ld
        z_list, z = [], x
        for i in range(self.num_levels - 1, -1, -1):
            for flow in reversed(self.flows[i]):
                z, ld = flow.inverse(z)
                log_det = log_det + ld
            if i > 0:
                (z, z_i), ld = self.merges[i - 1].inverse(z)
                log_det = log_det + ld
                z_list.append(z_i)
            else:
                z_list.append(z)
        return list(reversed(z_list)), log_det

    # ---- densities and draws ---------------------------------------------
    def log_prob(self, x, y=None):
        z_list, log_q = self.inverse_and_log_det(x)
        for q, z in zip(self.q0, z_list):
            log_q = log_q + q.log_prob(z, self._context(y))
        return log_q

    def forward_kld(self, x, y=None):
        return -torch.mean(self.log_prob(x, y))

    def forward(self, x, y=None):
        """The negative log-likelihood of ``x``."""
        return -self.log_prob(x, y)

    def draw_noise(self, num_samples: int, *, generator: Optional[torch.Generator] = None):
        """Each level's unit draws, level 0 first (the sampler's input)."""
        t = self._base_tensor()
        return [draw_noise(spec, event, num_samples, generator=generator, dtype=t.dtype,
                           device=t.device) for spec, event in self.noise_levels]

    def from_noise(self, eps, y=None):
        """``(x, log_q)`` of :meth:`sample` with each level's draws given
        (``eps``, a list, level 0 first) and, for a class-conditional
        model, the labels ``y``.  The program ``serving.export_sampler``
        exports."""
        z_list, log_q = [], 0.0
        for q, e in zip(self.q0, eps):
            z, log_p = q.from_noise(e, self._context(y))
            z_list.append(z)
            log_q = log_q + log_p
        x, log_det = self.forward_and_log_det(z_list)
        return x, log_q - log_det

    def sample(self, num_samples: int = 1, y=None, temperature: Optional[float] = None, *,
               generator: Optional[torch.Generator] = None):
        """``(x, log_q)`` of ``num_samples`` draws: the labels first where the
        model is class-conditional and ``y`` is None, then each level's
        noise.  ``temperature`` holds for this call only."""
        saved = [q.temperature for q in self.q0]
        if temperature is not None:
            self.set_temperature(temperature)
        try:
            if self.class_cond and y is None:
                y = draw_labels(num_samples, _num_classes_of(self.q0[0]),
                                generator=generator, device=self._base_tensor().device)
            if y is not None:
                num_samples = y.shape[0]
            return self.from_noise(self.draw_noise(num_samples, generator=generator), y)
        finally:
            for q, t in zip(self.q0, saved):
                q.temperature = t

    def set_temperature(self, temperature: Optional[float]):
        """Every base's temperature, in place; returns the model."""
        for q in self.q0:
            if not hasattr(q, "temperature"):
                raise NotImplementedError(
                    "One base distribution does not support temperature annealing")
        for q in self.q0:
            q.temperature = temperature
        return self

    def reset_temperature(self):
        return self.set_temperature(None)

    # ---- data-dependent init (ActNorm) -----------------------------------
    @torch.no_grad()
    def init_actnorm(self, x, y=None):
        """Initialise every ActNorm layer from ``x`` in one density-direction
        pass over the levels (innermost last, through the merges'
        ``inverse``), in place; returns the model."""
        z = x
        if self.transform is not None:
            z, _ = self.transform.inverse(z)
        for i in range(self.num_levels - 1, -1, -1):
            for flow in reversed(self.flows[i]):
                z = flow.data_dep_init(z)
            if i > 0:
                (z, _), _ = self.merges[i - 1].inverse(z)
        return self


class NormalizingFlowVAE(nn.Module):
    """A VAE whose posterior is the encoder ``q0`` followed by ``flows``;
    ``prior`` the latent prior, ``decoder`` (optional) p(x | z)."""

    def __init__(self, prior: nn.Module, q0: nn.Module, flows,
                 decoder: Optional[nn.Module] = None):
        super().__init__()
        self.prior = prior
        self.decoder = decoder
        self.flows = nn.ModuleList(flows)
        self.q0 = q0

    @classmethod
    def create(cls, prior, q0, flows, decoder=None):
        return cls(prior, q0, flows, decoder)

    def forward(self, x, num_samples: int = 1, *,
                generator: Optional[torch.Generator] = None, noise=None):
        """``(z, log_q, log_p)``, each (batch, num_samples, ...): the
        encoder's draws from ``generator`` (or its noise ``noise``,
        (batch, num_samples, *latent)) through the flows, flattened to
        (batch * num_samples, ...) on the way; log_p is the prior's plus,
        with a decoder, log p(x | z)."""
        if noise is None:
            z, log_q = self.q0.sample_and_log_prob(x, num_samples, generator=generator)
        else:
            z, log_q = self.q0.from_noise(noise, x)
        batch, samples = z.shape[0], z.shape[1]
        z = z.reshape(-1, *z.shape[2:])
        log_q = log_q.reshape(-1)
        for flow in self.flows:
            z, ld = flow.forward(z)
            log_q = log_q - ld
        log_p = self.prior.log_prob(z)
        if self.decoder is not None:
            log_p = log_p + self.decoder.log_prob(x.repeat_interleave(samples, dim=0), z)
        return (z.reshape(batch, samples, *z.shape[1:]), log_q.reshape(batch, samples),
                log_p.reshape(batch, samples))


def _num_classes_of(q0) -> int:
    nc = getattr(q0, "num_classes", None)
    if nc is None:
        raise ValueError("class-conditional sampling requires q0.num_classes")
    return nc


def compact_copy(model: nn.Module) -> nn.Module:
    """A deep copy of ``model`` whose every parameter and buffer owns a
    storage of its own bytes; ``model`` keeps its tensors.

    A chunked trainer makes each parameter a view of a flat buffer that also
    holds Adam's moments (``training.loop``), and ``torch.save`` or
    ``torch.export`` of a view writes its whole storage: ``save`` and
    ``serving``'s exports take this copy instead."""
    copied = copy.deepcopy(model)
    with torch.no_grad():
        for t in [*copied.parameters(), *copied.buffers()]:
            if t.untyped_storage().nbytes() != t.numel() * t.element_size():
                t.data = t.data.clone(memory_format=torch.contiguous_format)
    return copied


def copy_tensors_like(model: nn.Module, saved: dict, source: str) -> nn.Module:
    """Copy ``saved`` (a state dict: name -> tensor) into ``model``'s
    parameters and buffers in place, each converted to the model tensor's
    dtype and device (a bfloat16 model loaded from a float32 checkpoint stays
    bfloat16).  The names must be the model's, in its order, and the shapes
    its: the first name or shape that differs raises ``ValueError`` naming
    it, before anything is copied."""
    current = model.state_dict(keep_vars=True)
    names, saved_names = list(current), list(saved)
    for i, (mine, theirs) in enumerate(zip(names, saved_names)):
        if mine != theirs:
            raise ValueError(f"{source} does not match the model: first differing path "
                             f"(entry {i}): model has {mine!r}, checkpoint has {theirs!r}")
    if len(names) != len(saved_names):
        longer, which = (names, "model") if len(names) > len(saved_names) \
            else (saved_names, "checkpoint")
        raise ValueError(f"{source} does not match the model: the model has {len(names)} "
                         f"entries, the checkpoint {len(saved_names)}; first unmatched path "
                         f"{longer[min(len(names), len(saved_names))]!r} (in the {which})")
    for name in names:
        if tuple(saved[name].shape) != tuple(current[name].shape):
            raise ValueError(f"{source}: {name!r} has shape {tuple(saved[name].shape)}, "
                             f"the model expects {tuple(current[name].shape)}")
    with torch.no_grad():
        for name in names:
            current[name].copy_(saved[name])
    return model


def save_model(model: nn.Module, path: str):
    """Pickle ``model`` whole with ``torch.save``, as :func:`compact_copy`
    gives it (the JAX package's ``save_model``)."""
    torch.save(compact_copy(model), path)


def load_model(path: str) -> nn.Module:
    """The ``nn.Module`` that :func:`save_model` (or a facade's ``save``)
    wrote at ``path``, whatever its class; a file that holds anything else
    raises ``TypeError``.  This unpickles the file, which can run code: load
    only files this program wrote."""
    obj = torch.load(path, weights_only=False)
    if not isinstance(obj, nn.Module):
        raise TypeError(f"checkpoint at {path} contains {type(obj).__name__}, not a model "
                        f"(an nn.Module)")
    return obj


def load_params_like(model: nn.Module, path: str) -> nn.Module:
    """Copy the tensors of a model written by :meth:`NormalizingFlow.save`
    into ``model`` in place, with :func:`copy_tensors_like`'s checks, and
    return it.  This unpickles the file: load only files this program
    wrote."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(obj, nn.Module):
        raise TypeError(f"checkpoint at {path} contains {type(obj).__name__}, not a model")
    return copy_tensors_like(model, obj.state_dict(), f"checkpoint at {path}")
