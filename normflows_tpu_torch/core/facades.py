"""Model facade (port of ``NormalizingFlow`` in ``normflows_tpu/core/facades.py``).

``forward`` is latent -> data (sampling); ``inverse`` is data -> latent
(density).  ``sample`` and ``reverse_kld`` draw from an explicit
``torch.Generator`` where the JAX version takes a key.  ``reverse_alpha_div``
waits for a later slice of the port.

Persistence (facades.py:220-335 of the JAX package): ``save`` pickles a
:func:`compact_copy` of the model with ``torch.save``,
``NormalizingFlow.load`` rebuilds it, and :func:`load_params_like` copies a
saved model's tensors into an existing one, each converted to the model
tensor's dtype, naming the first name or shape that differs.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..ops.backend import resolve_device
from .flow import zero_log_det_like_z


class _LogProb(nn.Module):
    """A flow's ``log_prob`` as a module's ``forward``, so that
    ``torch.func.functional_call`` can run it on other parameters."""

    def __init__(self, flow: nn.Module):
        super().__init__()
        self.flow = flow

    def forward(self, x, context=None):
        return self.flow.log_prob(x, context)


class NormalizingFlow(nn.Module):
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

    # ---- transport -------------------------------------------------------
    def forward(self, z, context=None):
        """Latent -> data, dropping the log-det."""
        for flow in self.flows:
            z, _ = flow.forward(z, context)
        return z

    def forward_and_log_det(self, z, context=None):
        log_det = zero_log_det_like_z(z)
        for flow in self.flows:
            z, ld = flow.forward(z, context)
            log_det = log_det + ld
        return z, log_det

    def inverse(self, x, context=None):
        """Data -> latent, dropping the log-det."""
        for flow in reversed(self.flows):
            x, _ = flow.inverse(x, context)
        return x

    def inverse_and_log_det(self, x, context=None):
        log_det = zero_log_det_like_z(x)
        for flow in reversed(self.flows):
            x, ld = flow.inverse(x, context)
            log_det = log_det + ld
        return x, log_det

    # ---- densities -------------------------------------------------------
    def log_prob(self, x, context=None):
        z, log_q = self.inverse_and_log_det(x, context)
        return log_q + self.q0.log_prob(z, context)

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        """Returns ``(x, log_q)``: samples and their log-density."""
        z, log_q = self.q0.sample_and_log_prob(num_samples, context, generator=generator)
        for flow in self.flows:
            z, ld = flow.forward(z, context)
            log_q = log_q - ld
        return z, log_q

    # distribution-protocol alias: a flow serves wherever a base
    # distribution does
    def sample_and_log_prob(self, num_samples: int = 1, context=None, *,
                            generator: Optional[torch.Generator] = None):
        return self.sample(num_samples, context, generator=generator)

    def from_noise(self, eps, context=None):
        """``(x, log_q)`` of :meth:`sample` with the base draws given: ``eps``
        (num_samples, *event) is the base's noise, drawn by its
        ``noise_spec`` (``distributions.base.draw_noise``), so that
        ``sample(n, generator=g)`` is ``from_noise(draw_noise(...))`` on
        the same draws.  The program ``serving.export_sampler`` exports."""
        z, log_q = self.q0.from_noise(eps, context)
        for flow in self.flows:
            z, ld = flow.forward(z, context)
            log_q = log_q - ld
        return z, log_q

    # ---- training objectives --------------------------------------------
    def forward_kld(self, x, context=None):
        """-E_p[log q(x)], the maximum-likelihood loss."""
        return -torch.mean(self.log_prob(x, context))

    def reverse_kld(self, num_samples: int = 1, context=None, beta: float = 1.0,
                    score_fn: bool = True, z_sharding=None, *,
                    generator: Optional[torch.Generator] = None):
        """E_q[log q] - beta E_q[log p] on ``num_samples`` draws of the model.

        ``score_fn=False`` drops the score-function term (sticking the landing,
        Roeder et al. 2017): log q is computed again at the sampled z through
        a copy of the model whose parameters are detached, so its gradient
        reaches the parameters only through z.  ``z_sharding`` (a sharded
        sample axis in the JAX package) waits for the parallel slice of the
        port."""
        if z_sharding is not None:
            raise NotImplementedError(
                "z_sharding waits for the parallel slice of the PyTorch port")
        z, log_q = self.sample(num_samples, context, generator=generator)
        if not score_fn:
            detached = {f"flow.{name}": p.detach() for name, p in self.named_parameters()}
            log_q = torch.func.functional_call(_LogProb(self), detached, (z, context))
        log_p = self.p.log_prob(z) if context is None else self.p.log_prob(z, context)
        return torch.mean(log_q) - beta * torch.mean(log_p)

    # ---- persistence -----------------------------------------------------
    def save(self, path: str):
        """Pickle the whole model (its classes by import path, every tensor
        where it lies) with ``torch.save``, as :func:`compact_copy` gives
        it: no storage beyond the model's own tensors goes into the file."""
        torch.save(compact_copy(self), path)

    @classmethod
    def load(cls, path: str):
        """Rebuild a model written by :meth:`save`; a file that holds
        another class raises ``TypeError``.  This unpickles the file, which
        can run code: load only files this program wrote."""
        obj = torch.load(path, weights_only=False)
        if not isinstance(obj, cls):
            raise TypeError(f"checkpoint at {path} contains {type(obj).__name__}, "
                            f"not {cls.__name__}")
        return obj


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


def load_params_like(model: nn.Module, path: str) -> nn.Module:
    """Copy the tensors of a model written by :meth:`NormalizingFlow.save`
    into ``model`` in place, with :func:`copy_tensors_like`'s checks, and
    return it.  This unpickles the file: load only files this program
    wrote."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(obj, nn.Module):
        raise TypeError(f"checkpoint at {path} contains {type(obj).__name__}, not a model")
    return copy_tensors_like(model, obj.state_dict(), f"checkpoint at {path}")
