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

import copy

import numpy as np
import torch
import torch.utils.checkpoint
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


class _Call(nn.Module):
    """``layer.forward`` or ``layer.inverse`` as a module's ``forward``, for
    ``torch.func.functional_call``."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer

    def forward(self, z, context, inverse, generator):
        run = self.layer.inverse if inverse else self.layer.forward
        return run(z, context, generator=generator)


def _host_config(module: nn.Module) -> dict:
    """``{(submodule path, attribute): value}`` of the Python-side settings
    of ``module`` and its submodules (public attributes that are neither
    tensors nor modules), and the class of each submodule."""
    out = {}
    for path, sub in module.named_modules():
        out[(path, "__class__")] = type(sub)
        for name, value in vars(sub).items():
            if name.startswith("_") or name == "training" or isinstance(value, nn.Module):
                continue
            out[(path, name)] = value
    return out


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return type(a) is type(b) and a == b


def check_homogeneous(layers, who: str):
    """Raise ``ValueError`` ("``who`` requires homogeneous layers: ...",
    naming the first difference) unless ``layers`` have the same tensors
    (names, shapes, dtypes, devices), the same module classes and equal
    Python-side settings, the host mirrors of a buffer (``host_mirrors``)
    excepted.  Returns each layer's tensors and settings, and the mirrored
    ``(path, attribute)`` keys."""
    first = layers[0]
    tensors = [{**dict(l.named_parameters()), **dict(l.named_buffers())} for l in layers]
    configs = [_host_config(l) for l in layers]
    mirrored = {(path, name) for path, sub in first.named_modules()
                for name in getattr(sub, "host_mirrors", ())}
    for i in range(1, len(layers)):
        if set(tensors[i]) != set(tensors[0]):
            diff = sorted(set(tensors[i]) ^ set(tensors[0]))
            raise ValueError(f"{who} requires homogeneous layers: layer {i} differs "
                             f"from layer 0 in its tensors ({diff[0]})")
        for name, t in tensors[i].items():
            t0 = tensors[0][name]
            if t.shape != t0.shape or t.dtype != t0.dtype or t.device != t0.device:
                raise ValueError(
                    f"{who} requires homogeneous layers: {name} of layer {i} is "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}, layer 0's "
                    f"{tuple(t0.shape)} {t0.dtype} on {t0.device}")
        for key in sorted(set(configs[i]) | set(configs[0]), key=str):
            if key in mirrored:
                continue
            if key not in configs[i] or key not in configs[0] or not _equal(
                    configs[i][key], configs[0][key]):
                path, name = key
                raise ValueError(
                    f"{who} requires homogeneous layers: {path + '.' if path else ''}"
                    f"{name} of layer {i} differs from layer 0's (a Python-side setting "
                    f"cannot be stacked)")
    return tensors, configs, mirrored


class ScanChain(Flow):
    """A homogeneous flow stack held as one layer of stacked tensors (port
    of the JAX package's ``ScanChain``, ``core/flow.py:121-182``).

    ``stacked`` is laid out like the first layer, with a leading ``depth``
    axis on every parameter and buffer, so that its names
    (``stacked.<layer path>``) mirror the JAX package's ``.stacked`` leaves.
    ``forward`` runs layer 0 to depth - 1 and ``inverse`` the reverse, each
    layer a ``torch.func.functional_call`` of ``stacked`` on the slices
    ``t[i]`` (views: a call allocates no stacked copy).  With ``remat`` each
    layer's call is checkpointed (``torch.utils.checkpoint``, non-reentrant),
    so that its activations are recomputed in the backward pass.

    Build with :meth:`create`: the layers must have the same tensors (names,
    shapes, dtypes), the same module classes and equal Python-side settings,
    else it raises ``ValueError`` naming the first that differs.  The one
    exception is an attribute a module lists in ``host_mirrors`` (a host
    copy of one of its buffers, such as ``MADE.input_order_host``): that is
    kept for each layer and set on ``stacked`` before the layer runs.
    """

    def __init__(self, stacked: nn.Module, depth: int, remat: bool = False, host=None):
        super().__init__()
        self.stacked = stacked
        self.depth = depth
        self.remat = remat
        # per layer: {(submodule path, attribute): value} of the host mirrors
        self.host = list(host) if host is not None else [{} for _ in range(depth)]

    @classmethod
    def create(cls, layers, remat: bool = False):
        layers = list(layers)
        if not layers:
            raise ValueError("ScanChain needs at least one layer")
        first = layers[0]
        tensors, configs, mirrored = check_homogeneous(layers, "ScanChain")
        stacked = copy.deepcopy(first)
        with torch.no_grad():
            for name, t in tensors[0].items():
                owner, _, attr = name.rpartition(".")
                module = stacked.get_submodule(owner)
                value = torch.stack([ts[name].detach() for ts in tensors])
                if isinstance(t, nn.Parameter):
                    setattr(module, attr, nn.Parameter(value, requires_grad=t.requires_grad))
                else:
                    module._buffers[attr] = value
        host = [{key: copy.deepcopy(c[key]) for key in sorted(mirrored, key=str)}
                for c in configs]
        return cls(stacked, len(layers), remat, host)

    def _slices(self, i: int) -> dict:
        return {f"layer.{n}": t[i] for n, t in [*self.stacked.named_parameters(),
                                                  *self.stacked.named_buffers()]}

    def _set_host(self, i: int):
        for (path, name), value in self.host[i].items():
            setattr(self.stacked.get_submodule(path), name, value)

    def _layer(self, i, z, context, inverse, generator):
        call = _Call(self.stacked)
        slices = self._slices(i)
        names = list(slices)

        def run(z_, *ts):
            self._set_host(i)
            try:
                return torch.func.functional_call(call, dict(zip(names, ts)),
                                                  (z_, context, inverse, generator))
            finally:
                self._set_host(0)

        if self.remat:
            return torch.utils.checkpoint.checkpoint(run, z, *slices.values(),
                                                     use_reentrant=False)
        return run(z, *slices.values())

    def _run(self, z, context, inverse, generator):
        log_det = zero_log_det_like_z(z)
        for i in (reversed(range(self.depth)) if inverse else range(self.depth)):
            z, ld = self._layer(i, z, context, inverse, generator)
            log_det = log_det + ld
        return z, log_det

    def forward(self, z, context=None, *, generator=None):
        return self._run(z, context, False, generator)

    def inverse(self, z, context=None, *, generator=None):
        return self._run(z, context, True, generator)

    def layers(self) -> list:
        """Unstack into one module a layer (copies of the tensors)."""
        out = []
        for i in range(self.depth):
            layer = copy.deepcopy(self.stacked)
            with torch.no_grad():
                for name, p in self.stacked.named_parameters():
                    owner, _, attr = name.rpartition(".")
                    setattr(layer.get_submodule(owner), attr,
                            nn.Parameter(p[i].detach().clone(), requires_grad=p.requires_grad))
                for name, b in self.stacked.named_buffers():
                    owner, _, attr = name.rpartition(".")
                    layer.get_submodule(owner)._buffers[attr] = b[i].clone()
            for (path, name), value in self.host[i].items():
                setattr(layer.get_submodule(path), name, copy.deepcopy(value))
            out.append(layer)
        return out
