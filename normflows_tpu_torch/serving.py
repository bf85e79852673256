"""Model export for serving (port of ``normflows_tpu/serving.py``).

A trained flow is frozen into ``torch.export`` programs: the parameters are
held in the program, which ``torch.export.save`` writes as a ``.pt2`` file
and any later process loads with ``torch.export.load`` and runs with no
model class and nothing unpickled.  Every kernel on the path is an operator
of the port (``normflows_tpu_torch::rqs_transposed`` and the others,
``ops.backend.kernel_op``) and stays one opaque node of the program, so the
loading process must import ``normflows_tpu_torch`` to register them; that
is all the code of the port it needs.

Two entry points are exported per model:

* the sampler, ``eps -> (samples, log_q)`` at a fixed ``num_samples``:
  ``eps`` (num_samples, *event) is the base distribution's unit noise, drawn
  by its ``noise_spec`` (``distributions.base.draw_noise``); a multiscale
  model's (``MultiscaleFlow``) is a list, one tensor a level.  JAX builds its
  PRNG key from the seed inside the graph; ``torch.export`` takes no
  ``torch.Generator``, so the noise is the program's input and
  :meth:`ServingBundle.sample` draws it from
  ``torch.Generator(device).manual_seed(seed)``: the draws the live model's
  ``sample(num_samples, generator=...)`` makes from the same seed.
* ``log_prob(x)``: densities for a data batch whose batch dimension is
  symbolic (``torch.export.Dim``), so one program serves any batch size;
  ``symbolic_batch=False`` with ``batch_size`` exports a concrete batch,
  which the fused MADE needs (its gate asks for a known batch of at least
  ``made_fused.TILE_B``; a symbolic batch takes the unfused pass, as the
  JAX package's symbolic export leaves its Pallas path).

On a card, :meth:`ServingBundle.sample` replays a CUDA graph of the loaded
sampler program: the noise is drawn and copied into the graph's static input,
the graph captured at the first call.  ``log_prob`` runs eagerly, since its
batch is symbolic.  A program exported on the card keeps its device: the
manifest records it, and loading a CUDA bundle without a card raises.

With ``class_cond=True`` (a class-conditional ``MultiscaleFlow`` or a
``ClassCondFlow``) both programs take the labels too: the sampler
``(eps, y) -> (samples, log_q)``, ``log_prob`` ``(x, y)``, ``y`` an integer
label vector (int32 or int64), one label a row, its batch dimension shared
with ``x``'s.  The graphed sampler replays on (noise, y).

Float32 convolutions run with cuDNN's TF32 off inside the port's ``Conv2d``
(``nets.cnn.fp32_convs``); an exported program does not keep that setting,
so :class:`ServingBundle` runs its programs inside ``fp32_convs`` too.

Models that draw past their base noise, and the samplers the JAX package
exports (its ``export_sampler`` traces ``sample_and_log_prob(key, n)`` or
``sample(key, n)``): a ``NormalizingFlow`` with MCMC layers (a stochastic
normalizing flow) or residual layers, ``sampling.HAIS`` and
``sampling.AnnealedSMC``.  Their sampler takes every draw as its input,
``(eps, draws)``: the base's noise, then one tuple a drawing layer
(``NormalizingFlow.drawing_flows``) or, for a sampler, its rungs' draws
stacked; the manifest records their layouts (``"draws"``,
``distributions.base.draw_layout``), and :meth:`ServingBundle.noise` draws
them from the seed in the live model's order, so that a bundle's
``sample(seed)`` is the live ``sample(n, generator=...)`` from the same
seed.  Their programs are the layers' and samplers' program forms
(``program``): ``torch.export`` cannot trace ``torch.autograd.grad`` (an
HMC move's gradient, a residual block's pullbacks), so those run as graphs
traced with ``make_fx`` (``ops.backend.trace_graph``), and the leapfrog
steps and rungs as ``scan`` loops, the residual fixed point as a
``while_loop``.  A program that holds a ``while_loop`` replays eagerly
(manifest ``"route": "eager"``; its loop reads the device each step); the
others as CUDA graphs.  ``NUTS`` and ``NeuTraHMC`` have no bundle: their
``sample`` takes a step count, which a sampler of a fixed size has no place
for (the JAX package's ``export_sampler`` cannot export them either).

The JAX package's ``save_bundle`` fails where ``log_prob`` draws (a model
with an MCMC layer; a residual flow whose log-det estimator draws in its
mode) or where there is none (HAIS, annealed SMC); so does this one, and
``save_bundle(..., event_shape=None)`` writes a bundle of the sampler
alone.  A residual flow's ``log_prob`` program (its log-det drawing
nothing: eval mode in 2-D, or ``exact_trace`` with a fixed
``n_power_series``) is traced with ``make_fx`` on a symbolic batch.

Use :func:`save_bundle` / :func:`load_bundle` for a directory with a JSON
manifest, or :func:`export_sampler` / :func:`export_log_prob` for the raw
``torch.export.ExportedProgram``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import torch
from torch import nn

from .core.facades import (ClassCondFlow, MultiscaleFlow, NormalizingFlow, _LogProb,
                           compact_copy)
from .distributions.base import draw_layout, draw_noise
from .flows.residual import Residual, iResBlock
from .flows.stochastic import mcmc_layers
from .nets.cnn import fp32_convs
from .ops import backend, made_fused, spline_cuda, spline_flat  # noqa: F401  (the ops)
from .ops.backend import resolve_device
from .sampling import HAIS, NUTS, AnnealedSMC, NeuTraHMC

__all__ = ["export_sampler", "export_log_prob", "save_bundle", "load_bundle",
           "ServingBundle"]

SAMPLE_FILE, LOG_PROB_FILE, MANIFEST_FILE = "sample.pt2", "log_prob.pt2", "manifest.json"


class _Sampler(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, eps, y=None):
        if y is None:
            return self.model.from_noise(eps)
        return self.model.from_noise(eps, y)


def _check_class_cond(model, class_cond: bool):
    """``class_cond`` must say whether ``model`` takes class labels."""
    takes = isinstance(model, ClassCondFlow) or (isinstance(model, MultiscaleFlow)
                                                 and model.class_cond)
    if class_cond and not takes:
        raise ValueError(f"class_cond=True exports a class-conditional model (a "
                         f"MultiscaleFlow with class_cond, or a ClassCondFlow), not a "
                         f"{type(model).__name__}")
    if takes and not class_cond:
        raise ValueError(f"this {type(model).__name__} is class-conditional: export it "
                         f"with class_cond=True")


def _prepared(model, device):
    """A compact copy of ``model`` (``core.facades.compact_copy``) on
    ``device`` (default: where the model lies), in eval mode but for its
    residual blocks, which keep their mode: it picks the log-det estimator,
    as the JAX package's ``set_train`` does.  ``NUTS`` and ``NeuTraHMC``
    are refused (see the module docstring)."""
    if isinstance(model, (NUTS, NeuTraHMC)):
        raise NotImplementedError(
            f"a {type(model).__name__} sampler has no serving bundle: its sample takes a step "
            f"count (num_steps) besides the number of chains, and a bundle's sampler is a "
            f"program of a fixed number of draws; the JAX package's export_sampler, which "
            f"calls sample(key, n), cannot export it either")
    if device is None:
        device = next(iter([*model.parameters(), *model.buffers()])).device
    copied = compact_copy(model).to(resolve_device(device)).eval()
    for kept, block in zip(model.modules(), copied.modules()):
        if isinstance(kept, iResBlock):
            block.train(kept.training)
    return copied


def _kind(model) -> str:
    """``"hais"``, ``"smc"``, ``"program"`` (a ``NormalizingFlow`` holding a
    layer with a program form or draws of its own: an MCMC or residual
    layer) or ``"flow"``."""
    if isinstance(model, HAIS):
        return "hais"
    if isinstance(model, AnnealedSMC):
        return "smc"
    layers = [f for f in model.modules() if hasattr(f, "program") or hasattr(f, "noise_layout")]
    if layers and not isinstance(model, NormalizingFlow):
        raise NotImplementedError(
            f"a {type(model).__name__} holding {type(layers[0]).__name__} layers has no "
            f"serving bundle: its sampler takes each level's base noise only")
    return "program" if layers else "flow"


class _FlowProgram(nn.Module):
    """``NormalizingFlow.from_noise`` on every draw as a program runs it: a
    layer with a program form (``program``: HMC, residual) takes it, built
    for batches of ``num_samples``; another layer runs as it is."""

    def __init__(self, model, num_samples: int):
        super().__init__()
        self.model = model
        ref = next(iter([*model.q0.parameters(), *model.q0.buffers()]))
        shape = (num_samples, *model.q0.noise_shape)
        self.drawing = [i for i, _ in model.drawing_flows(num_samples)]
        self.steps = nn.ModuleList(
            f.program(shape, ref.dtype, ref.device) if hasattr(f, "program") else f
            for f in model.flows)

    def forward(self, eps, draws):
        noises = iter(draws)
        z, log_q = self.model.q0.from_noise(eps)
        for i, step in enumerate(self.steps):
            if i in self.drawing:
                z, ld = step(z, noise=next(noises))
            else:
                z, ld = step(z)
            log_q = log_q - ld
        return z, log_q


def _sampler_program(model, num_samples: int):
    """The module ``export_sampler`` exports for ``model`` (prepared), and
    the manifest's ``"draws"`` (None for a flow that draws its base noise
    only)."""
    kind = _kind(model)
    if kind in ("hais", "smc"):
        return model.program(num_samples), [model.noise_layout(num_samples)]
    if kind == "program":
        return _FlowProgram(model, num_samples), [d for _, d in model.drawing_flows(num_samples)]
    return _Sampler(model), None


def _base_noise(model):
    """``(noise_spec, noise_shape)`` of the draws a sampler starts from."""
    if isinstance(model, HAIS):
        return tuple(model.prior.noise_spec), tuple(model.prior.noise_shape)
    if isinstance(model, AnnealedSMC):
        return model._proposal_noise()
    return tuple(model.q0.noise_spec), tuple(model.q0.noise_shape)


def _log_prob_refusal(model) -> Optional[str]:
    """Why ``model`` has no ``log_prob`` program (the JAX package's
    ``save_bundle`` fails on the same models), or None."""
    if isinstance(model, (HAIS, AnnealedSMC)):
        return (f"a {type(model).__name__} has no log_prob: it gives weighted draws, not a "
                f"density")
    if mcmc_layers(model):
        return ("log_prob of a model with an MCMC layer draws (its moves run in the density "
                "direction too), and a log_prob program takes x alone; the JAX package's "
                "save_bundle fails on it too (its log_prob requires an explicit PRNG key)")
    event = tuple(getattr(getattr(model, "q0", None), "noise_shape", ()))
    for block in (m for m in model.modules() if isinstance(m, iResBlock)):
        if block._draw_kinds((1, *event)):
            return ("log_prob of this residual flow draws (its log-det estimator in its "
                    "current mode: set_train(False) in 2-D, or exact_trace with a fixed "
                    "n_power_series, draws nothing); the JAX package's save_bundle fails on "
                    "it too (its log_prob requires an explicit PRNG key)")
    return None


def _noise_levels(model):
    """``(noise_spec, noise_shape)`` of each base the sampler draws from: one
    a level of a ``MultiscaleFlow``, else the one ``q0``."""
    if isinstance(model, MultiscaleFlow):
        return model.noise_levels
    return [(tuple(model.q0.noise_spec), tuple(model.q0.noise_shape))]


def _draw(levels, num_samples, generator, device, multiscale):
    eps = [draw_noise(spec, event, num_samples, generator=generator, device=device)
           for spec, event in levels]
    return eps if multiscale else eps[0]


def export_sampler(model, num_samples: int, device=None, class_cond: bool = False):
    """Export ``eps -> (samples, log_q)`` (the model's ``from_noise``) at
    ``num_samples`` with the parameters held in the program; ``eps`` is the
    base's noise (num_samples, *event), a list of one such tensor a level
    for a ``MultiscaleFlow``.  With ``class_cond`` the program takes the
    labels ``y`` (num_samples,) too.  A model that draws past its base
    noise, HAIS and annealed SMC take ``(eps, draws)`` (see the module
    docstring; SMC returns ``(particles, log_w, log_z)``).  ``device``
    (default: the model's) is where the program runs."""
    return _export_sampler(model, num_samples, device, class_cond)[0]


def _export_sampler(model, num_samples, device, class_cond):
    """``(program, the manifest's "draws")``."""
    _check_class_cond(model, class_cond)
    model = _prepared(model, device)
    dev = next(iter([*model.parameters(), *model.buffers()])).device
    program, layouts = _sampler_program(model, num_samples)
    gen = torch.Generator(dev).manual_seed(0)
    if layouts is None:
        eps = _draw(_noise_levels(model), num_samples, gen, dev,
                    isinstance(model, MultiscaleFlow))
        args = (eps, torch.zeros(num_samples, dtype=torch.int64, device=dev)) if class_cond \
            else (eps,)
    else:
        args = _draws(_base_noise(model), layouts, num_samples, gen, dev)
    with torch.no_grad(), fp32_convs():
        return torch.export.export(program, args), layouts


def _draws(base, layouts, num_samples, generator, device):
    """``(eps, draws)``: the base's noise, then each layout's draws, from
    ``generator`` in turn."""
    eps = draw_noise(*base, num_samples, generator=generator, device=device)
    return eps, [draw_layout(layout, generator=generator, device=device) for layout in layouts]


def export_log_prob(model, event_shape: Sequence[int], device=None,
                    symbolic_batch: bool = True, class_cond: bool = False,
                    batch_size: Optional[int] = None):
    """Export ``x -> log_prob(x)`` (``(x, y) -> log_prob(x, y)`` with
    ``class_cond``) with a symbolic batch dimension
    (``torch.export.Dim("batch", min=1)``, shared by ``x`` and ``y``);
    ``symbolic_batch=False`` with ``batch_size`` exports a concrete batch
    (default 1)."""
    _check_class_cond(model, class_cond)
    if symbolic_batch and batch_size is not None:
        raise ValueError(
            "batch_size only applies with symbolic_batch=False: a symbolic-batch "
            "export would drop it, and a fused MADE needs the concrete batch")
    model = _prepared(model, device)
    refusal = _log_prob_refusal(model)
    if refusal is not None:
        raise ValueError(f"export_log_prob: {refusal}")
    dev = next(model.parameters()).device
    b = 8 if symbolic_batch else (batch_size if batch_size is not None else 1)
    x = torch.zeros(b, *event_shape, device=dev)
    args = (x, torch.zeros(b, dtype=torch.int64, device=dev)) if class_cond else (x,)
    dynamic = None
    if symbolic_batch:
        batch = torch.export.Dim("batch", min=1)
        dynamic = {"x": {0: batch}, "context": {0: batch}} if class_cond \
            else {"x": {0: batch}}
    module = _LogProb(model)
    with torch.no_grad(), fp32_convs():
        if any(isinstance(m, iResBlock) for m in model.modules()):
            module = _residual_log_prob(model, args, symbolic_batch)
            dynamic = None if dynamic is None else ({0: batch},)
        return torch.export.export(module, args, dynamic_shapes=dynamic)


def _residual_log_prob(model, args, symbolic_batch):
    """A residual flow's ``log_prob`` as a graph traced with ``make_fx``
    (its log-dets' pullbacks are ``torch.autograd.grad``), on a symbolic
    batch where asked.  Its density direction must not run the fixed point
    (``reverse=True``, the default)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if any(isinstance(f, Residual) and not f.reverse for f in model.modules()):
        raise NotImplementedError(
            "a residual layer with reverse=False runs its fixed point in the density "
            "direction, which a log_prob program on a symbolic batch does not loop over; "
            "export its sampler, or reverse=True (the default)")
    return make_fx(lambda x: model.log_prob(x), tracing_mode="symbolic" if symbolic_batch
                   else "real", _allow_non_fake_inputs=True)(*args)


def _nodes(program):
    """Every call of ``program`` (an ``ExportedProgram``), its loops' bodies
    included."""
    return [node for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
            for node in gm.graph.nodes if node.op == "call_function"]


def kernel_ops(program) -> list:
    """The port's operators that ``program`` (an ``ExportedProgram``) calls,
    by name, each once."""
    names = {node.target.name() for node in _nodes(program)
             if isinstance(node.target, torch._ops.OpOverload)
             and node.target.namespace == backend.NAMESPACE}
    return sorted(names)


def save_bundle(model, path: str, num_samples: Optional[int],
                event_shape: Optional[Sequence[int]], device=None, symbolic_batch: bool = True,
                class_cond: bool = False, batch_size: Optional[int] = None) -> dict:
    """Write a serving bundle under ``path``: ``sample.pt2`` (none when
    ``num_samples`` is None: a bundle of densities only), ``log_prob.pt2``
    (none when ``event_shape`` is None: a bundle of the sampler only) and
    ``manifest.json``, and return the manifest.  A model whose ``log_prob``
    draws or that has none raises unless ``event_shape`` is None (see the
    module docstring).  See :func:`export_log_prob` for ``symbolic_batch``
    / ``batch_size``."""
    if event_shape is not None:
        refusal = _log_prob_refusal(model)
        if refusal is not None:
            raise ValueError(f"save_bundle: {refusal}; save_bundle(..., event_shape=None) "
                             f"writes a bundle of its sampler alone")
    elif num_samples is None:
        raise ValueError("save_bundle: num_samples and event_shape are both None: nothing "
                         "to export")
    os.makedirs(path, exist_ok=True)
    seconds, programs, layouts = {}, {}, None
    if num_samples is not None:
        t0 = time.perf_counter()
        programs[SAMPLE_FILE], layouts = _export_sampler(model, num_samples, device, class_cond)
        seconds["sample"] = time.perf_counter() - t0
    if event_shape is not None:
        t0 = time.perf_counter()
        programs[LOG_PROB_FILE] = export_log_prob(model, event_shape, device, symbolic_batch,
                                                  class_cond, batch_size)
        seconds["log_prob"] = time.perf_counter() - t0
    for name, program in programs.items():
        torch.export.save(_without_traces(program), os.path.join(path, name))
    any_program = next(iter(programs.values()))
    kind = _kind(model)
    multiscale = isinstance(model, MultiscaleFlow)
    levels = _noise_levels(model) if multiscale else [_base_noise(model)]
    sample = programs.get(SAMPLE_FILE)
    manifest = {
        "num_samples": num_samples,
        "event_shape": None if event_shape is None else list(event_shape),
        "symbolic_batch": symbolic_batch,
        "batch_size": batch_size,
        "class_cond": class_cond,
        "kind": kind,
        # one base: its spec; a multiscale model: each level's spec and shape
        "noise_spec": None if multiscale else list(levels[0][0]),
        "noise_shape": None if multiscale else list(levels[0][1]),
        "noise_levels": [[list(spec), list(event)] for spec, event in levels]
        if multiscale else None,
        # the draws after the base's: one layout a drawing layer, or the rungs'
        "draws": layouts,
        "outputs": ["particles", "log_w", "log_z"] if kind == "smc"
        else ["samples", "log_w"] if kind == "hais" else ["samples", "log_q"],
        "route": None if sample is None else "eager" if _holds_while_loop(sample)
        else "graphed",
        "device": str(next(iter(any_program.state_dict.values())).device),
        "torch": torch.__version__,
        "kernel_ops": {name[:-len(".pt2")]: kernel_ops(p) for name, p in programs.items()},
        "export_seconds": seconds,
    }
    with open(os.path.join(path, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _without_traces(program):
    """``program`` with its nodes' source records dropped (their Python
    stack traces, module and function stacks): a program of traced graphs
    in loops has tens of thousands of nodes, whose records would make most
    of its file and of its loading time."""
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                for key in ("stack_trace", "nn_module_stack", "source_fn_stack",
                            "from_node", "fwd_nn_module_stack", "fwd_source_fn_stack"):
                    node.meta.pop(key, None)
    return program


def _holds_while_loop(program) -> bool:
    """Whether ``program`` loops a number of times its data decide (a
    residual fixed point): its replay reads the device, so a CUDA graph
    cannot hold it."""
    return any(node.target is torch.ops.higher_order.while_loop for node in _nodes(program))


class ServingBundle:
    """Loaded serving endpoints: ``.sample(seed)`` and ``.log_prob(x)``."""

    def __init__(self, sample_program, log_prob_program, manifest):
        self.manifest = manifest
        self.device = torch.device(manifest["device"])
        self._sample = None if sample_program is None else sample_program.module()
        self._log_prob = None if log_prob_program is None else log_prob_program.module()
        self._graph = None

    def _inputs(self, y, method, n=None):
        """The label input of a class-conditional bundle (int64 on the
        bundle's device, ``n`` of them where given), or () for another."""
        if not self.manifest.get("class_cond"):
            if y is not None:
                raise ValueError(f"this bundle is unconditional; {method} does not accept y")
            return ()
        if y is None:
            raise ValueError(f"this bundle is class-conditional; {method} needs the labels y")
        y = torch.as_tensor(y, device=self.device).to(torch.int64)
        if n is not None and tuple(y.shape) != (n,):
            raise ValueError(f"{method}: y must hold {n} labels, got shape {tuple(y.shape)}")
        return (y,)

    def noise(self, seed: int):
        """The sampler's input for ``seed``: the base noise by the manifest
        (a list, one tensor a level, for a multiscale model), from
        ``torch.Generator(device).manual_seed(seed)``; where the manifest
        lays out draws past it, ``(eps, draws)``, drawn in turn."""
        m = self.manifest
        gen = torch.Generator(self.device).manual_seed(int(seed))
        if m.get("draws") is not None:
            return _draws((m["noise_spec"], m["noise_shape"]), m["draws"], m["num_samples"],
                          gen, self.device)
        levels = m.get("noise_levels") or [(m["noise_spec"], m["noise_shape"])]
        return _draw(levels, m["num_samples"], gen, self.device,
                     m.get("noise_levels") is not None)

    def sample(self, seed: int, y=None, graphed: bool = True):
        """``(samples, log_q)`` of ``num_samples`` draws from ``seed`` (at the
        labels ``y`` for a class-conditional bundle; the manifest's
        ``"outputs"`` name them).  On a card the sampler runs as a CUDA graph
        (captured at the first call) unless ``graphed=False`` or the
        manifest's route is ``"eager"``; elsewhere it runs eagerly."""
        if self._sample is None:
            raise ValueError("this bundle holds no sampler (saved with num_samples=None)")
        m = self.manifest
        noise = self.noise(seed)
        args = noise if m.get("draws") is not None \
            else (noise, *self._inputs(y, "sample", m["num_samples"]))
        with torch.no_grad(), fp32_convs():
            if not graphed or self.device.type != "cuda" or m.get("route") == "eager":
                return self._sample(*args)
            if self._graph is None:
                self._capture(args)
            for held, given in zip(torch.utils._pytree.tree_leaves(self._args),
                                   torch.utils._pytree.tree_leaves(args)):
                held.copy_(given)
            self._graph.replay()
            return tuple(t.clone() for t in self._out)

    def _capture(self, args):
        """Warm the sampler up on a side stream, then capture it once on
        copies of ``args``, the graph's inputs."""
        self._args = torch.utils._pytree.tree_map(torch.clone, args)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._sample(*self._args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._out = self._sample(*self._args)

    def log_prob(self, x, y=None):
        if self._log_prob is None:
            raise ValueError("this bundle holds no log_prob program (saved with "
                             "event_shape=None)")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        args = (x, *self._inputs(y, "log_prob", x.shape[0]))
        with torch.no_grad(), fp32_convs():
            return self._log_prob(*args)


def load_bundle(path: str) -> ServingBundle:
    """Load a bundle written by :func:`save_bundle`.  It needs no model class
    and unpickles nothing, but the process must have imported
    ``normflows_tpu_torch`` (this module does), which registers the kernel
    operators the programs call."""
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    device = torch.device(manifest["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the bundle at {path} was exported on {device}, and this "
                           f"process has no CUDA card: export it again with device='cpu'")
    ops = getattr(torch.ops, backend.NAMESPACE)
    for name in sorted({n for names in manifest["kernel_ops"].values() for n in names}):
        if not hasattr(ops, name.split("::")[-1]):
            raise RuntimeError(f"the bundle at {path} calls the operator {name}, which "
                               f"this version of normflows_tpu_torch does not register")
    programs = [os.path.join(path, name) for name in (SAMPLE_FILE, LOG_PROB_FILE)]
    return ServingBundle(*(torch.export.load(p) if os.path.exists(p) else None
                           for p in programs), manifest)
