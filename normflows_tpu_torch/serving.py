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

from .core.facades import ClassCondFlow, MultiscaleFlow, _LogProb, compact_copy
from .distributions.base import draw_noise
from .flows.residual import iResBlock
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
    ``device`` (default: where the model lies), in eval mode.  A residual
    flow is refused: its fixed-point inverse and its log-det series loop a
    number of times the data decide.  So is a model with an MCMC layer
    (a stochastic normalizing flow): its moves draw, and the programs take
    the base's noise only.  The samplers (NUTS, annealed SMC, NeuTra HMC,
    HAIS) are refused too: each draws at every step, and NUTS reads the
    device once a doubling."""
    if isinstance(model, (NUTS, AnnealedSMC, NeuTraHMC, HAIS)):
        raise NotImplementedError(
            f"a {type(model).__name__} sampler has no serving bundle: a bundle freezes a flow's "
            f"sample and log_prob, and a sampler's loop draws at every step (NUTS also reads "
            f"the device once a doubling); serving a sampler waits for a later slice of the "
            f"PyTorch port")
    if any(isinstance(m, iResBlock) for m in model.modules()):
        raise NotImplementedError(
            "a residual flow (flows.Residual) has no serving bundle yet: its fixed-point "
            "inverse loops a data-dependent number of times; it waits for a later slice "
            "of the PyTorch port")
    if mcmc_layers(model):
        raise NotImplementedError(
            "a model with an MCMC layer (MetropolisHastings, HamiltonianMonteCarlo) has no "
            "serving bundle yet: its moves draw, and a bundle would need every layer's "
            "draws as program inputs; it waits for a later slice of the PyTorch port")
    if device is None:
        device = next(iter([*model.parameters(), *model.buffers()])).device
    return compact_copy(model).to(resolve_device(device)).eval()


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
    labels ``y`` (num_samples,) too.  ``device`` (default: the model's) is
    where the program runs."""
    _check_class_cond(model, class_cond)
    model = _prepared(model, device)
    dev = next(model.parameters()).device
    eps = _draw(_noise_levels(model), num_samples, torch.Generator(dev).manual_seed(0), dev,
                isinstance(model, MultiscaleFlow))
    args = (eps, torch.zeros(num_samples, dtype=torch.int64, device=dev)) if class_cond \
        else (eps,)
    with torch.no_grad(), fp32_convs():
        return torch.export.export(_Sampler(model), args)


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
    dev = next(model.parameters()).device
    b = 8 if symbolic_batch else (batch_size if batch_size is not None else 1)
    x = torch.zeros(b, *event_shape, device=dev)
    args = (x, torch.zeros(b, dtype=torch.int64, device=dev)) if class_cond else (x,)
    dynamic = None
    if symbolic_batch:
        batch = torch.export.Dim("batch", min=1)
        dynamic = {"x": {0: batch}, "context": {0: batch}} if class_cond \
            else {"x": {0: batch}}
    with torch.no_grad(), fp32_convs():
        return torch.export.export(_LogProb(model), args, dynamic_shapes=dynamic)


def kernel_ops(program) -> list:
    """The port's operators that ``program`` (an ``ExportedProgram``) calls,
    by name, each once."""
    names = {node.target.name() for node in program.graph.nodes
             if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
             and node.target.namespace == backend.NAMESPACE}
    return sorted(names)


def save_bundle(model, path: str, num_samples: Optional[int], event_shape: Sequence[int],
                device=None, symbolic_batch: bool = True, class_cond: bool = False,
                batch_size: Optional[int] = None) -> dict:
    """Write a serving bundle under ``path``: ``sample.pt2`` (none when
    ``num_samples`` is None: a bundle of densities only), ``log_prob.pt2``
    and ``manifest.json``, and return the manifest.  See
    :func:`export_log_prob` for ``symbolic_batch`` / ``batch_size``."""
    os.makedirs(path, exist_ok=True)
    seconds, programs = {}, {}
    if num_samples is not None:
        t0 = time.perf_counter()
        programs[SAMPLE_FILE] = export_sampler(model, num_samples, device, class_cond)
        seconds["sample"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    programs[LOG_PROB_FILE] = export_log_prob(model, event_shape, device, symbolic_batch,
                                              class_cond, batch_size)
    seconds["log_prob"] = time.perf_counter() - t0
    for name, program in programs.items():
        torch.export.save(program, os.path.join(path, name))
    lp = programs[LOG_PROB_FILE]
    levels = _noise_levels(model)
    multiscale = isinstance(model, MultiscaleFlow)
    manifest = {
        "num_samples": num_samples,
        "event_shape": list(event_shape),
        "symbolic_batch": symbolic_batch,
        "batch_size": batch_size,
        "class_cond": class_cond,
        # one base: its spec; a multiscale model: each level's spec and shape
        "noise_spec": None if multiscale else list(levels[0][0]),
        "noise_shape": None if multiscale else list(levels[0][1]),
        "noise_levels": [[list(spec), list(event)] for spec, event in levels]
        if multiscale else None,
        "device": str(next(iter(lp.state_dict.values())).device),
        "torch": torch.__version__,
        "kernel_ops": {name[:-len(".pt2")]: kernel_ops(p) for name, p in programs.items()},
        "export_seconds": seconds,
    }
    with open(os.path.join(path, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingBundle:
    """Loaded serving endpoints: ``.sample(seed)`` and ``.log_prob(x)``."""

    def __init__(self, sample_program, log_prob_program, manifest):
        self.manifest = manifest
        self.device = torch.device(manifest["device"])
        self._sample = None if sample_program is None else sample_program.module()
        self._log_prob = log_prob_program.module()
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
        ``torch.Generator(device).manual_seed(seed)``."""
        m = self.manifest
        levels = m.get("noise_levels") or [(m["noise_spec"], m["noise_shape"])]
        return _draw(levels, m["num_samples"],
                     torch.Generator(self.device).manual_seed(int(seed)), self.device,
                     m.get("noise_levels") is not None)

    def sample(self, seed: int, y=None, graphed: bool = True):
        """``(samples, log_q)`` of ``num_samples`` draws from ``seed`` (at the
        labels ``y`` for a class-conditional bundle).  On a card the sampler
        runs as a CUDA graph (captured at the first call) unless
        ``graphed=False``; elsewhere it runs eagerly."""
        if self._sample is None:
            raise ValueError("this bundle holds no sampler (saved with num_samples=None)")
        args = (self.noise(seed), *self._inputs(y, "sample", self.manifest["num_samples"]))
        with torch.no_grad(), fp32_convs():
            if not graphed or self.device.type != "cuda":
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
    sample_path = os.path.join(path, SAMPLE_FILE)
    sample = torch.export.load(sample_path) if os.path.exists(sample_path) else None
    return ServingBundle(sample, torch.export.load(os.path.join(path, LOG_PROB_FILE)),
                         manifest)
