"""Training-step factories (port of ``normflows_tpu/training/loop.py``).

In PyTorch idiom the model and a ``torch.optim`` optimizer are updated in
place.  ``torch.optim.Adam(params, lr=5e-4)`` is the counterpart of
``optax.adam(5e-4)``: both default to betas (0.9, 0.999) and eps 1e-8.
``torch.optim.Adamax(params, lr, weight_decay=wd)`` is that of
``optax.chain(optax.add_decayed_weights(wd), optax.adamax(lr))`` (Glow's):
L2 added to the gradient, then the infinity moment max(b2 nu, |g| + eps).

* :func:`make_train_step` runs one eager step a call and reads the loss on
  the host to decide the non-finite skip.
* :func:`make_step_chunk` runs ``chunk_len`` steps a call with no host read
  inside them: the skip is decided on the device, and the losses land in a
  device vector.  On a CUDA model one whole step is captured once in a CUDA
  graph and replayed ``chunk_len`` times, the counterpart of the JAX
  package's ``lax.scan`` over a donated step; on a CPU model the same step
  code runs eagerly.
* :func:`make_chunked_train_step` is that chunk with its minibatches
  gathered on the device from a dataset placed there once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
from torch import nn

from ..utils.optim import update_lipschitz

WARMUP_STEPS = 2  # eager steps before a capture, on a side stream
# the optimizers a chunk captures (each with capturable=True on the card)
CHUNK_OPTIMIZERS = (torch.optim.Adam, torch.optim.AdamW, torch.optim.Adamax)


@dataclass
class TrainState:
    """The model and optimizer a step updates in place, and the count of
    steps taken (skipped ones included, as in the JAX package): an ``int``
    for :func:`make_train_step`, a 0-d int64 tensor on the model's device
    for a chunk, which counts on the device."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: Union[int, torch.Tensor] = 0


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable, update_lipschitz_iters: Optional[int] = None):
    """Build ``(state, step_fn)``.

    ``loss_fn(model, batch, generator) -> scalar``.  ``step_fn(state, batch,
    generator=None)`` returns ``(state, metrics)`` with metrics ``{"loss",
    "finite"}``.  A non-finite loss skips the whole optimizer step: the
    parameters stay and so does the optimizer's state (Adam's moments and
    step count), as the reference notebooks' ``if not (isnan | isinf)`` loss
    skip does; masking only the gradients would still move Adam.  Deciding
    that reads the loss on the host once a step, after the backward has
    been queued.

    With ``update_lipschitz_iters`` (residual flows), power iteration runs
    ``utils.optim.update_lipschitz(model, update_lipschitz_iters)`` after
    the update on every step, skipped ones included, as in the JAX
    package."""
    return eager_step(model, optimizer, loss_fn, lambda loss: loss, update_lipschitz_iters)


def build_optimizer(factory: Callable, params) -> torch.optim.Optimizer:
    """``factory(params)``: the optimizer of a step that trains parameters
    it made itself (the sharded steps of ``parallel``, on copies of the
    caller's model).  An optimizer in the factory's place raises: it holds
    other parameters."""
    if isinstance(factory, torch.optim.Optimizer):
        raise TypeError("this step builds its optimizer on the parameters it made: pass a "
                        "factory, params -> optimizer (e.g. lambda ps: torch.optim.Adam(ps, "
                        "lr=1e-3))")
    return factory(params)


def eager_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable,
               reduce: Callable, update_lipschitz_iters: Optional[int] = None):
    """:func:`make_train_step` with ``reduce(loss)`` run after the backward
    on the detached loss: what it returns is the step's loss, the one the
    skip reads.  ``parallel.make_data_parallel_step`` averages the loss and
    the gradients over the ranks there."""
    state = TrainState(model, optimizer)

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch, generator)
        loss.backward()
        loss = reduce(loss.detach())
        finite = bool(torch.isfinite(loss))
        if finite:
            state.optimizer.step()
        if update_lipschitz_iters is not None:
            update_lipschitz(state.model, update_lipschitz_iters)
        state.step += 1
        return state, {"loss": loss, "finite": finite}

    return state, step_fn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule`` as a function of a step tensor
    (see :func:`cosine_decay_schedule` for ``count``): a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    from ``peak_value`` to ``end_value`` over the other ``decay_steps -
    warmup_steps``, held at ``end_value`` past the end."""
    if warmup_steps <= 0 or decay_steps <= warmup_steps:
        raise ValueError(f"need 0 < warmup_steps < decay_steps, got {warmup_steps}, "
                         f"{decay_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = float(decay_steps - warmup_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = count.to(torch.float32)
        ramp = init_value + (peak_value - init_value) * torch.clamp(
            count, 0.0, float(warmup_steps)) / warmup_steps
        t = torch.clamp(count - warmup_steps, max=cosine_steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / cosine_steps))
        decayed = peak_value * ((1.0 - alpha) * cosine + alpha)
        return torch.where(count < warmup_steps, ramp, decayed)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable:
    """``optax.cosine_decay_schedule(init_value, decay_steps)`` (alpha 0) as a
    function of a step tensor, on the tensor's device: ``count`` is the number
    of updates taken before this one (optax counts from 0), held at
    ``decay_steps`` past the end.

    A chunk's ``schedule`` takes the place of the schedule that optax holds
    inside its transform: it is evaluated inside each step on the
    optimizer's own count, so that it moves inside a captured graph."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        return init_value * (0.5 * (1.0 + torch.cos(math.pi * count / decay_steps)))

    return schedule


class _FlatState:
    """The parameters and the optimizer's state tensors moved into one flat
    buffer for each dtype and device (each tensor a view of it, 16 bytes
    aligned), beside a second buffer of the same size: copying the state
    before an update is one copy, and selecting it back where the loss is
    not finite one ``torch.where``, over all of it at once."""

    def __init__(self, optimizer):
        params = [p for group in optimizer.param_groups for p in group["params"]]
        # (owner, key, tensor): a parameter (key None) or an entry of its state
        slots = [(p, None, p) for p in params] + [
            (optimizer.state[p], k, v) for p in params
            for k, v in optimizer.state[p].items() if isinstance(v, torch.Tensor)]
        kinds = {}
        for slot in slots:
            kinds.setdefault((slot[2].dtype, slot[2].device), []).append(slot)
        self.pairs = []
        with torch.no_grad():
            for (dtype, device), members in kinds.items():
                align = max(1, 16 // torch.empty((), dtype=dtype).element_size())
                offsets, total = [], 0
                for _, _, t in members:
                    offsets.append(total)
                    total += -(-t.numel() // align) * align
                live = torch.zeros(total, dtype=dtype, device=device)
                for (owner, key, t), o in zip(members, offsets):
                    view = live[o:o + t.numel()].view(t.shape)
                    view.copy_(t)
                    if key is None:
                        owner.data = view
                    else:
                        owner[key] = view
                self.pairs.append((live, torch.empty_like(live)))

    def save(self):
        for live, old in self.pairs:
            old.copy_(live)

    def keep_if(self, keep: torch.Tensor):
        """Every tensor as the update left it where ``keep`` (a device bool)
        holds, else as :meth:`save` found it."""
        for live, old in self.pairs:
            torch.where(keep, live, old, out=live)


def _compact(t):
    """``t``, or a copy of it that owns a storage of its own bytes where its
    storage is larger (a view of a chunk's flat buffer)."""
    if isinstance(t, nn.Parameter) or not isinstance(t, torch.Tensor) or \
            t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _compact_module_entries(module, state_dict, prefix, local_metadata):
    """A module's ``state_dict`` post-hook: its own parameters as compact
    copies (``torch.save`` of a view writes its whole storage, here the flat
    buffer with the optimizer's moments).  With ``keep_vars=True`` the
    entries are the parameters themselves and stay."""
    for name in module._parameters:
        if prefix + name in state_dict:
            state_dict[prefix + name] = _compact(state_dict[prefix + name])


def _compact_optimizer_state(optimizer, state_dict):
    """An optimizer's ``state_dict`` post-hook: each parameter's state as a
    new dict of compact copies (the packed dicts are the live ones)."""
    state_dict["state"] = {i: {k: _compact(v) for k, v in s.items()}
                           for i, s in state_dict["state"].items()}
    return state_dict


def compact_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer):
    """Make ``model.state_dict()`` and ``optimizer.state_dict()`` give
    tensors that own their bytes, once the parameters and the optimizer's
    state are views of flat buffers (:class:`_FlatState`); the parameters
    stay views, so that a captured graph's addresses hold, and
    ``load_state_dict`` still copies into them in place."""
    for module in model.modules():
        if module._parameters and not getattr(module, "_compact_state_dict", False):
            module.register_state_dict_post_hook(_compact_module_entries)
            module._compact_state_dict = True
    if not getattr(optimizer, "_compact_state_dict", False):
        optimizer.register_state_dict_post_hook(_compact_optimizer_state)
        optimizer._compact_state_dict = True


def _materialize(optimizer):
    """Give every parameter the optimizer state a fresh Adam or Adamax gives
    it on its first update (moments and step count zero: Adam's
    ``exp_avg`` / ``exp_avg_sq``, Adamax's ``exp_avg`` / ``exp_inf``),
    through one update on zero gradients whose effect is then undone, so
    that the state exists before the first step of a chunk copies it."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    missing = [p for p in params if not optimizer.state.get(p)]
    if not missing:
        return
    ids = {id(p) for p in missing}
    grads = [p.grad for p in params]
    kept = [p.detach().clone() for p in missing]
    for p in params:
        p.grad = torch.zeros_like(p) if id(p) in ids else None
    optimizer.step()
    with torch.no_grad():
        for p, k in zip(missing, kept):
            p.copy_(k)
            for v in optimizer.state[p].values():
                if isinstance(v, torch.Tensor):
                    v.zero_()
    for p, g in zip(params, grads):
        p.grad = g


class _StepChunk:
    """``chunk_len`` optimizer steps a call (see :func:`make_step_chunk`)."""

    def __init__(self, model, optimizer, loss_fn, chunk_len, batch_fn, schedule,
                 update_lipschitz_iters):
        devices = {p.device for p in model.parameters()}
        if len(devices) != 1:
            raise ValueError(f"the model's parameters lie on {sorted(map(str, devices))}: "
                             f"a chunk runs on one device")
        self.device = devices.pop()
        self.loss_fn, self.chunk_len = loss_fn, chunk_len
        self.batch_fn, self.schedule = batch_fn, schedule
        self.lipschitz_iters = update_lipschitz_iters
        if not isinstance(optimizer, CHUNK_OPTIMIZERS):
            raise TypeError(f"a chunk takes torch.optim.Adam, AdamW or Adamax, not "
                            f"{type(optimizer).__name__}")
        if self.device.type == "cuda" and not all(g["capturable"]
                                                  for g in optimizer.param_groups):
            raise ValueError("a chunk on the card captures the optimizer in a CUDA "
                             "graph: build it with capturable=True")
        self.state = TrainState(model, optimizer,
                                torch.zeros((), dtype=torch.int64, device=self.device))
        self.index = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.losses = torch.zeros(chunk_len, device=self.device)
        # False while the warm-up before a capture runs: every update undone
        self.updating = torch.ones((), dtype=torch.bool, device=self.device)
        self.ready, self.graph, self.generator = False, None, None

    def _prepare(self):
        """The optimizer's state and tensor learning rates, made once before
        the first step, and the flat buffers that then hold them and the
        parameters."""
        optimizer = self.state.optimizer
        _materialize(optimizer)
        if self.schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = torch.as_tensor(group["lr"], dtype=torch.float32,
                                              device=self.device).clone()
        self.flat = _FlatState(optimizer)
        compact_state_dicts(self.state.model, optimizer)
        self.count = optimizer.state[optimizer.param_groups[0]["params"][0]]["step"]
        self.watched = self._pointers()
        self.ready = True

    def _pointers(self):
        """Where every tensor a captured step reads or writes lies."""
        opt = self.state.optimizer
        params = [p for group in opt.param_groups for p in group["params"]]
        held = [v for p in params for v in opt.state[p].values()
                if isinstance(v, torch.Tensor)]
        lrs = [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
        return [t.data_ptr() for t in (*params, *held, *lrs, self.state.step)]

    def _step(self, generator):
        """One step; no host read."""
        state = self.state
        state.optimizer.zero_grad(set_to_none=True)
        if self.schedule is not None:
            lr = self.schedule(self.count)
            for group in state.optimizer.param_groups:
                group["lr"].copy_(lr)
        batch = None if self.batch_fn is None else self.batch_fn(state.step, generator)
        loss = self.loss_fn(state.model, batch, generator)
        loss.backward()
        with torch.no_grad():
            keep = torch.isfinite(loss) & self.updating
            self.flat.save()
            state.optimizer.step()
            self.flat.keep_if(keep)
            if self.lipschitz_iters is not None:
                update_lipschitz(state.model, self.lipschitz_iters)
            self.losses.index_copy_(0, self.index, loss.detach().reshape(1).float())
            self.index.add_(1)
            state.step.add_(1)

    def _capture(self, generator):
        """Warm up on a side stream with every update undone (the skip,
        forced), then capture one step.  The training state, the step count
        and the generator come out of it as they went in."""
        gen = generator if generator is not None else \
            torch.cuda.default_generators[self.device.index or 0]
        rng = gen.get_state()
        step = self.state.step.clone()
        buffers = [(b, b.detach().clone()) for b in self.state.model.buffers()]
        self.updating.fill_(False)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.index.zero_()
                self._step(generator)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph):
            self._step(generator)
        with torch.no_grad():
            self.state.step.copy_(step)
            for b, saved in buffers:
                b.copy_(saved)
        self.updating.fill_(True)
        gen.set_state(rng)
        self.generator = generator

    def __call__(self, state: TrainState, generator: Optional[torch.Generator] = None):
        if state is not self.state:
            raise ValueError("a chunk steps the TrainState it was made with")
        if not self.ready:
            self._prepare()
        if self._pointers() != self.watched:
            raise RuntimeError(
                "a parameter, optimizer state tensor or learning rate of this chunk "
                "was replaced since it was made (load_state_dict does that): copy "
                "into them in place (training.restore_checkpoint does) or make "
                "the chunk anew")
        cuda = self.device.type == "cuda"
        if cuda and self.graph is None:
            self._capture(generator)
        elif cuda and generator is not self.generator:
            raise ValueError("a captured chunk draws from the generator it was "
                             "captured with: pass that one")
        self.index.zero_()
        for _ in range(self.chunk_len):
            if cuda:
                self.graph.replay()
            else:
                self._step(generator)
        return state, {"loss": self.losses.clone()}


def make_step_chunk(model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable,
                    chunk_len: int = 10, batch_fn: Optional[Callable] = None,
                    schedule: Optional[Callable] = None,
                    update_lipschitz_iters: Optional[int] = None):
    """Build ``(state, chunk_fn)``: ``chunk_len`` optimizer steps a call,
    with no host read inside them.

    ``loss_fn(model, batch, generator) -> scalar``; ``batch`` is
    ``batch_fn(step, generator)``, with ``step`` the device count of steps
    taken, or None without a ``batch_fn``.  ``chunk_fn(state,
    generator=None)`` returns ``(state, {"loss": (chunk_len,) tensor})``, the
    losses on the model's device; reading them is the chunk's one host read.

    Each step: zero the gradients; write ``schedule(count)`` (if given; count
    is Adam's own count of updates taken) into the optimizer's tensor
    learning rates; the loss and its backward; Adam's update, undone on the
    device where the loss is not finite (the parameters, ``exp_avg``,
    ``exp_avg_sq`` and Adam's ``step`` keep their values, as the JAX
    package's step keeps its optimizer state); with
    ``update_lipschitz_iters``, ``utils.optim.update_lipschitz`` on the
    updated model, writing each induced-norm layer's ``u``, ``v`` and
    ``scale`` in place (so that the graph's addresses hold; the warm-up's
    writes are undone with the model's other buffers); the loss into the
    vector at a device index; ``state.step`` plus one, skipped steps
    included.  The same holds for Adamax (``exp_avg``, ``exp_inf``,
    ``step``).

    The first call moves the parameters and Adam's state tensors into one
    flat buffer for each dtype (each stays a tensor of its shape, now a view
    of the buffer), so that the skip copies and selects each buffer once.
    ``model.state_dict()`` and ``optimizer.state_dict()`` then give copies
    that own their bytes (:func:`compact_state_dicts`), so that
    ``torch.save`` of either writes no more than before the chunk.

    On a CUDA model the optimizer must be ``torch.optim.Adam``, ``AdamW``
    or ``Adamax`` with ``capturable=True``.  The first call warms the step up on a side
    stream with its updates undone, then captures one step in a CUDA graph
    (its generator registered with the graph, so that each replay draws
    anew), and every call replays it ``chunk_len`` times.  A capture that
    fails raises; there is no eager fallback on the card.  A captured chunk
    holds its tensors by address: restore a checkpoint into them in place
    (``training.restore_checkpoint``), and pass the generator it was
    captured with.  On a CPU model (plain Adam) the same step runs eagerly
    ``chunk_len`` times.

    Kernel launch counters (``ops.spline_cuda.LAUNCHES`` and the others)
    count the warm-up and the captured step, not the replays."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be at least 1, got {chunk_len}")
    chunk = _StepChunk(model, optimizer, loss_fn, chunk_len, batch_fn, schedule,
                       update_lipschitz_iters)
    return chunk.state, chunk


def make_chunked_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                            loss_fn: Callable, data, batch_size: int, chunk_len: int = 10,
                            shuffle: bool = True, update_lipschitz_iters: Optional[int] = None,
                            schedule: Optional[Callable] = None):
    """Device-resident-data training: ``chunk_len`` steps a call.

    ``data`` is a tensor (or numpy array) or a tuple of them with a common
    leading dimension, moved to the model's device once; ``loss_fn(model,
    batch, generator)`` receives the same structure per minibatch.  Each
    step gathers its minibatch on the device: ``shuffle=True`` draws i.i.d.
    indices with the chunk's generator (sampling with replacement, as the
    JAX package does); ``shuffle=False`` slides a window that starts at
    ``(state.step * batch_size) % (n - batch_size + 1)``, counted on the
    device across chunks.  ``schedule(count) -> lr``
    (:func:`cosine_decay_schedule`) is the one argument the JAX signature
    lacks: it stands for the schedule optax holds inside its transform.

    Returns ``(state, chunk_fn)``, ``chunk_fn(state, generator=None) ->
    (state, {"loss": (chunk_len,) tensor})``; see :func:`make_step_chunk`
    for the step, the capture and the optimizer it takes."""
    data = tuple(data) if isinstance(data, (tuple, list)) else (data,)
    n = data[0].shape[0]
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
    device = next(model.parameters()).device
    data = tuple(torch.as_tensor(d).to(device) for d in data)
    window = torch.arange(batch_size, device=device)

    def batch_fn(step, generator):
        if shuffle:
            idx = torch.randint(0, n, (batch_size,), generator=generator, device=device)
        else:
            idx = (step * batch_size) % (n - batch_size + 1) + window
        batch = tuple(d.index_select(0, idx) for d in data)
        return batch[0] if len(batch) == 1 else batch

    return make_step_chunk(model, optimizer, loss_fn, chunk_len, batch_fn, schedule,
                           update_lipschitz_iters)
