"""A sampler's loop body replayed as a CUDA graph.

``replay_loop(body, state, n, generator, before, cache)`` runs ``state,
out = body(state)`` ``n`` times, ``before(i)`` (where given) ahead of the
i-th, from 1, and returns the last state and the ``n`` outputs stacked.

Where the state lies on a card and ``generator`` is that card's, one
iteration is captured in a CUDA graph, ``generator`` registered with it,
and replayed ``n`` times: the host issues one replay an iteration instead
of the iteration's kernels.  The generator's state before the call is
restored after the warm-up and the capture, so that the replays draw what
the eager loop draws, bit for bit.  The loop runs eagerly on the CPU,
without a generator (a sampler's replayed ``noise=``), and inside another
graph's capture, which then holds the whole loop.

``cache`` (a dict the caller keeps) holds the graph across calls: a later
call with the same state shapes and generator copies its state in and
replays, without a warm-up or a capture.  Its ``"last"`` is the graph the
call replayed (a handle for a profile of one replay), None where the loop
ran eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.backend import capturing


def replay_loop(body: Callable, state: tuple, n: int, generator: Optional[torch.Generator],
                before: Optional[Callable] = None, cache: Optional[dict] = None):
    if (n == 0 or state[0].device.type != "cuda" or generator is None
            or generator.device.type != "cuda" or capturing()):
        if cache is not None:
            cache["last"] = None
        outs = []
        for i in range(n):
            if before is not None:
                before(i + 1)
            state, out = body(state)
            outs.append(out)
        return state, torch.stack(outs) if outs else None
    cache = {} if cache is None else cache
    key = tuple((t.shape, t.dtype, t.device) for t in state)
    if cache.get("key") == key and cache.get("generator") is generator:
        for s, t in zip(cache["static"], state):
            s.copy_(t)
    else:
        if before is not None:  # the warm-up and the capture run the first iteration's inputs
            before(1)
        saved = generator.get_state()
        static = tuple(t.clone() for t in state)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the default stream, on copies
            body(tuple(t.clone() for t in static))
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        generator.set_state(saved)
        with torch.cuda.graph(graph):
            new, out = body(static)
            for s, t in zip(static, new):
                s.copy_(t)
        generator.set_state(saved)
        cache.update(key=key, generator=generator, graph=graph, static=static, out=out)
    static, out, graph = cache["static"], cache["out"], cache["graph"]
    cache["last"] = graph
    outs = []
    for i in range(n):
        if before is not None:
            before(i + 1)
        graph.replay()
        outs.append(out.clone())
    return tuple(t.clone() for t in static), torch.stack(outs)
