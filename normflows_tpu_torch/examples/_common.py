"""What the reference examples (``circular_nsf``, ``neural_spline_twomoons``,
``augmented_flow``, ``image_density``) share: host draws from a seed, the
loop over a chunk's calls with the JAX scripts' progress lines, and the
training half of their JSON records."""

from __future__ import annotations

import time

import numpy as np
import torch


def host_normal(seed: int, *shape) -> torch.Tensor:
    """Standard normal draws (float32, on the CPU) from numpy at ``seed``."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape,
                                                                        dtype=np.float32))


def run_chunks(state, chunk, iters: int, chunk_len: int, generator=None,
               label: str = "loss", every: int = 500):
    """``iters // chunk_len`` calls of ``chunk``, printing the loss every
    ``every`` steps and at the last; returns ``(losses on the CPU, timing)``:
    ``seconds``, what the calls and the host reads of their losses took,
    ``first_call_seconds``, the first call's (the capture included), and
    ``steady_step_ms``, a step of the other calls."""
    calls, losses = iters // chunk_len, []
    t0 = time.perf_counter()
    for c in range(calls):
        state, metrics = chunk(state, generator)
        losses.append(metrics["loss"])
        if c == 0:
            losses[0] = losses[0].cpu()  # waits for the first call
            t1 = time.perf_counter()
    losses = torch.cat([t.cpu() for t in losses])
    t2 = time.perf_counter()
    for i in [*range(0, iters, every), iters - 1]:
        print(f"iter {i:6d}  {label} {float(losses[i]):8.4f}")
    steady = (t2 - t1) / (iters - chunk_len) if calls > 1 else (t1 - t0) / iters
    return losses, {"seconds": t2 - t0, "first_call_seconds": t1 - t0,
                    "steady_step_ms": 1e3 * steady}


def training_record(losses, timing: dict, batch: int, chunk_len: int, seed: int,
                    host_inputs: bool, device: torch.device) -> dict:
    """The training half of an example's JSON record; a step whose loss is
    not finite kept the parameters and the optimizer's state."""
    iters, seconds = len(losses), timing["seconds"]
    print(f"trained {iters} iters in {seconds:.1f}s ({iters * batch / seconds:.0f} samples/s)")
    return {"final_loss": float(losses[-1]), "losses_every_100": losses[::100].tolist(),
            "non_finite_steps": int((~torch.isfinite(losses)).sum()), **timing,
            "samples_per_s": iters * batch / seconds,
            "steady_samples_per_s": 1e3 * batch / timing["steady_step_ms"],
            "seed": seed, "iters": iters, "batch": batch, "chunk": chunk_len,
            "host_inputs": host_inputs,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def step_inputs(inputs, device):
    """``batch_fn(step, generator)`` of a chunk that takes step i's entry of
    each tensor of ``inputs`` (leading axis the step), placed on ``device``
    once."""
    inputs = tuple(t.to(device) for t in inputs)

    def batch_fn(step, generator):
        i = step.reshape(1)
        picked = tuple(t.index_select(0, i)[0] for t in inputs)
        return picked[0] if len(picked) == 1 else picked

    return batch_fn
