"""The chunked trainer of the port (``training.make_step_chunk``,
``make_chunked_train_step``, ``cosine_decay_schedule``) and its example
``normflows_tpu_torch.examples.nsf_cylinder``, on the CPU, where a chunk runs
its step eagerly ``chunk_len`` times (on the card it is captured in a CUDA
graph: tests/test_torch_gpu.py).

The model is the flagship cut to 3 layers of hidden width 64
(tests/test_torch_flow_model.py), from the JAX model's weights
(``load_jax_leaves``).  Bars: a sequential forward-KL chunk against JAX's
``make_chunked_train_step``, every per-step loss and final parameter within
atol = rtol = 1e-4 (the f32 bar of tests/test_torch_training.py); a chunk
against the same steps through ``make_train_step`` bit for bit, since both
run the same operations on the same draws."""

import copy

import jax
import numpy as np
import optax
import pytest
import torch

from normflows_tpu.training.loop import make_chunked_train_step as jax_chunked
from normflows_tpu_torch import training
from normflows_tpu_torch.examples import nsf_cylinder
from tests.helpers import assert_close
from tests.test_torch_flow_model import jax_model, leaves_of, torch_model
from tests.test_torch_training import data, port_of

torch.set_num_threads(2)

TOL = 1e-4
LR = 5e-4
B, C = 128, 5


@pytest.fixture(scope="module")
def jm():
    return jax_model()


def forward_kld(model, batch, generator):
    return model.forward_kld(batch)


def reverse_kld(model, batch, generator):
    return model.reverse_kld(256, generator=generator)


def adam_state(opt):
    return {(i, k): v.clone() for i, s in opt.state_dict()["state"].items()
            for k, v in s.items()}


def assert_same(model_a, model_b, opt_a, opt_b):
    for (n, a), b in zip(model_a.named_parameters(), model_b.parameters()):
        assert torch.equal(a, b), n
    sa, sb = adam_state(opt_a), adam_state(opt_b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_sequential_chunk_matches_jax(jm):
    """Two sequential chunks of 5 forward-KL steps with Adam under cosine
    decay over the 10 steps, against JAX's chunks: the window continues
    across chunks, and the schedule counts from 0 on the optimizer."""
    x = data()
    schedule = optax.cosine_decay_schedule(LR, 2 * C)
    jstate, jchunk = jax_chunked(jm, optax.adam(schedule), lambda m, b, k: m.forward_kld(b),
                                 x, batch_size=B, chunk_len=C, shuffle=False)
    jlosses = []
    for i in range(2):
        jstate, metrics = jchunk(jstate, jax.random.key(i))
        jlosses.append(np.asarray(metrics["loss"]))
    tm = port_of(jm)
    opt = torch.optim.Adam(tm.parameters(), lr=LR)
    state, chunk = training.make_chunked_train_step(
        tm, opt, forward_kld, torch.from_numpy(x), batch_size=B, chunk_len=C, shuffle=False,
        schedule=training.cosine_decay_schedule(LR, 2 * C))
    losses = []
    for i in range(2):
        state, metrics = chunk(state)
        assert metrics["loss"].shape == (C,) and int(state.step) == (i + 1) * C
        losses.append(metrics["loss"].numpy())
    assert_close(np.concatenate(losses), np.concatenate(jlosses), atol=TOL, rtol=TOL)
    want = port_of(jstate.model)
    for (name, p), q in zip(tm.named_parameters(), want.parameters()):
        assert_close(p.detach().numpy(), q.detach().numpy(), atol=TOL, rtol=TOL, msg=name)
    assert float(opt.param_groups[0]["lr"]) == pytest.approx(float(schedule(2 * C - 1)),
                                                             rel=1e-6)


def test_reverse_kld_chunk_is_bit_equal_to_eager_steps():
    eager, chunked = torch_model(), torch_model()
    chunked.load_state_dict(eager.state_dict())
    state, step = training.make_train_step(
        eager, torch.optim.Adam(eager.parameters(), lr=LR), reverse_kld)
    gen = torch.Generator().manual_seed(3)
    want = [step(state, None, gen)[1]["loss"] for _ in range(C)]
    cstate, chunk = training.make_step_chunk(
        chunked, torch.optim.Adam(chunked.parameters(), lr=LR), reverse_kld, chunk_len=C)
    cstate, metrics = chunk(cstate, torch.Generator().manual_seed(3))
    assert torch.equal(metrics["loss"], torch.stack(want))
    assert int(cstate.step) == C == state.step
    assert_same(eager, chunked, state.optimizer, cstate.optimizer)


def test_shuffled_chunk_trains():
    x = torch.from_numpy(data(1))
    model = torch_model()
    state, chunk = training.make_chunked_train_step(
        model, torch.optim.Adam(model.parameters(), lr=5e-3), forward_kld, x,
        batch_size=256, chunk_len=10, shuffle=True)
    gen = torch.Generator().manual_seed(0)
    losses = [chunk(state, gen)[1]["loss"] for _ in range(3)]
    assert int(state.step) == 30
    assert all(torch.isfinite(v).all() for v in losses)
    assert losses[-1].mean() < losses[0].mean()


def test_tuple_data_and_oversized_batch():
    x = torch.from_numpy(data(2)[:256])
    y = torch.zeros(256, dtype=torch.int32)
    model = torch_model()
    opt = torch.optim.Adam(model.parameters(), lr=LR)

    def loss_fn(m, batch, generator):
        xb, yb = batch
        assert xb.shape == (64, 2) and yb.shape == (64,) and yb.dtype == torch.int32
        return m.forward_kld(xb)

    state, chunk = training.make_chunked_train_step(model, opt, loss_fn, (x, y),
                                                    batch_size=64, chunk_len=2)
    state, metrics = chunk(state, torch.Generator().manual_seed(0))
    assert metrics["loss"].shape == (2,) and int(state.step) == 2
    with pytest.raises(ValueError, match="exceeds dataset size"):
        training.make_chunked_train_step(model, opt, loss_fn, (x, y), batch_size=512)
    # power iteration after each step (residual flows) runs on any model
    other = torch_model()
    lstate, lchunk = training.make_chunked_train_step(
        other, torch.optim.Adam(other.parameters(), lr=LR), loss_fn, (x, y), 64, 2,
        update_lipschitz_iters=1)
    assert torch.isfinite(lchunk(lstate)[1]["loss"]).all() and int(lstate.step) == 2
    with pytest.raises(TypeError, match="Adam"):
        training.make_step_chunk(model, torch.optim.SGD(model.parameters(), lr=LR), loss_fn)


def poisoned(at, box):
    """A loss whose value is NaN when the step count (the chunk's device
    count in ``box["state"]``, or the host's count of calls) equals ``at``."""
    calls = {"n": 0}

    def loss_fn(model, batch, generator):
        loss = sum(p.square().sum() for p in model.parameters())
        if "state" in box:
            return loss + torch.where(box["state"].step == at, float("nan"), 0.0)
        calls["n"] += 1
        return loss * float("nan") if calls["n"] - 1 == at else loss

    return loss_fn


def test_nan_step_inside_a_chunk_skips_the_whole_update(jm):
    """The device-side skip against the eager trap-2 step: a chunk of 4 with
    step 2 NaN equals 4 eager steps with step 2 NaN (parameters, exp_avg,
    exp_avg_sq, Adam's step), and a one-step chunk at that step leaves them
    all as they were."""
    eager, chunked, single = port_of(jm), port_of(jm), port_of(jm)
    estate, step = training.make_train_step(
        eager, torch.optim.Adam(eager.parameters(), lr=LR), poisoned(2, {}))
    for _ in range(4):
        estate, metrics = step(estate, None)
    box = {}
    cstate, chunk = training.make_step_chunk(
        chunked, torch.optim.Adam(chunked.parameters(), lr=LR), poisoned(2, box), chunk_len=4)
    box["state"] = cstate
    cstate, metrics = chunk(cstate)
    finite = torch.isfinite(metrics["loss"])
    assert finite.tolist() == [True, True, False, True] and int(cstate.step) == 4
    assert_same(eager, chunked, estate.optimizer, cstate.optimizer)
    assert int(cstate.optimizer.state_dict()["state"][0]["step"]) == 3

    box = {}
    sstate, one = training.make_step_chunk(
        single, torch.optim.Adam(single.parameters(), lr=LR), poisoned(2, box), chunk_len=1)
    box["state"] = sstate
    for _ in range(2):
        one(sstate)
    before = (copy.deepcopy(single), adam_state(sstate.optimizer))
    _, metrics = one(sstate)
    assert torch.isnan(metrics["loss"]).all() and int(sstate.step) == 3
    for (n, a), b in zip(single.named_parameters(), before[0].parameters()):
        assert torch.equal(a, b), n
    after = adam_state(sstate.optimizer)
    assert after.keys() == before[1].keys()
    assert all(torch.equal(after[k], before[1][k]) for k in after)
    one(sstate)
    assert not torch.equal(next(single.parameters()), next(before[0].parameters()))


def test_cosine_schedule_matches_optax():
    T = 10
    want = optax.cosine_decay_schedule(LR, T)
    got = training.cosine_decay_schedule(LR, T)
    for count in range(T + 3):
        assert_close(float(got(torch.tensor(float(count)))), float(want(count)),
                     atol=1e-10, rtol=1e-6, msg=str(count))
    with pytest.raises(ValueError, match="positive"):
        training.cosine_decay_schedule(LR, 0)


def test_nsf_cylinder_runs_chunked_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(nsf_cylinder, "HELD_OUT", 1024)  # 2^16 takes ~10 s on the CPU
    kl = nsf_cylinder.main(["--device", "cpu", "--iters", "4", "--chunk", "2",
                            "--num-samples", "256"])
    out = capsys.readouterr().out
    assert "iter     3  reverse KLD" in out
    assert "training wall time:" in out and "samples/s" in out
    assert "final KL(q||p) estimate:" in out
    assert np.isfinite(kl)


def test_captured_chunk_wants_a_capturable_optimizer(monkeypatch):
    """The card's path refuses a plain Adam before anything runs (the device
    is faked: the check is all that runs)."""
    model = torch_model()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    fake = torch.device("cuda", 0)
    monkeypatch.setattr(torch.nn.Parameter, "device", property(lambda self: fake),
                        raising=False)
    with pytest.raises(ValueError, match="capturable=True"):
        training.make_step_chunk(model, opt, reverse_kld)


def test_device_counters_count_launches_only():
    """``backend.count_launch`` adds one to ``[backward][inverse]`` of the
    tensor a wrapper's ``DEVICE_LAUNCHES`` holds, and nothing when it is
    None; on the CPU the spline wrappers take their plain versions, which
    are not launches, so a CPU chunk leaves the counters at 0."""
    from normflows_tpu_torch.ops import backend, spline_cuda

    counts = torch.zeros(2, 2, dtype=torch.int64)
    backend.count_launch(counts, True, False)
    backend.count_launch(counts, False, True)
    backend.count_launch(None, True, True)
    assert counts.tolist() == [[0, 1], [1, 0]]
    counts.zero_()
    model = torch_model()
    state, chunk = training.make_step_chunk(
        model, torch.optim.Adam(model.parameters(), lr=LR), reverse_kld, chunk_len=1)
    spline_cuda.DEVICE_LAUNCHES = counts
    try:
        chunk(state, torch.Generator().manual_seed(0))
    finally:
        spline_cuda.DEVICE_LAUNCHES = None
    assert counts.tolist() == [[0, 0], [0, 0]]
