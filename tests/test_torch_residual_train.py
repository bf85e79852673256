"""Residual-flow models in the port against the JAX package on the CPU (the
blocks are held in tests/test_torch_residual.py, whose helpers these tests
take): a K = 2 model (Residual + ActNorm twice) from the same weights and
numpy inputs, the port fed the JAX package's draws:

* its ``forward_kld`` and every gradient leaf;
* 20 eager AdamW steps (``make_train_step`` with ``update_lipschitz_iters``)
  against the JAX package's ``make_train_step`` on the same batches and
  draws;
* a chunk on the CPU with the power iteration after each step; the example
  ``residual_twomoons`` on the CPU; ``from_noise`` replaying the blocks'
  draws of ``sample``.

Bars: 1e-4 on losses and gradient leaves, 1e-4 / 1e-3 on the weights and
power-iteration buffers after 20 steps (atol / rtol).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.training.loop import make_train_step as jax_train_step
from normflows_tpu_torch import NormalizingFlow, training
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.examples import residual_twomoons
from normflows_tpu_torch.interop import _torch_name
from normflows_tpu_torch.nets import LipschitzMLP
from tests.helpers import assert_close
from tests.test_torch_lipschitz import jax_net_of
from tests.test_torch_conditional import leaves_of, ported
from tests.test_torch_residual import TOL, B, feed, model_draws, normal, t  # noqa: F401

torch.set_num_threads(2)


def torch_residual_model(K, hidden=16, **kw):
    layers = []
    for i in range(K):
        net = LipschitzMLP([2, hidden, hidden, 2], 0.9, init_zeros=False,
                           generator=torch.Generator().manual_seed(i), device="cpu")
        layers += [tflows.Residual(net, **kw), tflows.ActNorm((2,), device="cpu")]
    return NormalizingFlow.create(tdist.DiagGaussian(2, device="cpu"), layers,
                                  p=tdist.TwoMoons(device="cpu"), device="cpu")


def jax_residual_model(tmodel, **kw):
    """The JAX package's model with the port model's nets (``jax_net_of``)."""
    layers = []
    for flow in tmodel.flows:
        if isinstance(flow, tflows.Residual):
            layers.append(jflows.Residual.create(jax_net_of(flow.iresblock.nnet), **kw))
        else:
            layers.append(jflows.ActNorm.create((2,)))
    return jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), layers,
                                      p=jdist.TwoMoons())


def model_pair(K=2, **kw):
    kw = {"n_power_series_max": 8, **kw}
    jm = jax_residual_model(torch_residual_model(K, **kw), **kw)
    x0 = normal(21, 64, 2)
    jm = jm.init_actnorm(jnp.asarray(x0))
    return jm, ported(jm, torch_residual_model(K, **kw))


@pytest.fixture(scope="module")
def shared_pair():
    """One K = 2 pair (``reduce_memory``) for the module; tests take a copy
    of the port's model."""
    return model_pair(reduce_memory=True)


@pytest.fixture
def pair(shared_pair):
    jm, tm = shared_pair
    return jm, copy.deepcopy(tm)


def test_model_forward_kld_gradient_matches_jax(pair, feed):
    """A K = 2 model (Residual with ``reduce_memory`` + ActNorm twice):
    ``forward_kld`` and every gradient leaf, on JAX's draws (the estimators
    without ``reduce_memory`` are held block by block in
    tests/test_torch_residual.py)."""
    jm, tm = pair
    x = normal(22, B, 2)
    key = jax.random.key(23)
    diff, rest = jnf.partition(jm)
    vj, gj = jax.jit(jax.value_and_grad(
        lambda d, x, k: jnf.combine(d, rest).forward_kld(x, key=k)))(diff, jnp.asarray(x), key)
    left = feed(model_draws(jm, key, x.shape))
    loss = tm.forward_kld(t(x), generator=torch.Generator())
    loss.backward()
    assert not left
    assert_close(float(loss), float(vj), atol=TOL, rtol=TOL)
    want = dict(ported(jnf.combine(gj, rest), torch_residual_model(
        2, n_power_series_max=8)).named_parameters())
    for name, p in tm.named_parameters():
        assert_close(p.grad.numpy(), want[name].detach().numpy(), atol=TOL, rtol=TOL, msg=name)


def test_eager_steps_with_update_lipschitz_match_jax(pair, feed):
    """20 AdamW steps (``make_train_step`` with ``update_lipschitz_iters=5``)
    of a K = 2 model against JAX's ``make_train_step`` on the same batches
    and draws: every loss, and the weights and power-iteration buffers after
    them."""
    jm, tm = pair
    xs = normal(24, 20, B, 2)
    lr = 1e-2
    jstate, jstep = jax_train_step(jm, optax.adamw(lr, weight_decay=1e-5),
                                   lambda m, b, k: m.forward_kld(b, key=k),
                                   update_lipschitz_iters=5)
    state, step = training.make_train_step(
        tm, torch.optim.AdamW(tm.parameters(), lr=lr, weight_decay=1e-5),
        lambda m, b, g: m.forward_kld(b, generator=g), update_lipschitz_iters=5)
    gen = torch.Generator()
    for i in range(20):
        key = jax.random.key(100 + i)
        jstate, jmetrics = jstep(jstate, jnp.asarray(xs[i]), key)
        feed(model_draws(jstate.model, key, xs[i].shape))
        state, metrics = step(state, t(xs[i]), gen)
        assert_close(float(metrics["loss"]), float(jmetrics["loss"]), atol=TOL, rtol=TOL,
                     msg=f"step {i}")
    want = leaves_of(jstate.model)
    tensors = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}
    for path, value in want.items():
        got = tensors[_torch_name(path)].detach().numpy()
        assert_close(got, value, atol=TOL, rtol=1e-3, msg=path)


def test_cpu_chunk_trains_with_update_lipschitz():
    """Two chunks of 10 steps of the example's model cut to K = 2, hidden
    32, on its data: finite losses, the second chunk's mean below the
    first's, each layer's u, v and scale the power iteration's of the
    updated weights."""
    model, x_all, _ = residual_twomoons.inputs(2, 0, hidden=32)
    model.init_actnorm(x_all[:64])
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3, weight_decay=1e-5)
    state, chunk = training.make_chunked_train_step(
        model, opt, residual_twomoons.forward_kld_loss, x_all, 64, 10, shuffle=False,
        update_lipschitz_iters=50)
    gen = torch.Generator().manual_seed(1)
    first = chunk(state, gen)[1]["loss"]
    second = chunk(state, gen)[1]["loss"]
    assert torch.isfinite(first).all() and torch.isfinite(second).all()
    assert float(second.mean()) < float(first.mean())
    for m in model.modules():
        if hasattr(m, "u") and hasattr(m, "scale"):
            w = m.weight.detach()
            assert_close(float(m.scale), float(m.u @ (w @ m.v)), atol=1e-6, rtol=1e-6)
            assert_close(float(m.scale), float(torch.linalg.matrix_norm(w, 2)), atol=1e-4,
                         rtol=1e-3)


def test_from_noise_replays_the_blocks_draws(pair):
    """In training mode each block's sampling direction draws its horizon and
    probe: ``from_noise(eps, layer_noise=...)`` on ``draw_noise``'s draws is
    ``sample`` on the same generator, bit for bit; in eval mode (2-D) the
    blocks draw nothing."""
    _, tm = pair
    assert [i for i, _ in tm.drawing_flows(B)] == [0, 2]
    with torch.no_grad():
        want = tm.sample(B, generator=torch.Generator().manual_seed(4))
        eps, noise = tm.draw_noise(B, generator=torch.Generator().manual_seed(4))
        got = tm.from_noise(eps, layer_noise=noise)
    assert [len(n) for n in noise] == [2, 2]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert residual_twomoons.set_train(tm, False).drawing_flows(B) == []


def test_example_runs_on_the_cpu():
    _, record = residual_twomoons.main(["--device", "cpu", "--iters", "20", "--chunk", "10",
                                        "--k", "2", "--hidden", "16", "--batch", "64"])
    assert record["non_finite_steps"] == 0 and record["samples_finite"]
    assert np.isfinite(record["held_out_log_q"])


def test_facade_hands_residual_blocks_a_generator_and_replays_their_draws():
    """``sample`` draws for a residual block's estimator with no generator
    given (the device's default one); ``reverse_kld(score_fn=False)``'s
    detached pass replays each block's draws, as JAX reuses each layer's
    key: at the same points it gives the first pass's log q, where fresh
    draws do not."""
    layers = [tflows.Residual(LipschitzMLP([3, 16, 3], 0.9, init_zeros=False,
                                           generator=torch.Generator().manual_seed(i),
                                           device="cpu")) for i in range(2)]
    model = NormalizingFlow.create(tdist.DiagGaussian(3, device="cpu"), layers, device="cpu")
    _, log_q = model.sample(64)
    assert torch.isfinite(log_q).all()
    gen, states = torch.Generator().manual_seed(3), []
    with torch.no_grad():
        x, log_q = model._draw(64, None, gen, states)
        again = model._log_q_detached(x, None, gen, states)
        fresh = model.log_prob(x, generator=torch.Generator().manual_seed(99))
    assert len(states) == 2
    # the same points up to the fixed point's tolerance (|dz| <~ 1e-3)
    gap, fresh_gap = (again - log_q).abs(), (fresh - log_q).abs()
    assert float(gap.max()) < 1e-2 and float(gap.median()) < 1e-5
    assert float(fresh_gap.median()) > 1e-2
