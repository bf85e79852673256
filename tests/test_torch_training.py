"""The training slice of the port against the JAX package: the softplus
gradient at 0, ``forward_kld`` / ``reverse_kld`` (with beta, and the
path-only ``score_fn=False``) with their gradients, and ``make_train_step``
with Adam.

The flagship model is cut to 3 layers of hidden width 64 with 10 bins
(tests/test_torch_flow_model.py), built with ``init_identity=False`` so that
the splines do real work, from the same weights (``load_jax_leaves``).  The
JAX side runs its default CPU path (the jnp spline) under ``jax.grad``; the
port runs its plain spline under its own ``autograd.Function``.  Base samples
cannot come from the same generator, so the port's ``q0`` is replaced by a
stub that hands out JAX's own draws.

Bars: f32 losses and gradients within atol = rtol = 1e-4 (the two agree to
about 3e-6; the sum over 1024 samples and 3 layers in another order is what
is left)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu.training.loop import make_train_step as jax_make_train_step
from normflows_tpu.utils import set_compute_dtype as jax_set_compute_dtype
from normflows_tpu_torch import training
from normflows_tpu_torch.interop import _torch_name, load_jax_leaves
from normflows_tpu_torch.ops import splines
from normflows_tpu_torch.utils import set_compute_dtype
from tests.helpers import assert_close
from tests.test_torch_flow_model import jax_model, leaves_of, torch_model

torch.set_num_threads(2)

TOL = 1e-4
N = 1024
LR = 5e-4


class FixedBase(torch.nn.Module):
    """Test-only ``q0``: hands out the given draws ``(z, log_q)`` in turn,
    and the real base's ``log_prob``."""

    def __init__(self, base, draws):
        super().__init__()
        self.base = base
        self.draws = list(draws)

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        z, log_q = self.draws.pop(0)
        assert z.shape[0] == num_samples
        return torch.from_numpy(z), torch.from_numpy(log_q)

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


def jax_draw(jm, key, n=N):
    """The base samples JAX's ``reverse_kld(key, n)`` draws."""
    kq, _ = jax.random.split(key)
    z, log_q = jm.q0.sample_and_log_prob(kq, n)
    return np.array(z), np.array(log_q)


def port_of(jm, draws=()):
    tm = load_jax_leaves(torch_model(), leaves_of(jm))
    tm.q0 = FixedBase(tm.q0, draws)
    return tm


def jax_value_and_grads(jm, loss):
    """JAX's loss and gradients, the gradients laid out as the port's
    parameters (by name, weights transposed)."""
    diff, rest = jnf.partition(jm)
    value, grads = jax.value_and_grad(lambda d: loss(jnf.combine(d, rest)))(diff)
    as_port = load_jax_leaves(torch_model(), leaves_of(jnf.combine(grads, rest)))
    return float(value), {n: p.detach() for n, p in as_port.named_parameters()}


def port_value_and_grads(tm, loss):
    tm.zero_grad(set_to_none=True)
    value = loss(tm)
    value.backward()
    return float(value.detach()), {n: p.grad for n, p in tm.named_parameters()}


def data(seed=0):
    """Data on the flagship's domain: Gaussian dim 0, dim 1 in [-pi, pi]."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=N), rng.uniform(-np.pi, np.pi, N)],
                    axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def jm():
    return jax_model()


def test_softplus_gradient_is_sigmoid_at_zero():
    x = torch.tensor([0.0, -0.0, 1.5, -3.0, 30.0], requires_grad=True)
    y = splines.softplus(x)
    y.sum().backward()
    assert x.grad[0] == 0.5 and x.grad[1] == 0.5
    assert_close(x.grad.numpy(), torch.sigmoid(x.detach()).numpy(), atol=1e-7, rtol=1e-6)
    # values as before: max(x, 0) + log1p(exp(-|x|))
    xd = x.detach()
    assert torch.equal(y.detach(), torch.clamp_min(xd, 0) + torch.log1p(torch.exp(-xd.abs())))


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_layer_bias_gradients_match_jax(jm, direction):
    """The gradient of every parameter of one layer, final_layer.bias the
    one to watch: a degree-1 MADE output is its zero bias alone, so feature
    0's derivative logits sit at exactly 0, where softplus' gradient is 0.5
    (a ``clamp_min`` softplus gave twice that)."""
    x = (np.random.default_rng(1).normal(size=(N, 2)) * 2.0).astype(np.float32)
    tm = port_of(jm)

    def jax_loss(model):
        y, ld = getattr(model.flows[0], direction)(jnp.asarray(x))
        return jnp.mean(jnp.sin(y)) + jnp.mean(ld)

    def port_loss(model):
        y, ld = getattr(model.flows[0], direction)(torch.from_numpy(x))
        return torch.mean(torch.sin(y)) + torch.mean(ld)

    _, gj = jax_value_and_grads(jm, jax_loss)
    _, gt = port_value_and_grads(tm, port_loss)
    for name, g in gt.items():
        if name.startswith("flows.0."):
            assert torch.isfinite(g).all()
            assert_close(g.numpy(), gj[name].numpy(), atol=2e-3, rtol=2e-3, msg=name)
    bias = "flows.0.mprqat.autoregressive_net.final_layer.bias"
    assert gt[bias].abs().max() > 1e-3


# each loss as (JAX, port): the JAX one takes the key of its draw, the
# port's q0 stub hands out that same draw
LOSSES = {
    "reverse_kld": (lambda m, x, key: m.reverse_kld(key, N),
                    lambda m, x: m.reverse_kld(N)),
    "reverse_kld_beta_half": (lambda m, x, key: m.reverse_kld(key, N, beta=0.5),
                              lambda m, x: m.reverse_kld(N, beta=0.5)),
    "reverse_kld_path_only": (lambda m, x, key: m.reverse_kld(key, N, score_fn=False),
                              lambda m, x: m.reverse_kld(N, score_fn=False)),
    "forward_kld": (lambda m, x, key: m.forward_kld(x),
                    lambda m, x: m.forward_kld(x)),
}


@pytest.mark.parametrize("what", list(LOSSES))
def test_loss_and_gradients_match_jax(jm, what):
    key = jax.random.key(3)
    x = data()
    tm = port_of(jm, [jax_draw(jm, key)])
    jax_loss, port_loss = LOSSES[what]
    vj, gj = jax_value_and_grads(jm, lambda m: jax_loss(m, jnp.asarray(x), key))
    vt, gt = port_value_and_grads(tm, lambda m: port_loss(m, torch.from_numpy(x)))
    assert np.isfinite(vt)
    assert_close(vt, vj, atol=TOL, rtol=TOL)
    assert gt.keys() == gj.keys() and len(gt) == 27
    for name, g in gt.items():
        assert torch.isfinite(g).all(), name
        assert_close(g.numpy(), gj[name].numpy(), atol=TOL, rtol=TOL, msg=name)


def test_bf16_loss_and_gradients_match_jax(jm):
    """bf16 MADE matmuls: the two frameworks round their accumulators to bf16
    at other points, and a parameter's bf16 rounding flips where its float32
    input differs in the last bit.  Bars: 1e-3 on the loss (7e-7 measured),
    and each gradient leaf within 5% of its norm, plus 1e-6 for the leaves
    whose gradient is 0 (1.2e-2 of the norm measured, on the biases)."""
    key = jax.random.key(4)
    jmb = jax_set_compute_dtype(jm, "bfloat16")
    tm = set_compute_dtype(port_of(jm, [jax_draw(jm, key)]), "bfloat16")
    vj, gj = jax_value_and_grads(jmb, lambda m: m.reverse_kld(key, N))
    vt, gt = port_value_and_grads(tm, lambda m: m.reverse_kld(N))
    assert_close(vt, vj, atol=1e-3, rtol=0)
    for name, g in gt.items():
        assert torch.isfinite(g).all(), name
        assert float((g - gj[name]).norm()) <= 5e-2 * float(gj[name].norm()) + 1e-6, name


def test_trainable_parameters_are_jax_partition_leaves(jm):
    diff, _ = jnf.partition(jm)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(diff)[0]:
        name = _torch_name(jax.tree_util.keystr(path))
        shape = np.shape(leaf)
        want[name] = shape[::-1] if name.endswith(".weight") and len(shape) == 2 else shape
    tm = port_of(jm)
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want and len(got) == 27


def test_adam_step_matches_optax(jm):
    """One step of make_train_step with torch's Adam(5e-4) against
    optax.adam(5e-4), on gradients drawn with numpy (the loss sum(p * g) has
    gradient g)."""
    tm = port_of(jm)
    rng = np.random.default_rng(5)
    grads = {n: rng.normal(size=tuple(p.shape)).astype(np.float32) * 10.0 ** rng.integers(-4, 1)
             for n, p in tm.named_parameters()}
    start = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    opt = torch.optim.Adam(tm.parameters(), lr=LR)

    def loss_fn(model, batch, generator):
        return sum((p * torch.from_numpy(grads[n])).sum() for n, p in model.named_parameters())

    state, step_fn = training.make_train_step(tm, opt, loss_fn)
    tx = optax.adam(LR)
    params = {n: jnp.asarray(v) for n, v in start.items()}
    opt_state = tx.init(params)
    for i in range(2):
        state, metrics = step_fn(state, None)
        assert metrics["finite"] and state.step == i + 1
        updates, opt_state = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
    for n, p in tm.named_parameters():
        assert_close(p.detach().numpy(), np.asarray(params[n]), atol=1e-7, rtol=1e-6, msg=n)


def test_non_finite_loss_skips_the_whole_update(jm):
    tm = port_of(jm)
    opt = torch.optim.Adam(tm.parameters(), lr=LR)
    poison = {"on": False}

    def loss_fn(model, batch, generator):
        loss = sum(p.square().sum() for p in model.parameters())
        return loss * float("nan") if poison["on"] else loss

    state, step_fn = training.make_train_step(tm, opt, loss_fn)
    state, metrics = step_fn(state, None)  # a good step: Adam has state now
    assert metrics["finite"]
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    adam = copy.deepcopy(opt.state_dict()["state"])
    poison["on"] = True
    state, metrics = step_fn(state, None)
    assert not metrics["finite"] and torch.isnan(metrics["loss"])
    assert state.step == 2  # the step counter advances, as in the JAX package
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    after = opt.state_dict()["state"]
    assert after.keys() == adam.keys()
    for i, s in adam.items():
        for k, v in s.items():
            assert torch.equal(after[i][k], v), (i, k)
    # power iteration after each step (residual flows): on a model without
    # induced-norm layers it leaves the skipped step's parameters as they were
    state, step_fn = training.make_train_step(tm, opt, loss_fn, update_lipschitz_iters=1)
    state, metrics = step_fn(state, None)
    assert not metrics["finite"]
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), params[n]), n


def test_three_steps_match_jax_train_step(jm):
    """Three reverse-KLD steps with Adam(5e-4), the same base draws on both
    sides: the losses agree within the f32 bar (2e-6 measured)."""
    keys = [jax.random.key(10 + i) for i in range(3)]
    state, step_fn = jax_make_train_step(jm, optax.adam(LR),
                                         lambda m, batch, k: m.reverse_kld(k, N))
    jax_losses = []
    for k in keys:
        state, metrics = step_fn(state, None, k)
        jax_losses.append(float(metrics["loss"]))
    tm = port_of(jm, [jax_draw(jm, k) for k in keys])
    tstate, tstep = training.make_train_step(
        tm, torch.optim.Adam(tm.parameters(), lr=LR),
        lambda m, batch, generator: m.reverse_kld(N, generator=generator))
    losses = []
    for _ in keys:
        tstate, metrics = tstep(tstate, None)
        losses.append(float(metrics["loss"]))
    assert tstate.step == 3
    assert_close(np.array(losses), np.array(jax_losses), atol=TOL, rtol=TOL)
