"""Residual flows in the port (``flows.residual``, ``utils.optim``'s
``update_lipschitz`` in the trainers, ``interop`` of a residual model, the
example ``residual_twomoons``) against the JAX package on the CPU, from the
same weights (``load_jax_leaves``) and numpy inputs, the port fed the JAX
package's draws (``draw_horizon`` / ``draw_probe``):

* every estimator (basic, Neumann under a static cap, Neumann to the sampled
  horizon; geometric and Poisson horizons; ``exact_trace``; the 2-D brute
  force), value and gradient;
* the capped form of the dynamic estimator against the exact one below the
  cap, bit for bit; ``reduce_memory`` (rematerialisation) against none;
* the missing-generator error, the fixed-point round trip, the eval mode;
* (the models and their training: tests/test_torch_residual_train.py);
* the example's inputs replayed through the JAX package (:func:`replay`),
  which sets the quality bar of the card's run.

Bars: 1e-5 on a block's values and log-dets, 1e-4 on a model's log-densities,
losses and gradient leaves (atol and rtol; float32 sums in other orders).
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.nets import LipschitzMLP as JLipschitzMLP
from normflows_tpu.training.loop import make_chunked_train_step as jax_chunked
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.examples import residual_twomoons
from normflows_tpu_torch.flows import residual
from normflows_tpu_torch.interop import _torch_name
from normflows_tpu_torch.nets import LipschitzMLP
from tests.helpers import assert_close
from tests.test_torch_lipschitz import jax_net_of
from tests.test_torch_conditional import ported

torch.set_num_threads(2)

Y_TOL, TOL = 1e-5, 1e-4
B = 16


def normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ---- JAX's draws fed to the port ---------------------------------------------

def block_draws(jblock, key, shape):
    """The draws JAX's ``iResBlock._logdetgrad(x, key)`` takes, in the port's
    order: the horizon (where the mode has one), then the probe (where it has
    one)."""
    kn, ke = jax.random.split(key)
    train = jblock.train
    if (jblock.brute_force or not train) and len(shape) == 2 and shape[1] == 2:
        return []
    draws = []
    roulette = not (train and jblock.n_power_series is not None)
    if roulette:
        p = jax.nn.sigmoid(jblock.geom_p_logit)
        n = (jax.random.geometric(kn, p, (jblock.n_samples,)) if jblock.n_dist == "geometric"
             else jax.random.poisson(kn, jblock.lamb, (jblock.n_samples,)))
        draws.append(("horizon", np.asarray(n, np.float32)))
    if not jblock.exact_trace:
        draws.append(("probe", np.asarray(jax.random.normal(ke, shape))))
    return draws


def model_draws(jmodel, key, shape):
    """The draws of ``jmodel.log_prob(x, key=key)`` (x of ``shape``), block
    by block in the density direction."""
    keys = jax.random.split(key, len(jmodel.flows))
    out = []
    for flow, k in zip(reversed(jmodel.flows), reversed(list(keys))):
        if isinstance(flow, jflows.Residual):
            out += block_draws(flow.iresblock, k, shape)
    return out


@pytest.fixture
def feed(monkeypatch):
    """``feed(draws)``: the port's next draws are ``draws``, in order."""
    queue = []

    def take(kind):
        def draw(*args, **kwargs):
            got, value = queue.pop(0)
            assert got == kind, f"the port drew a {kind} where JAX drew a {got}"
            return t(value)
        return draw

    monkeypatch.setattr(residual, "draw_horizon", take("horizon"))
    monkeypatch.setattr(residual, "draw_probe", take("probe"))

    def put(draws):
        queue.extend(draws)
        return queue
    return put


# ---- blocks ---------------------------------------------------------------------

def net_pair(seed, channels=(2, 16, 16, 2)):
    tnet = LipschitzMLP(list(channels), 0.9, init_zeros=False,
                        generator=torch.Generator().manual_seed(seed), device="cpu")
    return jax_net_of(tnet), tnet


BLOCKS = {
    "neumann_dynamic": dict(),
    "neumann_dynamic_poisson": dict(n_dist="poisson"),
    "neumann_static": dict(n_power_series=6),
    "basic": dict(neumann_grad=False),
    "exact_trace": dict(exact_trace=True, n_power_series=5),
    "remat_dynamic": dict(grad_in_forward=True),
    "brute_force": dict(brute_force=True),
}


def block_pair(kw, seed=1, channels=(2, 16, 16, 2)):
    jnet, tnet = net_pair(seed, channels)
    jb = jflows.iResBlock.create(jnet, **kw)
    return jb, ported(jb, tflows.iResBlock(tnet, **kw))


def jax_block_loss(jb, x, key, w):
    """(g, logdet) of JAX's block and the gradient of sum(g * w) + sum(logdet)
    w.r.t. its leaves and x."""
    diff, rest = jnf.partition(jb)

    def f(d, x):
        g, ld = jnf.combine(d, rest)._logdetgrad(x, key)
        return jnp.sum(g * w) + jnp.sum(ld), (g, ld)

    (_, (g, ld)), (gd, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        diff, jnp.asarray(x))
    return g, ld, jnf.combine(gd, rest), gx


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_estimator_matches_jax_in_value_and_gradient(name, feed):
    """Each estimator's g and log-det, and the gradients of sum(g w) +
    sum(logdet) w.r.t. every parameter and the input, on JAX's draws."""
    kw = {"n_power_series_max": 6, **BLOCKS[name]}
    d = 3 if name != "brute_force" else 2
    channels = (d, 16, d)
    jb, tb = block_pair(kw, channels=channels)
    x, w = normal(2, B, d, scale=0.5), normal(3, B, d)
    key = jax.random.key(4)
    g, ld, jgrads, jgx = jax_block_loss(jb, x, key, w)
    left = feed(block_draws(jb, key, x.shape))
    xt = t(x).requires_grad_(True)
    tg, tld = tb._logdetgrad(xt, torch.Generator())
    assert not left
    assert_close(tg.detach().numpy(), np.asarray(g), atol=Y_TOL, rtol=Y_TOL)
    assert_close(tld.detach().numpy(), np.asarray(ld), atol=Y_TOL, rtol=Y_TOL)
    (torch.sum(tg * t(w)) + torch.sum(tld)).backward()
    assert_close(xt.grad.numpy(), np.asarray(jgx), atol=TOL, rtol=TOL, msg="x")
    want = dict(ported(jgrads, tflows.iResBlock(
        LipschitzMLP(list(channels), 0.9, init_zeros=False, device="cpu"), **kw))
        .named_parameters())
    for n, p in tb.named_parameters():
        assert_close(p.grad.numpy(), want[n].detach().numpy(), atol=TOL, rtol=TOL, msg=n)


def test_capped_series_equals_the_exact_one_below_the_cap():
    """Horizons under the cap: the capped form (what a captured step runs)
    gives the exact form's values bit for bit (its extra terms add exact
    zeros) and the same gradients; above the cap it stops short."""
    _, tb = block_pair({})
    x = normal(5, B, 2, scale=0.5)
    vareps = t(normal(6, B, 2))
    offset, p, lamb = 2, torch.sigmoid(tb.geom_p_logit), tb.lamb
    for horizon in (1.0, 3.0, 22.0):
        n_arr = torch.tensor([horizon])
        out = {}
        for cap in (None, 24):
            tb.zero_grad()
            xt = t(x).requires_grad_(True)
            g, ld = residual.neumann_logdet_estimator_dynamic(
                tb.nnet, xt, vareps, n_arr, offset, "geometric", p, lamb, cap=cap)
            (g.sum() + ld.sum()).backward()
            out[cap] = (ld.detach(), xt.grad, [q.grad.clone() for q in tb.parameters()])
        assert torch.equal(out[None][0], out[24][0])
        assert torch.equal(out[None][1], out[24][1])
        assert all(torch.equal(a, b) for a, b in zip(out[None][2], out[24][2]))
    # a horizon past the cap: the capped series takes 24 pullbacks, the
    # exact one 32
    n_arr = torch.tensor([30.0])
    for cap, want in ((None, 32), (24, 24)):
        calls = []
        pullback = residual._pullback

        def counted(*args, **kwargs):
            calls.append(1)
            return pullback(*args, **kwargs)

        residual._pullback = counted
        try:
            with torch.no_grad():
                residual.neumann_logdet_estimator_dynamic(
                    tb.nnet, t(x), vareps, n_arr, offset, "geometric", p, lamb, cap=cap)
        finally:
            residual._pullback = pullback
        assert len(calls) == want + 1  # the series, then the differentiable pullback


def test_capped_horizons_are_counted(monkeypatch):
    """``residual.CAPPED`` adds one for each capped call whose horizon
    exceeds the cap."""
    _, tb = block_pair({})
    counts = torch.zeros((), dtype=torch.int64)
    monkeypatch.setattr(residual, "CAPPED", counts)
    p, lamb, x, v = torch.sigmoid(tb.geom_p_logit), tb.lamb, t(normal(7, 4, 2)), t(normal(8, 4, 2))
    for horizon in (5.0, 23.0, 21.0):
        residual.neumann_logdet_estimator_dynamic(tb.nnet, x, v, torch.tensor([horizon]), 2,
                                                  "geometric", p, lamb, cap=24)
    assert int(counts) == 1


@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_reduce_memory_equals_plain_in_values_and_gradients(kind):
    """The rematerialised Neumann estimator (``grad_in_forward``, the
    ``reduce_memory`` of ``Residual``) against the same estimator without
    it, on the same draws: values and gradients equal."""
    extra = {} if kind == "dynamic" else {"n_power_series": 6}
    _, plain = block_pair(extra)
    _, remat = block_pair({**extra, "grad_in_forward": True})
    x, w = normal(9, B, 2, scale=0.5), t(normal(10, B, 2))
    got = {}
    for name, block in (("plain", plain), ("remat", remat)):
        xt = t(x).requires_grad_(True)
        g, ld = block._logdetgrad(xt, torch.Generator().manual_seed(11))
        (torch.sum(g * w) + torch.sum(ld ** 2)).backward()
        got[name] = (g.detach(), ld.detach(), xt.grad,
                     [p.grad for p in block.parameters()])
    a, b = got["plain"], got["remat"]
    for u, v in zip(a[:3], b[:3]):
        assert_close(u.numpy(), v.numpy(), atol=1e-6, rtol=1e-6)
    for u, v in zip(a[3], b[3]):
        assert_close(u.numpy(), v.numpy(), atol=1e-6, rtol=1e-6)


def test_missing_generator_raises():
    """A stochastic log-det without a generator raises (JAX: without a key);
    the deterministic modes need none."""
    jnet, tnet = net_pair(12, (3, 16, 3))
    flow = tflows.Residual(tnet, reduce_memory=False)
    z = t(normal(13, 4, 3))
    with pytest.raises(ValueError, match="torch.Generator"):
        flow.inverse(z)
    exact = tflows.Residual(tnet, exact_trace=True, reduce_memory=False, n_power_series=8)
    _, ld = exact.inverse(z)
    assert torch.isfinite(ld).all()


def test_round_trip_and_the_fixed_point_inverse_match_jax():
    """``forward`` (the fixed point) of JAX's and the port's layer on the
    same input, within 1e-5; ``inverse(forward(z))`` returns z, the
    brute-force log-dets cancel; the fixed point read the host once a block
    of steps."""
    jnet, tnet = net_pair(14)
    jf = jflows.Residual.create(jnet, brute_force=True, reduce_memory=False)
    tf = ported(jf, tflows.Residual(tnet, brute_force=True, reduce_memory=False))
    z = normal(15, B, 2)
    jx, jld = jax.jit(lambda f, z: f.forward(z))(jf, jnp.asarray(z))
    x, ld = tf.forward(t(z))
    assert_close(x.detach().numpy(), np.asarray(jx), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ld.detach().numpy(), np.asarray(jld), atol=TOL, rtol=TOL)
    back, ld_back = tf.inverse(x)
    assert_close(back.detach().numpy(), z, atol=1e-4, rtol=1e-3)
    assert_close((ld + ld_back).detach().numpy(), np.zeros(B), atol=1e-3, rtol=1e-3)
    info = tf.iresblock.last_inverse
    steps = int(info["steps"])
    assert 0 < steps and info["host_reads"] == -(-(steps + 1) // residual.FIXED_POINT_BLOCK)


def test_eval_mode_takes_the_brute_force_and_the_static_cap():
    """Eval mode (``set_train(False)``): a 2-D block's log-det is the
    brute-force one, needing no generator; a 3-D block's takes 20 exact
    terms under a cap of ``n_power_series_max + 18`` (22 here), on JAX's
    draws."""
    jnet, tnet = net_pair(16)
    jf = jflows.Residual.create(jnet).set_train(False)
    tf = ported(jf, tflows.Residual(tnet)).set_train(False)
    assert not tf.training
    z = normal(17, B, 2)
    jz, jld = jax.jit(lambda f, z: f.inverse(z))(jf, jnp.asarray(z))
    with torch.no_grad():
        tz, tld = tf.inverse(t(z))
    assert_close(tld.numpy(), np.asarray(jld), atol=Y_TOL, rtol=Y_TOL)
    jnet3, tnet3 = net_pair(18, (3, 16, 3))
    jf3 = jflows.Residual.create(jnet3, n_power_series_max=4).set_train(False)
    tf3 = ported(jf3, tflows.Residual(tnet3, n_power_series_max=4)).set_train(False)
    z3 = normal(19, B, 3, scale=0.5)
    key = jax.random.key(20)
    _, jld3 = jax.jit(lambda f, z, k: f.inverse(z, key=k))(jf3, jnp.asarray(z3), key)
    draws = block_draws(jf3.iresblock, key, z3.shape)
    queue = list(draws)
    with torch.no_grad():
        orig = residual.draw_horizon, residual.draw_probe
        try:
            residual.draw_horizon = lambda *a, **k: t(queue.pop(0)[1])
            residual.draw_probe = lambda *a, **k: t(queue.pop(0)[1])
            _, tld3 = tf3.inverse(t(z3), generator=torch.Generator())
        finally:
            residual.draw_horizon, residual.draw_probe = orig
    assert_close(tld3.numpy(), np.asarray(jld3), atol=Y_TOL, rtol=Y_TOL)


# ---- the example replayed through the JAX package ----------------------------
#
# The port's residual example (``residual_twomoons``) draws its inputs on the
# host from a seed: the weights, the training points and the held-out points.
# ``replay`` trains the JAX package's model on them with its
# ``make_chunked_train_step``, ``optax.adamw(lr, weight_decay=1e-5)`` and
# ``update_lipschitz_iters=50`` in the same sequential windows, on the CPU,
# and evaluates the same held-out points in eval mode.  The estimator's draws
# are JAX's own.  At full size, one JSON line a seed:
#
#     JAX_PLATFORMS=cpu python -m tests.test_torch_residual [--seeds 0-2]
#         [--iters 1000] [--k 16] [--batch 512] [--lr 3e-4] [--chunk 100]


def jax_model_of(tmodel, K, hidden=128):
    """The JAX example's model holding the port model's tensors (no
    transposes: ``InducedNormLinear`` keeps (out, in) on both sides)."""
    layers = []
    for i in range(K):
        net = JLipschitzMLP.create(jax.random.key(i), [2, hidden, hidden, 2],
                                   lipschitz_const=0.9, init_zeros=True)
        layers += [jflows.Residual.create(net, reduce_memory=True), jflows.ActNorm.create((2,))]
    jmodel = jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), layers,
                                        p=jdist.TwoMoons())
    tensors = {**dict(tmodel.named_parameters()), **dict(tmodel.named_buffers())}
    paths, treedef = jax.tree_util.tree_flatten_with_path(jmodel)
    leaves = []
    for path, leaf in paths:
        # a copy: jnp.asarray may alias a numpy view of the port's tensor
        value = np.array(tensors[_torch_name(jax.tree_util.keystr(path))].detach().cpu())
        if value.shape != leaf.shape:
            raise ValueError(f"{path}: the port's {value.shape}, JAX's {leaf.shape}")
        leaves.append(jnp.asarray(value, leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def jax_eval(jmodel, x):
    """Mean log q of ``x`` with every Residual in eval mode (brute force)."""
    flows = tuple(f.set_train(False) if isinstance(f, jflows.Residual) else f
                  for f in jmodel.flows)
    return float(jnp.mean(jax.jit(lambda m, x: m.log_prob(x))(jmodel.replace(flows=flows),
                                                              jnp.asarray(x))))


def replay(seed, iters=1000, K=16, batch=512, lr=3e-4, chunk=100, hidden=128):
    """Train the JAX package's model on the example's inputs at ``seed``;
    returns the record."""
    tmodel, x_all, x_held_out = residual_twomoons.inputs(K, seed, hidden=hidden)
    tmodel.init_actnorm(x_all[:batch])
    jmodel = jax_model_of(tmodel, K, hidden)
    state, chunk_fn = jax_chunked(
        jmodel, optax.adamw(lr, weight_decay=1e-5), lambda m, b, k: m.forward_kld(b, key=k),
        x_all.numpy(), batch, chunk, shuffle=False, update_lipschitz_iters=50)
    key = jax.random.key(seed + 3)
    losses = []
    t0 = time.time()
    for _ in range(iters // chunk):
        key, sub = jax.random.split(key)
        state, metrics = chunk_fn(state, sub)
        losses.append(np.asarray(metrics["loss"]))
    seconds = time.time() - t0
    losses = np.concatenate(losses)
    return {"seed": seed, "held_out_log_q": jax_eval(state.model, x_held_out.numpy()),
            "train_log_q": jax_eval(state.model, x_all[:residual_twomoons.HELD_OUT].numpy()),
            "final_kld": float(losses[-1]),
            "non_finite_steps": int((~np.isfinite(losses)).sum()),
            "losses_every_100": losses[::100].tolist(), "seconds": seconds,
            "iters": iters, "k": K, "batch": batch, "chunk": chunk, "side": "jax-cpu"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-2")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chunk", type=int, default=100)
    args = ap.parse_args()
    lo, _, hi = args.seeds.partition("-")
    for seed in range(int(lo), int(hi or lo) + 1):
        print(json.dumps(replay(seed, args.iters, args.k, args.batch, args.lr, args.chunk)),
              flush=True)


if __name__ == "__main__":
    main()
