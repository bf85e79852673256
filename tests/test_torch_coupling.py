"""The coupling NSF of the port against the JAX package, with the same weights
(``load_jax_leaves``) and the same numpy inputs:

* the masks (exact), ``ResidualNet`` with a periodic preprocessing (1e-5);
* ``PiecewiseRationalQuadraticCoupling`` and ``PiecewiseRationalQuadraticCDF``
  on mixed per-dim tails, both directions (1e-5 on values, 1e-4 on
  log-dets, the JAX package's flat-kernel bars, tests/test_pallas.py), and
  both wrappers, the circular one with a scalar and a per-dim ``tail_bound``;
* ``TwoMoons.log_prob`` and ``Target.sample`` replaying JAX's proposal draws
  round by round;
* the model of ``docs/getting_started.md`` (DiagGaussian(2), coupled RQ
  splines with reverse_mask alternating, TwoMoons) cut from 8 layers of
  hidden 64 to 2 of hidden 32 (2 blocks, 8 bins; both mask directions), with
  random transform nets and CDFs so that every spline does work:
  ``log_prob``, ``sample`` on JAX's base draw, ``forward_kld`` and
  ``reverse_kld`` with every gradient leaf (1e-4, f32), bf16, and three
  ``make_train_step`` steps with Adam(5e-4);
* what the port refuses: batch norm; 4-D inputs of an MLP-net coupling.

The JAX side runs its default CPU path (the jnp spline); the port runs the
plain flat spline, which the CUDA kernel is held against on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
import normflows_tpu_torch as tnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.flows.neural_spline import coupling as jcoupling
from normflows_tpu.nets.resnet import ResidualNet as JResidualNet
from normflows_tpu.training.loop import make_train_step as jax_make_train_step
from normflows_tpu.utils import masks as jmasks
from normflows_tpu.utils import set_compute_dtype as jax_set_compute_dtype
from normflows_tpu.utils.nn import PeriodicFeaturesElementwise as JPeriodic
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import training
from normflows_tpu_torch.flows.neural_spline import coupling as tcoupling
from normflows_tpu_torch.interop import load_jax_leaves
from normflows_tpu_torch.nets import ResidualNet
from normflows_tpu_torch.ops import spline_flat
from normflows_tpu_torch.utils import masks as tmasks
from normflows_tpu_torch.utils import set_compute_dtype
from normflows_tpu_torch.utils.nn import PeriodicFeaturesElementwise
from tests.helpers import assert_close
from tests.test_torch_large_d import NoiseBase, leaves_of
from tests.test_torch_training import jax_draw

torch.set_num_threads(2)

LAYERS, HIDDEN, BLOCKS, BINS, B = 2, 32, 2, 8, 256
Y_TOL, LD_TOL = 1e-5, 1e-4
TOL = 1e-4
LR = 5e-4
DIRECTIONS = pytest.mark.parametrize("direction", ["forward", "inverse"])


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy: JAX hands out read-only views


def perturbed(jmodel, seed, std=0.5):
    """The JAX module with noise of ``std`` added to every float leaf of its
    unconditional CDFs, which the JAX package creates at the identity."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        if "unconditional_transform" in jax.tree_util.keystr(path) and \
                jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf + std * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(f, jmodel)


@pytest.mark.parametrize("features", [1, 4, 5])
def test_masks_match_jax(features):
    for even in (True, False):
        assert np.array_equal(tmasks.create_alternating_binary_mask(features, even).numpy(),
                              np.asarray(jmasks.create_alternating_binary_mask(features, even)))
    mid = tmasks.create_mid_split_binary_mask(features)
    assert mid.dtype == torch.float32
    assert np.array_equal(mid.numpy(), np.asarray(jmasks.create_mid_split_binary_mask(features)))
    for mask in (tmasks.create_random_binary_mask(features, seed=3),
                 tmasks.create_random_binary_mask(
                     features, generator=torch.Generator().manual_seed(3))):
        want = np.asarray(jmasks.create_random_binary_mask(features, seed=3))
        assert mask.dtype == torch.float32 and mask.shape == want.shape
        assert set(mask.tolist()) <= {0.0, 1.0} and mask.sum() == want.sum()


def test_residual_net_matches_jax():
    jnet = JResidualNet.create(jax.random.key(0), 3, 7, HIDDEN, num_blocks=2,
                               preprocessing=JPeriodic.create(3, [1], 0.5))
    tnet = ResidualNet.create(None, 3, 7, HIDDEN, num_blocks=2,
                              preprocessing=PeriodicFeaturesElementwise(3, [1], 0.5,
                                                                        device="cpu"),
                              device="cpu")
    # zero_initialization: the blocks' second linear starts within +-1e-3
    assert float(tnet.blocks[0].linear_1.weight.detach().abs().max()) <= 1e-3
    load_jax_leaves(tnet, leaves_of(jnet))
    x = np.random.default_rng(0).normal(size=(B, 3)).astype(np.float32)
    with torch.no_grad():
        got = tnet(t(x))
    assert_close(got.numpy(), np.asarray(jnet(jnp.asarray(x))), atol=1e-5, rtol=1e-5)
    assert tnet.hidden_features == HIDDEN


MIXED_TAILS = (["linear", "circular", "linear", "circular", "linear"],
               [4.0, float(np.pi), 3.0, float(np.pi), 2.0])


def layer_inputs(seed, bounds, n=B):
    """~20% of the inputs outside +-bound on every dim."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.25, 1.25, (n, len(bounds))) * np.asarray(bounds)).astype(np.float32)


def coupling_pair(seed=1):
    """A 5-dim RQ coupling (mid-split mask, mixed tails, CDF on) in both
    frameworks, random nets and CDF, the same weights."""
    tails, bounds = MIXED_TAILS
    mask = np.asarray(jmasks.create_mid_split_binary_mask(5))
    j = jcoupling.PiecewiseRationalQuadraticCoupling.create(
        mask, lambda i, o: JResidualNet.create(jax.random.key(seed), i, o, HIDDEN),
        num_bins=BINS, tails=tails, tail_bound=bounds, apply_unconditional_transform=True)
    j = perturbed(j, seed)
    tm = tcoupling.PiecewiseRationalQuadraticCoupling.create(
        mask, lambda i, o: ResidualNet.create(None, i, o, HIDDEN, device="cpu"),
        num_bins=BINS, tails=tails, tail_bound=bounds, apply_unconditional_transform=True,
        device="cpu")
    return j, load_jax_leaves(tm, leaves_of(j))


@DIRECTIONS
def test_coupling_matches_jax(direction):
    j, tm = coupling_pair()
    assert tm.net_hidden == HIDDEN and tm.tr_tail_codes == (1, 2, 1)
    x = layer_inputs(2, MIXED_TAILS[1])
    yj, ldj = getattr(j, direction)(jnp.asarray(x))
    with torch.no_grad():
        yt, ldt = getattr(tm, direction)(t(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


@DIRECTIONS
def test_cdf_matches_jax(direction):
    tails, bounds = (["circular", "linear", "circular"], [float(np.pi), 2.0, 1.5])
    j = jcoupling.PiecewiseRationalQuadraticCDF.create(
        3, num_bins=6, tails=tails, tail_bound=bounds, identity_init=False,
        key=jax.random.key(4))
    tm = tcoupling.PiecewiseRationalQuadraticCDF.create(
        3, num_bins=6, tails=tails, tail_bound=bounds, identity_init=False, device="cpu")
    load_jax_leaves(tm, leaves_of(j))
    x = layer_inputs(3, bounds)
    yj, ldj = getattr(j, direction)(jnp.asarray(x))
    with torch.no_grad():
        yt, ldt = getattr(tm, direction)(t(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    # the identity init is the identity inside the bounds
    ident = tcoupling.PiecewiseRationalQuadraticCDF.create(3, num_bins=6, tails=tails,
                                                           tail_bound=bounds, device="cpu")
    x = np.clip(x, -0.999 * np.asarray(bounds, np.float32), 0.999 * np.asarray(bounds, np.float32))
    with torch.no_grad():
        y, ld = ident.forward(t(x))
    assert_close(y.numpy(), x, atol=1e-5, rtol=1e-5)
    assert_close(ld.numpy(), np.zeros(B), atol=1e-5, rtol=0)


WRAPPERS = {
    "coupled": (lambda key, rev: jflows.CoupledRationalQuadraticSpline.create(
                    key, 2, BLOCKS, HIDDEN, reverse_mask=rev, init_identity=False),
                lambda rev: tflows.CoupledRationalQuadraticSpline.create(
                    None, 2, BLOCKS, HIDDEN, reverse_mask=rev, init_identity=False,
                    device="cpu"), [3.0, 3.0]),
    "circular_scalar_bound": (
        lambda key, rev: jflows.CircularCoupledRationalQuadraticSpline.create(
            key, 3, BLOCKS, HIDDEN, ind_circ=[1], tail_bound=2.0, reverse_mask=rev,
            init_identity=False),
        lambda rev: tflows.CircularCoupledRationalQuadraticSpline.create(
            None, 3, BLOCKS, HIDDEN, ind_circ=[1], tail_bound=2.0, reverse_mask=rev,
            init_identity=False, device="cpu"), [2.0, 2.0, 2.0]),
    "circular_per_dim_bound": (
        lambda key, rev: jflows.CircularCoupledRationalQuadraticSpline.create(
            key, 2, BLOCKS, HIDDEN, ind_circ=[1], tail_bound=np.array([5.0, np.pi]),
            reverse_mask=rev, init_identity=False),
        lambda rev: tflows.CircularCoupledRationalQuadraticSpline.create(
            None, 2, BLOCKS, HIDDEN, ind_circ=[1], tail_bound=np.array([5.0, np.pi]),
            reverse_mask=rev, init_identity=False, device="cpu"), [5.0, np.pi]),
}


@DIRECTIONS
@pytest.mark.parametrize("reverse_mask", [False, True], ids=["mask", "reverse_mask"])
@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_wrapper_matches_jax(kind, reverse_mask, direction):
    make_jax, make_port, bounds = WRAPPERS[kind]
    j = perturbed(make_jax(jax.random.key(6), reverse_mask), 6)
    tm = load_jax_leaves(make_port(reverse_mask), leaves_of(j))
    x = layer_inputs(7, bounds)
    yj, ldj = getattr(j, direction)(jnp.asarray(x))
    with torch.no_grad():
        yt, ldt = getattr(tm, direction)(t(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    if kind.startswith("circular") and reverse_mask:  # the circular dim conditions
        assert isinstance(tm.prqct.transform_net.preprocessing, PeriodicFeaturesElementwise)


def test_two_moons_log_prob_matches_jax():
    z = (np.random.default_rng(8).normal(size=(B, 2)) * 2.0).astype(np.float32)
    got = tdist.TwoMoons(device="cpu").log_prob(t(z))
    assert_close(got.numpy(), np.asarray(jdist.TwoMoons().log_prob(jnp.asarray(z))),
                 atol=1e-5, rtol=1e-5)


def test_target_sample_replays_jax_draws():
    """Each round of the port's sampler on JAX's proposal uniforms accepts
    the same candidates into the same slots: the buffer is JAX's sample."""
    n, key = 200, jax.random.key(9)
    want = np.asarray(jdist.TwoMoons().sample(key, n))
    target = tdist.TwoMoons(device="cpu")
    buf, count, rounds = torch.zeros(n, 2), 0, 0
    while count < n:
        k1, k2, key = jax.random.split(key, 3)
        eps = np.asarray(jax.random.uniform(k1, (n, 2)))
        u = np.asarray(jax.random.uniform(k2, (n,)))
        buf, count = target.accept_round(buf, count, t(eps), t(u))
        rounds += 1
    assert rounds > 2 and count == n
    assert_close(buf.numpy(), want, atol=1e-6, rtol=1e-6)
    # its own draws: the shape, the proposal box, and most mass near the moons
    x = target.sample(n, generator=torch.Generator().manual_seed(0))
    assert x.shape == (n, 2) and x.dtype == torch.float32
    assert bool((x.abs() <= 3.0).all()) and float(target.log_prob(x).median()) > -2.0


def jax_model(seed=0):
    layers = [jflows.CoupledRationalQuadraticSpline.create(
        jax.random.key(seed + i), 2, BLOCKS, HIDDEN, reverse_mask=bool(i % 2),
        init_identity=False) for i in range(LAYERS)]
    model = jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), layers,
                                       p=jdist.TwoMoons())
    return perturbed(model, seed + 100, std=0.3)


def torch_model():
    layers = [tflows.CoupledRationalQuadraticSpline.create(
        None, 2, BLOCKS, HIDDEN, reverse_mask=bool(i % 2), init_identity=False, device="cpu")
        for i in range(LAYERS)]
    return tnf.NormalizingFlow.create(tdist.DiagGaussian.create(2, device="cpu"), layers,
                                      p=tdist.TwoMoons(device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def jm():
    return jax_model()


def port_of(jm, eps=np.zeros((B, 2), np.float32)):
    tm = load_jax_leaves(torch_model(), leaves_of(jm))
    tm.q0 = NoiseBase(tm.q0, eps)
    return tm


def moons(seed, n=B):
    return np.asarray(jdist.TwoMoons().sample(jax.random.key(seed), n))


def test_docs_model_log_prob_and_sample_match_jax(jm):
    key = jax.random.key(11)
    z, _ = jax_draw(jm, key, B)
    tm = port_of(jm, z)
    xj, log_qj = jm.sample(key, B)
    x = moons(12)
    with torch.no_grad():
        xt, log_qt = tm.sample(B)
        lpt = tm.log_prob(t(x))
    assert_close(xt.numpy(), np.asarray(xj), atol=TOL, rtol=TOL)
    assert_close(log_qt.numpy(), np.asarray(log_qj), atol=TOL, rtol=TOL)
    assert_close(lpt.numpy(), np.asarray(jm.log_prob(jnp.asarray(x))), atol=TOL, rtol=TOL)


def calls_per_pass(tm, x):
    """The flat spline entry's calls in one log_prob and one sample."""
    calls = []
    real = spline_flat.unconstrained_rational_quadratic_spline_flat

    def spy(*args, **kwargs):
        calls.append(bool(args[6]))
        return real(*args, **kwargs)

    spline_flat.unconstrained_rational_quadratic_spline_flat = spy
    try:
        with torch.no_grad():
            tm.log_prob(x)
            tm.sample(x.shape[0])
    finally:
        spline_flat.unconstrained_rational_quadratic_spline_flat = real
    return calls


def test_docs_model_takes_two_flat_calls_a_layer(jm):
    calls = calls_per_pass(port_of(jm), t(moons(13)))
    assert calls == [False] * 2 * LAYERS + [True] * 2 * LAYERS


def jax_value_and_grads(jm, loss):
    diff, rest = jnf.partition(jm)
    value, grads = jax.jit(jax.value_and_grad(lambda d: loss(jnf.combine(d, rest))))(diff)
    return float(value), dict(load_jax_leaves(torch_model(), leaves_of(
        jnf.combine(grads, rest))).named_parameters())


@pytest.mark.parametrize("what", ["forward_kld", "reverse_kld"])
def test_docs_model_loss_and_gradients_match_jax(jm, what):
    key = jax.random.key(14)
    x = moons(15)
    if what == "reverse_kld":
        tm = port_of(jm, jax_draw(jm, key, B)[0])
        vj, gj = jax_value_and_grads(jm, lambda m: m.reverse_kld(key, B))
        loss = tm.reverse_kld(B)
    else:
        tm = port_of(jm)
        vj, gj = jax_value_and_grads(jm, lambda m: m.forward_kld(jnp.asarray(x)))
        loss = tm.forward_kld(t(x))
    loss.backward()
    assert_close(float(loss.detach()), vj, atol=TOL, rtol=TOL)
    gt = {n.replace("q0.base.", "q0."): p.grad for n, p in tm.named_parameters()}
    # LAYERS x (ResidualNet 2 + 2 x 2 x 2 + 2, CDF 3) + base 2
    assert gt.keys() == gj.keys() and len(gt) == LAYERS * 15 + 2
    for name, g in gt.items():
        want = gj[name].detach()
        if g is None:  # the base in forward_kld
            assert what == "forward_kld" and name.startswith("q0.") and not want.any()
            continue
        assert torch.isfinite(g).all(), name
        assert_close(g.numpy(), want.numpy(), atol=TOL, rtol=TOL, msg=name)


def test_docs_model_bf16_loss_and_gradients_match_jax(jm):
    """bf16 transform-net matmuls on both sides.  The two frameworks round
    at other points, and a parameter's bf16 rounding flips where its float32
    input differs in the last bit; through random nets and splines that
    moves a gradient leaf about as far as bf16 itself moves it from float32.
    Bars: the loss within 1e-3; each leaf within 5% of its norm plus 1.5
    times JAX's own bf16-to-float32 distance (0.2 to 1.1 times that
    distance measured, or within the 5%)."""
    x = jnp.asarray(moons(16))
    vj, gj = jax_value_and_grads(jax_set_compute_dtype(jm, "bfloat16"),
                                 lambda m: m.forward_kld(x))
    _, gf = jax_value_and_grads(jm, lambda m: m.forward_kld(x))
    tm = set_compute_dtype(port_of(jm), "bfloat16")
    loss = tm.forward_kld(t(np.asarray(x)))
    loss.backward()
    assert_close(float(loss.detach()), vj, atol=1e-3, rtol=0)
    for name, p in tm.named_parameters():
        name = name.replace("q0.base.", "q0.")
        want = gj[name].detach()
        assert torch.isfinite(p.grad).all(), name
        bar = 5e-2 * float(want.norm()) + 1.5 * float((want - gf[name].detach()).norm()) + 1e-6
        assert float((p.grad - want).norm()) <= bar, name


def test_three_train_steps_match_jax(jm):
    """The docs' loop: make_train_step with Adam(5e-4) on forward_kld,
    batches alternating between the two halves of one target sample."""
    data = moons(17, 2 * B)
    batches = [data[i % 2 * B:i % 2 * B + B] for i in range(3)]
    state, step_fn = jax_make_train_step(jm, optax.adam(LR),
                                         lambda m, batch, key: m.forward_kld(batch))
    jax_losses = []
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, jnp.asarray(batch), jax.random.key(i))
        jax_losses.append(float(metrics["loss"]))
    tm = port_of(jm)
    tstate, tstep = training.make_train_step(
        tm, torch.optim.Adam(tm.parameters(), lr=LR),
        lambda m, batch, generator: m.forward_kld(batch))
    losses = [float(tstep(tstate, t(batch))[1]["loss"]) for batch in batches]
    assert tstate.step == 3
    assert_close(np.array(losses), np.array(jax_losses), atol=TOL, rtol=TOL)
    after = dict(load_jax_leaves(torch_model(), leaves_of(state.model)).named_parameters())
    for name, p in tm.named_parameters():
        assert_close(p.detach().numpy(), after[name.replace("q0.base.", "q0.")].detach().numpy(),
                     atol=1e-5, rtol=1e-5, msg=name)


def test_what_the_port_refuses():
    """Batch norm stays refused.  A context, dropout and constrained tails
    (``tails=None``), refused before, are built and run: the context widens
    the net's input and gates its blocks, dropout acts only with a
    generator, and the constrained spline keeps [0, 1].  Image (4-D)
    inputs, refused before, run on a convolutional net (tests in
    test_torch_image_nsf.py): a CDF on (2, 4, 4) events runs, and a 4-D
    input to a coupled layer built for vectors (its CDF and its
    ``ResidualNet``) fails."""
    net = ResidualNet(2, 4, 8, context_features=3, device="cpu")
    assert net.initial_layer.weight.shape == (8, 5)
    assert all(b.context_layer is not None for b in net.blocks)
    assert net(torch.zeros(3, 2), torch.ones(3, 3)).shape == (3, 4)
    drop = ResidualNet(2, 4, 8, dropout_probability=0.1, device="cpu")
    x = torch.randn(3, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(drop(x), drop(x))
    with pytest.raises(NotImplementedError, match="batch_norm"):
        ResidualNet(2, 4, 8, use_batch_norm=True, device="cpu")
    cond = tflows.CoupledRationalQuadraticSpline.create(None, 2, 1, 8, num_context_channels=3,
                                                        device="cpu")
    y, ld = cond.forward(torch.zeros(3, 2), torch.ones(3, 3))
    assert y.shape == (3, 2) and ld.shape == (3,)
    constrained = tflows.CoupledRationalQuadraticSpline.create(None, 2, 1, 8, tails=None,
                                                               device="cpu")
    assert constrained.prqct.constrained
    with torch.no_grad():
        y, _ = constrained.forward(torch.full((3, 2), 0.5))
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0
    cdf = tcoupling.PiecewiseRationalQuadraticCDF.create((2, 4, 4), tails="linear",
                                                         device="cpu")
    with torch.no_grad():
        y, ld = cdf.forward(torch.zeros(3, 2, 4, 4))
    assert y.shape == (3, 2, 4, 4) and ld.shape == (3,)
    layer = tflows.CoupledRationalQuadraticSpline.create(None, 2, 1, 8, device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        layer.forward(torch.zeros(3, 2, 4, 4))
    # a context given to a net built without one: its input is one wider than
    # the layer takes, as in the JAX package
    with pytest.raises(RuntimeError):
        layer.prqct.transform_net(torch.zeros(3, 1), torch.zeros(3, 2))
