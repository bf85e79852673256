"""The small flows and the Rezende–Mohamed priors in the port (``flows.planar``,
``flows.radial``, ``flows.periodic``, ``distributions.prior``,
``utils.nn``'s ``ConstScaleLayer`` / ``PeriodicFeaturesCat`` / ``tile``, the
example ``planar_radial_comparison``) against the JAX package on the CPU,
from the same weights (``load_jax_leaves``) and numpy inputs:

* ``Planar`` (tanh and leaky ReLU; the tanh inverse raises), ``Radial``,
  ``PeriodicWrap`` and ``PeriodicShift``: values and log-dets;
* every prior's ``log_prob``; ``ImagePrior.sample`` on JAX's uniforms, round
  by round, against JAX's sampler;
* the three helpers;
* 20 reverse-KL Adam steps of a K = 2 planar model on ``TwoModes`` against
  the JAX package's steps on the same base draws (fed through
  ``distributions.base.draw_noise``);
* :func:`replay`, the comparison example's training through the JAX package
  on the port's initial weights, which sets the quality bar of the card's
  run: ``JAX_PLATFORMS=cpu python -m tests.test_torch_small_flows --seeds 0-2``.

Bars: 1e-5 on values and log-dets (atol and rtol), 1e-4 on losses.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.utils import nn as jnn
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.distributions import base as tbase
from normflows_tpu_torch.examples import planar_radial_comparison as example
from normflows_tpu_torch.interop import _torch_name
from normflows_tpu_torch.utils import nn as tnn
from tests.helpers import assert_close
from tests.test_torch_conditional import ported

torch.set_num_threads(2)

TOL, LOSS_TOL, B = 1e-5, 1e-4, 16


def normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def directions(jf, tf, z, inverse=True):
    pairs = [("forward", jf.forward, tf.forward)]
    if inverse:
        pairs.append(("inverse", jf.inverse, tf.inverse))
    for name, jfn, tfn in pairs:
        jz, jld = jax.jit(jfn)(jnp.asarray(z))
        tz, tld = tfn(t(z))
        assert_close(tz.detach().numpy(), np.asarray(jz), atol=TOL, rtol=TOL, msg=name)
        assert tld.shape == (z.shape[0],)
        assert_close(tld.detach().numpy(), np.asarray(jld), atol=TOL, rtol=TOL, msg=name)


@pytest.mark.parametrize("act", ["tanh", "leaky_relu"])
def test_planar_matches_jax(act):
    jf = jflows.Planar.create((2,), act=act, key=jax.random.key(1))
    jf = jf.replace(b=jnp.asarray([0.3]))
    tf = ported(jf, tflows.Planar((2,), act=act, device="cpu"))
    z = normal(2, B, 2, scale=2.0)
    directions(jf, tf, z, inverse=act == "leaky_relu")
    if act == "tanh":
        with pytest.raises(NotImplementedError, match="no algebraic inverse"):
            tf.inverse(t(z))
    with pytest.raises(NotImplementedError):
        tflows.Planar((2,), act="relu", device="cpu")


def test_planar_on_images_and_radial_match_jax():
    jp = jflows.Planar.create((3, 2, 2), act="leaky_relu", key=jax.random.key(3))
    tp = ported(jp, tflows.Planar((3, 2, 2), act="leaky_relu", device="cpu"))
    directions(jp, tp, normal(4, B, 3, 2, 2))
    for shape in ((2,), (3, 2)):
        jr = jflows.Radial.create(shape, key=jax.random.key(5))
        tr = ported(jr, tflows.Radial(shape, device="cpu"))
        directions(jr, tr, normal(6, B, *shape), inverse=False)


def test_periodic_flows_match_jax():
    z = normal(7, B, 3, scale=3.0)
    for jf, tf in ((jflows.PeriodicWrap.create([0, 2], bound=1.5),
                    tflows.PeriodicWrap([0, 2], bound=1.5, device="cpu")),
                   (jflows.PeriodicShift.create([1], bound=2.0, shift=0.7),
                    tflows.PeriodicShift([1], bound=2.0, shift=0.7, device="cpu"))):
        directions(jf, ported(jf, tf), z)


PRIORS = {
    "TwoModes": (jdist.TwoModes(loc=2.0, scale=0.2), tdist.TwoModes(2.0, 0.2)),
    "Sinusoidal": (jdist.Sinusoidal(scale=0.2, period=4.0), tdist.Sinusoidal(0.2, 4.0)),
    "Sinusoidal_gap": (jdist.Sinusoidal_gap(scale=0.35, period=4.0),
                       tdist.Sinusoidal_gap(0.35, 4.0)),
    "Sinusoidal_split": (jdist.Sinusoidal_split(scale=0.4, period=4.0),
                         tdist.Sinusoidal_split(0.4, 4.0)),
    "Smiley": (jdist.Smiley(scale=0.2), tdist.Smiley(0.2)),
}


def image(seed=8):
    img = np.random.default_rng(seed).uniform(size=(12, 9))
    img[:, :3] = 0.0  # a dark band: no draw may land there
    return img


def test_priors_log_prob_match_jax():
    z = normal(9, 64, 2, scale=2.0)
    for name, (jp, tp) in PRIORS.items():
        assert_close(tp.log_prob(t(z)).numpy(), np.asarray(jp.log_prob(jnp.asarray(z))),
                     atol=TOL, rtol=TOL, msg=name)
    jimg = jdist.ImagePrior.create(image(), x_range=(-2, 3), y_range=(-3, 1))
    timg = tdist.ImagePrior(image(), x_range=(-2, 3), y_range=(-3, 1), device="cpu")
    for name in ("image", "density", "scale", "shift"):
        assert np.array_equal(getattr(timg, name).numpy(), np.asarray(getattr(jimg, name)))
    assert np.array_equal(timg.log_prob(t(z)).numpy(), np.asarray(jimg.log_prob(jnp.asarray(z))))


def test_image_prior_sample_accepts_as_jax():
    """The port's rounds on JAX's uniforms (JAX's key schedule: key, k1, k2
    = split(key, 3) a round) fill the same buffer as JAX's sampler; every
    draw lies on a pixel brighter than 0."""
    n = 256
    jimg = jdist.ImagePrior.create(image())
    timg = tdist.ImagePrior(image(), device="cpu")
    key = jax.random.key(10)
    want = np.asarray(jax.jit(lambda k: jimg.sample(k, n))(key))
    buf, count = torch.zeros(n, 2), torch.zeros((), dtype=torch.int64)
    rounds = 0
    while int(count) < n:
        key, k1, k2 = jax.random.split(key, 3)
        z_ = t(jax.random.uniform(k1, (n, 2)))
        prob = t(jax.random.uniform(k2, (n,)))
        buf, count = timg.accept_round(buf, count, z_, prob)
        rounds += 1
    assert rounds > 1
    assert_close(buf.numpy(), want, atol=1e-6, rtol=1e-6)
    got = timg.sample(n, generator=torch.Generator().manual_seed(0))
    assert got.shape == (n, 2) and torch.isfinite(got).all()
    assert torch.all(timg.log_prob(got) > np.log(1e-9 / image().size))


def test_helpers_match_jax():
    x = normal(11, B, 4)
    assert np.array_equal(tnn.tile(t(x[0]), 3).numpy(), np.asarray(jnn.tile(jnp.asarray(x[0]), 3)))
    assert_close(tnn.ConstScaleLayer(2.5)(t(x)).numpy(),
                 np.asarray(jnn.ConstScaleLayer(scale=2.5)(jnp.asarray(x))), atol=0, rtol=0)
    jc = jnn.PeriodicFeaturesCat.create(4, [1, 3], scale=[2.0, 0.5])
    tc = tnn.PeriodicFeaturesCat(4, [1, 3], scale=[2.0, 0.5], device="cpu")
    assert_close(tc(t(x)).numpy(), np.asarray(jc(jnp.asarray(x))), atol=TOL, rtol=TOL)


# ---- training ----------------------------------------------------------------------

class JaxPriorTarget(jnf.Module):
    """The JAX script's ``PriorTarget``."""

    prior: jnf.Module

    def log_prob(self, z, context=None):
        return self.prior.log_prob(z)


def jax_model_of(tmodel, kind, K, prior):
    """The JAX comparison script's model (``examples/planar_radial_comparison.py``
    ``build``) holding the port model's tensors."""
    layers = [(jflows.Planar if kind == "planar" else jflows.Radial).create(
        (2,), key=jax.random.key(i)) for i in range(K)]
    jm = jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), layers,
                                    p=JaxPriorTarget(prior=prior))
    tensors = {**dict(tmodel.named_parameters()), **dict(tmodel.named_buffers())}
    paths, treedef = jax.tree_util.tree_flatten_with_path(jm)
    # copies: on the CPU jnp.asarray can alias a numpy view of a torch tensor,
    # and the port's optimizer then updates the JAX model's leaves in place,
    # racing a jitted step that JAX still runs asynchronously
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.array(tensors[_torch_name(jax.tree_util.keystr(p))].detach().cpu()),
                    leaf.dtype) for p, leaf in paths])


def test_jax_model_holds_copies_of_the_port_tensors():
    """The step comparison below updates the port's weights in place while
    JAX may still be running its jitted step on the JAX model: that model's
    leaves must not alias the port's tensors (on the CPU ``jnp.asarray`` of
    a tensor's numpy view can), or the JAX loss reads the updated weights on
    a busy machine."""
    tm = example.build_model("planar", "TwoModes", 2, 0, "cpu")
    jm = jax_model_of(tm, "planar", 2, jdist.TwoModes(loc=2.0, scale=0.2))
    before = [np.array(leaf) for leaf in jax.tree_util.tree_leaves(jm)]
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    after = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jm)]
    assert len(before) == len(after) > 0
    assert all(np.array_equal(a, b) for a, b in zip(before, after))


def test_reverse_kld_steps_match_jax(monkeypatch):
    """20 Adam(1e-3) steps of ``reverse_kld(512)`` on a K = 2 planar model
    and TwoModes, the port's base draws JAX's (``reverse_kld(key)`` draws
    them from the first half of its key): every loss, and the weights after."""
    tm = example.build_model("planar", "TwoModes", 2, 0, "cpu")
    jm = jax_model_of(tm, "planar", 2, jdist.TwoModes(loc=2.0, scale=0.2))
    opt = optax.adam(1e-3)
    diff, rest = jnf.partition(jm)
    ostate = opt.init(diff)

    @jax.jit
    def jstep(diff, ostate, key):
        loss, g = jax.value_and_grad(lambda d: jnf.combine(d, rest).reverse_kld(key, 512))(diff)
        updates, ostate = opt.update(g, ostate, diff)
        return optax.apply_updates(diff, updates), ostate, loss

    topt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    for i in range(20):
        key = jax.random.key(200 + i)
        eps = t(jax.random.normal(jax.random.split(key)[0], (512, 2)))
        monkeypatch.setattr(tbase, "draw_noise", lambda *a, eps=eps, **k: eps)
        diff, ostate, jloss = jstep(diff, ostate, key)
        topt.zero_grad()
        loss = tm.reverse_kld(512, generator=torch.Generator())
        loss.backward()
        topt.step()
        assert_close(float(loss), float(jloss), atol=LOSS_TOL, rtol=LOSS_TOL, msg=f"step {i}")
    want = ported(jnf.combine(diff, rest), example.build_model("planar", "TwoModes", 2, 0, "cpu"))
    for (name, p), q in zip(tm.named_parameters(), want.parameters()):
        assert_close(p.detach().numpy(), q.detach().numpy(), atol=LOSS_TOL, rtol=LOSS_TOL,
                     msg=name)


def test_example_runs_on_the_cpu():
    record = example.main(["--device", "cpu", "--iters", "20", "--chunk", "10", "--k", "2",
                           "--prior", "TwoModes", "Smiley", "--host-noise"])
    assert len(record["runs"]) == 6
    assert all(r["non_finite_steps"] == 0 and np.isfinite(r["eval_reverse_kld"])
               for r in record["runs"])


# ---- the example replayed through the JAX package ----------------------------
#
# The port's comparison example draws its initial weights on the host from a
# seed.  ``replay`` trains the JAX package's planar or radial model holding
# them as the JAX script trains it (Adam(1e-3), ``reverse_kld(key, 512)``,
# the script's key schedule from ``jax.random.key(seed)``), on the CPU, and
# reports the reverse KL estimate on 4,096 fresh draws.  One JSON line a
# seed and family:
#
#     JAX_PLATFORMS=cpu python -m tests.test_torch_small_flows [--seeds 0-2]
#         [--iters 500] [--k 16] [--prior TwoModes]


def replay(seed, kind, iters=500, K=16, prior="TwoModes"):
    tmodel = example.build_model(kind, prior, K, seed, "cpu")
    jprior = {"TwoModes": jdist.TwoModes(loc=2.0, scale=0.2), "Smiley": jdist.Smiley(scale=0.2),
              "Sinusoidal": jdist.Sinusoidal(scale=0.2, period=4.0)}[prior]
    jm = jax_model_of(tmodel, kind, K, jprior)
    opt = optax.adam(1e-3)
    diff, rest = jnf.partition(jm)
    ostate = opt.init(diff)

    @jax.jit
    def step(diff, ostate, key):
        loss, g = jax.value_and_grad(lambda d: jnf.combine(d, rest).reverse_kld(key, 512))(diff)
        updates, ostate = opt.update(g, ostate, diff)
        return optax.apply_updates(diff, updates), ostate, loss

    key = jax.random.key(seed)
    losses = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        diff, ostate, loss = step(diff, ostate, sub)
        losses.append(float(loss))
    kld = float(jax.jit(lambda d, k: jnf.combine(d, rest).reverse_kld(k, 4096))(
        diff, jax.random.key(seed + 1000)))
    return {"seed": seed, "kind": kind, "prior": prior, "first": losses[0], "last": losses[-1],
            "eval_reverse_kld": kld, "non_finite_steps": int(sum(not np.isfinite(v)
                                                                 for v in losses)),
            "iters": iters, "k": K, "side": "jax-cpu"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-2")
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--prior", default="TwoModes")
    args = ap.parse_args()
    lo, _, hi = args.seeds.partition("-")
    for seed in range(int(lo), int(hi or lo) + 1):
        for kind in ("planar", "radial"):
            print(json.dumps(replay(seed, kind, args.iters, args.k, args.prior)), flush=True)


if __name__ == "__main__":
    main()
