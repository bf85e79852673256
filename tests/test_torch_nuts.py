"""The port's NUTS (``normflows_tpu_torch.sampling.nuts``) against the JAX
package's on the CPU, on JAX's own draws:

* ``ckpt_slot_range`` / ``trailing_ones`` against brute force and the
  never-clobbered check (the JAX package's tests/test_nuts.py:22-69), on
  host ints;
* ``NUTS.transition`` against ``jax.jit(nuts.transition)`` on 16 chains
  over several transitions, for a correlated Gaussian (lanes stop at
  different depths) and a narrow Gaussian at step 50 (every lane diverges
  and stays put): depth, leapfrog count and divergence exact, z and
  ``accept_prob`` within TOL;
* a short ``sample`` (8 chains, 6 warm-up transitions with the mass
  adaptation, 4 steps) against JAX's: step size, inverse mass, draws;
* a generator against the noise drawn from it; the recorded multinomial
  picks against the draws they choose; moments on a correlated Gaussian;
  NeuTra-NUTS on the pullback of an ``AffineConstFlow``.

JAX's draws are re-derived from its keys by repeating its splits
(``nuts.py:186, :202, :124``): the momentum normals, the direction and
subtree-accept uniforms a doubling, the take uniform a leaf.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.sampling import NUTS as JNUTS
from normflows_tpu.sampling import PullbackTarget as JPullback
import normflows_tpu_torch as nft
from normflows_tpu_torch.sampling import NUTS, PullbackTarget
from normflows_tpu_torch.sampling.nuts import ckpt_slot_range, trailing_ones

torch.set_num_threads(2)

# float32 on two sides: the leapfrog's products and the target's gradient
# round alike but not always bit for bit (XLA may contract a multiply-add)
TOL = 2e-5

LOC = np.array([1.0, -2.0], np.float32)
COV = np.array([[1.0, 0.8], [0.8, 2.0]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


class JCorrelated:
    def log_prob(self, z):
        d = z - LOC
        return -0.5 * jnp.einsum("bi,ij,bj->b", d, PREC, d)


class TCorrelated(torch.nn.Module):
    def log_prob(self, z):
        d = z - torch.from_numpy(LOC)
        return -0.5 * torch.einsum("bi,ij,bj->b", d, torch.from_numpy(PREC), d)


class JNarrow:
    def log_prob(self, z):
        return -0.5 * jnp.sum((z * 100.0) ** 2, -1)


class TNarrow(torch.nn.Module):
    def log_prob(self, z):
        return -0.5 * torch.sum((z * 100.0) ** 2, -1)


@functools.lru_cache(maxsize=None)
def _jax_draws(chains, dim, max_depth):
    """A jitted function of a transition's key: JAX's draws."""

    def leaf(ks, _):
        ks, k_take = jax.random.split(ks)
        return ks, jax.random.uniform(k_take, (), jnp.float32)

    def doubling(key, _):
        key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
        _, takes = jax.lax.scan(leaf, k_sub, None, length=2 ** (max_depth - 1))
        return key, (jax.random.uniform(k_dir, (), jnp.float32),
                     jax.random.uniform(k_acc, (), jnp.float32), takes)

    def one(k):
        k_mom, key = jax.random.split(k)
        p = jax.random.normal(k_mom, (dim,), jnp.float32)
        _, (dirs, accs, takes) = jax.lax.scan(doubling, key, None, length=max_depth)
        return p, dirs, accs, takes

    return jax.jit(lambda key: jax.vmap(one)(jax.random.split(key, chains)))


def jax_noise(key, chains, dim, max_depth):
    """JAX's draws for ``transition(key, z)`` in the port's layout."""
    p, dirs, accs, takes = _jax_draws(chains, dim, max_depth)(key)
    return (np.array(p), np.array(dirs).T, np.array(accs).T,
            np.array(takes).transpose(1, 2, 0))


def t(a):
    return torch.from_numpy(np.array(a))


def test_slot_range_matches_bruteforce():
    for i in range(1, 256):
        starts = [i - 2**k + 1 for k in range(1, 20) if (i + 1) % 2**k == 0]
        assert trailing_ones(i) == len(starts)
        lo, hi = ckpt_slot_range(i)
        if i % 2 == 0:
            assert hi < lo
            continue
        assert hi - lo + 1 == len(starts)
        assert sorted(bin(s).count("1") for s in starts) == list(range(lo, hi + 1))


def test_checkpoint_slots_never_clobbered_while_live():
    max_leaves = 256
    for j in range(0, max_leaves, 2):
        slot = bin(j).count("1")
        ks, k = [], 1
        while (j % 2**k == 0 or j == 0) and 2**k <= max_leaves:
            if j % 2**k == 0:
                ks.append(k)
            k += 1
        if not ks:
            continue
        for j2 in range(j + 2, j + 2 ** max(ks), 2):
            assert bin(j2).count("1") != slot, (j, j2, slot)


def run_transitions(jtarget, ttarget, step, max_depth, z0, key, steps):
    dim = z0.shape[1]
    jn = JNUTS.create(jtarget, dim, step_size=step, max_depth=max_depth)
    tn = NUTS.create(ttarget, dim, step_size=step, max_depth=max_depth, device="cpu")
    jstep = jax.jit(jn.transition)
    zj, zt = jnp.asarray(z0), t(z0)
    out = []
    for k in jax.random.split(key, steps):
        zj, sj = jstep(k, zj)
        zt, st = tn.transition(zt, noise=jax_noise(k, z0.shape[0], dim, max_depth))
        out.append((np.asarray(zj), {n: np.asarray(v) for n, v in sj.items()}, zt.numpy(),
                    {n: v.numpy() for n, v in st.items()}))
    return out


@pytest.mark.parametrize("case", ["correlated", "narrow"])
def test_transition_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "correlated":
        z0 = (LOC + rng.normal(size=(16, 2))).astype(np.float32)
        out = run_transitions(JCorrelated(), TCorrelated(), 0.3, 5, z0, jax.random.key(11), 4)
    else:
        z0 = np.full((16, 2), 0.01, np.float32)
        out = run_transitions(JNarrow(), TNarrow(), 50.0, 5, z0, jax.random.key(4), 2)
    depths = set()
    for zj, sj, zt, st in out:
        for name in ("depth", "num_leapfrog", "diverging"):
            np.testing.assert_array_equal(st[name], sj[name], err_msg=name)
        np.testing.assert_allclose(zt, zj, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(st["accept_prob"], sj["accept_prob"], atol=TOL, rtol=TOL)
        depths |= set(st["depth"].tolist())
    if case == "correlated":
        assert len(depths) > 1  # lanes stop at different depths
    else:
        assert all(st["diverging"].all() for _, _, _, st in out)
        np.testing.assert_allclose(out[-1][2], z0, atol=1e-6, rtol=0)


def test_short_sample_matches_jax():
    chains, steps, adapt, max_depth = 8, 4, 6, 5
    key = jax.random.key(21)
    jn = JNUTS.create(JCorrelated(), 2, step_size=0.5, max_depth=max_depth)
    zs_j, info_j = jax.jit(lambda k: jn.sample(k, chains, steps, num_adapt=adapt))(key)
    k_init, k_a, k_b, k_run = jax.random.split(key, 4)
    z_init = np.array(jax.random.normal(k_init, (chains, 2)))
    keys = [*jax.random.split(k_a, adapt // 2), *jax.random.split(k_b, adapt - adapt // 2),
            *jax.random.split(k_run, steps)]
    noises = [jax_noise(k, chains, 2, max_depth) for k in keys]
    tn = NUTS.create(TCorrelated(), 2, step_size=0.5, max_depth=max_depth, device="cpu")
    zs_t, info_t = tn.sample(chains, steps, num_adapt=adapt, noise=(z_init, noises))
    np.testing.assert_allclose(float(info_t["step_size"]), float(info_j["step_size"]),
                               rtol=1e-4)
    np.testing.assert_allclose(info_t["inv_mass"].numpy(), np.asarray(info_j["inv_mass"]),
                               rtol=1e-4)
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(info_t["accept_prob"].numpy(), np.asarray(info_j["accept_prob"]),
                               atol=1e-4, rtol=1e-4)
    assert float(info_t["mean_depth"]) == float(info_j["mean_depth"])
    assert float(info_t["divergence_rate"]) == float(info_j["divergence_rate"])


def test_generator_is_noise_drawn_from_it():
    tn = NUTS.create(TCorrelated(), 2, step_size=0.4, max_depth=5, device="cpu")
    z = t(np.random.default_rng(1).normal(size=(8, 2)).astype(np.float32))
    a, sa = tn.transition(z, generator=torch.Generator().manual_seed(3))
    noise = tn.draw_noise(8, 2, generator=torch.Generator().manual_seed(3))
    b, sb = tn.transition(z, noise=noise)
    assert torch.equal(a, b) and torch.equal(sa["depth"], sb["depth"])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    zs1, _ = tn.sample(4, 3, num_adapt=4, generator=g1)
    z_init = torch.randn(4, 2, generator=g2)
    zs2, _ = tn.sample(4, 3, num_adapt=4, noise=(z_init, [tn.draw_noise(4, 2, generator=g2)
                                                          for _ in range(7)]))
    assert torch.equal(zs1, zs2)


def test_picks_fix_the_draw():
    """``picks[d]``, the leaf of doubling d's subtree whose draw replaced the
    proposal, lies in [0, 2^d) and only below the tree's depth; a chain
    whose picks are all -1 stays put, and one whose last pick is the
    first leaf of a rightward subtree of depth 0 moves one leapfrog step."""
    rng = np.random.default_rng(2)
    z0 = t((LOC + rng.normal(size=(64, 2))).astype(np.float32))
    # a long step: some chains reject every subtree, some take one leaf
    tn = NUTS.create(TCorrelated(), 2, step_size=1.5, max_depth=5, device="cpu")
    noise = tn.draw_noise(64, 2, generator=torch.Generator().manual_seed(7))
    z, st = tn.transition(z0, noise=noise)
    picks, depth = st["picks"], st["depth"]
    levels = torch.arange(5)[:, None]
    assert picks.shape == (5, 64)
    assert bool(((picks == -1) | ((picks >= 0) & (picks < 2**levels))).all())
    assert bool((picks[levels.expand(-1, 64) >= depth[None]] == -1).all())
    stay = (picks == -1).all(0)
    assert bool(stay.any()) and bool((~stay).any())
    assert torch.equal(z[stay], z0[stay])
    assert bool((z[~stay] != z0[~stay]).any(-1).all())
    # one leapfrog step from z0 (unit mass): the draw of chains whose only
    # pick is doubling 0's, taken rightward
    p0 = noise[0]
    with torch.enable_grad():
        z_ = z0.clone().requires_grad_(True)
        (g0,) = torch.autograd.grad(TCorrelated().log_prob(z_).sum(), z_)
    p_half = p0 + 0.5 * 1.5 * g0
    one = (picks[0] == 0) & (picks[1:] == -1).all(0) & (noise[1][0] < 0.5)
    assert bool(one.any())
    np.testing.assert_allclose(z[one].numpy(), (z0 + 1.5 * p_half)[one].numpy(), atol=1e-6)


def test_correlated_gaussian_moments():
    """32 chains, 300 steps after 80 of warm-up: the mean within 0.15 (+
    10%) and the covariance within 0.35 (+ 20%), the JAX package's bars."""
    tn = NUTS.create(TCorrelated(), 2, step_size=0.2, max_depth=6, device="cpu")
    zs, info = tn.sample(32, 300, num_adapt=80, generator=torch.Generator().manual_seed(0))
    xs = zs.reshape(-1, 2).numpy()
    assert float(info["divergence_rate"]) < 0.02
    np.testing.assert_allclose(xs.mean(0), LOC, atol=0.15, rtol=0.1)
    np.testing.assert_allclose(np.cov(xs.T), COV, atol=0.35, rtol=0.2)


def test_neutra_nuts_on_pullback():
    """The JAX package's tests/test_nuts.py:149-171 on the port, its draws
    from a generator: the pullback of the matched target is N(0, I)."""
    shift = nft.flows.AffineConstFlow((2,), device="cpu")
    with torch.no_grad():
        shift.t.copy_(torch.tensor([[3.0, -1.0]]))
    target = nft.distributions.DiagGaussian(2, device="cpu")
    with torch.no_grad():
        target.loc.copy_(torch.tensor([[3.0, -1.0]]))
    model = nft.NormalizingFlow.create(nft.distributions.DiagGaussian(2, device="cpu"), [shift],
                                       p=target, device="cpu")
    nuts = NUTS.create(PullbackTarget(model), 2, step_size=0.5, max_depth=6, device="cpu")
    us, _ = nuts.sample(16, 200, num_adapt=50, generator=torch.Generator().manual_seed(5))
    u = us.reshape(-1, 2).numpy()
    np.testing.assert_allclose(u.mean(0), np.zeros(2), atol=0.15, rtol=0)
    np.testing.assert_allclose(u.std(0), np.ones(2), atol=0.15, rtol=0)
    # the same pullback in JAX: equal log-densities on the same latents
    jmodel = jnf.NormalizingFlow.create(
        jdist.DiagGaussian.create(2),
        [jflows.AffineConstFlow.create((2,)).replace(t=jnp.array([[3.0, -1.0]]))],
        p=jdist.DiagGaussian.create(2).replace(loc=jnp.array([[3.0, -1.0]])))
    lp_j = JPullback(flow_model=jmodel).log_prob(jnp.asarray(u[:64]))
    lp_t = PullbackTarget(model).log_prob(t(u[:64]))
    np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(lp_j), atol=1e-5, rtol=1e-5)
