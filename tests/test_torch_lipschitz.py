"""Lipschitz nets in the port (``nets.lipschitz``, ``utils.optim``) against the
JAX package on the CPU, from the same weights and power-iteration buffers
(``load_jax_leaves``) and numpy inputs:

* the dual-norm normalisers at p = 1, 2, infinity and 3, on one vector and
  on a stack of them (the grouped form's last axis);
* fixed-``n`` power iteration and iteration to a tolerance, for
  ``InducedNormLinear`` at each pair of orders and ``InducedNormConv2d``;
* both layers' forward and the gradients through ``_scaled_weight``;
* ``LipschitzMLP`` and ``LipschitzCNN``;
* ``update_lipschitz`` on a whole net after the weights moved: the grouped
  linear layers against JAX, the convolutions against their own power
  iteration;
* the contraction bound; ``set_requires_grad`` / ``clear_grad``;
  ``leaky_elu`` / ``asym_squash``.

Bars: 1e-5 on values (atol and rtol), 1e-4 on gradients and on the power
iteration's vectors after 50 steps (float32 sums in other orders, repeated).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu.nets import lipschitz as jl
from normflows_tpu.utils import update_lipschitz as jax_update_lipschitz
from normflows_tpu_torch.nets import lipschitz as tl
from normflows_tpu_torch.utils import clear_grad, set_requires_grad, update_lipschitz
from tests.helpers import assert_close
from tests.test_torch_conditional import leaves_of, ported

torch.set_num_threads(2)

TOL, G_TOL = 1e-5, 1e-4


def normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_net_of(tnet):
    """The JAX package's module holding the port module's tensors, built
    directly (its ``create`` would run 50 power-iteration steps eagerly,
    seconds of compiling a layer): ``Swish``, ``InducedNormLinear``,
    ``InducedNormConv2d``, ``LipschitzMLP``, ``LipschitzCNN``."""
    def a(x):
        # a copy: jnp.asarray may alias a numpy view of the port's tensor
        return None if x is None else jnp.asarray(np.array(x.detach().cpu()))

    if isinstance(tnet, tl.Swish):
        return jl.Swish(beta=a(tnet.beta))
    if isinstance(tnet, (tl.LipschitzMLP, tl.LipschitzCNN)):
        cls = jl.LipschitzMLP if isinstance(tnet, tl.LipschitzMLP) else jl.LipschitzCNN
        return cls(layers=tuple(jax_net_of(m) for m in tnet.layers))
    common = dict(weight=a(tnet.weight), bias=a(tnet.bias), u=a(tnet.u), v=a(tnet.v),
                  scale=a(tnet.scale), coeff=tnet.coeff, n_iterations=tnet.n_iterations,
                  atol=tnet.atol, rtol=tnet.rtol, domain=tnet.domain, codomain=tnet.codomain)
    if isinstance(tnet, tl.InducedNormLinear):
        return jl.InducedNormLinear(**common)
    return jl.InducedNormConv2d(**common, in_shape=tnet.in_shape, out_shape=tnet.out_shape,
                                padding=tnet.padding)


def gen(seed):
    return torch.Generator().manual_seed(seed)


ORDERS = [1.0, 2.0, math.inf, 3.0]


@pytest.mark.parametrize("p", ORDERS, ids=["1", "2", "inf", "3"])
def test_normalisers_match_jax(p):
    x = normal(1, 4, 7)
    x[0, 2] = 0.0  # a zero entry takes the sign 1
    for name in ("_normalize_u", "_normalize_v"):
        if name == "_normalize_v" and p == math.inf:
            continue  # the input side takes p < inf (1 is its projmax)
        jfn, tfn = getattr(jl, name), getattr(tl, name)
        rows = tfn(t(x), p)
        for i in range(x.shape[0]):
            want = np.asarray(jfn(jnp.asarray(x[i]), p))
            assert_close(tfn(t(x[i]), p).numpy(), want, atol=TOL, rtol=TOL, msg=name)
            assert_close(rows[i].numpy(), want, atol=TOL, rtol=TOL, msg=name)


PAIRS = [(2, 2), (1, 1), (2, math.inf), (3, 3)]


def linear_pair(seed=4, domain=2, codomain=2, zero_init=False, n_iterations=5, tol=None):
    tlin = tl.InducedNormLinear(6, 5, coeff=0.9, domain=domain, codomain=codomain,
                                zero_init=zero_init, n_iterations=n_iterations, atol=tol,
                                rtol=tol, generator=gen(seed), device="cpu")
    return jax_net_of(tlin), tlin


def buffers_close(tmod, jmod, tol=G_TOL):
    for name in ("u", "v", "scale"):
        assert_close(getattr(tmod, name).numpy(), np.asarray(getattr(jmod, name)), atol=tol,
                     rtol=tol, msg=name)


@pytest.mark.parametrize("orders", PAIRS, ids=["2-2", "1-1", "2-inf", "3-3"])
def test_linear_power_iteration_forward_and_gradient_match_jax(orders):
    """After moving the weight: 7 power-iteration steps, the forward and the
    gradient of sum(y w) w.r.t. the weight and bias (through sigma)."""
    jlin, tlin = linear_pair(domain=orders[0], codomain=orders[1])
    wnew = np.asarray(jlin.weight) * 3.0
    jlin = jlin.replace(weight=jnp.asarray(wnew)).update_power_iteration(7)
    with torch.no_grad():
        tlin.weight.copy_(t(wnew))
    tlin.update_power_iteration(7)
    buffers_close(tlin, jlin)
    x, w = normal(5, 8, 6), normal(6, 8, 5)
    assert_close(tlin(t(x)).detach().numpy(), np.asarray(jlin(jnp.asarray(x))), atol=TOL,
                 rtol=TOL)
    gj = jax.grad(lambda m: jnp.sum(m(jnp.asarray(x)) * w))(jlin)
    (tlin(t(x)) * t(w)).sum().backward()
    assert_close(tlin.weight.grad.numpy(), np.asarray(gj.weight), atol=G_TOL, rtol=G_TOL)
    assert_close(tlin.bias.grad.numpy(), np.asarray(gj.bias), atol=G_TOL, rtol=G_TOL)


def test_power_iteration_to_a_tolerance_matches_jax():
    jlin, tlin = linear_pair(n_iterations=None, tol=1e-3)
    wnew = np.asarray(jlin.weight) + normal(7, 5, 6)
    jlin = jlin.replace(weight=jnp.asarray(wnew)).update_power_iteration()
    with torch.no_grad():
        tlin.weight.copy_(t(wnew))
    tlin.update_power_iteration()
    buffers_close(tlin, jlin)
    with pytest.raises(ValueError, match="n_iterations"):
        tl.power_iterate(tlin.u, tlin.v, lambda v: v, lambda u: u, None)


def conv_pair(seed=8, orders=(2, 2), k=3):
    tc = tl.InducedNormConv2d(2, 3, k, (5, 4), coeff=0.9, domain=orders[0],
                              codomain=orders[1], generator=gen(seed), device="cpu")
    return jax_net_of(tc), tc


def test_construction_matches_jax_create():
    """The port's constructors against JAX's ``create`` on the same initial
    draws: 50 power-iteration steps from the same u and v, and an
    ``interop`` round trip of the layers' tensors."""
    jlin = jl.InducedNormLinear.create(jax.random.key(4), 6, 5, coeff=0.9)
    tlin = ported(jlin, tl.InducedNormLinear(6, 5, coeff=0.9, device="cpu"))
    start = jlin.replace(u=jnp.asarray(normal(14, 5)), v=jnp.asarray(normal(15, 6)))
    want = start.update_power_iteration(50)
    with torch.no_grad():
        tlin.u.copy_(t(start.u))
        tlin.v.copy_(t(start.v))
    buffers_close(tlin.update_power_iteration(50), want)
    assert set(leaves_of(jax_net_of(tlin))) == set(leaves_of(jlin))


@pytest.mark.parametrize("orders", [(2, 2), (1, 1)], ids=["2-2", "1-1"])
def test_conv_power_iteration_forward_and_gradient_match_jax(orders):
    jc, tc = conv_pair(orders=orders)
    wnew = np.asarray(jc.weight) * 2.0
    jc = jc.replace(weight=jnp.asarray(wnew)).update_power_iteration(5)
    with torch.no_grad():
        tc.weight.copy_(t(wnew))
    tc.update_power_iteration(5)
    buffers_close(tc, jc)
    x, w = normal(9, 2, 2, 5, 4), normal(10, 2, 3, 5, 4)
    assert_close(tc(t(x)).detach().numpy(), np.asarray(jc(jnp.asarray(x))), atol=TOL, rtol=TOL)
    gj = jax.grad(lambda m: jnp.sum(m(jnp.asarray(x)) * w))(jc)
    (tc(t(x)) * t(w)).sum().backward()
    assert_close(tc.weight.grad.numpy(), np.asarray(gj.weight), atol=G_TOL, rtol=G_TOL)


def test_nets_and_update_lipschitz_match_jax():
    """``LipschitzMLP`` [3, 16, 16, 3]: the forward; then every weight moved
    and ``update_lipschitz(net, 50)`` (its three linear shapes, each a group)
    against JAX's layer-by-layer power iteration.  ``LipschitzCNN`` [2, 4, 2]
    with kernels 3-1: the forward against JAX's, and ``update_lipschitz``
    equal to each convolution's own ``update_power_iteration`` (held against
    JAX's in the convolution tests above)."""
    tm = tl.LipschitzMLP([3, 16, 16, 3], 0.9, init_zeros=False, generator=gen(16),
                         device="cpu")
    tc = tl.LipschitzCNN([2, 4, 2], [3, 1], (4, 4), 0.9, generator=gen(17), device="cpu")
    jm, jc = jax_net_of(tm), jax_net_of(tc)
    x, xi = normal(11, 8, 3), normal(12, 2, 2, 4, 4)
    for tnet, jnet, a in ((tm, jm, x), (tc, jc, xi)):
        assert_close(tnet(t(a)).detach().numpy(),
                     np.asarray(jax.jit(lambda m, a: m(a))(jnet, jnp.asarray(a))), atol=TOL,
                     rtol=TOL)
    moved = jax.tree_util.tree_map(lambda a: a * 1.7 if a.ndim >= 2 else a, jm)
    jm = jax.jit(lambda m: jax_update_lipschitz(m, 50))(moved)
    with torch.no_grad():
        for p in [*tm.parameters(), *tc.parameters()]:
            if p.dim() >= 2:
                p.mul_(1.7)
    assert update_lipschitz(tm, 50) is tm
    tensors = dict(tm.named_buffers())
    for path, value in leaves_of(jm).items():
        name = path.replace("[", ".").replace("]", "").lstrip(".")
        if name in tensors:
            assert_close(tensors[name].numpy(), value, atol=G_TOL, rtol=G_TOL, msg=name)
    alone = copy.deepcopy(tc)
    for m in alone.modules():
        if isinstance(m, tl.InducedNormConv2d):
            m.update_power_iteration(50)
    update_lipschitz(tc, 50)
    for (name, a), b in zip(tc.named_buffers(), alone.buffers()):
        assert torch.equal(a, b), name


def test_contraction_bound_holds():
    """After ``update_lipschitz``, each scaled weight's spectral norm is at
    most the coefficient and the net is a contraction on random pairs."""
    net = tl.LipschitzMLP([2, 32, 32, 2], 0.9, init_zeros=False,
                          generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, tl.InducedNormLinear):
                m.weight.mul_(10.0)
    update_lipschitz(net, 100)
    for m in net.modules():
        if isinstance(m, tl.InducedNormLinear):
            assert float(torch.linalg.matrix_norm(m._scaled_weight().detach(), 2)) < 0.9 + 1e-4
    gen = torch.Generator().manual_seed(1)
    x, y = torch.randn(256, 2, generator=gen), torch.randn(256, 2, generator=gen)
    with torch.no_grad():
        ratio = torch.linalg.vector_norm(net(x) - net(y), dim=1) / \
            torch.linalg.vector_norm(x - y, dim=1)
    assert float(ratio.max()) < 1.0


def test_optim_helpers_and_squashes():
    net = tl.LipschitzMLP([2, 8, 2], device="cpu")
    assert set_requires_grad(net, False) is net
    assert not any(p.requires_grad for p in net.parameters())
    set_requires_grad(net, True)
    net(torch.ones(3, 2)).sum().backward()
    assert clear_grad(net) is net and all(p.grad is None for p in net.parameters())
    x = normal(13, 32)
    assert_close(tl.leaky_elu(t(x)).numpy(), np.asarray(jl.leaky_elu(jnp.asarray(x))),
                 atol=TOL, rtol=TOL)
    assert_close(tl.asym_squash(t(x)).numpy(), np.asarray(jl.asym_squash(jnp.asarray(x))),
                 atol=TOL, rtol=TOL)
    with pytest.raises(NotImplementedError, match="fixed float"):
        tl.InducedNormLinear(2, 2, domain=0.5, device="cpu")
