"""``ScanChain`` in the port (``normflows_tpu_torch.core.flow``) against the
JAX package's ``ScanChain`` on the CPU, carrying JAX's stacked leaves
(``load_jax_leaves``, a stacked (depth, in, out) weight transposed on its
last two axes), and against the same layers unrolled:

* planar layers (tests/test_flows_basic.py:242-257) and 3 circular AR
  spline layers at hidden 8 (mask seeds 0, 3, 4: two feature orders), forward and inverse, against JAX within TOL;
* against the same layers unrolled (``Composite``), bit for bit;
* ``remat=True`` values and gradients against ``remat=False``;
* ``layers()`` round-trips; a heterogeneous stack raises, naming what
  differs; a layer's host copy of a buffer (``MADE.input_order_host``)
  is kept for each layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu import flows as jflows
import normflows_tpu_torch as nft
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.interop import load_jax_leaves

torch.set_num_threads(2)

TOL = 2e-5  # the per-layer bars of the spline tests, here over 3-4 layers
TAIL_BOUND = np.array([5.0, np.pi], np.float32)


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def planar_pair():
    jl = [jflows.Planar.create((4,), act="leaky_relu", key=k)
          for k in jax.random.split(jax.random.key(0), 4)]
    tl = [tflows.Planar((4,), act="leaky_relu", device="cpu") for _ in range(4)]
    return jl, tl


def spline_pair():
    jl = [jflows.CircularAutoregressiveRationalQuadraticSpline.create(
        jax.random.key(i), 2, 1, 8, ind_circ=[1], num_bins=6,
        tail_bound=jnp.asarray(TAIL_BOUND), permute_mask=True, rng_seed=i,
        init_identity=False) for i in (0, 3, 4)]
    tl = [tflows.CircularAutoregressiveRationalQuadraticSpline.create(
        None, 2, 1, 8, ind_circ=[1], num_bins=6, tail_bound=TAIL_BOUND, permute_mask=True,
        rng_seed=i, init_identity=False, device="cpu") for i in (0, 3, 4)]
    return jl, tl


def inputs(kind, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "planar":
        return rng.normal(size=(64, 4)).astype(np.float32)
    return np.stack([rng.normal(size=64), rng.uniform(-np.pi, np.pi, 64)], 1).astype(np.float32)


@pytest.fixture(scope="module", params=["planar", "spline"])
def chains(request):
    jl, tl = (planar_pair if request.param == "planar" else spline_pair)()
    jchain = jflows.ScanChain.create(jl)
    tchain = nft.ScanChain.create(tl)
    load_jax_leaves(tchain, leaves_of(jchain))
    return request.param, jchain, tchain


def test_matches_jax_scan_chain(chains):
    kind, jchain, tchain = chains
    x = inputs(kind)
    for direction in ("forward", "inverse"):
        zj, ldj = getattr(jchain, direction)(jnp.asarray(x))
        with torch.no_grad():
            zt, ldt = getattr(tchain, direction)(torch.from_numpy(x))
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=10 * TOL, rtol=10 * TOL)


def test_matches_unrolled_bit_for_bit(chains):
    kind, _, tchain = chains
    unrolled = nft.Composite(tchain.layers())
    x = torch.from_numpy(inputs(kind))
    with torch.no_grad():
        for direction in ("forward", "inverse"):
            a = getattr(tchain, direction)(x)
            b = getattr(unrolled, direction)(x)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_remat_values_and_gradients(chains):
    kind, _, tchain = chains
    x = torch.from_numpy(inputs(kind))
    remat = nft.ScanChain(tchain.stacked, tchain.depth, True, tchain.host)
    out = {}
    for name, chain in (("plain", tchain), ("remat", remat)):
        chain.zero_grad()
        z, ld = chain.inverse(x)
        (z.square().sum() + ld.sum()).backward()
        out[name] = (z.detach(), ld.detach(),
                     {n: p.grad.clone() for n, p in chain.named_parameters()})
    assert torch.equal(out["plain"][0], out["remat"][0])
    assert torch.equal(out["plain"][1], out["remat"][1])
    for n, g in out["plain"][2].items():
        torch.testing.assert_close(out["remat"][2][n], g, atol=1e-6, rtol=1e-6)
    assert sum(float(g.abs().sum()) > 0 for g in out["plain"][2].values()) >= 2


def test_layers_round_trip(chains):
    kind, _, tchain = chains
    again = nft.ScanChain.create(tchain.layers())
    for (n, a), (m, b) in zip(tchain.state_dict().items(), again.state_dict().items()):
        assert n == m and torch.equal(a, b)
    assert again.host == tchain.host
    if kind == "spline":  # the permuted feature order differs between layers
        orders = {h[("mprqat.autoregressive_net", "input_order_host")] for h in tchain.host}
        assert len(orders) == 2


def test_heterogeneous_stack_raises():
    with pytest.raises(ValueError, match="homogeneous"):  # a shape differs
        nft.ScanChain.create([tflows.Planar((4,), device="cpu"), tflows.Planar((3,),
                                                                              device="cpu")])
    with pytest.raises(ValueError, match=r"\bact of layer 1"):  # a host setting differs
        nft.ScanChain.create([tflows.Planar((4,), act="tanh", device="cpu"),
                              tflows.Planar((4,), act="leaky_relu", device="cpu")])
    a, b = spline_pair()[1][:2]
    b.mprqat.tail_bound = (4.0, float(np.pi))
    with pytest.raises(ValueError, match=r"mprqat\.tail_bound of layer 1"):
        nft.ScanChain.create([a, b])


def test_exported_names():
    assert nft.ScanChain is nft.flows.ScanChain is nft.core.ScanChain
