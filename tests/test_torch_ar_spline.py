"""The port's autoregressive RQ-spline layers against the JAX package's, the
JAX side on its planar path (MADE.apply_t into ``rqs_transposed_pallas`` in
interpret mode).  Same weights (``load_jax_leaves``), same numpy inputs, with
``init_identity=False`` so the spline does real work.  Bars: the JAX
package's, atol = rtol = 2e-5 on outputs and 2e-4 on log-dets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu import flows as jflows
from normflows_tpu.ops import backend as jbackend
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.interop import load_jax_leaves
from tests.helpers import assert_close

torch.set_num_threads(2)

Y_TOL = 2e-5
LD_TOL = 2e-4
B = 1024


def with_jax_backend(mode, interpret, fn):
    jbackend.set_kernel_backend(mode)
    jbackend.set_pallas_interpret(interpret)
    try:
        return fn()
    finally:
        jbackend.set_kernel_backend("auto")
        jbackend.set_pallas_interpret(False)


def layer_pair(kind, features, seed=3):
    tb = np.array([5.0, np.pi, 3.0][:features], np.float32)
    common = dict(num_bins=10, init_identity=False, rng_seed=seed)
    if kind == "circular":
        j = jflows.CircularAutoregressiveRationalQuadraticSpline.create(
            jax.random.key(seed), features, 1, 64, ind_circ=[1],
            tail_bound=jnp.asarray(tb), permute_mask=True, **common)
        t = tflows.CircularAutoregressiveRationalQuadraticSpline.create(
            None, features, 1, 64, ind_circ=[1], tail_bound=tb, permute_mask=True,
            device="cpu", **common)
    else:
        j = jflows.AutoregressiveRationalQuadraticSpline.create(
            jax.random.key(seed), features, 2, 64, tail_bound=3.0, permute_mask=True,
            **common)
        t = tflows.AutoregressiveRationalQuadraticSpline.create(
            None, features, 2, 64, tail_bound=3.0, permute_mask=True, device="cpu",
            **common)
    leaves = {jax.tree_util.keystr(p): np.asarray(l)
              for p, l in jax.tree_util.tree_flatten_with_path(j)[0]}
    load_jax_leaves(t, leaves)
    return j, t


def inputs(features, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, features)) * 2.0  # some beyond the tail bound
    x[:, 1] = rng.uniform(-4.0, 4.0, B)  # the circular dim, wrapped past pi
    return x.astype(np.float32)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("kind,features", [
    ("circular", 2), ("linear", 2), ("circular", 3),
], ids=["circular-D2", "linear-D2", "mixed-D3"])
def test_layer_matches_jax_planar_path(kind, features, direction):
    j, t = layer_pair(kind, features)
    x = inputs(features)
    assert with_jax_backend(  # the JAX side takes its planar path
        "pallas", True, lambda: j.mprqat._transposed_ok(jnp.asarray(x), None))
    yj, ldj = with_jax_backend(
        "pallas", True, lambda: getattr(j, direction)(jnp.asarray(x)))
    with torch.no_grad():
        yt, ldt = getattr(t, direction)(torch.from_numpy(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


def test_round_trip():
    _, t = layer_pair("circular", 3)
    x = inputs(3)
    # inside (-pi, pi): the circular dim comes back wrapped into [-pi, pi]
    x[:, 1] = np.random.default_rng(2).uniform(-3.1, 3.1, B)
    with torch.no_grad():
        z, ld_f = t.inverse(torch.from_numpy(x))
        x2, ld_i = t.forward(z)
    assert_close(x2.numpy(), x, atol=1e-4, rtol=1e-4)
    assert_close((ld_f + ld_i).numpy(), np.zeros(B), atol=1e-3, rtol=0)


@pytest.mark.parametrize("kwargs,match", [
    ({"features": 9, "context_features": 2}, "conditional"),
    ({"tails": None}, "constrained"),
    ({"context_features": 2}, "conditional"),
    ({"dropout_probability": 0.1}, "dropout"),
], ids=["F>8", "constrained", "context", "dropout"])
def test_refused_features_name_the_later_slice(kwargs, match):
    """The features that earlier slices refused (a context above and below
    8 features, constrained tails, dropout) now match the JAX layer in both
    directions: with a context where the layer has one, on [0, 1] inputs for
    the constrained spline, and, with dropout, as the deterministic function
    that a call without randomness is in both packages."""
    args = dict(features=2, hidden_features=16, tails="linear", tail_bound=3.0,
                init_identity=False, num_bins=4)
    args.update(kwargs)
    j = jflows.MaskedPiecewiseRationalQuadraticAutoregressive.create(jax.random.key(4), **args)
    t = tflows.MaskedPiecewiseRationalQuadraticAutoregressive.create(None, device="cpu",
                                                                     **args)
    leaves = {jax.tree_util.keystr(p): np.asarray(l)
              for p, l in jax.tree_util.tree_flatten_with_path(j)[0]}
    load_jax_leaves(t, leaves)
    rng = np.random.default_rng(5)
    F = args["features"]
    x = (rng.uniform(0.05, 0.95, (64, F)) if match == "constrained"
         else rng.normal(size=(64, F)) * 2.0).astype(np.float32)
    c = rng.normal(size=(64, 2)).astype(np.float32) if match == "conditional" else None
    for direction in ("forward", "inverse"):
        yj, ldj = jax.jit(lambda m, x, c: getattr(m, direction)(x, c))(
            j, jnp.asarray(x), None if c is None else jnp.asarray(c))
        with torch.no_grad():
            yt, ldt = getattr(t, direction)(torch.from_numpy(x),
                                            None if c is None else torch.from_numpy(c))
        assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
        assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


def test_context_at_call_raises():
    """A context given to a layer built without one is taken and not used,
    as in the JAX package (its MADE has no context layer): the layer gives
    its context-free values."""
    j, t = layer_pair("linear", 2)
    x = inputs(2)
    c = np.random.default_rng(3).normal(size=(B, 2)).astype(np.float32)
    for direction in ("forward", "inverse"):
        with torch.no_grad():
            yt, ldt = getattr(t, direction)(torch.from_numpy(x), context=torch.from_numpy(c))
            y0, ld0 = getattr(t, direction)(torch.from_numpy(x))
        yj, ldj = jax.jit(lambda m, x, c: getattr(m, direction)(x, c))(
            j, jnp.asarray(x), jnp.asarray(c))
        assert torch.equal(yt, y0) and torch.equal(ldt, ld0)
        assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
        assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
