"""The port's MADE (normflows_tpu_torch/nets/made.py) against the JAX
package's: masks, degrees and input order bit-equal; ``__call__`` and
``apply_t`` equal at 1e-5 (float32 matmuls of the same weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu.nets.made import MADE as JMADE
from normflows_tpu.utils.nn import PeriodicFeaturesElementwise as JPeriodic
from normflows_tpu_torch.interop import load_jax_leaves
from normflows_tpu_torch.nets.made import MADE
from normflows_tpu_torch.utils import set_compute_dtype
from normflows_tpu_torch.utils.nn import PeriodicFeaturesElementwise
from tests.helpers import assert_close

torch.set_num_threads(2)

TOL = 1e-5


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def made_pair(features, hidden, num_blocks, permute_mask, rng_seed, periodic=False):
    mult = 31
    jpre = JPeriodic.create(features, [1], np.float32(np.pi / np.pi)) if periodic else None
    tpre = (PeriodicFeaturesElementwise(features, [1], np.float32(1.0), device="cpu")
            if periodic else None)
    jm = JMADE.create(jax.random.key(rng_seed), features, hidden, num_blocks=num_blocks,
                      output_multiplier=mult, permute_mask=permute_mask,
                      preprocessing=jpre, rng_seed=rng_seed)
    tm = MADE(features, hidden, num_blocks=num_blocks, output_multiplier=mult,
              permute_mask=permute_mask, preprocessing=tpre, rng_seed=rng_seed,
              device="cpu")
    return jm, tm


@pytest.mark.parametrize("features,num_blocks,permute_mask,rng_seed", [
    (2, 1, True, 3), (3, 2, True, 5), (5, 1, False, 0), (8, 2, True, 11),
])
def test_masks_degrees_and_order_are_bit_equal(features, num_blocks, permute_mask,
                                               rng_seed):
    jm, tm = made_pair(features, 32, num_blocks, permute_mask, rng_seed)
    pairs = [(jm.initial_layer, tm.initial_layer), (jm.final_layer, tm.final_layer)]
    for jb, tb in zip(jm.blocks, tm.blocks):
        pairs += [(jb.linear_0, tb.linear_0), (jb.linear_1, tb.linear_1)]
    for jl, tl in pairs:
        np.testing.assert_array_equal(tl.mask.numpy(), np.asarray(jl.mask).T)
        np.testing.assert_array_equal(tl.degrees.numpy(), np.asarray(jl.degrees))
    np.testing.assert_array_equal(tm.input_order.numpy(), np.asarray(jm.input_order))


@pytest.mark.parametrize("periodic", [False, True], ids=["plain", "periodic"])
def test_call_and_apply_t_match_jax(periodic):
    jm, tm = made_pair(2, 64, 1, True, 3, periodic=periodic)
    load_jax_leaves(tm, leaves_of(jm))
    x = np.random.default_rng(0).normal(size=(256, 2)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        got_t = tm.apply_t(torch.from_numpy(x.T.copy())).numpy()
    assert_close(got, want, atol=TOL, rtol=TOL)
    assert_close(got_t, np.asarray(jm.apply_t(jnp.asarray(x.T))), atol=TOL, rtol=TOL)
    assert_close(got_t.T, got, atol=TOL, rtol=TOL)


def test_bf16_compute_dtype_matches_jax():
    # bf16 operands round at each matmul (~3 significant digits), and the two
    # frameworks may round their f32 accumulators at other points: a bar of
    # 2e-2 absolute on outputs of size ~1.
    from normflows_tpu.utils import set_compute_dtype as jset

    jm, tm = made_pair(2, 64, 1, True, 3)
    load_jax_leaves(tm, leaves_of(jm))
    jm = jset(jm, "bfloat16")
    set_compute_dtype(tm, "bfloat16")
    assert tm.initial_layer.compute_dtype == torch.bfloat16
    x = np.random.default_rng(1).normal(size=(256, 2)).astype(np.float32)
    want = np.asarray(jm.apply_t(jnp.asarray(x.T)))
    with torch.no_grad():
        got = tm.apply_t(torch.from_numpy(x.T.copy()))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("kwargs", [
    {"context_features": 3}, {"dropout_probability": 0.1},
    {"use_residual_blocks": False},
], ids=["context", "dropout", "feedforward"])
def test_later_slice_features_raise(kwargs):
    """The MADEs that earlier slices refused (a context, dropout,
    feedforward blocks) now match the JAX package's: masks and degrees
    bit-equal (``load_jax_leaves`` holds them), ``__call__`` and ``apply_t``
    at 1e-5 (with the context, and its cache for ``apply_t``; dropout as the
    deterministic function of a call without randomness)."""
    jm = JMADE.create(jax.random.key(6), 4, 16, output_multiplier=3, rng_seed=6, **kwargs)
    tm = MADE(4, 16, output_multiplier=3, rng_seed=6, device="cpu", **kwargs)
    load_jax_leaves(tm, leaves_of(jm))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(33, 4)).astype(np.float32)
    c = rng.normal(size=(33, 3)).astype(np.float32) if "context_features" in kwargs else None
    jc = None if c is None else jnp.asarray(c)
    tc = None if c is None else torch.from_numpy(c)
    want = np.asarray(jm(jnp.asarray(x), jc))
    want_t = np.asarray(jm.apply_t(jnp.asarray(x.T), jm.context_cache_t(jc)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), tc).numpy()
        got_t = tm.apply_t(torch.from_numpy(x.T.copy()), tm.context_cache_t(tc)).numpy()
    assert_close(got, want, atol=TOL, rtol=TOL)
    assert_close(got_t, want_t, atol=TOL, rtol=TOL)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MADE(2, 16)
