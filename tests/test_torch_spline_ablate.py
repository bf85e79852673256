"""The plain versions of the spline-backward ablation
(normflows_tpu_torch/ops/spline_ablate.py) against the JAX package's own
kernel, ``variant_kernel`` of ``examples/spline_bwd_ablate.py``, run through
``pl.pallas_call(..., interpret=True)`` on ``spline_pallas._specs``:

* n = 2^9 samples x 2 features = 1,024 elements (8 rows of 128, sub 8),
  K = 10 as in the script;
* two cases: ``run_variant``'s inputs (every tail circular at pi, unit
  cotangents) and a mixed-tail one (linear at 5 and circular at pi per
  element, random cotangents), both directions.  The script's kernel reads
  its direction from its module-level ``cfg``, set here for each call;
  ``sel_post`` pulls back the inverse map whatever ``cfg`` says, so its
  forward direction is held against ``_selection`` and ``jax.vjp`` of
  ``_post_math(inverse=False)`` composed here;
* bars: ``sel_only`` 1e-5, the rest 1e-3 (atol = rtol), the JAX package's
  flat-backward bar (tests/test_pallas.py).

The port's script runs in-process with ``--tiny --device cpu``.  The CUDA
kernel is held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from normflows_tpu.ops import spline_pallas as sp
from normflows_tpu_torch.examples import spline_bwd_ablate as port_script
from normflows_tpu_torch.ops import spline_ablate, spline_flat
from tests.helpers import assert_close

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
import spline_bwd_ablate as jax_script  # noqa: E402

torch.set_num_threads(2)

K = jax_script.K
ROWS, SUB = 8, 8
N = ROWS * sp.LANE  # 2^9 x 2
TOLS = {"sel_only": 1e-5, "sel_post": 1e-3, "full": 1e-3, "vjp_all": 1e-3}
DIRECTIONS = pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])


def inputs(case, seed=0):
    """x, uw, uh (K, N), ud (K+1, N), codes, bounds, ybar, lbar as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N).astype(np.float32)
    uw, uh = (0.1 * rng.normal(size=(2, K, N))).astype(np.float32)
    ud = (0.1 * rng.normal(size=(K + 1, N))).astype(np.float32)
    if case == "run_variant":
        codes = np.full(N, 2, np.int32)
        bounds = np.full(N, np.pi, np.float32)
        ybar = lbar = np.ones(N, np.float32)
    else:
        codes = rng.choice([1, 2], size=N).astype(np.int32)
        bounds = np.where(codes == 1, 5.0, np.pi).astype(np.float32)
        ybar, lbar = rng.normal(size=(2, N)).astype(np.float32)
    return x, uw, uh, ud, codes, bounds, ybar, lbar


@functools.lru_cache(maxsize=None)
def jax_variant(mode, inverse):
    """The script's kernel in interpret mode, traced with its ``cfg`` set to
    ``inverse``, on the flat layout: (N,) and (S, N) in, the same out."""
    espec, pspec = sp._specs(K, SUB)
    call = pl.pallas_call(
        jax_script.variant_kernel(mode), grid=(ROWS // SUB,),
        in_specs=[espec, pspec(K), pspec(K), pspec(K + 1), espec, espec, espec, espec],
        out_specs=(espec, pspec(K), pspec(K), pspec(K + 1)),
        out_shape=(jax.ShapeDtypeStruct((ROWS, sp.LANE), jnp.float32),
                   jax.ShapeDtypeStruct((K, ROWS, sp.LANE), jnp.float32),
                   jax.ShapeDtypeStruct((K, ROWS, sp.LANE), jnp.float32),
                   jax.ShapeDtypeStruct((K + 1, ROWS, sp.LANE), jnp.float32)),
        interpret=True)

    def run(x, uw, uh, ud, codes, bounds, ybar, lbar):
        r2 = lambda a: a.reshape(ROWS, sp.LANE)  # noqa: E731
        r3 = lambda a: a.reshape(a.shape[0], ROWS, sp.LANE)  # noqa: E731
        outs = call(r2(x), r3(uw), r3(uh), r3(ud), r2(codes), r2(bounds), r2(ybar), r2(lbar))
        return outs[0].reshape(-1), *(o.reshape(o.shape[0], -1) for o in outs[1:])

    saved = jax_script.cfg["inverse"]
    jax_script.cfg["inverse"] = inverse
    try:
        return jax.jit(run).lower(*(jax.ShapeDtypeStruct(a.shape, a.dtype)
                                    for a in inputs("mixed"))).compile()
    finally:
        jax_script.cfg["inverse"] = saved


def jax_sel_post_forward(x, uw, uh, ud, codes, bounds, ybar, lbar):
    """``sel_post`` in the forward direction, composed from the JAX
    package's ``_selection`` and ``_post_math(inverse=False)``."""
    cfg = dict(jax_script.cfg, inverse=False)
    xs, _, _, _, sel, hits, _ = sp._selection(x, uw, uh, ud, codes, bounds, collect=True,
                                              **cfg)
    _, vjp_fn = jax.vjp(lambda *a: sp._post_math(*a, inverse=False), xs, *sel)
    acc = sum(vjp_fn((ybar, lbar)))
    for h in hits:
        acc = acc + h.astype(x.dtype)
    return acc, uw, uh, ud


def jax_outputs(mode, inverse, args):
    if mode == "sel_post" and not inverse:
        return [np.asarray(a) for a in jax.jit(jax_sel_post_forward)(*args)]
    return [np.asarray(a) for a in jax_variant(mode, inverse)(*args)]


@pytest.mark.parametrize("case", ["run_variant", "mixed"])
@DIRECTIONS
@pytest.mark.parametrize("mode", spline_ablate.VARIANTS)
def test_plain_variant_matches_jax_kernel(mode, inverse, case):
    args = inputs(case, seed=1 if case == "mixed" else 0)
    if case == "mixed":  # linear tails at 5 hold every x: no clamped input
        assert np.abs(args[0]).max() < 5.0 and (args[4] == 1).any() and (args[4] == 2).any()
    want = jax_outputs(mode, inverse, [jnp.asarray(a) for a in args])
    before = dict(spline_ablate.LAUNCHES)
    got = spline_ablate.run_variant(mode, *map(torch.from_numpy, args), inverse=inverse)
    assert spline_ablate.LAUNCHES == before  # a CPU tensor takes the plain version
    tol = TOLS[mode]
    for g, w, name in zip(got, want, ("xg", "uwg", "uhg", "udg")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert torch.isfinite(g).all(), name
        assert_close(g.numpy(), w, atol=tol, rtol=tol, msg=f"{mode} {name}")


@DIRECTIONS
def test_full_and_vjp_all_share_the_spline_gradient(inverse):
    """full and vjp_all compute one function: the gradient of the plain
    spline, which is their plain version; sel_only's xg holds the one hit."""
    args = [torch.from_numpy(a) for a in inputs("mixed", seed=2)]
    full = spline_ablate.run_variant("full", *args, inverse=inverse)
    vjp_all = spline_ablate.run_variant("vjp_all", *args, inverse=inverse)
    want = spline_flat.unconstrained_rqs_dyncodes_backward_reference(*args, inverse)
    for a, b, c in zip(full, vjp_all, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    xs, sel, hits, stats = spline_ablate.selection(*args[:6], inverse)
    assert torch.equal(sum(h.int() for h in hits), torch.ones(N, dtype=torch.int32))
    xg = spline_ablate.run_variant("sel_only", *args, inverse=inverse)[0]
    assert torch.equal(xg, xs + sum(sel) + sum(stats) + 1.0)


def test_run_variant_checks_its_inputs():
    args = [torch.from_numpy(a) for a in inputs("mixed")]
    with pytest.raises(ValueError, match="mode"):
        spline_ablate.run_variant("scatter", *args, inverse=True)
    with pytest.raises(ValueError, match="ybar"):
        spline_ablate.run_variant("full", *args[:6], args[6][:-1], args[7], inverse=True)
    with pytest.raises(ValueError, match="do not fit"):
        spline_ablate.run_variant("full", args[0], args[1][:, :-1], *args[2:], inverse=True)


def test_port_script_runs_on_the_cpu(capsys):
    records = port_script.main(["--tiny", "--device", "cpu"])
    assert [r["mode"] for r in records] == list(spline_ablate.VARIANTS)
    for r in records:
        assert r["n"] == N and r["ms"] is None and r["device"] == "cpu"
        assert r["bound_ms"] > 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 4
    # the bound counts 272 B an element (264 without the cotangents) and is
    # set by the bytes at run_variant's 32,768 elements: 8.9 MB, 2.7 us
    ms, by, moved = port_script.bound("full", 2**15)
    assert moved == 272 * 2**15 and by == "bytes" and abs(ms - 2.66e-3) < 1e-5
    assert port_script.bound("sel_only", 2**15)[2] == 264 * 2**15
