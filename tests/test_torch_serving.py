"""Serving export of the port (``normflows_tpu_torch.serving``) on the CPU,
against the live port model and the JAX package, from the same weights
(``load_jax_leaves``) and numpy inputs:

* the flagship cut as in tests/test_torch_flow_model.py (3 layers, hidden
  64, 10 bins), the coupled NSF cut as in tests/test_torch_coupling.py (2
  layers, hidden 32), a K = 4 Real NVP, and the D = 12 large-D stack of
  tests/test_torch_made_fused.py for ``log_prob`` with the fused MADE off
  (symbolic batch) and on (concrete batch of 256);
* each loaded bundle bit-equal to its live model: the sampler from a seed
  against ``model.sample`` from the same seed, and ``log_prob`` at
  batches 1, 7 and 300 through one symbolic program;
* ``log_prob`` against JAX's, and the sampler on given noise against JAX's
  ``forward_and_log_det(z)`` and ``q0.log_prob(z)`` of the z the noise
  maps to, at tests/test_torch_flow_model.py's bars (5e-5 on values, 5e-4
  on log-densities; the models' own files' bars elsewhere);
* the manifest, what export refuses, and the graphs: each kernel an opaque
  operator node, its plain version not traced in;
* ``torch.library.opcheck`` of every kernel operator at small shapes;
* a model saved or exported after a chunk of the chunked trainer holds no
  optimizer state (the parameters are views of a flat buffer then).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu_torch import NormalizingFlow, serving, training
from normflows_tpu_torch.core.facades import compact_copy
from normflows_tpu_torch.interop import load_jax_leaves
from normflows_tpu_torch.ops import backend, made_fused, spline_cuda, spline_flat
from tests import test_torch_coupling as coupled
from tests import test_torch_flow_model as flagship
from tests import test_torch_made_fused as large_d
from tests.helpers import assert_close
from tests.test_torch_realnvp import real_nvp_pair

torch.set_num_threads(2)

V_TOL, LD_TOL = flagship.V_TOL, flagship.LD_TOL
N_SAMPLES = 256
BATCHES = (1, 7, 300)


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


MODELS = {
    "flagship": lambda: (lambda jm: (jm, load_jax_leaves(flagship.torch_model(),
                                                         leaves_of(jm))))(
        flagship.jax_model()),
    "coupled": lambda: (lambda jm: (jm, load_jax_leaves(coupled.torch_model(),
                                                        leaves_of(jm))))(
        coupled.jax_model()),
    "real_nvp": real_nvp_pair,
}
# bars against JAX: the flagship's file's, the coupled file's (its flat
# kernels' 1e-4 on a model), Real NVP at the flagship's
JAX_TOL = {"flagship": (V_TOL, LD_TOL), "coupled": (coupled.TOL, coupled.TOL),
           "real_nvp": (V_TOL, LD_TOL)}


@pytest.fixture(scope="module", params=list(MODELS))
def served(request, tmp_path_factory):
    """(name, JAX model, port model, loaded bundle, manifest)."""
    jm, tm = MODELS[request.param]()
    path = tmp_path_factory.mktemp(request.param)
    manifest = serving.save_bundle(tm, str(path), N_SAMPLES, (2,))
    return request.param, jm, tm, serving.load_bundle(str(path)), manifest


def data(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=n) * 1.5, rng.uniform(-3.0, 3.0, n)],
                    axis=1).astype(np.float32)


def test_bundle_sampler_is_bit_equal_to_the_live_model(served):
    _, _, tm, bundle, _ = served
    for seed in (0, 11):
        x, log_q = bundle.sample(seed)
        with torch.no_grad():
            xl, lql = tm.sample(N_SAMPLES, generator=torch.Generator().manual_seed(seed))
        assert x.shape == (N_SAMPLES, 2) and torch.equal(x, xl) and torch.equal(log_q, lql)
        assert torch.equal(bundle.noise(seed), bundle.noise(seed))


@pytest.mark.parametrize("batch", BATCHES)
def test_one_symbolic_log_prob_serves_every_batch_bit_equal(served, batch):
    _, _, tm, bundle, _ = served
    x = torch.from_numpy(data(batch, batch))
    with torch.no_grad():
        want = tm.log_prob(x)
    got = bundle.log_prob(x)
    assert got.shape == (batch,) and torch.equal(got, want)


def test_bundle_log_prob_matches_jax(served):
    name, jm, _, bundle, _ = served
    x = data(3, 300)
    assert_close(bundle.log_prob(torch.from_numpy(x)).numpy(),
                 np.asarray(jm.log_prob(jnp.asarray(x))), atol=JAX_TOL[name][1],
                 rtol=JAX_TOL[name][1])


def test_sampler_on_given_noise_matches_jax(served):
    """The exported program on the base noise against JAX: x =
    forward_and_log_det(z), log_q = q0.log_prob(z) - log_det, z the base
    sample the noise maps to."""
    name, jm, tm, bundle, _ = served
    eps = bundle.noise(5)
    program = bundle._sample
    with torch.no_grad():
        x, log_q = program(eps)
        z, _ = tm.q0.from_noise(eps)
    zj = jnp.asarray(z.numpy())
    xj, ldj = jm.forward_and_log_det(zj)
    v_tol, ld_tol = JAX_TOL[name]
    assert_close(x.numpy(), np.asarray(xj), atol=v_tol, rtol=v_tol)
    assert_close(log_q.numpy(), np.asarray(jm.q0.log_prob(zj) - ldj), atol=ld_tol,
                 rtol=ld_tol)


def test_manifest(served, tmp_path):
    name, _, _, bundle, manifest = served
    ops = {"flagship": ["normflows_tpu_torch::rqs_transposed"],
           "coupled": ["normflows_tpu_torch::rqs_flat"], "real_nvp": []}[name]
    spec = ["normal", "uniform"] if name == "flagship" else ["normal", "normal"]
    assert manifest["num_samples"] == N_SAMPLES and manifest["event_shape"] == [2]
    assert manifest["symbolic_batch"] is True and manifest["batch_size"] is None
    assert manifest["class_cond"] is False and manifest["device"] == "cpu"
    assert manifest["noise_spec"] == spec and manifest["torch"] == torch.__version__
    assert manifest["kernel_ops"] == {"sample": ops, "log_prob": ops}
    assert set(manifest["export_seconds"]) == {"sample", "log_prob"}
    assert bundle.manifest == json.loads(json.dumps(manifest))


def op_nodes(program):
    return [n.target.name() for n in program.graph.nodes
            if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
            and n.target.namespace == backend.NAMESPACE]


def aten_names(program):
    return {str(n.target) for n in program.graph.nodes if n.op == "call_function"}


# each model's operator nodes: (sampler, log_prob)
NODES = {"flagship": (["normflows_tpu_torch::rqs_transposed"] * 6,
                      ["normflows_tpu_torch::rqs_transposed"] * 3),
         "coupled": (["normflows_tpu_torch::rqs_flat"] * 4,
                     ["normflows_tpu_torch::rqs_flat"] * 4),
         "real_nvp": ([], [])}


def test_graphs_hold_each_kernel_as_an_opaque_operator(served):
    """The flagship's sampler holds 6 planar nodes (the D = 2 recursion's two
    passes a layer, 3 layers) and its log_prob 3; the coupled model 4 flat
    nodes in each (a coupling and a CDF a layer, 2 layers); Real NVP none.
    The plain splines (their bin search and softmax) are not traced in."""
    name, _, _, bundle, _ = served
    for program, want in zip((bundle._sample, bundle._log_prob), NODES[name]):
        assert op_nodes(program) == want
        assert not any(("searchsorted" in a or "softmax" in a or "cumsum" in a)
                       for a in aten_names(program))


@pytest.fixture(scope="module")
def large_d_pair():
    jm = large_d.jax_model()
    return jm, load_jax_leaves(large_d.torch_model(), leaves_of(jm))


@pytest.mark.parametrize("fusion", [False, True], ids=["fusion_off", "fusion_on"])
def test_large_d_log_prob_bundle(fusion, large_d_pair, tmp_path):
    """The D = 12 stack (hidden 128, 2 AR layers) by its log_prob alone:
    with the fused MADE off through a symbolic batch (2 flat nodes), on
    through a concrete batch of 256 (2 flat and 2 fused nodes; a symbolic
    batch takes the unfused pass); bit-equal to the live model, and within
    tests/test_torch_made_fused.py's bar of JAX's log_prob."""
    jm, tm = large_d_pair
    x = (np.random.default_rng(10).normal(size=(256, large_d.D)) * 1.5).astype(np.float32)
    before = backend.made_fusion_enabled()
    backend.set_made_fusion(fusion)
    try:
        kw = dict(symbolic_batch=False, batch_size=256) if fusion else {}
        manifest = serving.save_bundle(tm, str(tmp_path), None, (large_d.D,), **kw)
        bundle = serving.load_bundle(str(tmp_path))
        with torch.no_grad():
            want = tm.log_prob(torch.from_numpy(x))
    finally:
        backend.set_made_fusion(before)
    got = bundle.log_prob(torch.from_numpy(x))
    assert torch.equal(got, want)
    assert_close(got.numpy(), np.asarray(jm.log_prob(jnp.asarray(x))), atol=large_d.MODEL_TOL,
                 rtol=large_d.MODEL_TOL)
    want_ops = ["normflows_tpu_torch::rqs_flat"] + (
        ["normflows_tpu_torch::fused_resmade"] if fusion else [])
    assert manifest["kernel_ops"] == {"log_prob": sorted(want_ops)}
    assert manifest["num_samples"] is None and not os.path.exists(tmp_path / "sample.pt2")
    assert sorted(op_nodes(bundle._log_prob)) == sorted(
        ["normflows_tpu_torch::rqs_flat"] * 2
        + ["normflows_tpu_torch::fused_resmade"] * (2 if fusion else 0))
    if not fusion:
        for batch in BATCHES:
            xb = torch.from_numpy(data(batch, batch).repeat(6, axis=1))
            with torch.no_grad():
                assert torch.equal(bundle.log_prob(xb), tm.log_prob(xb))
    with pytest.raises(ValueError, match="holds no sampler"):
        bundle.sample(0)


def test_what_export_refuses(tmp_path, monkeypatch):
    """``class_cond=True`` asks for a class-conditional model (a
    class-conditional ``MultiscaleFlow`` or a ``ClassCondFlow``, whose
    bundles tests/test_torch_multiscale.py serves)."""
    _, tm = MODELS["real_nvp"]()
    with pytest.raises(ValueError, match="class-conditional model"):
        serving.export_sampler(tm, 8, class_cond=True)
    with pytest.raises(ValueError, match="class-conditional model"):
        serving.export_log_prob(tm, (2,), class_cond=True)
    with pytest.raises(ValueError, match="batch_size only applies"):
        serving.export_log_prob(tm, (2,), batch_size=16)
    # a concrete batch is exported at that batch
    program = serving.export_log_prob(tm, (2,), symbolic_batch=False, batch_size=16)
    assert program.module()(torch.zeros(16, 2)).shape == (16,)
    bundle = serving.ServingBundle(None, program, {"device": "cpu"})
    with pytest.raises(ValueError, match="unconditional"):
        bundle.log_prob(torch.zeros(16, 2), y=torch.zeros(16))
    # a bundle exported on a card does not load in a process without one
    serving.save_bundle(tm, str(tmp_path), 8, (2,))
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    (tmp_path / "manifest.json").write_text(json.dumps({**manifest, "device": "cuda:0"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serving.load_bundle(str(tmp_path))


# ---- the operators --------------------------------------------------------

def _planar_args(rng, F=2, B=33, K=4):
    x = torch.from_numpy(rng.uniform(-4, 4, (F, B)).astype(np.float32))
    p = torch.from_numpy((0.5 * rng.normal(size=(F * (3 * K + 1), B))).astype(np.float32))
    return x, p, [1, 2], [5.0, 3.1]


def _flat_args(rng, N=40, K=4):
    x = torch.from_numpy(rng.uniform(-4, 4, N).astype(np.float32))
    slab = torch.from_numpy((0.5 * rng.normal(size=(3 * K + 1, N))).astype(np.float32))
    return (x, slab[:K].clone(), slab[K:2 * K].clone(), slab[2 * K:].clone(),
            torch.ones(N, dtype=torch.int32), torch.full((N,), 3.0))


def _made_args(rng, B=8, F=3, H=16, R=1, P=6):
    shapes = ((B, F), (H, F), (H,), (R, H, H), (R, H), (R, H, H), (R, H), (P, H), (P,))
    return [torch.from_numpy((0.3 * rng.normal(size=s)).astype(np.float32)) for s in shapes]


def _cotangent(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


OPS = {
    "rqs_transposed": lambda rng: (spline_cuda.OP, (
        *(t.requires_grad_() for t in _planar_args(rng)[:2]), [1, 2], [5.0, 3.1], True,
        1e-3, 1e-3, 1e-3)),
    "rqs_transposed_backward": lambda rng: (spline_cuda.BACKWARD_OP, (
        *_planar_args(rng)[:2], _cotangent(rng, (2, 33)), _cotangent(rng, (2, 33)),
        [1, 2], [5.0, 3.1], False, 1e-3, 1e-3, 1e-3)),
    "rqs_flat": lambda rng: (spline_flat.OP, (
        *(t.requires_grad_() for t in _flat_args(rng)[:4]), *_flat_args(rng)[4:], True,
        1e-3, 1e-3, 1e-3)),
    "rqs_flat_backward": lambda rng: (spline_flat.BACKWARD_OP, (
        *_flat_args(rng), _cotangent(rng, 40), _cotangent(rng, 40), False, 1e-3, 1e-3,
        1e-3)),
    "fused_resmade": lambda rng: (made_fused.OP, (
        *(t.requires_grad_() for t in _made_args(rng)), "tanh")),
    "fused_resmade_backward": lambda rng: (made_fused.BACKWARD_OP, (
        *_made_args(rng), _cotangent(rng, (8, 6)), "relu", None)),
}


@pytest.mark.parametrize("name", list(OPS))
def test_opcheck(name):
    """The operator's schema, fake implementation (for a symbolic batch
    too), autograd registration and its tracing by AOT autograd."""
    op, args = OPS[name](np.random.default_rng(0))
    torch.library.opcheck(op, args)


def test_flat_operator_lays_out_the_rows_it_is_given():
    """The flat kernels' operator takes its parameter rows as they lie when
    they fit the kernel (one row stride >= N, unit stride along a row) and
    packs them otherwise: an exported program can hand it, at batch 1, the
    views a reshape gives where the traced batch gave copies."""
    K, N = 4, 64
    slab = torch.arange((3 * K + 1) * 2 * N, dtype=torch.float32).view(3 * K + 1, 2 * N)[:, :N]
    rows = spline_flat._rows(slab[:K], slab[K:2 * K], slab[2 * K:])
    assert rows[3] == 2 * N and rows[0].data_ptr() == slab.data_ptr()
    p = torch.arange(3 * (3 * K + 1), dtype=torch.float32).view(1, 3, 3 * K + 1)
    views = [p[..., a:b].movedim(-1, 0).reshape(b - a, -1)
             for a, b in ((0, K), (K, 2 * K), (2 * K, 3 * K + 1))]
    assert views[0].stride() == (1, 3 * K + 1)  # a view, not rows of one stride
    uw, uh, ud, stride = spline_flat._rows(*views)
    assert stride == 3 and uw.stride() == (3, 1) and ud.stride() == (3, 1)
    for got, want in zip((uw, uh, ud), views):
        assert torch.equal(got, want)


# ---- a model after a chunk ------------------------------------------------

def test_saved_and_exported_model_after_a_chunk_is_compact(tmp_path):
    """After a 2-step chunk each parameter is a view of a flat buffer that
    also holds Adam's moments: ``save`` writes a compact copy (within 5% of
    the fresh model's file), every loaded parameter owns its bytes,
    log_prob round trips bit for bit, and a bundle exported after the chunk
    is no larger than one exported before."""
    model = flagship.torch_model()
    fresh, fresh_bundle = tmp_path / "fresh.pt", tmp_path / "fresh_bundle"
    model.save(str(fresh))
    serving.save_bundle(model, str(fresh_bundle), 64, (2,))
    state, chunk = training.make_step_chunk(
        model, torch.optim.Adam(model.parameters(), lr=5e-4),
        lambda m, batch, gen: m.reverse_kld(128, generator=gen), chunk_len=2)
    chunk(state, torch.Generator().manual_seed(0))
    assert any(p.untyped_storage().nbytes() > p.numel() * 4 for p in model.parameters())
    after, after_bundle = tmp_path / "after.pt", tmp_path / "after_bundle"
    model.save(str(after))
    serving.save_bundle(model, str(after_bundle), 64, (2,))
    assert os.path.getsize(after) <= 1.05 * os.path.getsize(fresh)
    loaded = NormalizingFlow.load(str(after))
    for name, p in [*loaded.named_parameters(), *loaded.named_buffers()]:
        assert p.untyped_storage().nbytes() == p.numel() * p.element_size(), name
    x = torch.from_numpy(data(4, 100))
    with torch.no_grad():
        assert torch.equal(loaded.log_prob(x), model.log_prob(x))
    for entry in ("sample.pt2", "log_prob.pt2"):
        assert os.path.getsize(after_bundle / entry) <= os.path.getsize(fresh_bundle / entry)
    # the live model keeps its views
    assert any(p.untyped_storage().nbytes() > p.numel() * 4 for p in model.parameters())
    copy = compact_copy(model)
    assert all(torch.equal(a, b) for a, b in zip(copy.parameters(), model.parameters()))
