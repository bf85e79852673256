"""The port on the card: the CUDA spline kernels, planar and flat (forward and
backward), the fused MADE's kernels and the flat backward's ablation kernel,
against their plain PyTorch versions (and the register kernels against the
loops they replaced), a small model's serving path and
training step through the planar kernels, a D = 64 autoregressive model's
through the flat kernels and, with fusion on, the fused MADE, and a coupled
NSF's through the flat kernels; the chunked trainer, its step captured in a
CUDA graph and replayed, against eager steps, with no host sync inside a
chunk and its kernels read from the profiler in every replay; conditional
models through the planar kernels and the sliced inverse; an image NSF
through the flat kernels along ``event_axis = 1``, and a Glow's float32
convolutions held to IEEE float32 (not TF32).

Every test is marked ``gpu`` and skips where no CUDA card is present (decided
at run time, in the ``cuda`` fixture).  This file imports no JAX, so that it
runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX.)
"""

import math

import numpy as np
import pytest
import torch

import normflows_tpu_torch as nft
from normflows_tpu_torch.ops import (backend, cuda_build, made_fused, spline_ablate, spline_cuda,
                                     spline_flat)

Y_TOL = 2e-5  # the JAX package's bars (tests/test_pallas.py), atol = rtol
LD_TOL = 2e-4
G_TOL = 2e-3  # the JAX package's gradient bars (tests/test_pallas.py)
PARAM_STD = 0.5  # see tests/test_torch_splines.py
CODES, BOUNDS = (1, 2), (5.0, math.pi)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; none here")
    return torch.device("cuda")


def close(a, b, tol):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=tol, rtol=tol)


def planar_inputs(B, device, seed=0, K=10, std=PARAM_STD):
    rng = np.random.default_rng(seed)
    bounds = np.asarray(BOUNDS, np.float32)[:, None]
    x = (rng.uniform(-1.25, 1.25, (2, B)) * bounds).astype(np.float32)
    p = (std * rng.normal(size=(2 * (3 * K + 1), B))).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(p).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("B", [2**14, 2**14 + 37, 1])
def test_kernel_matches_plain(cuda, B, inverse):
    x, p = planar_inputs(B, cuda)
    before = spline_cuda.LAUNCHES
    y, ld = spline_cuda.rqs_transposed(x, p, CODES, BOUNDS, inverse)
    torch.cuda.synchronize()
    assert spline_cuda.LAUNCHES == before + 1
    yr, ldr = spline_cuda.rqs_transposed_reference(x, p, CODES, BOUNDS, inverse)
    close(y, yr, Y_TOL)
    close(ld, ldr, LD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("K", [2, 8, 16, 20])
def test_kernel_bins_match_plain(cuda, K, inverse):
    """The forward's other instantiations beside the flagship's K = 10: 8
    exactly, 2 and 16 (K <= 16, bins masked), 20 (the loops over a runtime
    K)."""
    x, p = planar_inputs(2**14 + 37, cuda, K=K)
    y, ld = spline_cuda.rqs_transposed(x, p, CODES, BOUNDS, inverse)
    yr, ldr = spline_cuda.rqs_transposed_reference(x, p, CODES, BOUNDS, inverse)
    close(y, yr, Y_TOL)
    close(ld, ldr, LD_TOL)


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    """The design-step variants of normflows_tpu_torch/examples/design_steps.py,
    written from the shipped sources."""
    from normflows_tpu_torch.examples import design_steps

    return design_steps.write_variants(tmp_path_factory.mktemp("design_steps"))


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("K", [2, 8, 10, 16, 20])
def test_register_kernel_gives_the_loops_bits(cuda, variants, monkeypatch, K, inverse):
    """The planar forward from registers against the same source built with
    the loops over a runtime K at 256 threads a block (``planar_loops_256``,
    the earlier kernel): the same operations in the same order, the same
    bits."""
    x, p = planar_inputs(2**14 + 37, cuda, K=K)
    got = spline_cuda.rqs_transposed(x, p, CODES, BOUNDS, inverse)
    monkeypatch.setattr(spline_cuda, "SOURCE", variants[("planar", "planar_loops_256")])
    want = spline_cuda.rqs_transposed(x, p, CODES, BOUNDS, inverse)
    for name, a, b in zip(("y", "ld"), got, want):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


def flat_backward_builds(cuda, variants, monkeypatch, K, inverse):
    """The flat backward of the shipped source and of ``backward_loops_256``
    (the earlier kernel) on the same inputs, with those inputs."""
    args = flat_inputs(4096 + 37, cuda) if K == 8 else sweep_inputs(4096 + 37, cuda, K)
    yb, lb = (torch.from_numpy(a).to(cuda)
              for a in np.random.default_rng(1).normal(size=(2, 4096 + 37)).astype(np.float32))
    got = spline_flat.unconstrained_rqs_dyncodes_backward(*args, yb, lb, inverse)
    monkeypatch.setattr(spline_flat, "SOURCE", variants[("flat", "backward_loops_256")])
    want = spline_flat.unconstrained_rqs_dyncodes_backward(*args, yb, lb, inverse)
    return got, want, (*args, yb, lb)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("K", [2, 8, 10, 16, 20])
def test_register_backward_against_the_loops(cuda, variants, monkeypatch, K, inverse):
    """The flat backward from registers and the loops it replaced
    (``backward_loops_256``) each within the float64 bars (1e-3) on the same
    inputs.  Their bits differ where the registers are used (K <= 16: nvcc
    contracts multiply-adds into fmas differently in the two kernels; the
    next test builds both without contraction) and agree at K = 20, where
    both run the loops."""
    got, want, args = flat_backward_builds(cuda, variants, monkeypatch, K, inverse)
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    ref = spline_flat.unconstrained_rqs_dyncodes_backward_reference(*f64, inverse)
    for a, b, r in zip(got, want, ref):
        close(a, r, 1e-3)
        close(b, r, 1e-3)
        assert K <= 16 or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("K", [2, 8, 10, 16, 20])
def test_register_backward_gives_the_loops_bits_without_contraction(
        cuda, variants, monkeypatch, K, inverse):
    """Built with ``-fmad=false`` (no multiply-add contracted into an fma),
    the flat backward from registers gives the loops' bits: the same
    operations in the same order."""
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-fmad=false",))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    got, want, _ = flat_backward_builds(cuda, variants, monkeypatch, K, inverse)
    for name, a, b in zip(("dx", "duw", "duh", "dud"), got, want):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


def planar_backward_builds(cuda, variants, monkeypatch, K, inverse):
    """The planar backward of the shipped source and of
    ``planar_backward_loops_256`` (the earlier kernel) on the same inputs,
    with those inputs: B = 4096 + 37, the flat backward's test size, the
    flagship's K at PARAM_STD and the others at 0.3 (the flat sweep's draw,
    chip_smoke.py's SWEEP_STD)."""
    B = 4096 + 37
    x, p = planar_inputs(B, cuda, K=K, std=PARAM_STD if K == 10 else 0.3)
    yb, lb = (torch.from_numpy(a).to(cuda)
              for a in np.random.default_rng(1).normal(size=(2, 2, B)).astype(np.float32))
    got = spline_cuda.rqs_transposed_backward(x, p, yb, lb, CODES, BOUNDS, inverse)
    monkeypatch.setattr(spline_cuda, "SOURCE", variants[("planar", "planar_backward_loops_256")])
    want = spline_cuda.rqs_transposed_backward(x, p, yb, lb, CODES, BOUNDS, inverse)
    return got, want, (x, p, yb, lb)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("K", [2, 8, 10, 16, 20])
def test_register_planar_backward_against_the_loops(cuda, variants, monkeypatch, K, inverse):
    """The planar backward from registers and the loops it replaced
    (``planar_backward_loops_256``) each within the JAX package's gradient
    bar (2e-3) of the float64 plain version on the same inputs; bit for bit
    at K = 20, where both run the loops."""
    got, want, args = planar_backward_builds(cuda, variants, monkeypatch, K, inverse)
    ref = spline_cuda.rqs_transposed_backward_reference(*(a.double() for a in args), CODES,
                                                        BOUNDS, inverse)
    for a, b, r in zip(got, want, ref):
        close(a, r, G_TOL)
        close(b, r, G_TOL)
        assert K <= 16 or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("K", [2, 8, 10, 16, 20])
def test_register_planar_backward_gives_the_loops_bits_without_contraction(
        cuda, variants, monkeypatch, K, inverse):
    """Built with ``-fmad=false``, the planar backward from registers gives
    the loops' bits: the same operations in the same order."""
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-fmad=false",))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    got, want, _ = planar_backward_builds(cuda, variants, monkeypatch, K, inverse)
    for name, a, b in zip(("dx", "dparams"), got, want):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.mark.gpu
def test_kernel_rejects_non_contiguous(cuda):
    x, p = planar_inputs(256, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        spline_cuda.rqs_transposed(x, p[:, ::2], CODES, BOUNDS, False)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("B", [2**14, 2**14 + 37, 1])
def test_backward_kernel_matches_plain(cuda, B, inverse):
    x, p = planar_inputs(B, cuda)
    rng = np.random.default_rng(1)
    yb, lb = (torch.from_numpy(a).to(cuda)
              for a in rng.normal(size=(2, 2, B)).astype(np.float32))
    before = spline_cuda.BACKWARD_LAUNCHES
    dx, dp = spline_cuda.rqs_transposed_backward(x, p, yb, lb, CODES, BOUNDS, inverse)
    torch.cuda.synchronize()
    assert spline_cuda.BACKWARD_LAUNCHES == before + 1
    dxr, dpr = spline_cuda.rqs_transposed_backward_reference(x, p, yb, lb, CODES, BOUNDS,
                                                             inverse)
    assert torch.isfinite(dx).all() and torch.isfinite(dp).all()
    close(dx, dxr, G_TOL)
    close(dp, dpr, G_TOL)


def small_model(device, target=False):
    base = nft.distributions.UniformGaussian.create(2, [1], [1.0, 2 * math.pi],
                                                    device=device)
    layers = [nft.flows.CircularAutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(i), 2, 1, 64, ind_circ=[1], num_bins=10,
        tail_bound=np.array([5.0, math.pi], np.float32), init_identity=False,
        rng_seed=i, device=device) for i in range(2)]
    p = nft.distributions.GaussianVonMises(device=device) if target else None
    return nft.NormalizingFlow.create(base, layers, p=p, device=device)


@pytest.mark.gpu
def test_small_model_trains_through_the_kernels(cuda):
    """One reverse-KL step with Adam on the card and on the CPU, the same
    weights and the same base draws: 4 + 4 kernel launches, and the loss
    and gradients agree."""
    from normflows_tpu_torch.training import make_train_step

    card, cpu = small_model(cuda, target=True), small_model("cpu", target=True)
    cpu.load_state_dict(card.state_dict())
    z, log_q = card.q0.sample_and_log_prob(1000, generator=torch.Generator(
        device=cuda).manual_seed(0))
    results = {}
    for where, model, draw in (("card", card, (z, log_q)),
                               ("cpu", cpu, (z.cpu(), log_q.cpu()))):
        model.q0.sample_and_log_prob = lambda n, context=None, *, generator=None, d=draw: (
            d[0].clone(), d[1].clone())
        state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=5e-4),
                                      lambda m, batch, gen: m.reverse_kld(1000))
        spline_cuda.LAUNCHES = spline_cuda.BACKWARD_LAUNCHES = 0
        _, metrics = step(state, None)
        results[where] = (metrics, spline_cuda.LAUNCHES, spline_cuda.BACKWARD_LAUNCHES,
                          {n: p.grad.cpu() for n, p in model.named_parameters()})
    (m_card, fwd, bwd, g_card), (m_cpu, fwd_cpu, bwd_cpu, g_cpu) = results["card"], results["cpu"]
    assert (fwd, bwd) == (4, 4) and (fwd_cpu, bwd_cpu) == (0, 0)
    assert m_card["finite"]
    close(m_card["loss"], m_cpu["loss"], 1e-4)
    for n, g in g_cpu.items():
        assert float((g_card[n] - g).norm()) <= G_TOL * float(g.norm()) + 1e-6, n


@pytest.mark.gpu
def test_small_model_serves_through_the_kernel(cuda):
    card, cpu = small_model(cuda), small_model("cpu")
    cpu.load_state_dict(card.state_dict())
    with torch.inference_mode():
        spline_cuda.LAUNCHES = 0
        x, log_q = card.sample(1000, generator=torch.Generator(device=cuda).manual_seed(0))
        assert spline_cuda.LAUNCHES == 4
        lp = card.log_prob(x)
        assert spline_cuda.LAUNCHES == 6
        close(lp, log_q, 1e-3)
        close(lp, cpu.log_prob(x.cpu()), 1e-3)


def flat_inputs(N, device, seed=0, slab=True, K=8):
    """x, uw_t, uh_t, ud_t, codes, bounds of the flat kernel, the parameter
    rows one feature's slab of a (64 (3K+1), N) tensor or packed."""
    rng = np.random.default_rng(seed)
    S = 3 * K + 1
    codes = rng.choice([1, 2], size=N).astype(np.int32)
    bounds = np.where(codes == 1, 3.0, np.pi).astype(np.float32)
    x = (rng.uniform(-1.25, 1.25, N) * bounds).astype(np.float32)
    p = torch.from_numpy((PARAM_STD * rng.normal(size=(64 * S if slab else S, N)))
                         .astype(np.float32)).to(device)
    if slab:
        p = p[5 * S:6 * S]
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(x), p[:K], p[K:2 * K], p[2 * K:], to(codes), to(bounds)


def sweep_inputs(N, device, K, seed=0):
    """The flat kernel's inputs as the JAX package's dyncodes test draws them
    (tests/test_pallas.py:408-416: x ~ U(-4, 4), logits N(0, 0.3^2), linear
    tails at 4 and circular at pi in turn), on one feature's slab: the
    inputs its runtime-tail bars were set on."""
    rng = np.random.default_rng(seed)
    S = 3 * K + 1
    codes = np.where(np.arange(N) % 2 == 0, 1, 2).astype(np.int32)
    bounds = np.where(codes == 1, 4.0, np.pi).astype(np.float32)
    x = rng.uniform(-4, 4, N).astype(np.float32)
    p = torch.from_numpy((0.3 * rng.normal(size=(64 * S, N))).astype(np.float32)).to(device)
    p = p[5 * S:6 * S]
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(x), p[:K], p[K:2 * K], p[2 * K:], to(codes), to(bounds)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("N,slab,K", [(4096, True, 8), (4096 + 37, True, 8), (1, True, 8),
                                      (4096 * 64, False, 8)] +
                         [(4096 + 37, True, K) for K in (2, 10, 16, 20)])
def test_flat_kernel_matches_plain(cuda, N, slab, K, inverse):
    """Forward and backward (1e-3) against the plain versions in float64, at the JAX
    package's bars: 1e-5 / 1e-4 for the sliced inverse's slab (the runtime-tail
    entry), 2e-5 / 2e-4 at the density direction's packed size (the
    static-tail entry).  The bin sweep reaches every instantiation of the
    forward: K = 8 and 10 exactly, 2 and 16 (K <= 16, bins masked), 20 (a
    runtime K), on the JAX package's own test inputs (``sweep_inputs``)."""
    args = flat_inputs(N, cuda, slab=slab) if K == 8 else sweep_inputs(N, cuda, K)
    before = (spline_flat.LAUNCHES, spline_flat.BACKWARD_LAUNCHES)
    y, ld = spline_flat.unconstrained_rqs_dyncodes(*args, inverse)
    yb, lb = (torch.from_numpy(a).to(cuda)
              for a in np.random.default_rng(1).normal(size=(2, N)).astype(np.float32))
    grads = spline_flat.unconstrained_rqs_dyncodes_backward(*args, yb, lb, inverse)
    torch.cuda.synchronize()
    assert (spline_flat.LAUNCHES, spline_flat.BACKWARD_LAUNCHES) == (before[0] + 1,
                                                                     before[1] + 1)
    # the plain versions in float64 (see chip_smoke.py's FLAT_G_TOL)
    f64 = [a.double() if a.is_floating_point() else a for a in (*args, yb, lb)]
    yr, ldr = spline_flat.unconstrained_rqs_dyncodes_reference(*f64[:6], inverse)
    close(y, yr, 1e-5 if slab else Y_TOL)
    close(ld, ldr, 1e-4 if slab else LD_TOL)
    want = spline_flat.unconstrained_rqs_dyncodes_backward_reference(*f64, inverse)
    for g, r in zip(grads, want):
        assert torch.isfinite(g).all()
        close(g, r, 1e-3)


def large_d_model(device, layers=2):
    """examples/ar_large_d_bench.py's layers at D = 64, narrowed to hidden 32."""
    flows = []
    for i in range(layers):
        flows.append(nft.flows.AutoregressiveRationalQuadraticSpline.create(
            torch.Generator().manual_seed(i), 64, 1, 32, num_bins=8, permute_mask=True,
            rng_seed=i, init_identity=False, device=device))
        flows.append(nft.flows.LULinearPermute.create(
            64, generator=torch.Generator().manual_seed(100 + i), device=device))
    return nft.NormalizingFlow.create(nft.distributions.DiagGaussian.create(64, device=device),
                                      flows, device=device)


@pytest.mark.gpu
def test_large_d_model_serves_through_the_flat_kernel(cuda):
    """64 flat launches per layer and sample (the sliced inverse), one per
    layer and log_prob, no planar launch; the card against the CPU."""
    card, cpu = large_d_model(cuda), large_d_model("cpu")
    cpu.load_state_dict(card.state_dict())
    with torch.inference_mode():
        spline_cuda.LAUNCHES = spline_flat.LAUNCHES = 0
        x, log_q = card.sample(1000, generator=torch.Generator(device=cuda).manual_seed(0))
        torch.cuda.synchronize()
        assert spline_flat.LAUNCHES == 128
        lp = card.log_prob(x)
        torch.cuda.synchronize()
        assert spline_flat.LAUNCHES == 130 and spline_cuda.LAUNCHES == 0
        close(lp, log_q, 1e-3)
        close(lp, cpu.log_prob(x.cpu()), 1e-3)


def made_operands(B, F, H, R, mult, device, bf16=False, seed=0, activation="relu"):
    """x and the packed operands of a MADE with random weights (the residual
    blocks' second linear drawn like the others, not near zero), all drawn
    from ``seed``: the same operands whatever ran before."""
    gen = torch.Generator().manual_seed(seed)
    made = nft.nets.MADE(F, H, num_blocks=R, output_multiplier=mult, permute_mask=True,
                         rng_seed=seed, activation=activation, generator=gen, device=device)
    with torch.no_grad():
        for blk in made.blocks:
            for t in (blk.linear_1.weight, blk.linear_1.bias):
                t.copy_(torch.empty(t.shape).uniform_(-H ** -0.5, H ** -0.5, generator=gen))
    if bf16:
        nft.utils.set_compute_dtype(made, "bfloat16")
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32))
    return x.to(device), [t.detach() for t in made_fused.pack(made)]


# the large-D shape, the JAX package's test shapes, the same with tanh and
# leaky_relu (where no cotangent is bf16 and the split takes all its
# terms), and the gate's widest hidden layer
MADE_SHAPES = [(4096, 64, 256, 1, 25, "relu"), (300, 2, 512, 1, 31, "relu"),
               (300, 2, 512, 2, 31, "relu"), (300, 2, 512, 2, 31, "tanh"),
               (300, 2, 512, 2, 31, "leaky_relu"), (1024, 8, 768, 1, 7, "relu")]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,F,H,R,mult,activation", MADE_SHAPES)
def test_made_fused_kernels_match_plain(cuda, B, F, H, R, mult, activation, bf16):
    """Forward and backward kernels against the plain versions: in f32
    against them in float64 (1e-5 outputs, 2e-4 gradients, the JAX
    package's bars), in bf16 against the bf16 plain version (5e-2) and the
    forward against the f32 one (0.15 / 0.05)."""
    x, ops = made_operands(B, F, H, R, mult, cuda, bf16, activation=activation)
    g = torch.randn(B, F * mult, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    before = (made_fused.LAUNCHES, made_fused.BACKWARD_LAUNCHES)
    out = made_fused.fused_resmade(x, *ops, activation)
    grads, kinks = made_backward_and_kinks(x, ops, g, activation)
    torch.cuda.synchronize()
    assert (made_fused.LAUNCHES, made_fused.BACKWARD_LAUNCHES) == (before[0] + 1,
                                                                 before[1] + 1)
    args = (x, *ops, g) if bf16 else [t.double() for t in (x, *ops, g)]
    if bf16:
        close(out, made_fused.fused_resmade_reference(x, *ops, activation), 5e-2)
        f32_ops = [t.float() for t in ops]
        np.testing.assert_allclose(out.cpu().numpy(), made_fused.fused_resmade_reference(
            x, *f32_ops, activation).cpu().numpy(), atol=0.15, rtol=0.05)
        tol = 5e-2
    else:
        close(out, made_fused.fused_resmade_reference(*args[:-1], activation), 1e-5)
        tol = 2e-4
    # the kernels' pre-activations against the plain ones at the forward's
    # bar; the pull-back then takes the kernels' side of relu's step
    for got, ref in zip(kinks, made_fused.preactivations_reference(*args[:-1], activation)):
        close(got, ref, 5e-2 if bf16 else 1e-5)
    want = made_fused.fused_resmade_backward_reference(*args, activation, kinks=kinks)
    for got, ref in zip(grads, want):
        assert got.dtype == (ref.dtype if bf16 else torch.float32) and torch.isfinite(got).all()
        close(got.float(), ref.float(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_made_fused_backward_is_deterministic(cuda, bf16):
    """Two backward calls on the same inputs give the same bits: no atomics,
    the weight gradients' splits added in order (large-D shape)."""
    x, ops = made_operands(4096, 64, 256, 1, 25, cuda, bf16)
    g = torch.randn(4096, 1600, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    first = made_fused.fused_resmade_backward(x, *ops, g)
    second = made_fused.fused_resmade_backward(x, *ops, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_made_fused_forward_is_deterministic(cuda, bf16):
    """Two forward calls on the same inputs give the same bits: no atomics,
    each output summed by one block in a fixed order (large-D shape)."""
    x, ops = made_operands(4096, 64, 256, 1, 25, cuda, bf16)
    first = made_fused.fused_resmade(x, *ops)
    second = made_fused.fused_resmade(x, *ops)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_made_fused_forward_at_a_width_no_multiple_of_32(cuda, bf16):
    """H = 144: the final layer's last chunk along H is half empty, and P =
    15 is odd (no paired stores); the same bars (f32 against float64 1e-5,
    bf16 against the bf16 plain version 5e-2).  A width no multiple of 16
    is refused, on both sides of the C interface."""
    x, ops = made_operands(300, 3, 144, 1, 5, cuda, bf16)
    out = made_fused.fused_resmade(x, *ops)
    torch.cuda.synchronize()
    if bf16:
        close(out, made_fused.fused_resmade_reference(x, *ops), 5e-2)
    else:
        close(out, made_fused.fused_resmade_reference(*[t.double() for t in (x, *ops)]), 1e-5)
    x, ops = made_operands(300, 3, 100, 1, 5, cuda, bf16)
    with pytest.raises(ValueError, match="multiple of 16"):
        made_fused.fused_resmade(x, *ops)
    out = torch.empty(300, 15, device=cuda)
    work = torch.empty(made_fused.forward_workspace(300, 100, 15, bf16), dtype=torch.bfloat16,
                       device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        made_fused._launch("made_fused_forward", (x, *ops, out, work), x, (300, 3, 100, 1, 15),
                           "relu", bf16)


def made_backward_and_kinks(x, ops, g, activation="relu"):
    """The backward kernels' gradients and, from their scratch, the
    pre-activations they took: (h before each block (R, B, H), each block's
    inner z (R, B, H))."""
    B, H, R = x.shape[0], ops[0].shape[0], ops[2].shape[0]
    scratch = torch.empty((4 * R + 2) * B * H, device=x.device)
    grads = made_fused.fused_resmade_backward(x, *ops, g, activation, scratch=scratch)
    slabs = scratch.view(4 * R + 2, B, H)
    return grads, (slabs[:R], slabs[R + 1:2 * R + 1])


@pytest.mark.gpu
def test_made_fused_backward_pins_relu_kinks(cuda):
    """The bf16 backward at (300, 2, 512, R 2) over 24 draws of the weights:
    against the plain version's own relu derivatives a draw can miss the
    5e-2 bar where a pre-activation within rounding of 0 lands on the other
    side of relu's step (the kernels sum on the tensor cores, the plain
    version in cuBLAS's order); with the kernels' pre-activations every
    draw passes.  Prints the count of draws each way."""
    B, F, H, R, mult = 300, 2, 512, 2, 31
    g = torch.randn(B, F * mult, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    misses = {"plain": 0, "kernels": 0}
    for seed in range(24):
        x, ops = made_operands(B, F, H, R, mult, cuda, bf16=True, seed=seed)
        grads, kinks = made_backward_and_kinks(x, ops, g)
        for side, want in (
                ("plain", made_fused.fused_resmade_backward_reference(x, *ops, g)),
                ("kernels", made_fused.fused_resmade_backward_reference(x, *ops, g,
                                                                        kinks=kinks))):
            misses[side] += any(not torch.allclose(a.float(), b.float(), atol=5e-2, rtol=5e-2)
                                for a, b in zip(grads, want))
    print(f"\nmade_fused bf16 backward, 24 draws: {misses['plain']} miss the bar with the "
          f"plain relu derivatives, {misses['kernels']} with the kernels'")
    assert misses["kernels"] == 0


@pytest.mark.gpu
def test_made_fused_refuses_what_it_cannot_take(cuda, tmp_path):
    x, ops = made_operands(300, 2, 128, 1, 3, cuda)
    with pytest.raises(ValueError, match="shape"):
        made_fused.fused_resmade(x, ops[0][:, :1], *ops[1:])
    with pytest.raises(ValueError, match="H <= 768"):
        big = made_operands(300, 2, 896, 1, 3, cuda)
        made_fused.fused_resmade(big[0], *big[1])
    with pytest.raises(ValueError, match="B >= 1"):
        made_fused.fused_resmade(x[:0], *ops)
    out = torch.empty(300, 6, device=cuda)
    work = torch.empty(made_fused.forward_workspace(300, 1024, 6, False), dtype=torch.bfloat16,
                       device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):  # the C side's own check
        made_fused._launch("made_fused_forward", (x, *ops, out, work), x, (300, 2, 1024, 1, 6),
                           "relu", False)
    with pytest.raises(TypeError, match="float32"):
        made_fused.fused_resmade(x, *ops[:6], ops[6].bfloat16(), ops[7])
    broken = tmp_path / "broken.cu"
    broken.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build([broken])


@pytest.fixture
def fusion():
    before = backend.made_fusion_enabled()
    backend.set_made_fusion(True)
    yield
    backend.set_made_fusion(before)


@pytest.mark.gpu
def test_large_d_fused_log_prob_equals_unfused(cuda, fusion):
    """D = 64 at hidden 128: with fusion on, one fused launch per AR layer
    and log_prob, and the same log-densities as the unfused path; none in
    sample (the sliced inverse stays unfused)."""
    card = nft.NormalizingFlow.create(
        nft.distributions.DiagGaussian.create(64, device=cuda),
        [f for i in range(2) for f in (
            nft.flows.AutoregressiveRationalQuadraticSpline.create(
                torch.Generator().manual_seed(i), 64, 1, 128, num_bins=8, permute_mask=True,
                rng_seed=i, init_identity=False, device=cuda),
            nft.flows.LULinearPermute.create(
                64, generator=torch.Generator().manual_seed(100 + i), device=cuda))],
        device=cuda)
    with torch.inference_mode():
        made_fused.LAUNCHES = 0
        x, _ = card.sample(1000, generator=torch.Generator(device=cuda).manual_seed(0))
        torch.cuda.synchronize()
        assert made_fused.LAUNCHES == 0
        fused = card.log_prob(x)
        torch.cuda.synchronize()
        assert made_fused.LAUNCHES == 2
        backend.set_made_fusion(False)
        unfused = card.log_prob(x)
    assert made_fused.LAUNCHES == 2
    close(fused, unfused, 1e-4)


def ablate_inputs(N, device, seed=0, K=10):
    """The ablation's flat operands with mixed tails (linear at 5, circular
    at pi), x ~ N(0, 1) and random cotangents."""
    rng = np.random.default_rng(seed)
    codes = rng.choice([1, 2], size=N).astype(np.int32)
    bounds = np.where(codes == 1, 5.0, np.pi).astype(np.float32)
    x = rng.normal(size=N).astype(np.float32)
    p = (0.1 * rng.normal(size=(3 * K + 1, N))).astype(np.float32)
    yb, lb = rng.normal(size=(2, N)).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(x), to(p[:K]), to(p[K:2 * K]), to(p[2 * K:]), to(codes), to(bounds), to(yb), to(lb)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("N", [2**15, 2**15 + 37])
@pytest.mark.parametrize("mode", spline_ablate.VARIANTS)
def test_ablate_kernel_matches_plain(cuda, mode, N, inverse):
    """Each variant against its plain version in float64: sel_only 1e-5,
    the others the flat backward's 1e-3; vjp_all equals full within 1e-3."""
    args = ablate_inputs(N, cuda)
    before = spline_ablate.LAUNCHES[mode]
    got = spline_ablate.run_variant(mode, *args, inverse=inverse)
    torch.cuda.synchronize()
    assert spline_ablate.LAUNCHES[mode] == before + 1
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    want = spline_ablate.REFERENCES[mode](*f64, inverse)
    tol = 1e-5 if mode == "sel_only" else 1e-3
    for g, r in zip(got, want):
        assert torch.isfinite(g).all()
        close(g, r, tol)
    if mode == "vjp_all":
        for g, r in zip(got, spline_ablate.run_variant("full", *args, inverse=inverse)):
            close(g, r, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("K", [8, 16, 20])
@pytest.mark.parametrize("mode", spline_ablate.VARIANTS)
def test_ablate_kernel_bins_match_plain(cuda, mode, K, inverse):
    """The kernel's other instantiations beside the script's K = 10: 8
    exactly, 16 (K <= 16, bins masked) and, for every variant but vjp_all,
    20 (the loops over a runtime K); the bars as above."""
    args = ablate_inputs(2**15 + 37, cuda, K=K)
    if mode == "vjp_all" and K > spline_ablate.MAX_BINS:
        with pytest.raises(ValueError, match="at most"):
            spline_ablate.run_variant(mode, *args, inverse=inverse)
        return
    got = spline_ablate.run_variant(mode, *args, inverse=inverse)
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    want = spline_ablate.REFERENCES[mode](*f64, inverse)
    for g, r in zip(got, want):
        assert torch.isfinite(g).all()
        close(g, r, 1e-5 if mode == "sel_only" else 1e-3)
    if mode == "vjp_all":
        for g, r in zip(got, spline_ablate.run_variant("full", *args, inverse=inverse)):
            close(g, r, 1e-3)


@pytest.mark.gpu
def test_ablate_refuses_too_many_bins(cuda):
    args = ablate_inputs(256, cuda, K=spline_ablate.MAX_BINS + 1)
    with pytest.raises(ValueError, match="at most"):
        spline_ablate.run_variant("vjp_all", *args, inverse=True)
    spline_ablate.run_variant("full", *args, inverse=True)  # the lean kernel takes any K


def coupled_model(device, layers=2):
    """docs/getting_started.md's layers (2 blocks of hidden 64, 8 bins) with
    random transform nets, on DiagGaussian(2) and TwoMoons."""
    flows = [nft.flows.CoupledRationalQuadraticSpline.create(
        torch.Generator().manual_seed(i), 2, 2, 64, reverse_mask=bool(i % 2),
        init_identity=False, device=device) for i in range(layers)]
    return nft.NormalizingFlow.create(nft.distributions.DiagGaussian.create(2, device=device),
                                      flows, p=nft.distributions.TwoMoons(device=device),
                                      device=device)


@pytest.mark.gpu
def test_coupled_model_runs_through_the_flat_kernel(cuda):
    """Two flat launches per layer in each direction (the coupling's and the
    CDF's), their backward in a forward-KL step; the card against the CPU."""
    card, cpu = coupled_model(cuda), coupled_model("cpu")
    cpu.load_state_dict(card.state_dict())
    x = card.p.sample(1000, generator=torch.Generator(device=cuda).manual_seed(0))
    assert x.shape == (1000, 2) and bool((x.abs() <= 3.0).all())
    with torch.inference_mode():
        spline_flat.LAUNCHES = 0
        z, log_q = card.sample(1000, generator=torch.Generator(device=cuda).manual_seed(1))
        lp = card.log_prob(z)
        torch.cuda.synchronize()
        assert spline_flat.LAUNCHES == 8
        close(lp, log_q, 1e-3)
        close(card.log_prob(x), cpu.log_prob(x.cpu()), 1e-3)
    spline_flat.LAUNCHES = spline_flat.BACKWARD_LAUNCHES = 0
    losses = []
    for model, batch in ((card, x), (cpu, x.cpu())):
        model.zero_grad(set_to_none=True)
        loss = model.forward_kld(batch)
        loss.backward()
        losses.append(loss.detach().cpu())
    torch.cuda.synchronize()
    assert (spline_flat.LAUNCHES, spline_flat.BACKWARD_LAUNCHES) == (4, 4)
    close(losses[0], losses[1], 1e-4)
    for (n, p), q in zip(card.named_parameters(), cpu.parameters()):
        assert float((p.grad.cpu() - q.grad).norm()) <= G_TOL * float(q.grad.norm()) + 1e-6, n


# ---- the chunked trainer: one step captured in a CUDA graph and replayed ------

def kernel_counts(fn):
    """``{kernel name: launches}`` that torch.profiler records on the card
    while ``fn`` runs (graph replays included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return {e.key: e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host}


def launches_of(counts, kernel):
    """Launches of the kernel named ``kernel`` (its template arguments aside)."""
    return sum(n for name, n in counts.items() if f"{kernel}<" in name or f"{kernel}(" in name)


def profiled_as(counts, kernel, exact):
    """The profiler's records of ``kernel`` in replayed chunks that launch it
    ``exact`` times: never more, and short only by a few records the
    profiler drops (on the H100 it can drop ~1%)."""
    n = launches_of(counts, kernel)
    return exact * 0.95 <= n <= exact


def reverse_kld_1000(model, batch, generator):
    return model.reverse_kld(1000, generator=generator)


@pytest.mark.gpu
def test_captured_chunk_matches_eager_steps(cuda):
    """Five reverse-KL steps captured once and replayed against five eager
    steps from the same weights, generator seed and optimizer (Adam with
    capturable=True, run eagerly): the replays draw what the eager steps
    draw (the generator is registered with the graph), the losses agree
    within 1e-4 and every leaf within 2e-3 of its norm."""
    from normflows_tpu_torch.training import make_step_chunk, make_train_step

    eager, captured = small_model(cuda, target=True), small_model(cuda, target=True)
    captured.load_state_dict(eager.state_dict())
    state, step = make_train_step(
        eager, torch.optim.Adam(eager.parameters(), lr=5e-4, capturable=True), reverse_kld_1000)
    gen = torch.Generator(device=cuda).manual_seed(0)
    want = torch.stack([step(state, None, gen)[1]["loss"] for _ in range(5)])
    cstate, chunk = make_step_chunk(
        captured, torch.optim.Adam(captured.parameters(), lr=5e-4, capturable=True),
        reverse_kld_1000, chunk_len=5)
    _, metrics = chunk(cstate, torch.Generator(device=cuda).manual_seed(0))
    assert int(cstate.step) == 5
    close(metrics["loss"], want, 1e-4)
    for (n, p), q in zip(captured.named_parameters(), eager.parameters()):
        assert float((p - q).detach().norm()) <= G_TOL * float(q.detach().norm()) + 1e-6, n


@pytest.mark.gpu
def test_chunk_replays_without_a_host_sync_and_draws_anew(cuda):
    """After the capture a chunk makes no host sync (sync debug mode
    "error"), and each replay draws new samples: at lr 0 the losses differ
    only through the draws."""
    from normflows_tpu_torch.training import make_step_chunk

    model = small_model(cuda, target=True)
    state, chunk = make_step_chunk(
        model, torch.optim.Adam(model.parameters(), lr=0.0, capturable=True),
        reverse_kld_1000, chunk_len=4)
    gen = torch.Generator(device=cuda).manual_seed(1)
    chunk(state, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = chunk(state, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    losses = metrics["loss"].tolist()
    assert int(state.step) == 8 and all(np.isfinite(losses))
    assert len(set(losses)) == 4
    with pytest.raises(ValueError, match="generator it was captured with"):
        chunk(state, torch.Generator(device=cuda).manual_seed(1))


@pytest.mark.gpu
def test_chunk_launches_its_kernels_every_replay(cuda):
    """The planar kernels run 4 + 4 times a step (2 layers, reverse KL, the
    inverse direction) in every replay: the Python counters tick at the
    warm-up and the capture only, 4 + 4 a step; the device counters, whose
    adds are captured beside the launches, count 12 + 12 in a replayed chunk
    of 3; the profiler's records of that chunk agree."""
    from normflows_tpu_torch.training import make_step_chunk
    from normflows_tpu_torch.training.loop import WARMUP_STEPS

    model = small_model(cuda, target=True)
    state, chunk = make_step_chunk(
        model, torch.optim.Adam(model.parameters(), lr=5e-4, capturable=True),
        reverse_kld_1000, chunk_len=3)
    gen = torch.Generator(device=cuda).manual_seed(2)
    on_card = torch.zeros(2, 2, dtype=torch.int64, device=cuda)
    spline_cuda.DEVICE_LAUNCHES = on_card
    try:
        spline_cuda.LAUNCHES = spline_cuda.BACKWARD_LAUNCHES = 0
        chunk(state, gen)
        captured = (spline_cuda.LAUNCHES, spline_cuda.BACKWARD_LAUNCHES)
        assert captured == (4 * (WARMUP_STEPS + 1),) * 2
        # the warm-up's steps ran, the captured one did not: 3 replays did
        assert on_card.tolist() == [[0, 4 * (WARMUP_STEPS + 3)], [0, 4 * (WARMUP_STEPS + 3)]]
        on_card.zero_()
        counts = kernel_counts(lambda: chunk(state, gen))
        assert on_card.tolist() == [[0, 12], [0, 12]]
    finally:
        spline_cuda.DEVICE_LAUNCHES = None
    assert profiled_as(counts, "rqs_transposed_kernel", 12)
    assert profiled_as(counts, "rqs_transposed_backward_kernel", 12)
    assert (spline_cuda.LAUNCHES, spline_cuda.BACKWARD_LAUNCHES) == captured


@pytest.mark.gpu
def test_chunk_on_the_card_wants_a_capturable_adam(cuda):
    from normflows_tpu_torch.training import make_step_chunk

    model = small_model(cuda, target=True)
    with pytest.raises(ValueError, match="capturable=True"):
        make_step_chunk(model, torch.optim.Adam(model.parameters(), lr=5e-4),
                        reverse_kld_1000)


@pytest.mark.gpu
def test_sequential_data_chunk_on_the_card(cuda):
    """make_chunked_train_step on the coupled model, data on the card,
    shuffle=False: the same minibatches as eager steps on the window (the
    same capturable Adam), losses
    within 1e-4, leaves within 2e-3 of their norms, and 4 + 4 flat launches a
    step captured and replayed (the device counters: 12 + 12 in a chunk of
    3, the forward direction)."""
    from normflows_tpu_torch.training import make_chunked_train_step, make_train_step
    from normflows_tpu_torch.training.loop import WARMUP_STEPS

    eager, captured = coupled_model(cuda), coupled_model(cuda)
    captured.load_state_dict(eager.state_dict())
    x = eager.p.sample(4096, generator=torch.Generator(device=cuda).manual_seed(3))
    loss_fn = lambda m, batch, gen: m.forward_kld(batch)  # noqa: E731
    state, step = make_train_step(
        eager, torch.optim.Adam(eager.parameters(), lr=5e-4, capturable=True), loss_fn)
    want = []
    for i in range(6):
        s = (i * 512) % (4096 - 512 + 1)
        want.append(step(state, x[s:s + 512])[1]["loss"])
    cstate, chunk = make_chunked_train_step(
        captured, torch.optim.Adam(captured.parameters(), lr=5e-4, capturable=True), loss_fn,
        x, batch_size=512, chunk_len=3, shuffle=False)
    on_card = torch.zeros(2, 2, dtype=torch.int64, device=cuda)
    spline_flat.DEVICE_LAUNCHES = on_card
    try:
        spline_flat.LAUNCHES = spline_flat.BACKWARD_LAUNCHES = 0
        got = [chunk(cstate)[1]["loss"]]
        assert (spline_flat.LAUNCHES, spline_flat.BACKWARD_LAUNCHES) == \
            (4 * (WARMUP_STEPS + 1),) * 2
        on_card.zero_()
        counts = kernel_counts(lambda: got.append(chunk(cstate)[1]["loss"]))
        assert on_card.tolist() == [[12, 0], [12, 0]]
    finally:
        spline_flat.DEVICE_LAUNCHES = None
    close(torch.cat(got), torch.stack(want), 1e-4)
    for (n, p), q in zip(captured.named_parameters(), eager.parameters()):
        assert float((p - q).detach().norm()) <= G_TOL * float(q.detach().norm()) + 1e-6, n
    assert profiled_as(counts, "rqs_flat_kernel", 12)
    assert profiled_as(counts, "rqs_flat_backward_kernel", 12)


def _randomize_last_layers(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.flows[::2]:
            w = layer.mprqat.autoregressive_net.final_layer.weight
            w.copy_(0.2 * torch.randn(w.shape, generator=gen))


@pytest.mark.gpu
def test_conditional_planar_model_matches_cpu(cuda):
    """The conditional example's model (hidden 32, random last layers) on the
    card against the CPU: log_prob and from_noise with a per-sample context,
    through the planar kernels (4 layers: 4 forward launches, 8 inverse)."""
    from normflows_tpu_torch.examples import conditional_flow as ex

    card = ex.build_model(cuda, hidden=32)
    _randomize_last_layers(card, 3)
    cpu = ex.build_model("cpu", hidden=32)
    cpu.load_state_dict(card.state_dict())
    c, x = ex.draw_pairs(cpu.p, 1024, torch.Generator().manual_seed(4))
    eps = torch.randn(1024, 2, generator=torch.Generator().manual_seed(5))
    spline_cuda.LAUNCHES = 0
    with torch.no_grad():
        lp = card.log_prob(x.to(cuda), c.to(cuda))
        forward_launches = spline_cuda.LAUNCHES
        xf, lf = card.from_noise(eps.to(cuda), c.to(cuda))
        torch.cuda.synchronize()
        assert (forward_launches, spline_cuda.LAUNCHES) == (4, 12)
        close(lp, cpu.log_prob(x, c), 1e-3)
        xc, lc = cpu.from_noise(eps, c)
    close(xf, xc, 1e-3)
    close(lf, lc, 1e-3)


@pytest.mark.gpu
def test_conditional_sliced_inverse_matches_naive(cuda):
    """A conditional D = 16 AR spline on the card: the sliced inverse (16
    flat launches, the context projected once) against the naive recursion
    on the (B, F) MADE, and against the CPU."""
    layer = nft.flows.AutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(6), 16, 1, 64, num_context_channels=3, num_bins=8,
        permute_mask=True, init_identity=False, device=cuda).mprqat
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32)).to(cuda)
    spline_flat.LAUNCHES = 0
    with torch.no_grad():
        z, ld = layer.inverse(x, c)
        torch.cuda.synchronize()
        assert spline_flat.LAUNCHES == 16
        out = torch.zeros_like(x)
        for _ in range(16):
            out_t, ld_t = layer._elementwise_t(
                x.T.contiguous(), layer.autoregressive_net(out, c).T.contiguous(), True)
            out = out_t.T
        cpu = nft.flows.AutoregressiveRationalQuadraticSpline.create(
            torch.Generator().manual_seed(6), 16, 1, 64, num_context_channels=3,
            num_bins=8, permute_mask=True, init_identity=False, device="cpu").mprqat
        cpu.load_state_dict(layer.state_dict())
        zc, ldc = cpu.inverse(x.cpu(), c.cpu())
    close(z, out, 1e-5)
    close(ld, ld_t.sum(0), 1e-4)
    close(z, zc, 1e-3)
    close(ld, ldc, 1e-3)


def image_nsf_model(device, layers=2, channels=4, hw=4, hidden=16):
    """Model B of chip_smoke.py, cut: DiagGaussian((C, H, W)) and ``layers``
    x (an image RQ coupling on a ConvResidualNet, Invertible1x1Conv with LU,
    ActNorm)."""
    flows = []
    for i in range(layers):
        gen = torch.Generator().manual_seed(30 + i)
        flows += [
            nft.flows.PiecewiseRationalQuadraticCoupling.create(
                nft.utils.create_alternating_binary_mask(channels, even=i % 2 == 0),
                lambda c_in, c_out: nft.nets.ConvResidualNet(c_in, c_out, hidden,
                                                             generator=gen, device=device),
                num_bins=8, tails="linear", tail_bound=3.0, device=device),
            nft.flows.Invertible1x1Conv(channels, use_lu=True, generator=gen, device=device),
            nft.flows.ActNorm((channels, 1, 1), device=device)]
    return nft.NormalizingFlow.create(
        nft.distributions.DiagGaussian((channels, hw, hw), device=device), flows,
        device=device)


@pytest.mark.gpu
def test_image_coupling_runs_through_the_flat_kernel(cuda):
    """A small image NSF on the card: one flat launch a coupling a pass (the
    spline's inverse in the density direction), the backward in a
    forward-KL step; the static-tail entry along ``event_axis = 1`` against
    its plain version on the same operands; the card against the CPU."""
    x = 1.5 * torch.randn(64, 4, 4, 4, generator=torch.Generator().manual_seed(3))
    card, cpu = image_nsf_model(cuda), image_nsf_model("cpu")
    card.init_actnorm(x.to(cuda))
    cpu.load_state_dict(card.state_dict())
    spline_flat.LAUNCHES = spline_flat.BACKWARD_LAUNCHES = 0
    with torch.no_grad():
        lp = card.log_prob(x.to(cuda))
        torch.cuda.synchronize()
        assert spline_flat.LAUNCHES == 2
        close(lp, cpu.log_prob(x), 1e-3)
        z = torch.randn(64, 4, 4, 4, generator=torch.Generator().manual_seed(4))
        y, ld = card.forward_and_log_det(z.to(cuda))
        yc, ldc = cpu.forward_and_log_det(z)
    close(y, yc, 1e-4)
    close(ld, ldc, 1e-3)
    card.forward_kld(x.to(cuda)).backward()
    torch.cuda.synchronize()
    assert spline_flat.BACKWARD_LAUNCHES == 2
    layer = card.flows[0]
    xin = x.to(cuda)[:, layer.transform_features]
    params = 0.5 * torch.randn(64, 2 * 25, 4, 4, device=cuda)
    cpu_layer = cpu.flows[0]
    for inverse in (False, True):
        got = layer._coupling_transform(xin, params, inverse)
        want = cpu_layer._coupling_transform(xin.cpu(), params.cpu(), inverse)
        close(got[0], want[0], Y_TOL)
        close(got[1], want[1], 1e-3)  # a sum of 32 log-dets, each within LD_TOL


@pytest.mark.gpu
def test_glow_float32_convolutions_are_not_tf32(cuda):
    """A small class-conditional Glow on the card against the CPU in
    float32, with the caller's cuDNN TF32 setting on: the convolutions run
    in IEEE float32 (``nets.cnn.fp32_convs``), within 1e-4 on every level's
    latents and 1e-2 nats on log_prob, and the setting comes back on."""
    from normflows_tpu_torch.examples import glow_image

    x, y = glow_image.synthetic_images(16, (3, 8, 8), 4, seed=1)
    card = glow_image.build_glow(2, 2, 32, (3, 8, 8), 4, device=cuda, seed=1)
    cpu = glow_image.build_glow(2, 2, 32, (3, 8, 8), 4, device="cpu", seed=1)
    with torch.no_grad():
        for p in card.parameters():
            if p.dim() == 4 and not p.abs().any():
                p.normal_(0.0, 0.05)
    card.init_actnorm(x.to(cuda), y.to(cuda))
    cpu.load_state_dict(card.state_dict())
    prior = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            zg, _ = card.inverse_and_log_det(x.to(cuda))
            lp = card.log_prob(x.to(cuda), y.to(cuda))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prior
    with torch.no_grad():
        zc, _ = cpu.inverse_and_log_det(x)
        assert float((lp.cpu() - cpu.log_prob(x, y)).abs().max()) <= 1e-2
    for a, b in zip(zg, zc):
        close(a, b, 1e-4)


@pytest.mark.gpu
def test_horizon_draws_capture_with_a_registered_generator(cuda):
    """``Tensor.geometric_`` and ``torch.poisson`` (the residual flows'
    horizons) captured in a CUDA graph with their generator registered:
    each replay draws anew, and the replays draw what eager calls from the
    same seed draw."""
    gen = torch.Generator(cuda).manual_seed(3)
    rates = torch.full((64,), 2.0, device=cuda)

    def draw():
        return (torch.empty(64, device=cuda).geometric_(0.5, generator=gen),
                torch.poisson(rates, generator=gen))

    eager = [draw() for _ in range(3)]
    gen.manual_seed(3)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = draw()
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(tuple(t.clone() for t in out))
    assert not torch.equal(replays[0][0], replays[1][0])
    for (g, p), (eg, ep) in zip(replays, eager):
        assert torch.equal(g, eg) and torch.equal(p, ep)
        assert bool((g >= 1).all())


@pytest.mark.gpu
def test_power_iteration_to_a_tolerance_raises_under_capture(cuda):
    from normflows_tpu_torch.nets import InducedNormLinear

    layer = InducedNormLinear(8, 8, n_iterations=None, atol=1e-3, rtol=1e-3, device=cuda)
    layer.update_power_iteration()  # eagerly: to the tolerance
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="fixed n_iterations"):
        with torch.cuda.graph(graph):
            layer.update_power_iteration()


@pytest.mark.gpu
def test_residual_chunk_with_power_iteration_matches_eager_steps(cuda):
    """A K = 2 residual model (hidden 32) on the card: a captured chunk of 10
    forward-KL AdamW steps with ``update_lipschitz_iters=50`` (each block's
    series capped, the power iteration inside the graph) against 10 eager
    steps (the series to the sampled horizon) from the same weights,
    windows and generator seed: the losses within 1e-5 and every parameter
    and power-iteration buffer within 1e-5 of its norm."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import residual_twomoons as example

    def build():
        model, x_all, _ = example.inputs(2, 0, "cpu", hidden=32)
        model.init_actnorm(x_all[:128])
        return model.to(cuda), x_all

    def adamw(m):
        return torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-5, capturable=True)

    model, x_all = build()
    state, chunk = training.make_chunked_train_step(
        model, adamw(model), example.forward_kld_loss, x_all, 128, 10, shuffle=False,
        update_lipschitz_iters=50)
    losses = chunk(state, torch.Generator(cuda).manual_seed(5))[1]["loss"]
    eager, _ = build()
    estate, step = training.make_train_step(eager, adamw(eager), example.forward_kld_loss,
                                            update_lipschitz_iters=50)
    gen = torch.Generator(cuda).manual_seed(5)
    xd = x_all.to(cuda)
    eager_losses = torch.stack([step(estate, xd[i * 128:(i + 1) * 128], gen)[1]["loss"]
                                for i in range(10)])
    close(losses, eager_losses, 1e-5)
    got = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    for name, want in [*eager.named_parameters(), *eager.named_buffers()]:
        if want.is_floating_point():
            gap = float(torch.linalg.vector_norm(got[name] - want) /
                        torch.clamp(torch.linalg.vector_norm(want), min=1e-30))
            assert gap <= 1e-5, name


@pytest.mark.gpu
def test_lipschitz_cnn_float32_gradients_are_not_tf32(cuda):
    """A LipschitzCNN's float32 forward and weight gradients on the card,
    with the caller's cuDNN TF32 setting on, against the CPU: within 1e-4
    of their norms (TF32 operands, 10 mantissa bits, miss that by ~10x)."""
    from normflows_tpu_torch.nets import LipschitzCNN

    cpu = LipschitzCNN([3, 16, 3], [3, 3], (8, 8), 0.9, init_zeros=False,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    card = LipschitzCNN([3, 16, 3], [3, 3], (8, 8), 0.9, init_zeros=False,
                        generator=torch.Generator().manual_seed(0), device=cuda)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    x, w = torch.randn(16, 3, 8, 8, generator=gen), torch.randn(16, 3, 8, 8, generator=gen)
    prior = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        (card(x.to(cuda)) * w.to(cuda)).sum().backward()
    finally:
        torch.backends.cudnn.allow_tf32 = prior
    (cpu(x) * w).sum().backward()
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        gap = float(torch.linalg.vector_norm(a.grad.cpu() - b.grad) /
                    torch.linalg.vector_norm(b.grad))
        assert gap <= 1e-4, name


def _captured(fn, gen):
    """``fn`` captured in a CUDA graph after two warm-up calls on a side
    stream, ``gen`` registered with it: ``(replay, outputs)``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.gpu
def test_captured_hais_replays_equal_eager_calls(cuda):
    """A 4-rung HAIS ladder (3 leapfrog steps) on 256 chains captured with
    its generator registered: each replay equals, bit for bit, an eager
    ``sample`` from the generator state the replay starts at."""
    from normflows_tpu_torch.examples import snf_hais

    hais = snf_hais.build_hais(cuda, betas=6, leapfrog=3)
    gen = torch.Generator(cuda).manual_seed(3)

    def draw():
        with torch.no_grad():
            return hais.sample(256, generator=gen)

    graph, (z, log_w) = _captured(draw, gen)
    for _ in range(2):
        state = gen.get_state()
        graph.replay()
        got = (z.clone(), log_w.clone())
        after = gen.get_state()
        gen.set_state(state)
        want = draw()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(gen.get_state(), after)


@pytest.mark.gpu
@pytest.mark.parametrize("mcmc", ["mh", "hmc"])
def test_snf_chunk_matches_eager_steps(cuda, mcmc):
    """The SNF (MH, or HMC with its double backward inside the graph) trained
    by reverse KL: a captured chunk of 5 capturable-Adam steps against 5
    eager steps from the same weights and generator seed, bit for bit."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import snf_hais

    def loss_fn(model, batch, gen):
        return model.reverse_kld(256, generator=gen)

    def build():
        model = snf_hais.build_snf(cuda, 0, mcmc)
        return model, torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True)

    model, opt = build()
    state, chunk = training.make_step_chunk(model, opt, loss_fn, 5)
    losses = chunk(state, torch.Generator(cuda).manual_seed(4))[1]["loss"]
    eager, eopt = build()
    estate, step = training.make_train_step(eager, eopt, loss_fn)
    gen = torch.Generator(cuda).manual_seed(4)
    eager_losses = torch.stack([step(estate, None, gen)[1]["loss"] for _ in range(5)])
    assert torch.equal(losses, eager_losses)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), eager.parameters()))


@pytest.mark.gpu
def test_mixture_draws_capture(cuda):
    """The mixture's inverse-CDF mode draw in a CUDA graph equals eager draws."""
    from normflows_tpu_torch.examples import change_base

    base = change_base.build_base("mixture", cuda)
    gen = torch.Generator(cuda).manual_seed(5)

    def draw():
        with torch.no_grad():
            return base.sample_and_log_prob(1024, generator=gen)

    graph, (z, log_p) = _captured(draw, gen)
    state = gen.get_state()
    graph.replay()
    got = (z.clone(), log_p.clone())
    gen.set_state(state)
    want = draw()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_captured_adapt_step_size_equals_eager_calls(cuda):
    """``adapt_step_size`` (HMC on TwoMoons, 512 chains, 12 iterations)
    captured whole with its generator registered (its loop then runs
    inside the outer capture): a replay equals, bit for bit, a call from
    the generator state it starts at (one iteration a replayed graph), and
    both equal the eager loop on the noise drawn from that state."""
    from normflows_tpu_torch.sampling import adapt_step_size

    hmc = nft.flows.HamiltonianMonteCarlo(nft.distributions.TwoMoons(device=cuda), 4,
                                          np.zeros(2, np.float32), np.zeros(2, np.float32),
                                          device=cuda)
    z = 1.5 * torch.randn(512, 2, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    gen = torch.Generator(cuda).manual_seed(4)

    def adapt():
        tuned, info = adapt_step_size(hmc, z, 12, generator=gen)
        return tuned.log_step_size.detach(), info["accept_rate"]

    graph, out = _captured(adapt, gen)
    state = gen.get_state()
    graph.replay()
    got = [t.clone() for t in out]
    gen.set_state(state)
    want = adapt()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gen.set_state(state)
    draws = [(torch.randn(512, 2, generator=gen, device=cuda),
              torch.randn(512, 2, generator=gen, device=cuda),
              torch.rand(512, generator=gen, device=cuda)) for _ in range(12)]
    tuned, info = adapt_step_size(hmc, z, 12, noise=[torch.stack(d) for d in zip(*draws)])
    assert torch.equal(tuned.log_step_size.detach(), want[0])
    assert torch.equal(info["accept_rate"], want[1])


@pytest.mark.gpu
def test_captured_smc_with_a_flow_proposal_equals_eager_calls(cuda):
    """``AnnealedSMC.sample`` with the flagship (12 circular AR spline
    layers of hidden 512) as proposal toward GaussianVonMises, 1,024
    particles, 4 temperatures of 3 leapfrog steps, captured whole: a replay
    equals an eager call bit for bit, the resampling flags too."""
    from normflows_tpu_torch.examples.nsf_cylinder import build_model
    from normflows_tpu_torch.sampling import AnnealedSMC

    smc = AnnealedSMC.create(build_model(cuda),
                             nft.distributions.GaussianVonMises(device=cuda), num_temps=4,
                             num_leapfrog=3)
    gen = torch.Generator(cuda).manual_seed(5)

    def draw():
        return (*smc.sample(1024, generator=gen), smc.last_resampled)

    graph, out = _captured(draw, gen)
    state = gen.get_state()
    graph.replay()
    got = [t.clone() for t in out]
    gen.set_state(state)
    want = draw()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(torch.isfinite(want[0]).all())


@pytest.mark.gpu
def test_scan_chain_chunk_equals_eager_and_unrolled(cuda):
    """The flagship's 12 layers as one ScanChain: a captured chunk of 3
    reverse-KL steps equals 3 eager steps (capturable Adam) bit for bit, and
    leaves every parameter bit-equal to the unrolled flagship's chunk (its
    losses within 1e-6 relative: the facade accumulates log q layer by
    layer, ScanChain sums the log-dets first)."""
    from normflows_tpu_torch.examples.nsf_cylinder import build_model
    from normflows_tpu_torch.training import make_step_chunk, make_train_step

    def build(scan):
        model = build_model(cuda)
        if scan:
            model.flows = torch.nn.ModuleList([nft.ScanChain.create(list(model.flows))])
        return model

    def adam(m):
        return torch.optim.Adam(m.parameters(), lr=5e-4, capturable=True)

    eager = build(True)
    state, step = make_train_step(eager, adam(eager), reverse_kld_1000)
    gen = torch.Generator(cuda).manual_seed(6)
    want = torch.stack([step(state, None, gen)[1]["loss"] for _ in range(3)])
    out = {}
    for scan in (True, False):
        model = build(scan)
        cstate, chunk = make_step_chunk(model, adam(model), reverse_kld_1000, chunk_len=3)
        _, metrics = chunk(cstate, torch.Generator(cuda).manual_seed(6))
        out[scan] = (metrics["loss"], {n: p.detach() for n, p in model.named_parameters()})
    assert torch.equal(out[True][0], want)
    for n, p in eager.named_parameters():
        assert torch.equal(out[True][1][n], p.detach()), n
    rel = ((out[True][0] - out[False][0]).abs() / out[False][0].abs()).max()
    assert float(rel) <= 1e-6
    for n, t in out[True][1].items():
        if n.startswith("flows.0.stacked."):
            path = n[len("flows.0.stacked."):]
            for i in range(t.shape[0]):
                assert torch.equal(t[i], out[False][1][f"flows.{i}.{path}"]), (n, i)


@pytest.mark.gpu
def test_nuts_leaf_graphs_equal_eager_leaves(cuda, monkeypatch):
    """NUTS with each leaf a replayed CUDA graph (on a card) against the
    same transitions op by op (``_leaf_graph`` stubbed out), on the
    pullback of the small flagship: draws, depths, leapfrog counts, picks
    and acceptance probabilities bit for bit, and the same host reads."""
    from normflows_tpu_torch.sampling import NUTS, PullbackTarget

    target = PullbackTarget(small_model(cuda, target=True))
    z0 = torch.randn(128, 2, generator=torch.Generator(cuda).manual_seed(7), device=cuda)
    out = {}
    for graphs in (True, False):
        if not graphs:
            monkeypatch.setattr(NUTS, "_leaf_graph", lambda self, bufs: None)
        nuts = NUTS.create(target, 2, step_size=0.3, max_depth=6, device=cuda)
        gen = torch.Generator(cuda).manual_seed(8)
        z, steps = z0, []
        for _ in range(3):
            z, st = nuts.transition(z, generator=gen)
            steps.append((z, st, nuts.host_reads, nuts.leaves))
        out[graphs] = steps
    for (za, sa, ra, la), (zb, sb, rb, lb) in zip(out[False], out[True]):
        assert torch.equal(za, zb) and (ra, la) == (rb, lb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.gpu
def test_smc_rung_graphs_equal_the_eager_ladder(cuda):
    """``AnnealedSMC.sample`` on a card (one temperature captured at the
    first call and replayed for each; the second call replays the cached
    graph) equals, bit for bit, the eager ladder of ``from_noise`` on the
    draws taken from the same generator state, the resampling flags too."""
    from normflows_tpu_torch.distributions.base import draw_noise
    from normflows_tpu_torch.sampling import AnnealedSMC

    smc = AnnealedSMC.create(small_model(cuda, target=True),
                             nft.distributions.GaussianVonMises(device=cuda), num_temps=5,
                             num_leapfrog=3)
    n, out = 2048, {}
    for seed in (9, 10):
        gen = torch.Generator(cuda).manual_seed(seed)
        graphed = (*smc.sample(n, generator=gen), smc.last_resampled)
        assert smc.last_graph is not None
        gen.manual_seed(seed)
        eps0 = draw_noise(smc.proposal.q0.noise_spec, (2,), n, generator=gen, device=cuda)
        noises = [(torch.rand((), generator=gen, device=cuda),
                   torch.randn(n, 2, generator=gen, device=cuda),
                   torch.rand(n, generator=gen, device=cuda)) for _ in range(4)]
        eager = (*smc.from_noise(eps0, noises), smc.last_resampled)
        assert smc.last_graph is None
        assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
        out[seed] = graphed
    assert not torch.equal(out[9][0], out[10][0])


@pytest.mark.gpu
def test_prefetch_to_device_copies_pinned_batches_to_the_card(cuda):
    """``data.prefetch_to_device`` on a card (pinned host buffers, copies on a
    copy stream, two batches in flight): every batch equals its host batch
    bit for bit, consumed on a stream of the caller's own, while the stream
    it waits on is kept busy."""
    from normflows_tpu_torch import data

    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, size=(96, 3, 8, 8), dtype=np.uint8)
    labels = rng.integers(0, 10, size=96)

    def loader():
        return data.NativeImageLoader(images, labels, batch_size=16, seed=3, num_workers=2)

    host = loader()
    want = [next(host) for _ in range(12)]
    host.close()
    source = loader()
    stream = data.prefetch_to_device(source, size=2, device=cuda)
    consumer = torch.cuda.Stream(cuda)
    got = []
    with torch.cuda.stream(consumer):
        busy = torch.randn(2048, 2048, device=cuda)
        for _ in range(12):
            busy = busy @ busy / 2048  # work queued ahead of each batch's use
            x, y, e = next(stream)
            got.append((x * 1.0, y + 0, e))
    torch.cuda.synchronize()
    source.close()
    for (x, y, e), (hx, hy, he) in zip(got, want):
        assert x.device.type == "cuda" and y.device.type == "cuda" and e == he
        assert torch.equal(x.cpu(), hx) and torch.equal(y.cpu(), hy)


@pytest.mark.gpu
def test_world_of_one_step_is_make_train_step(cuda):
    """``parallel.make_reverse_kld_step`` in a world of one (NCCL) equals
    ``make_train_step``'s reverse-KL step bit for bit on the same generator:
    the loss, every gradient and the parameters after Adam; 4 + 4 planar
    launches a step."""
    import torch.distributed as dist

    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.training import make_train_step

    started = not dist.is_initialized()
    try:
        mesh = parallel.make_mesh()
        assert dist.get_world_size() == 1
        out = []
        for data_parallel in (False, True):
            model = small_model(cuda, target=True)
            opt = torch.optim.Adam(model.parameters(), lr=5e-4)
            gen = torch.Generator(cuda).manual_seed(21)
            if data_parallel:
                state, step = parallel.make_reverse_kld_step(model, opt, mesh, 4096)
                run = lambda: step(state, gen)  # noqa: E731
            else:
                state, step = make_train_step(
                    model, opt, lambda m, b, g: m.reverse_kld(4096, generator=g))
                run = lambda: step(state, None, gen)  # noqa: E731
            spline_cuda.LAUNCHES = spline_cuda.BACKWARD_LAUNCHES = 0
            _, metrics = run()
            assert (spline_cuda.LAUNCHES, spline_cuda.BACKWARD_LAUNCHES) == (4, 4)
            out.append((metrics["loss"], {n: (p.grad.clone(), p.detach().clone())
                                          for n, p in model.named_parameters()}))
        (la, a), (lb, b) = out
        assert torch.equal(la, lb)
        for n in a:
            assert torch.equal(a[n][0], b[n][0]) and torch.equal(a[n][1], b[n][1]), n
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["tensor_parallel", "fsdp"])
def test_world_of_one_sharded_step_is_make_train_step(cuda, mode):
    """``parallel.make_tensor_parallel_step`` over {"model": 1} and
    ``make_fsdp_step`` over {"data": 1} (NCCL, hidden 64 so that every MADE
    layer is sharded) equal ``make_train_step``'s reverse-KL steps bit for
    bit on the same generator: the losses, every gradient and the
    parameters after two Adam steps; 4 + 4 planar launches a step."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.training import make_train_step

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    started = not dist.is_initialized()
    try:
        parallel.make_mesh()
        loss_fn = lambda m, b, g: m.reverse_kld(4096, generator=g)  # noqa: E731
        out = []
        for sharded in (False, True):
            model = small_model(cuda, target=True)
            adam = lambda ps: torch.optim.Adam(ps, lr=5e-4)  # noqa: E731
            if not sharded:
                state, step = make_train_step(model, adam(model.parameters()), loss_fn)
            elif mode == "tensor_parallel":
                state, step = parallel.make_tensor_parallel_step(
                    model, adam, loss_fn, parallel.make_mesh({"model": 1}), min_dim=16)
            else:
                state, step = parallel.make_fsdp_step(
                    model, adam, loss_fn, parallel.make_mesh({"data": 1}), min_size=256)
            gen = torch.Generator(cuda).manual_seed(22)
            losses = []
            for _ in range(2):
                spline_cuda.LAUNCHES = spline_cuda.BACKWARD_LAUNCHES = 0
                state, metrics = step(state, None, gen)
                assert (spline_cuda.LAUNCHES, spline_cuda.BACKWARD_LAUNCHES) == (4, 4)
                losses.append(metrics["loss"])
            assert sharded == any(isinstance(p, DTensor) for p in state.model.parameters())
            out.append((losses, {n: (local(p.grad).clone(), local(p).detach().clone())
                                 for n, p in state.model.named_parameters()}))
        (la, a), (lb, b) = out
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
        for n in a:
            assert torch.equal(a[n][0], b[n][0]) and torch.equal(a[n][1], b[n][1]), n
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """Tensor-parallel state on the card (DTensors over {"model": 1})
    through ``training.save_checkpoint`` (torch.distributed.checkpoint)
    restored into a fresh step's state and into ``make_train_step``'s plain
    state: every tensor bit-equal, and one more step from each bit-equal to
    the uninterrupted step."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from normflows_tpu_torch import parallel, training

    def local(t):
        return (t.to_local() if isinstance(t, DTensor) else t).detach()

    started = not dist.is_initialized()
    try:
        parallel.make_mesh()
        mesh = parallel.make_mesh({"model": 1})
        loss_fn = lambda m, b, g: m.reverse_kld(4096, generator=g)  # noqa: E731

        def adam(ps):
            return torch.optim.Adam(ps, lr=5e-4)

        state, step = parallel.make_tensor_parallel_step(small_model(cuda, target=True), adam,
                                                         loss_fn, mesh, min_dim=16)
        gen = torch.Generator(cuda).manual_seed(23)
        for _ in range(2):
            state, _ = step(state, None, gen)
        training.save_checkpoint(str(tmp_path / "ckpt"), state)
        fresh, fresh_step = parallel.make_tensor_parallel_step(
            small_model(cuda, target=True), adam, loss_fn, mesh, min_dim=16)
        fresh = training.restore_checkpoint(str(tmp_path / "ckpt"), fresh)
        model = small_model(cuda, target=True)
        plain = training.restore_checkpoint(
            str(tmp_path / "ckpt"), training.TrainState(model, adam(model.parameters())))
        _, plain_step = training.make_train_step(plain.model, plain.optimizer, loss_fn)
        assert fresh.step == plain.step == 2
        for restored in (fresh, plain):
            got = dict(restored.model.named_parameters())
            for n, p in state.model.named_parameters():
                assert torch.equal(local(got[n]), local(p)), n
                for k, v in state.optimizer.state[p].items():
                    assert torch.equal(local(restored.optimizer.state[got[n]][k]), local(v)), (n, k)
        after = []
        for s, st in ((step, state), (fresh_step, fresh), (plain_step, plain)):
            st, metrics = s(st, None, torch.Generator(cuda).manual_seed(24))
            after.append((metrics["loss"], [local(p) for _, p in st.model.named_parameters()]))
        for loss, params in after[1:]:
            assert torch.equal(loss, after[0][0])
            assert all(torch.equal(a, b) for a, b in zip(params, after[0][1]))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.gpu
def test_circular_nsf_chunk_is_bit_equal_to_eager_steps(cuda):
    """``examples.circular_nsf``'s step (the target drawn on the card inside
    the step, forward KL, AdamW) at its width (hidden 128, batch 1,024; 4 of
    its 20 layers): a captured chunk of 5 steps against 5 eager steps of
    the same capturable AdamW from the same weights and generator seed, bit
    for bit."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import circular_nsf

    def loss_fn(model, batch, gen):
        return model.forward_kld(circular_nsf.sample_target(1024, gen, cuda))

    model = circular_nsf.build_model(cuda, K=4)
    state, chunk = circular_nsf.make_chunk(model, 1e-3, 1024, 5)
    losses = chunk(state, torch.Generator(cuda).manual_seed(5))[1]["loss"]
    eager = circular_nsf.build_model(cuda, K=4)
    opt = torch.optim.AdamW(eager.parameters(), lr=1e-3, weight_decay=1e-4, capturable=True)
    estate, step = training.make_train_step(eager, opt, loss_fn)
    gen = torch.Generator(cuda).manual_seed(5)
    eager_losses = torch.stack([step(estate, None, gen)[1]["loss"] for _ in range(5)])
    assert torch.equal(losses, eager_losses)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), eager.parameters()))


@pytest.mark.gpu
def test_captured_beta_is_the_scripts(cuda):
    """``examples.augmented_flow``'s beta, computed on the card from the
    chunk's step count inside the captured step, at step counts 0, 500,
    999, 1,000 and 1,500 set between replays: the JAX script's
    ``min(1.0, 0.01 + i / 1000)`` in float32, bit for bit."""
    from normflows_tpu_torch.examples import augmented_flow

    model = augmented_flow.initialised_model(cuda, K=2)
    state, chunk = augmented_flow.make_chunk(model, 1e-4, 64, 1000, 1)
    seen = torch.zeros((), device=cuda)
    beta_of = chunk.batch_fn

    def noted(step, generator):
        beta = beta_of(step, generator)
        seen.copy_(beta)
        return beta

    chunk.batch_fn = noted
    gen = torch.Generator(cuda).manual_seed(6)
    for i in (0, 500, 999, 1000, 1500):
        state.step.fill_(i)
        chunk(state, gen)
        assert float(seen) == float(np.float32(min(1.0, 0.01 + i / 1000))), i
        assert int(state.step) == i + 1


@pytest.mark.gpu
def test_glow_float32_chunk_is_bit_equal_to_eager_steps(cuda):
    """Glow at model A's geometry (L = 3, hidden 256, CIFAR-10's 3 x 32 x
    32, batch 128; 2 of its 16 blocks a level) in float32: a captured chunk
    of 5 Adamax steps against 5 eager steps of the same capturable Adamax,
    windows and generator seed, bit for bit, and two eager runs alike.
    cuDNN's default float32 weight gradient there adds with atomics; its
    deterministic algorithms (``nets.cnn.fp32_convs``) give the same bits on
    every run."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import glow_image

    x, y = glow_image.synthetic_images(1024, seed=2)

    def built():
        model = glow_image.build_glow(3, 2, 256, (3, 32, 32), 10, device=cuda, seed=2)
        model.init_actnorm(*(t.to(cuda) for t in glow_image.init_inputs(x, y, 128, 2)))
        return model

    model = built()
    state, chunk = glow_image.make_chunk(model, 1e-3, 128, x, y, chunk=5)
    losses = chunk(state, torch.Generator(cuda).manual_seed(7))[1]["loss"]
    xd, yd = x.to(cuda), y.to(cuda)
    runs = []
    for _ in range(2):
        eager = built()
        estate, step = training.make_train_step(
            eager, glow_image.make_optimizer(eager, 1e-3),
            lambda m, b, g: m.forward_kld(glow_image.dequantise(b[0], g), b[1]))
        gen = torch.Generator(cuda).manual_seed(7)
        eager_losses = []
        for i in range(5):
            s = (i * 128) % (x.shape[0] - 128 + 1)
            eager_losses.append(step(estate, (xd[s:s + 128], yd[s:s + 128]), gen)[1]["loss"])
        runs.append((eager, torch.stack(eager_losses)))
    for eager, eager_losses in runs:
        assert torch.equal(losses, eager_losses)
        assert all(torch.equal(p, q) for p, q in zip(model.parameters(), eager.parameters()))
