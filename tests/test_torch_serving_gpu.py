"""Serving bundles on the card (``normflows_tpu_torch.serving``): exported,
loaded and replayed as CUDA graphs, against the live model bit for bit,
with the kernels' launches counted on the card.  The models are
tests/test_torch_gpu.py's small ones.

Every test is marked ``gpu`` and skips where no CUDA card is present.  This
file imports no JAX, so that it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py tests/test_torch_serving_gpu.py -m gpu \\
        --noconftest -q
"""

import pytest
import torch

from normflows_tpu_torch.ops import spline_cuda, spline_flat
from test_torch_gpu import coupled_model, cuda, large_d_model, small_model  # noqa: F401


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flagship", "coupled"])
def test_bundle_on_the_card_is_bit_equal_eager_and_graphed(cuda, kind, tmp_path):
    """A bundle (``serving.save_bundle``) of a small flagship and a small
    coupled model, exported and loaded on the card: its sampler from a seed,
    eagerly and as the CUDA graph it replays after the first call, gives the
    live model's ``sample`` from the same seed bit for bit, and each request
    launches its kernels (4 planar or 4 flat ones, counted on the card; the
    graph replays them with no Python); one ``log_prob`` program serves
    batches 1, 7 and 1000 bit-equal to the live model."""
    from normflows_tpu_torch import serving

    model = small_model(cuda) if kind == "flagship" else coupled_model(cuda)
    module = spline_cuda if kind == "flagship" else spline_flat
    manifest = serving.save_bundle(model, str(tmp_path), 1000, (2,))
    assert manifest["device"] == "cuda:0"
    bundle = serving.load_bundle(str(tmp_path))
    with torch.inference_mode():
        x, log_q = model.sample(1000, generator=torch.Generator(device=cuda).manual_seed(7))
    on_card = torch.zeros(2, 2, dtype=torch.int64, device=cuda)
    module.DEVICE_LAUNCHES = on_card
    try:
        eager = bundle.sample(7, graphed=False)
        assert on_card.tolist() == [[0, 4], [0, 0]]
        bundle.sample(8)  # captures
        on_card.zero_()
        before = module.LAUNCHES
        graphed = bundle.sample(7)
        assert on_card.tolist() == [[0, 4], [0, 0]] and module.LAUNCHES == before
    finally:
        module.DEVICE_LAUNCHES = None
    for got in (eager, graphed):
        assert torch.equal(got[0], x) and torch.equal(got[1], log_q)
    for b in (1, 7, 1000):
        with torch.inference_mode():
            want = model.log_prob(x[:b])
        assert torch.equal(bundle.log_prob(x[:b]), want)


@pytest.mark.gpu
def test_large_d_log_prob_bundle_serves_every_batch_on_the_card(cuda, tmp_path):
    """The large-D model's log_prob bundle, one program with a symbolic
    batch, at batches 1, 7 and 1000 on the card: bit-equal to the live
    model, one flat launch a layer.  At batch 1 the program's relayout of
    the parameters gives views that the traced batch gave as copies; the
    operator lays them out as the kernel takes them."""
    from normflows_tpu_torch import serving

    model = large_d_model(cuda)
    serving.save_bundle(model, str(tmp_path), None, (64,))
    bundle = serving.load_bundle(str(tmp_path))
    x = 1.5 * torch.randn(1000, 64, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(5))
    for b in (1, 7, 1000):
        before = spline_flat.LAUNCHES
        got = bundle.log_prob(x[:b])
        assert spline_flat.LAUNCHES == before + 2
        with torch.inference_mode():
            assert torch.equal(got, model.log_prob(x[:b]))


@pytest.mark.gpu
def test_class_conditional_glow_bundle_on_the_card(cuda, tmp_path):
    """A small class-conditional Glow's bundle on the card (``class_cond=True``):
    its sampler at given labels from a seed, eagerly and replayed as a CUDA
    graph on (noise, y), and ``log_prob(x, y)`` at batches 1 and 16, bit
    for bit against the live model; no kernel of the port launched."""
    from normflows_tpu_torch import serving
    from normflows_tpu_torch.examples import glow_image

    x, y = glow_image.synthetic_images(16, (3, 8, 8), 4, seed=2)
    x, y = x.to(cuda), y.to(cuda)
    model = glow_image.build_glow(2, 2, 16, (3, 8, 8), 4, device=cuda, seed=2)
    model.init_actnorm(x, y)
    serving.save_bundle(model, str(tmp_path), 16, (3, 8, 8), class_cond=True)
    bundle = serving.load_bundle(str(tmp_path))
    labels = y.to(torch.int32)
    with torch.inference_mode():
        want = model.sample(16, y, generator=torch.Generator(device=cuda).manual_seed(5))
    before = spline_flat.LAUNCHES + spline_cuda.LAUNCHES
    eager = bundle.sample(5, labels, graphed=False)
    bundle.sample(6, labels)  # captures
    graphed = bundle.sample(5, labels)
    assert spline_flat.LAUNCHES + spline_cuda.LAUNCHES == before
    for got in (eager, graphed):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for b in (1, 16):
        with torch.inference_mode():
            assert torch.equal(bundle.log_prob(x[:b], y[:b]), model.log_prob(x[:b], y[:b]))


def stochastic_model(kind, device):
    """The bundles past plain flows, small: the SNF of examples/snf_hais.py
    at 2 blocks (MH or HMC), its HAIS at 4 rungs of 3 leapfrog steps, and
    annealed SMC on the small flagship (3 temperatures, 3 leapfrog steps)."""
    from normflows_tpu_torch import distributions as D
    from normflows_tpu_torch.examples import snf_hais
    from normflows_tpu_torch.sampling import AnnealedSMC

    if kind in ("snf_mh", "snf_hmc"):
        model = snf_hais.build_snf(device, 0, kind[4:])
        model.flows = torch.nn.ModuleList(list(model.flows)[:4])
        return model
    if kind == "hais":
        return snf_hais.build_hais(device, betas=6, leapfrog=3)
    return AnnealedSMC.create(small_model(device), D.GaussianVonMises(device=device),
                              num_temps=3, num_leapfrog=3)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["snf_mh", "snf_hmc", "hais", "smc"])
def test_stochastic_bundle_replays_its_graph_bit_equal(cuda, kind, tmp_path):
    """A sampler-only bundle of each family that replays as a CUDA graph:
    the graph (after the call that captures it) gives the eager program's
    draws from the same seed, and the live model's ``sample``, bit for
    bit."""
    from normflows_tpu_torch import serving

    model = stochastic_model(kind, cuda)
    manifest = serving.save_bundle(model, str(tmp_path), 512, None)
    assert manifest["route"] == "graphed" and manifest["device"] == "cuda:0"
    bundle = serving.load_bundle(str(tmp_path))
    eager = bundle.sample(3, graphed=False)
    bundle.sample(4)  # captures
    graphed = bundle.sample(3)
    with torch.no_grad():
        live = model.sample(512, generator=torch.Generator(device=cuda).manual_seed(3))
    for got in (graphed, live):
        assert all(torch.equal(a, b) for a, b in zip(eager, got))


def scan_extra_calls():
    """How many calls of its body more than its length the installed
    torch's eager ``scan`` makes (0, or 1 where it runs element 0 twice)."""
    calls = []

    def body(carry, x):
        calls.append(x)
        return carry + x, x

    with torch.no_grad():
        torch.ops.higher_order.scan(body, [torch.zeros(())], [torch.arange(3.0)], ())
    return len(calls) - 3


@pytest.mark.gpu
def test_smc_bundle_launches_the_planar_kernels_it_predicts(cuda, tmp_path):
    """The SMC bundle's planar launches a request on the card's counters:
    the proposal's draw 2 inverse launches a layer; each temperature one
    forward evaluation of the proposal's log-density for the reweighting
    and, in the move, L + 1 of its value and gradient (forward and
    backward), each scan running its body ``scan_extra_calls()`` more
    times; the same counts eager and replayed as a graph."""
    from normflows_tpu_torch import serving

    smc = stochastic_model("smc", cuda)
    layers, L, e = len(smc.proposal.flows), smc.num_leapfrog, scan_extra_calls()
    rungs, evals = len(smc.betas) - 1 + e, L + 1 + e
    want = [[rungs * (1 + evals) * layers, 2 * layers], [rungs * evals * layers, 0]]
    manifest = serving.save_bundle(smc, str(tmp_path), 512, None)
    assert manifest["kernel_ops"]["sample"] == ["normflows_tpu_torch::rqs_transposed",
                                                "normflows_tpu_torch::rqs_transposed_backward"]
    bundle = serving.load_bundle(str(tmp_path))
    on_card = torch.zeros(2, 2, dtype=torch.int64, device=cuda)
    spline_cuda.DEVICE_LAUNCHES = on_card
    try:
        bundle.sample(5, graphed=False)
        assert on_card.tolist() == want
        bundle.sample(6)  # captures
        on_card.zero_()
        bundle.sample(5)
        assert on_card.tolist() == want
    finally:
        spline_cuda.DEVICE_LAUNCHES = None
