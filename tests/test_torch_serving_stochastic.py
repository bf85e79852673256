"""Serving bundles of the models past plain flows (``normflows_tpu_torch.
serving`` on stochastic normalizing flows, residual flows, ``HAIS`` and
``AnnealedSMC``) on the CPU, against the JAX package's exported samplers and
the live port models, at small sizes (2 layers or blocks, widths 16, 3-4
rungs or temperatures):

* each family's loaded sampler program on JAX's draws, re-derived from
  ``jax.random.key(seed)`` by repeating the JAX package's key splits,
  against ``normflows_tpu.serving.export_sampler(jm, n).call(seed)``, at
  the bars of the family's live-model tests (tests/test_torch_stochastic.py,
  tests/test_torch_sampling.py, tests/test_torch_residual.py);
* each loaded sampler against the live model's ``sample`` on a generator
  seeded alike, bit for bit, and the flagship-proposal SMC bundle (the
  planar spline operator and its backward inside a program) too;
* the residual bundle's ``log_prob`` on a symbolic batch against the JAX
  package's exported one in eval mode, and against the live model;
* ``save_bundle`` refusing exactly the models whose ``log_prob`` the JAX
  package's ``export_log_prob`` (and so its ``save_bundle``) fails on, and
  NUTS and NeuTra refused by ``export_sampler`` with the reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu import serving as jserving
from normflows_tpu.nets import MLP as JMLP
from normflows_tpu.sampling import AnnealedSMC as JSMC
from normflows_tpu_torch import NormalizingFlow, serving
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.examples.residual_twomoons import set_train
from normflows_tpu_torch.nets import MLP
from normflows_tpu_torch.sampling import NUTS, AnnealedSMC, NeuTraHMC
from tests.helpers import assert_close
from tests.test_torch_residual import Y_TOL, block_draws
from tests.test_torch_residual import TOL as RES_TOL
from tests.test_torch_residual_train import model_pair
from tests.test_torch_sampling import LOGZ_TOL, smc_draws, smc_pair, spline_flows
from tests.test_torch_sampling import TOL as SMC_TOL
from tests.test_torch_stochastic import hais_pair, ported

torch.set_num_threads(2)

N, SEEDS = 32, (3, 11)
# the families' model-level bars against JAX (samples, log-density)
SNF_TOL = (1e-5, 1e-5)  # tests/test_torch_stochastic.py's SNF path
HAIS_TOL = (1e-6, 1e-5)  # its HAIS ladder: z, log_w
SMC_TOLS = (SMC_TOL, SMC_TOL, LOGZ_TOL)  # tests/test_torch_sampling.py


def t(a):
    return torch.from_numpy(np.array(a))


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


# ---- the families: (JAX model, port model, JAX's draws in the program's layout) -----

def snf_pair(mcmc):
    """2 couplings on MLP [2, 16, 2] (random nets), each followed by an MH
    layer of 2 steps or an HMC layer of 2 leapfrog steps, toward TwoMoons."""
    jl, tl = [], []
    b = np.array([1.0, 0.0], np.float32)
    for i in range(2):
        k1, k2 = jax.random.split(jax.random.key(30 + i))
        mask = b if i % 2 == 0 else 1 - b
        jl.append(jflows.MaskedAffineFlow.create(jnp.asarray(mask), t=JMLP.create(k1, [2, 16, 2]),
                                                 s=JMLP.create(k2, [2, 16, 2])))
        g = torch.Generator().manual_seed(i)
        tl.append(tflows.MaskedAffineFlow(torch.from_numpy(mask),
                                          t=MLP.create(g, [2, 16, 2], device="cpu"),
                                          s=MLP.create(g, [2, 16, 2], device="cpu"),
                                          device="cpu"))
        if mcmc == "mh":
            jl.append(jflows.MetropolisHastings(
                target=jdist.TwoMoons(), proposal=jdist.DiagGaussianProposal.create((2,), 0.3),
                steps=2))
            tl.append(tflows.MetropolisHastings(
                tdist.TwoMoons(device="cpu"), tdist.DiagGaussianProposal((2,), 0.3, device="cpu"),
                2))
        else:
            jl.append(jflows.HamiltonianMonteCarlo.create(
                jdist.TwoMoons(), 2, jnp.full(2, np.log(0.2)), jnp.asarray([0.1, -0.2])))
            tl.append(tflows.HamiltonianMonteCarlo(tdist.TwoMoons(device="cpu"), 2, np.zeros(2),
                                                   np.zeros(2), device="cpu"))
    jm = jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), jl, p=jdist.TwoMoons())
    tm = NormalizingFlow.create(tdist.DiagGaussian(2, device="cpu"), tl,
                                p=tdist.TwoMoons(device="cpu"), device="cpu")
    return jm, ported(jm, tm)


def snf_draws(jm, key, n):
    """``NormalizingFlow.sample_and_log_prob(key, n)``'s draws: the base's
    from the first half of the key, each flow's from its part of the
    second (an MH layer's from one key a step, split for the proposal and
    the accept uniforms; an HMC layer's split likewise)."""
    kq, kf = jax.random.split(key)
    draws = []
    for flow, k in zip(jm.flows, jax.random.split(kf, len(jm.flows))):
        if isinstance(flow, jflows.MetropolisHastings):
            steps = [jax.random.split(sk) for sk in jax.random.split(k, flow.steps)]
            draws.append((np.stack([normal(kp, (n, 2)) for kp, _ in steps]),
                          np.stack([uniform(ka, (n,)) for _, ka in steps])))
        elif isinstance(flow, jflows.HamiltonianMonteCarlo):
            kp, ka = jax.random.split(k)
            draws.append((normal(kp, (n, 2)), uniform(ka, (n,))))
    return normal(kq, (n, 2)), draws


def hais_family():
    jh, th = hais_pair(betas=5, leapfrog=2)
    return jh, th


def hais_draws(jh, key, n):
    """``HAIS.sample(key, n)``'s draws: the prior's from the first of
    ``len(layers) + 1`` keys, each rung's from its own, split for the
    momentum and the accept uniforms; stacked over the rungs."""
    keys = jax.random.split(key, len(jh.layers) + 1)
    rungs = [jax.random.split(k) for k in keys[1:]]
    return normal(keys[0], (n, 2)), [(np.stack([normal(kp, (n, 2)) for kp, _ in rungs]),
                                      np.stack([uniform(ka, (n,)) for _, ka in rungs]))]


def smc_family():
    jp, tp, jt, tt = smc_pair("diag")
    betas = (0.0, 0.3, 0.7, 1.0)
    return (JSMC.create(jp, jt, betas=betas, num_leapfrog=2, step_size=0.2),
            AnnealedSMC.create(tp, tt, betas=betas, num_leapfrog=2, step_size=0.2))


def smc_family_draws(jsmc, key, n):
    eps0, noises = smc_draws(key, "diag", n, len(jsmc.betas))
    return eps0, [tuple(np.stack(column) for column in zip(*noises))]


def residual_family(train):
    jm, tm = model_pair(K=2)
    jm = jm.replace(flows=tuple(f.set_train(train) if isinstance(f, jflows.Residual) else f
                                for f in jm.flows))
    return jm, set_train(tm, train)


def residual_draws(jm, key, n):
    """``sample_and_log_prob(key, n)`` of a residual model: the base's
    draws, then each block's estimator draws in the sampling direction
    (none in eval mode in 2-D)."""
    kq, kf = jax.random.split(key)
    draws = []
    for flow, k in zip(jm.flows, jax.random.split(kf, len(jm.flows))):
        if isinstance(flow, jflows.Residual):
            got = block_draws(flow.iresblock, k, (n, 2))
            if got:
                draws.append(tuple(v for _, v in got))
    return normal(kq, (n, 2)), draws


FAMILIES = {
    "snf_mh": (lambda: snf_pair("mh"), snf_draws, SNF_TOL),
    "snf_hmc": (lambda: snf_pair("hmc"), snf_draws, SNF_TOL),
    "hais": (hais_family, hais_draws, HAIS_TOL),
    "smc": (smc_family, smc_family_draws, SMC_TOLS),
    "residual_eval": (lambda: residual_family(False), residual_draws, (Y_TOL, RES_TOL)),
    "residual_train": (lambda: residual_family(True), residual_draws, (Y_TOL, RES_TOL)),
}
# the families whose log_prob the JAX package exports: a bundle with both programs
WITH_LOG_PROB = ("residual_eval",)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """``get(name)``: (name, JAX model, port model, loaded bundle,
    manifest), each family's built and saved once for the module."""
    made = {}

    def get(name):
        if name not in made:
            jm, tm = FAMILIES[name][0]()
            path = str(tmp_path_factory.mktemp(name))
            event = (2,) if name in WITH_LOG_PROB else None
            manifest = serving.save_bundle(tm, path, N, event)
            made[name] = name, jm, tm, serving.load_bundle(path), manifest
        return made[name]

    return get


@pytest.fixture(params=list(FAMILIES))
def family(request, bundles):
    return bundles(request.param)


def test_loaded_sampler_matches_the_jax_export_on_its_draws(family):
    name, jm, _, bundle, _ = family
    _, derive, tols = FAMILIES[name]
    exported = jserving.export_sampler(jm, N)
    for seed in SEEDS:
        want = exported.call(np.uint32(seed))
        eps, draws = derive(jm, jax.random.key(seed), N)
        with torch.no_grad():
            got = bundle._sample(t(eps), [tuple(map(t, d)) for d in draws])
        assert len(got) == len(want) == len(bundle.manifest["outputs"])
        for g, w, tol in zip(got, want, tols):
            assert_close(g.numpy(), np.asarray(w), atol=tol, rtol=tol, msg=f"{name} {seed}")


def test_loaded_sampler_is_bit_equal_to_the_live_model(family):
    name, _, tm, bundle, manifest = family
    assert manifest["kind"] == {"hais": "hais", "smc": "smc"}.get(name, "program")
    for seed in SEEDS:
        got = bundle.sample(seed)
        with torch.no_grad():
            live = tm.sample(N, generator=torch.Generator().manual_seed(seed))
        assert all(torch.equal(a, b) for a, b in zip(got, live)), name


def test_manifest_lays_out_every_draw(family):
    """The manifest's layouts give the program's inputs: the base's noise,
    then one tuple a drawing layer, or the rungs' stacked; the route is eager
    where the program loops to a fixed point."""
    name, _, tm, bundle, manifest = family
    eps, draws = bundle.noise(0)
    assert eps.shape == (N, 2) and len(draws) == len(manifest["draws"])
    repeats = {"snf_mh": [2, 2], "snf_hmc": [None, None], "hais": [3], "smc": [3],
               "residual_eval": [], "residual_train": [None, None]}[name]
    assert [d["repeat"] for d in manifest["draws"]] == repeats
    assert manifest["route"] == ("eager" if name.startswith("residual") else "graphed")
    if name not in WITH_LOG_PROB:
        with pytest.raises(ValueError, match="no log_prob program"):
            bundle.log_prob(torch.zeros(4, 2))


def test_residual_log_prob_on_a_symbolic_batch_matches_jax_and_the_live_model(bundles):
    _, jm, tm, bundle, manifest = bundles("residual_eval")
    assert manifest["symbolic_batch"] and manifest["kernel_ops"]["log_prob"] == []
    exported = jserving.export_log_prob(jm, (2,))
    rng = np.random.default_rng(5)
    for b in (1, 7, 300):
        x = rng.normal(size=(b, 2)).astype(np.float32)
        got = bundle.log_prob(t(x))
        with torch.no_grad():
            assert torch.equal(got, tm.log_prob(t(x)))
        assert_close(got.numpy(), np.asarray(exported.call(jnp.asarray(x))), atol=RES_TOL,
                     rtol=RES_TOL)


def test_flow_proposal_smc_bundle_runs_the_spline_operators_bit_equal(tmp_path):
    """The flagship cut to 1 layer as SMC's proposal: its program holds the
    planar spline operator and its backward (the gradient of log q in each
    move, through the operator's autograd), and equals the live sampler."""
    _, tm = spline_flows(layers=1, hidden=8)
    smc = AnnealedSMC.create(tm, tdist.GaussianVonMises(device="cpu"), num_temps=3,
                             num_leapfrog=2)
    manifest = serving.save_bundle(smc, str(tmp_path), N, None)
    assert manifest["kernel_ops"]["sample"] == ["normflows_tpu_torch::rqs_transposed",
                                                "normflows_tpu_torch::rqs_transposed_backward"]
    bundle = serving.load_bundle(str(tmp_path))
    got = bundle.sample(7)
    with torch.no_grad():
        live = smc.sample(N, generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(a, b) for a, b in zip(got, live))


def jax_log_prob_refused(jm):
    """Whether the JAX package's ``save_bundle`` fails on ``jm``: it exports
    the sampler, then ``log_prob``, which fails where it draws (no key) or
    where there is none."""
    try:
        jserving.export_log_prob(jm, (2,))
    except (ValueError, AttributeError):
        return True
    return False


@pytest.mark.parametrize("name", ["plain", *FAMILIES])
def test_save_bundle_refuses_where_the_jax_package_does(name, tmp_path):
    if name == "plain":
        jm = jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), [], p=jdist.TwoMoons())
        tm = NormalizingFlow.create(tdist.DiagGaussian(2, device="cpu"), [], device="cpu")
    else:
        jm, tm = FAMILIES[name][0]()
    refused = jax_log_prob_refused(jm)
    assert refused == (name not in ("plain", *WITH_LOG_PROB))
    if refused:
        with pytest.raises(ValueError, match="event_shape=None"):
            serving.save_bundle(tm, str(tmp_path), N, (2,))
        assert not list(tmp_path.iterdir())  # refused before anything is written
    else:
        assert serving._log_prob_refusal(tm) is None


def test_nuts_and_neutra_are_refused_with_the_reason():
    nuts = NUTS.create(tdist.TwoMoons(device="cpu"), 2, step_size=0.2, max_depth=3,
                       device="cpu")
    _, flow = spline_flows(layers=1, hidden=8)
    for sampler in (nuts, NeuTraHMC.create(flow)):
        with pytest.raises(NotImplementedError, match="step count"):
            serving.export_sampler(sampler, N)
