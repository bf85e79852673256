"""``AnnealedSMC`` with a flow proposal (the flagship cut to 2 circular AR
spline layers of hidden 8, random weights, toward GaussianVonMises) against
the JAX package's on JAX's own draws: particles, ``log_w``, ``log_z`` and
the resampling decisions, and a generator against the noise drawn from it
(the check of tests/test_torch_sampling.py, in a file of its own: most of
its time is JAX's compile of the jitted ladder)."""

from tests.test_torch_sampling import check_annealed_smc


def test_annealed_smc_with_a_flow_proposal_matches_jax(monkeypatch):
    check_annealed_smc("flow", monkeypatch)
