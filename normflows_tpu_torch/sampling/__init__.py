"""Samplers of the port: Hamiltonian annealed importance sampling, HMC
step-size adaptation by dual averaging, annealed SMC, NeuTra HMC and the
No-U-Turn sampler."""

from . import adaptation, hais, neutra, nuts, smc
from .adaptation import (DualAveragingState, adapt_step_size, dual_averaging_init,
                         dual_averaging_update, hmc_accept_prob)
from .hais import HAIS
from .neutra import NeuTraHMC, PullbackTarget
from .nuts import NUTS
from .smc import AnnealedSMC, SMCState, effective_sample_size, systematic_resample

__all__ = ["HAIS", "AnnealedSMC", "NUTS", "NeuTraHMC", "PullbackTarget", "DualAveragingState",
           "adapt_step_size", "dual_averaging_init", "dual_averaging_update", "hmc_accept_prob",
           "effective_sample_size", "systematic_resample", "SMCState"]
