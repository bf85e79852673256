"""normflows_tpu_torch: the PyTorch and CUDA port of ``normflows_tpu``.

It runs on an NVIDIA Hopper card (``device="cuda"``, the default of every
constructor) or, for tests, on the CPU (``device="cpu"``), where each kernel
wrapper takes its kernel's plain PyTorch version.  It imports neither JAX nor
anything of ``normflows_tpu``; ``interop.load_jax_leaves`` takes the JAX
model's weights as numpy arrays.

It holds the serving path of the flagship circular neural spline flow
(``NormalizingFlow.sample`` / ``sample_and_log_prob`` and ``log_prob``) and
its training step (``forward_kld``, ``reverse_kld`` and
``training.make_train_step``), the same for the large-D autoregressive
flows (more than 8 features, sampled by the sliced sequential inverse:
``MaskedAffineAutoregressive`` and the autoregressive RQ splines, with
``LULinearPermute`` between them), and for the coupled RQ-spline flows
(``CoupledRationalQuadraticSpline`` and its circular form, on a
``ResidualNet``; ``TwoMoons`` with the rejection sampler of ``Target``).
Real NVP, the README's first model, is ``MaskedAffineFlow`` layers on
``MLP`` nets (``flows.affine.coupling`` holds the other affine couplings,
``flows.reshape`` the feature split).
``training.make_step_chunk`` and ``training.make_chunked_train_step``
train many steps a call, one step captured in a CUDA graph and replayed;
``training.save_checkpoint`` / ``restore_checkpoint`` keep a training state,
``NormalizingFlow.save`` / ``load`` a model.  ``serving`` exports a model's
sampler and ``log_prob`` as ``torch.export`` programs over the kernels'
operators (``ops.backend.kernel_op``), saves them as a bundle and serves a
loaded bundle, the sampler as a CUDA graph on a card.
``ConditionalNormalizingFlow`` holds the conditional flows: a context
through MADE and ``ResidualNet`` and both autoregressive paths, with
``distributions.ConditionalDiagGaussian`` (base) and
``ConditionalDiagGaussianTarget``.
Glow's image path: ``MultiscaleFlow`` (class-conditional or not) of
``flows.GlowBlock`` levels with ``flows.Squeeze`` and ``flows.Merge``, on
``distributions.ClassCondDiagGaussian`` or ``GlowBase`` bases, ``ClassCondFlow``,
``transforms.Logit``, ``utils.preprocessing`` and ``utils.eval``
(bits/dim); the coupling splines on images through ``nets.ConvResidualNet``.
``examples.glow_image`` trains a class-conditional Glow.
Residual flows: ``flows.Residual`` on ``nets.LipschitzMLP`` /
``LipschitzCNN``, trained with ``utils.update_lipschitz`` after each step
(the trainers' ``update_lipschitz_iters``, inside a captured chunk too);
``examples.residual_twomoons`` trains one.  The small flows
(``flows.Planar``, ``Radial``, ``PeriodicWrap``, ``PeriodicShift``) and the
Rezende–Mohamed energies of ``distributions.prior``;
``examples.planar_radial_comparison`` trains them by reverse KL.
Stochastic normalizing flows: ``flows.MetropolisHastings`` and
``flows.HamiltonianMonteCarlo`` (HMC's step size and mass learnt through a
double backward), ``sampling.HAIS`` (annealed importance sampling);
``examples.snf_hais`` draws from an SNF and estimates a log normaliser.
The flow-VAE: ``NormalizingFlowVAE`` with the encoders and decoders of
``distributions``; ``examples.vae_flow`` and ``examples.plain_vae`` train
it.  The bases ``distributions.GaussianMixture``, ``GaussianPCA`` and
``AffineGaussian``; ``examples.change_base`` trains Real NVP from a
Gaussian and from a mixture.
``examples.nsf_cylinder`` trains the flagship to convergence,
``examples.conditional_flow`` trains the conditional NSF and samples it,
``examples.real_nvp_twomoons`` trains Real NVP and serves it, and
``examples.spline_bwd_ablate`` times the four variants of the flat spline
backward's ablation kernel.
``data`` is the native C++ image pipeline and ``prefetch_to_device`` (pinned
host memory, copies on a copy stream); ``parallel`` runs data and chain
parallelism over ``torch.distributed`` processes, one card a rank
(``examples.data_parallel_training``, ``examples.native_data_pipeline``,
under ``torchrun`` or as one process).
"""

from . import (core, data, distributions, flows, interop, nets, ops, parallel, sampling, serving,
               training, transforms, utils)
from .core.flow import Composite, Flow, Identity, Reverse, ScanChain
from .core.facades import (ClassCondFlow, ConditionalNormalizingFlow, MultiscaleFlow,
                           NormalizingFlow, NormalizingFlowVAE, load_model, save_model)
from .sampling import HAIS

__version__ = "0.1.0"
