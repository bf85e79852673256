#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``normflows_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--phases a,b,...]

Run from the root of a checkout.  It builds the CUDA kernels from the sources
in the checkout (one ``nvcc`` per source, started together), holds each
against its plain PyTorch version, and drives three models at full width
through their serving path and their training step (reverse or forward KL
and Adam(5e-4)), in float32 and bfloat16, with exact kernel launch counts:

* the flagship (12 circular autoregressive RQ-spline layers of hidden width
  512, 10 bins; 2^14 samples per request and step), through the planar
  spline kernels: phases kernel, main_path, times_kernel, times_requests,
  kernel_backward, train_path, times_train;
* the large-D autoregressive NSF of ``examples/ar_large_d_bench.py`` (D = 64,
  4 x (AR RQ-spline of hidden width 256, 8 bins + LULinearPermute), 4096
  samples), whose sampling direction is the sliced sequential inverse,
  through the flat spline kernels: phases kernel_flat,
  kernel_flat_backward, large_d_path, large_d_train, times_large_d;
* the same large-D model with the opt-in fused MADE on
  (``ops.backend.set_made_fusion(True)``): its density direction
  (``log_prob``, the forward-KL step) runs each layer's MADE as the fused
  kernels of ``csrc/made_fused.cu``: phases kernel_made_fused,
  kernel_made_fused_backward, large_d_fused, times_made_fused;
* the flat backward's ablation (``csrc/rqs_flat_ablate.cu``, the port of
  ``examples/spline_bwd_ablate.py``): each of its four variants against its
  plain version, then the port's script
  ``normflows_tpu_torch.examples.spline_bwd_ablate`` as a user runs it,
  with each variant's registers and spills: phases kernel_ablate,
  times_ablate;
* the coupled NSF of ``docs/getting_started.md`` (DiagGaussian(2), 8
  coupled RQ splines of 2 residual blocks of hidden 64, 8 bins, TwoMoons;
  2^14 samples per request, forward-KL steps on batches of 512), through
  the flat spline kernels along the coupling's and the CDF's layouts, and
  a circular coupled stack: phases coupled_path, coupled_train,
  coupled_float64 (card and CPU each against float64), times_coupled.
* the chunked trainer (``training.make_step_chunk`` and
  ``make_chunked_train_step``: one step captured in a CUDA graph and
  replayed): the flagship and the coupled NSF, each captured chunk against
  the same steps taken eagerly, with no host sync in a chunk, exact
  replayed launches (counted on the card, where the wrappers' device
  counters are captured beside the launches), the non-finite skip decided on the card, a checkpoint
  restored in place, step times, and 2,000 bf16 flagship steps trained to
  a KL(q||p) bar: phases chunked_train, chunked_data, times_chunked,
  convergence;
* the README's Real NVP (32 masked affine layers on MLPs, TwoMoons): one
  forward-KL step on the card against the CPU, the example's first 50
  chunked AdamW steps on the card against the CPU on the same inputs, then
  ``normflows_tpu_torch.examples.real_nvp_twomoons`` at 1,000 of its
  4,000 chunked AdamW steps, its held-out log q and the ring radius of the
  live model's draws reported: phase realnvp;
* conditional flows (``ConditionalNormalizingFlow``): model A, the port of
  ``examples/conditional_flow.py`` (4 conditional autoregressive RQ-spline
  layers of hidden 128 on 2 features, context 4), and model B, the
  conditional D = 64 layer of ``examples/ar_large_d_bench.py`` (hidden 256,
  context 8, batch 4096), f32 and bf16: every planar and flat kernel call
  of their paths against its plain version, exact launches, the card
  against the CPU, model B's sliced inverse against the naive recursion,
  the fused MADE off; then the example's first 50 steps on the card
  against the CPU, the example trained as a user runs it (5,000 chunked
  steps) to its held-out KL and moment bars, and times: phases
  conditional_path, conditional_train;
* serving export (``normflows_tpu_torch.serving``): bundles of the
  flagship (f32, bf16), the coupled NSF, the large-D ``log_prob`` with the
  fused MADE off and on, and Real NVP, each loaded and held bit
  for bit against its live model, eagerly and as a replayed CUDA graph,
  with exact launches on the device counters, and the request routes
  timed: phase serving_export;
* residual flows: model R, the port of ``examples/residual_twomoons.py``
  (16 residual blocks of LipschitzMLP [2, 128, 128, 2] and ActNorm), its
  log_prob in training mode (host-drawn horizons and probes) and in eval
  mode against the CPU, its fixed-point sampler, reduce_memory against
  none (values, gradients, peak memory), a LipschitzCNN against the CPU;
  then the example as a user runs it, 1,000 chunked steps with the power
  iteration inside the captured step, to a held-out bar, the captured
  step's kernels by part, a captured chunk against eager steps: phases
  residual_path, residual_train; the small flows: planar and radial flows
  of ``examples/planar_radial_comparison.py`` on TwoModes, their first
  steps against the CPU and 500 chunked reverse-KL steps each to a bar:
  phase small_flows.  No kernel of the port runs on these paths.
* stochastic flows, HAIS, the flow-VAE and the new bases: MH, HMC, a
  5-rung HAIS ladder, the SNF of ``examples/snf_hais.py`` and the bases
  ``GaussianMixture``, ``GaussianPCA`` and ``AffineGaussian`` on host-drawn
  draws, the card against the CPU, and the HMC SNF's gradients (its step
  size and mass through a double backward); the example's HAIS ladder
  (4,096 chains, 30 rungs) eager and captured, its log Z against
  TwoMoons' quadrature; the SNF's reverse-KL step captured in 20-step
  chunks (MH and HMC) bit-equal to eager steps; ``examples.vae_flow`` and
  ``plain_vae`` as a user runs them, 960 chunked steps each, to held-out
  -ELBO bars; ``examples.change_base`` on the inputs of the JAX replays
  that set its bars, both bases, 2,000 chunked steps each: phases
  stochastic_path, hais, snf_train, vae_train, change_base.  No kernel of
  the port runs on these paths.
* the rest of the sampling tier and ScanChain: dual-averaging adaptation,
  systematic resampling, annealed SMC, NeuTra HMC and NUTS on host-drawn
  draws, the card against the CPU with every discrete decision equal (a
  NUTS chain's values held where neither the card nor the CPU with
  perturbed weights parts it), and the flagship as one ScanChain against
  its layers unrolled, bit for bit (phase sampling_path); NUTS at
  ``examples/nuts_bench.py``'s configuration (1,024 chains, max_depth 8,
  GaussianVonMises; warm-up and steps cut) to
  the cylinder law's moments (phase nuts); NeuTra HMC (1,024 chains, 50
  adaptation iterations) and NUTS on the pullback of the convergence
  phase's flagship, and annealed SMC (2^14 particles, 16 temperatures)
  with that flagship as proposal, eager and with a temperature's graph
  replayed, bit-equal, to the moments and
  log Z = 0, with the planar launches the formulas give (phase
  neutra_smc); a captured bf16 reverse-KL chunk of the flagship as one
  ScanChain against the unrolled flagship's (phase scan_chain).  Their
  planar kernel launches are the kernels line's ``launches_sampling``.
* the native data loader and the data- and chain-parallel tier: the C++
  loader built with g++ from the checkout, its batches against the plain
  producer and ``utils.preprocessing``, across worker counts, and copied to
  the card through ``prefetch_to_device`` (pinned memory, a copy stream),
  host batches/s at CIFAR-10 geometry (phase loader); the flagship's
  data-parallel reverse-KL step at 2^14 (``parallel.make_reverse_kld_step``),
  a world of 1 (NCCL, in-process) bit-equal to ``make_train_step`` and its
  step time against it, and a world of 2 spawned once on the one card (gloo
  over CUDA tensors) against the single-process step, 24 + 24 planar
  launches a step a rank (phase data_parallel); Glow model A fed from the
  loader through ``prefetch_to_device`` against a batch already on the
  card, images/s and busy share (phase glow_loader); the HAIS of
  ``examples/snf_hais.py`` through ``parallel_chain_sample`` at worlds 1
  and 2 against ``HAIS.sample``, log Z against the quadrature (phase
  chains).  Their planar launches are the kernels line's
  ``launches_parallel``.
* the sharded tier, the flagship at full width (two f32 reverse-KL steps
  at 2^14, Adam(5e-4) from bench.py's init): ``make_tensor_parallel_step``
  over {"model": 1} (NCCL) bit-equal to ``make_train_step`` and timed
  against it, and over {"model": 2} in the world of 2 (256 of the 512
  hidden units a rank) against the single-process steps, collectives a
  step and bytes a rank (phase tensor_parallel); ``make_fsdp_step`` alike
  over {"data": 1} and {"data": 2}, bytes of parameters and moments a rank
  (phase fsdp); ``make_pipeline_apply`` and ``make_pipeline_train_step``
  over 2 stages of 6 layers, 4 microbatches of 4,096, against the layers in
  turn and the single-process steps, 48 + 48 planar launches a stage a
  step, each stage's kernel calls against their plain versions (phase
  pipeline); the tensor-parallel state checkpointed shard by shard,
  restored into a fresh state, onto FSDP's layout and onto a world of 1,
  one step resumed bit-equal (phase sharded_checkpoint).  The world of 2's
  part runs in the ranks that phase data_parallel spawns.  Their planar
  launches are the kernels line's ``launches_sharded``.

* the four reference examples of ``normflows_tpu_torch.examples``, the
  ports of ``examples/circular_nsf.py`` (20 circular AR RQ-spline layers of
  hidden 128, forward KL at batch 1,024, the target drawn inside the step),
  ``neural_spline_twomoons.py`` (16 x (AR RQ-spline of hidden 128 +
  LULinearPermute) on TwoMoons, batch 512), ``augmented_flow.py`` (32 x
  (MaskedAffineFlow + ActNorm) in 4-D, annealed reverse KL on 1,024 draws)
  and ``image_density.py`` (32 MaskedAffineFlow layers on an image's
  density, batch 512), at their scripts' widths and depths: each one's
  first 50 steps on the card against the CPU on its host inputs, its step
  time and busy share, then the example as a replay runs it at 500
  steps to bars set by the JAX package's replays, with 0 non-finite steps
  and the exact planar launches of rows 1 and 1b on the device counters
  (the two spline models): phase reference_examples, the kernels line's
  ``launches_examples``.

Every kernel on a model's path is reached through its ``torch.library``
operator (``normflows_tpu_torch.ops.backend.kernel_op``).
It prints one JSON line per phase, then the ``kernels`` line, then
``{"ok": true, "device": {...}}`` last.  ``--phases a,b`` runs the device
and build phases, the phases named and those whose results they take, and
then the last line without the kernels line (``PHASES`` lists the names);
without it every phase runs.  Any failure exits non-zero; without
a CUDA card, or without the package beside it, it exits non-zero before
printing anything.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import io
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"

# flagship (bench.py / __graft_entry__.py of the JAX package)
LAYERS, HIDDEN, BINS, BLOCKS = 12, 512, 10, 1
SCALE = [1.0, 2 * math.pi]
TAIL_BOUND = [5.0, math.pi]
CODES = (1, 2)  # TAIL_LINEAR, TAIL_CIRCULAR
N = 2**14
N_CPU = 2**12

# Kernel vs plain version: the JAX package's own bars (tests/test_pallas.py),
# |a - b| <= atol + rtol * |b| with atol = rtol = 2e-5 on outputs and 2e-4 on
# log-dets.  Raw parameters are drawn with std 0.5, near the scale of the
# flagship MADE's output at init (~0.3): at std 1 some bins get slopes so
# small that float32 rounding alone, in either version, passes the bars.
Y_TOL, LD_TOL, PARAM_STD = 2e-5, 2e-4, 0.5
# inverse(forward(x)) == x: two evaluations, the inverse amplifying rounding
# by 1/slope; the JAX package's round-trip bar (tests/helpers.py)
RT_TOL, RT_LD_TOL = 1e-4, 1e-3
# sample's log_q against log_prob of the samples, median over 2^14, f32:
# both directions see the same MADE parameters, so what is left is the
# spline's inverse/forward rounding through 12 layers.
LOGQ_F32 = 1e-3
# bf16: a layer's MADE input differs between the two directions by the
# float32 rounding of the layers after it, and where that flips the bf16
# rounding of a parameter (one bf16 step is ~4e-3 relative; the batch-1 and
# batch-2^14 GEMMs of the two directions round apart too), that element's
# log-det moves by up to ~0.1.  Most elements see no flip, so the median
# stays small; its bar is ten times the f32 one.
LOGQ_BF16 = 1e-2
# card against CPU, f32, same weights, 2^12 samples (2^14 on the coupled
# models, the size their requests run): matmuls summed in
# another order and the kernel against the plain spline, through 12 layers,
# each within 2e-5 / 2e-4: 1e-3 atol + rtol on values and log-densities.
CPU_TOL = 1e-3
# Backward kernel against its plain version (autograd through the plain
# spline): the JAX package's gradient bars (tests/test_pallas.py), atol = rtol.
G_TOL = 2e-3
# One f32 training step, card against CPU, same weights and base draws,
# 2^12 samples: each gradient leaf within 2e-3 of its norm (the gradient bar
# above, taken over a leaf), the loss within CPU_TOL.
STEP_G_TOL = 2e-3
N_TRAIN_CPU = 2**12
LR = 5e-4  # bench.py's Adam
# the flagship's bf16 steps of train_path and the coupled NSF's of coupled_train:
# runs that hold no bar (finite losses, the last 20 below the first 20), so
# 40 steps, the fewest that check keeps apart
TRAIN_STEPS = 40

# large-D autoregressive NSF (examples/ar_large_d_bench.py:60-93): linear
# tails at the wrapper's default bound, DiagGaussian base, DiagGaussian
# target with loc 0.5 and log_scale -0.2, both trainable
LD_D, LD_HIDDEN, LD_BINS, LD_LAYERS, LD_BATCH = 64, 256, 8, 4, 4096
LD_TAIL_BOUND = 3.0
LD_CPU = 512  # samples of the card-against-CPU checks
LD_TRAIN_STEPS = 20
# host medians of the large-D requests and steps (5 before PR 13, 3 before
# PR 14, 2 before PR 18)
LD_TIMED_REPS = 1
# Flat kernel against its plain version: the JAX package's bars for the
# runtime-tail entry (tests/test_pallas.py:427-428), 1e-5 on outputs and
# 1e-4 on log-dets, for the static-tail entry (:41-42) 2e-5 and 2e-4, and
# 1e-3 on gradients (:450); atol = rtol.  The plain version runs in float64
# on the same inputs: at N = 262,144 some elements' gradients are so badly
# conditioned that two float32 evaluations, the kernel's and the plain
# version's, can differ by more than the bar (on the card: two values of
# 6.8 million, by up to 1.7e-4 over it), while the kernel lies within the
# bar of the float64 value; the phase reports the float32 plain version's
# own excess beside.
FLAT_Y_TOL, FLAT_LD_TOL = 1e-5, 1e-4
FLAT_G_TOL = 1e-3
# sample's log_q against log_prob of the samples at D = 64, median over 4096:
# the spline's inverse and forward rounding through 4 layers of 64 features,
# and the LU's two triangular solves against its two products.  The same
# model on the CPU, at 256 samples, gives 1.5e-5 (f32) and 7.6e-6 (bf16;
# max 2.8e-3, where a float32 difference flips a parameter's bf16
# rounding): the bars are the flagship's, LOGQ_F32 and LOGQ_BF16.
LOGQ_LD_F32, LOGQ_LD_BF16 = LOGQ_F32, LOGQ_BF16
# bf16 against f32 on the card: log_prob of the f32 samples with bf16 MADE
# matmuls, median |difference| from the f32 log_prob.  Each MADE output
# rounds to bf16 (~4e-3 relative) before 256 one-dimensional splines; the
# same model on the CPU, at 256 samples, gives 0.029 nats (max 0.20).
LD_BF16_VS_F32 = 0.1

# fused MADE (ops/made_fused.py): the large-D model's MADE (B 4096, F 64,
# H 256, R 1, P 1600) and the JAX package's test shapes (F 2, H 512, R 1 and
# 2, P 62, B 300: a masked edge in P and a batch no multiple of a tile)
MADE_CASES = ((LD_BATCH, LD_D, LD_HIDDEN, 1, 3 * LD_BINS + 1), (300, 2, 512, 1, 31),
              (300, 2, 512, 2, 31))
# the JAX package's bars (tests/test_pallas.py): f32 outputs 1e-5 (:111) and
# gradients 2e-4 (:129), here against the plain version in float64; bf16
# against the bf16 plain version 5e-2 (:201), the forward against the f32
# plain version 0.15 / 0.05 (:177)
MADE_Y_TOL, MADE_G_TOL, MADE_BF16_TOL, MADE_BF16_F32 = 1e-5, 2e-4, 5e-2, (0.15, 0.05)
# fusion on against off on the card, f32: log_prob and the forward-KL loss
FUSED_TOL = 1e-4
LD_FUSED_STEPS = 20

# the flat backward's ablation (examples/spline_bwd_ablate.py): run_variant's
# 2^14 x 2 elements and 10 bins; sel_only's bar is 1e-5 (its output is the
# selection's values summed, no pull-back), the others the flat backward's
ABLATE_N, ABLATE_BINS, ABLATE_SEL_TOL = 2**15, 10, 1e-5
# the ablation kernel's other bin counts: 8 exactly, 16 (K <= 16, bins
# masked) and 20 (the loops over a runtime K, which vjp_all refuses)
ABLATE_SWEEP_BINS = (8, 16, 20)

# coupled NSF of docs/getting_started.md:19-47: 8 layers, 2 residual blocks
# of hidden 64, 8 bins, linear tails at 3; forward-KL steps on batches of 512
CP_LAYERS, CP_BLOCKS, CP_HIDDEN, CP_BATCH, CP_TRAIN_STEPS = 8, 2, 64, 512, TRAIN_STEPS

# the chunked trainer (training.make_step_chunk / make_chunked_train_step):
# a chunk of CHUNK steps checked against as many eager steps (bars: the
# losses within CPU_TOL, every parameter leaf within STEP_G_TOL of its
# norm), TIMED_CHUNK steps a timed chunk, the step made non-finite at
# NAN_STEP; the coupled model's data set of CP_DATA TwoMoons points;
# PROFILED_CHUNK steps a chunk profiled for the device time of a step
CHUNK, TIMED_CHUNK, TIMED_CHUNKS, NAN_STEP, CP_DATA = 50, 50, 1, 3, 2**16
PROFILED_CHUNK = 2
# bf16 flagship, CONV_STEPS chunked steps (chunks of CONV_CHUNK) under cosine
# decay over CONV_STEPS from bench.py's init, then KL(q||p) on CONV_HELD_OUT
# fresh samples.  Three runs on the H100 (generator seeds SEED + 13, + 20,
# + 21) gave 8.02e-4, 8.15e-4 and 6.26e-4 nats (a seed's run repeats to
# the last bit); the bar is ~3.7x the largest, and the 10k-step runs of
# examples/nsf_cylinder.py reach ~1e-4.
CONV_STEPS, CONV_CHUNK, CONV_HELD_OUT = 2000, 100, 2**16
CONV_KL = 3e-3

# the README's Real NVP (examples/real_nvp_twomoons.py: K = 32, MLP [2, 64,
# 64, 2] nets, batch 512, AdamW(5e-4, weight decay 1e-5), 4,000 iterations),
# trained chunked on the card.  Its first RNVP_PARITY_STEPS steps must give
# the CPU's losses on the same inputs within CPU_TOL.  The full run's
# held-out log q and served ring radius (the ring is at 2) are reported
# beside RNVP_LOG_Q (QUALITY.md's one chunked JAX run: -1.593) and
# RNVP_RADIUS, not held: an unbounded affine scale blows up in some runs of
# this recipe, on the card, on the CPU and in the JAX package alike, at
# seeds that differ between them, because float32 rounding parts the
# trajectories of one seed within a few hundred steps (PERF.md, PR 11: the
# example at 12 seeds on the card, its replay through the JAX package and
# its run on the CPU).
# The run holds no bar, so it takes 1,000 of the example's 4,000 steps and
# draws from the live model (phase serving_export exports and holds a Real
# NVP bundle).
RNVP_K, RNVP_ITERS, RNVP_CHUNK, RNVP_BATCH, RNVP_SERVED = 32, 1000, 100, 512, 4096
RNVP_LR, RNVP_PARITY_STEPS = 5e-4, 50
RNVP_LOG_Q, RNVP_RADIUS = -1.65, (1.9, 2.2)
# serving: log_prob through one program at these batches, each held bit for
# bit, the last timed; SERVE_REPS requests a route's host median
# (SERVE_REPS and REQUEST_REPS 3, from 5, and HAIS_REPS 2, from 3, to make
# room for the samplers' phases; SERVE_REPS and REQUEST_REPS 2, HAIS_REPS and
# LD_TIMED_REPS 1, for the loader's and the parallel tier's phases; log_prob
# timed at the last batch only, from every batch, for phase
# serving_stochastic)
SERVE_BATCHES, SERVE_REPS = (1, 1000, N), 1
# host medians of the flagship's requests and eager steps (20 before PR 13;
# PR 13 cut this, SERVE_REPS, LD_TIMED_REPS and TIMED_CHUNKS to make room for
# the Glow phases; PR 14 cut it to 5, SERVE_REPS from 10 to 5, LD_TIMED_REPS
# from 3 to 2 and TIMED_CHUNKS from 2 to 1 for the residual and small flows)
REQUEST_REPS = 2

# conditional flows.  Model A: examples/conditional_flow.py as published
# (4 x (AR RQ spline on 2 features, 2 blocks of hidden 128, context 4, 8
# bins) + LULinearPermute, fixed DiagGaussian(2) base,
# ConditionalDiagGaussianTarget, forward KL on batches of 128, Adam(3e-4)
# with coupled weight decay 1e-5, 5,000 iterations), ported as
# normflows_tpu_torch.examples.conditional_flow: COND_DRAWS draws and
# pairs a card-against-CPU check, its first COND_PARITY_STEPS steps on
# host-drawn inputs held against the CPU's within CPU_TOL.  Its trained
# run's held-out KL(p||q) must be at most COND_KL = max(2 x JAX's, JAX's +
# 0.01) nats, JAX's being 0.02261, the median of the JAX package's example
# at seeds 0-2 on a CPU (0.02528, 0.02261, 0.02207; tests/test_torch_conditional.py
# run as a script); its draws' largest |mean - [0.3, 0.9]| and |std - [0.6,
# 0.6]| at most COND_MOMENT_GAP: those runs miss 0.05 themselves (median of
# their largest gaps 0.0599 for the mean, 0.0887 for the std), so each bar
# is JAX's gap + 0.02.  The moment bars are indicative only at SEED: JAX's
# example misses them at 2 of its 8 seeds (gaps up to 0.1153 / 0.1074) and
# the port on the card at 3 of 8 (PERF.md, PR 12); COND_KL is the bar that
# tells a sound model from a faulty one.
COND_LAYERS, COND_BATCH, COND_ITERS, COND_CHUNK, COND_LR = 4, 128, 5000, 100, 3e-4
COND_DRAWS, COND_PARITY_STEPS = 4096, 50
COND_KL = max(2 * 0.02261, 0.02261 + 0.01)
COND_MOMENT_GAP = {"mean": 0.0599 + 0.02, "std": 0.0887 + 0.02}
# Model B: examples/ar_large_d_bench.py:160-176's conditional layer (D = 64,
# 1 block of hidden 256, context 8, 8 bins, permuted masks) at batch 4096
CB_D, CB_HIDDEN, CB_CONTEXT, CB_BINS, CB_BATCH = 64, 256, 8, 8, 4096
COND_CONTEXT = 4  # model A's context width, and the conditional coupled NSF's

# Glow, the image path (PR 13).  Model A: examples/glow_image.py's defaults
# (the reference notebook's CIFAR-10 configuration): a class-conditional
# MultiscaleFlow of L = 3 levels of K = 16 GlowBlocks (hidden 256), 10
# classes, 3 x 32 x 32 images drawn by normflows_tpu_torch.examples.glow_image
# from SEED, batch 128, Adamax(1e-3) with L2 1e-5.  Its output convolutions
# are drawn at random (the torch init) for the path's checks, so that the
# couplings do work; training starts from the example's init.
GLOW_L, GLOW_K, GLOW_HIDDEN, GLOW_CLASSES, GLOW_BATCH = 3, 16, 256, 10, 128
GLOW_CPU = 8  # images of the card-against-CPU checks
# Card against CPU, f32, same weights and images: model A on the CPU at
# batch 4 gives, float32 against float64, latents within 1.0e-5, log-dets
# within 1.7e-3 nats and log_prob within 1.4e-3 (of ~4,000); with its
# convolution operands rounded to TF32 (as cuDNN's default runs float32),
# 2.5e-3, 1.4e-2 and 6.2e-2.  So the bars, 1e-4 on latents and 1e-2 nats on
# log-dets and log_prob (absolute), pass float32 and fail TF32; the phase
# runs the card once with cuDNN's TF32 on and reports that it fails them.
GLOW_Z_TOL, GLOW_LP_TOL = 1e-4, 1e-2
# bf16 card against bf16 CPU: each convolution output rounds to bfloat16
# after float32 sums in different orders; the CPU's bf16 model against its
# f32 one differs by 2.1e-2 on latents and 0.23 nats on log_prob, so the
# bars are 5e-2 and 0.5 nats
GLOW_BF16_Z_TOL, GLOW_BF16_LP_TOL = 5e-2, 0.5
# sample's log_q against log_prob of its draws at the same temperature,
# inverse(forward) round trips: relative to |log_q| (~4,000 nats), 1e-5
GLOW_LOGQ_REL = 1e-5
# One forward-KL gradient at GLOW_CPU images, the card against float64: model
# A's random output convolutions leave many leaves' gradients ill-conditioned
# (sums over few positions that cancel); on the CPU its float32 gradient lies
# from float64 by a median of 3.3e-4 of a leaf's norm (90% within 6.9e-4),
# the worst leaf 1.19e-2.  The bars: the median within 4x and the worst
# within 2x of the CPU's.  (Model B's leaves: median 4.4e-6, worst 7.8e-4;
# held to STEP_G_TOL each.)
GLOW_G_MEDIAN, GLOW_G_MAX = 4 * 3.3e-4, 2 * 1.19e-2
# model A, bf16, the example's recipe; its run holds no bar (finite losses,
# the mean of the last 100 below that of the first 100), so 300 of the
# example's 1,000 steps
GLOW_TRAIN_ITERS = 300
GLOW_F32_STEPS = 50  # model A, f32: chunked, timed, against eager steps
# steps of the profiled chunk of model A: ~8,700 kernels a step, and
# processing a profile takes host time by the kernel
GLOW_PROFILED_CHUNK = 2
GLOW_SERVED = 64  # draws a request of model A's bundle
# Model Q: examples/quality_compare.py's GLOW_CFG (L = 2, K = 4, hidden 64,
# 8 x 8 x 3 images of 4 classes, 4,096 images with the last 1,024 held out,
# batch 64, Adamax 1e-3 with L2 1e-5, 800 steps), the example's host-drawn
# inputs (--host-inputs).  Its held-out bits/dim must be at most Q_BPD:
# the JAX package on the same model and inputs at seeds 0-2 on a CPU
# (tests/test_torch_multiscale.py run as a script, before any card run):
# 2.6603, 2.7259, 2.7107; median 2.7107, spread 0.0656; bar = median +
# max(0.05, spread).  Its first Q_PARITY_STEPS steps on the card within
# CPU_TOL of the CPU's losses.
Q_ARGS = ["--L", "2", "--K", "4", "--hidden", "64", "--batch", "64", "--lr", "1e-3",
          "--image-size", "8", "--classes", "4", "--images", "4096"]
Q_ITERS, Q_PARITY_STEPS = 800, 50
Q_BPD = 2.7107 + max(0.05, 2.7259 - 2.6603)
# Model B: the image NSF of the JAX package's tests/test_autoregressive_nsf.py:124-134
# at the squeezed CIFAR geometry: DiagGaussian((12, 16, 16)), 4 x (coupling
# on an alternating channel mask, ConvResidualNet of 2 blocks of hidden 128,
# 8 bins, linear tails at 3; Invertible1x1Conv with LU; ActNorm), batch
# 128: each flat launch covers 128 x 6 x 16 x 16 = 196,608 elements.  Bars
# against the CPU as model A's f32 (3,072 dims, as model A).
IMG_C, IMG_HW, IMG_HIDDEN, IMG_BINS, IMG_LAYERS, IMG_BATCH = 12, 16, 128, 8, 4, 128
IMG_N = IMG_BATCH * (IMG_C // 2) * IMG_HW * IMG_HW

# Residual flows (PR 14).  Model R: examples/residual_twomoons.py as published
# (16 x (Residual of LipschitzMLP([2, 128, 128, 2], L = 0.9, init_zeros) with
# reduce_memory, ActNorm), DiagGaussian(2), batch 512, AdamW(3e-4, weight
# decay 1e-5), update_lipschitz 50 after each step), ported as
# normflows_tpu_torch.examples.residual_twomoons, trained RES_ITERS chunked
# steps (chunks of RES_CHUNK) on its host-drawn data.  Its held-out mean log
# q (2,048 points, eval mode) must be at least RES_LOG_Q: the JAX package on
# the same weights, data and windows at seeds 0-2 on a CPU
# (tests/test_torch_residual.py run as a script, before any card run):
# -1.7741339, -1.7704459, -1.7838097; median - max(0.05, spread 0.0133638).
# The path's checks take the model with each
# net's last layer drawn at random (so that every block does work) at
# RES_CPU points; its training-mode log_prob runs on host-drawn horizons and
# probes.  Bars, card against CPU, from float32 against float64 on the CPU
# (same model and draws): the CPU's float32 log_prob (~-2.0 nats) lies within
# 1.65e-6 of float64 in training mode and 1.62e-6 in eval mode (brute-force
# 2-D log-dets), within 7.8e-7 relative; the bars RES_TRAIN_TOL and
# RES_EVAL_TOL, ~6x that, are atol = rtol.
RES_K, RES_HIDDEN, RES_BATCH, RES_ITERS, RES_CHUNK, RES_CPU = 16, 128, 512, 1000, 100, 1024
RES_MEM_BATCH = 2**14  # forward-KL batch of the peak-memory reading
RES_EAGER_STEPS = 20  # a captured chunk against as many eager steps
RES_PROFILED_CHUNK = 2
RES_LOG_Q = -1.7741339 - max(0.05, -1.7704459 - -1.7838097)
RES_TRAIN_TOL, RES_EVAL_TOL = 1e-5, 1e-5
# sample then log_prob in eval mode: the largest |z - inverse(forward(z))| and
# the median |log_prob(x) - log_q(x)|, the JAX package's round-trip bar
# (tests/test_residual.py: rtol 1e-3); on the CPU 1.3e-5 and 4.8e-7
RES_RT_TOL = 1e-3
# LipschitzCNN [3, 32, 32, 3], kernels 3-1-3 (the three kernels take four
# channel counts), on 3 x 16 x 16 images, batch 8: forward and one
# update_lipschitz(net, 50) after moving its weights, the card against the
# CPU in IEEE float32.  On the CPU float32 lies within 1.4e-8 of float64 on
# the outputs (|y| <= 0.033), 1.5e-7 on u and v, 6.5e-7 on a scale (<= 6.7):
# the bar, atol = rtol, is 1e-5
CNN_TOL = 1e-5
# Model P: examples/planar_radial_comparison.py's first prior (TwoModes(2.0,
# 0.2)), planar and radial at K = 16, reverse KL on 512 draws a step with
# Adam(1e-3), P_ITERS chunked steps; the reverse KL on 4,096 fresh draws must
# be at most P_KLD[kind]: the JAX package on the port example's initial
# weights at seeds 0-2 on a CPU (tests/test_torch_small_flows.py run as a
# script, before any card run): median + max(0.05, spread).  Its first
# P_PARITY_STEPS steps on host-drawn base noise within CPU_TOL of the CPU's.
P_K, P_ITERS, P_CHUNK, P_PARITY_STEPS = 16, 500, 100, 50
P_KLD = {"planar": -0.7777057 + max(0.05, -0.5963655 - -0.9525948),
         "radial": -1.2269239 + max(0.05, -1.2171435 - -1.5506650)}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores, same source


START = time.perf_counter()


def emit(phase: str, **fields):
    """One JSON line for ``phase``; ``seconds`` is the time since the script
    started, so that each phase's share of the run can be read off."""
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - START, **fields}),
          flush=True)


def excess(a, b, atol, rtol):
    """Largest |a - b| - (atol + rtol |b|); <= 0 passes."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, with CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time of one ``fn`` in ms: ``reps`` calls captured in one CUDA
    graph, so that no host work stands between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / (replays * reps)


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median wall time of ``fn`` ending in a synchronise, in ms."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def planar_inputs(rng, B, inside=False, K=BINS, std=PARAM_STD):
    """x_t (2, B), ~20% outside +-bound on both dims (or all inside), and
    params_t (2(3K+1), B) ~ N(0, std^2), both from the numpy generator."""
    bounds = np.asarray(TAIL_BOUND, np.float32)[:, None]
    reach = 0.999 if inside else 1.25
    x = (rng.uniform(-reach, reach, (2, B)) * bounds).astype(np.float32)
    p = (std * rng.normal(size=(2 * (3 * K + 1), B))).astype(np.float32)
    return torch.from_numpy(x).to(DEVICE), torch.from_numpy(p).to(DEVICE)


def build_flagship(device, init_identity=False):
    import normflows_tpu_torch as nft

    base = nft.distributions.UniformGaussian.create(2, [1], SCALE, device=device)
    layers = [nft.flows.CircularAutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(SEED + i), 2, BLOCKS, HIDDEN, ind_circ=[1],
        num_bins=BINS, tail_bound=np.asarray(TAIL_BOUND, np.float32),
        permute_mask=True, rng_seed=i, init_identity=init_identity, device=device)
        for i in range(LAYERS)]
    return nft.NormalizingFlow.create(
        base, layers, p=nft.distributions.GaussianVonMises(device=device), device=device)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, matmul_allow_tf32=tf32)
    if tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 is True: float32 "
                         "matmuls would run in TF32")
    return smi


def phase_build():
    """Every source built anew, one nvcc each, started together; returns
    the registers and spills of the ablation kernel's, the fused MADE's, the
    flat kernels' and the planar kernels' instantiations."""
    from normflows_tpu_torch.ops import (cuda_build, made_fused, spline_ablate, spline_cuda,
                                         spline_flat)

    info = cuda_build.build([spline_cuda.SOURCE, spline_flat.SOURCE, made_fused.SOURCE,
                             spline_ablate.SOURCE], force=True)
    resources = ablate_resources(info[spline_ablate.SOURCE]["ptxas"])
    made = made_resources(info[made_fused.SOURCE]["ptxas"])
    flat = flat_resources(info[spline_flat.SOURCE]["ptxas"])
    planar = planar_resources(info[spline_cuda.SOURCE]["ptxas"])
    emit("build", sources={
        str(src.relative_to(REPO)): {
            "seconds": i["seconds"],
            "ptxas": [line for line in i["ptxas"].splitlines()
                      if "registers" in line or "spill" in line or "smem" in line]}
        for src, i in info.items()}, ablate_resources=resources, made_resources=made,
        flat_resources=flat, planar_resources=planar)
    return resources, made, flat, planar


def kernel_resources(ptxas, name_of):
    """Registers, stack frame and spill bytes per thread of each kernel of
    a ptxas -v report: ``{name_of(mangled name): {...}}`` (a kernel whose
    ``name_of`` is None is left out)."""
    import re

    out, key = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            key = name_of(m.group(1))
            if key is not None:
                out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[key].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
            key = None
    return out


def ablate_resources(ptxas):
    """The ablation kernel's instantiations: ``{"<mode>_<direction>_<bins>":
    {...}}`` (<bins> as ``bins_key`` gives it).  Its template arguments
    <mode, inverse, bins, exact> are in its mangled name, as
    ILi<mode>ELb<0|1>ELi<n>ELb<0|1>E; vjp_all has no runtime-K one."""
    import re

    from normflows_tpu_torch.ops import spline_ablate

    def name_of(mangled):
        m = re.search(r"rqs_flat_ablate_kernelILi(\d)ELb([01])ELi(\d+)ELb([01])E", mangled)
        return m and (f"{spline_ablate.VARIANTS[int(m.group(1))]}_"
                      f"{'inverse' if m.group(2) == '1' else 'forward'}_"
                      f"{bins_key(m.group(3), m.group(4))}")

    out = kernel_resources(ptxas, name_of)
    want = {f"{v}_{d}_{b}" for v in spline_ablate.VARIANTS for d in ("forward", "inverse")
            for b in ("8", "10", "16_masked") + (() if v == "vjp_all" else ("runtime",))}
    if set(out) != want or any("registers" not in r or "spill_store_bytes" not in r
                               for r in out.values()):
        raise SystemExit(f"build: no full ptxas report of the ablation kernel: {out}")
    return out


def bins_key(bins, exact):
    """An instantiation's compile-time bin count as its key: ``8``, ``10``,
    ``16_masked`` (K <= 16) or ``runtime`` (the loops over a runtime K)."""
    return bins if exact == "1" else ("runtime" if bins == "0" else f"{bins}_masked")


def flat_resources(ptxas):
    """The flat kernels' instantiations: ``{"forward_<bins>", "inverse_<bins>",
    "backward_forward_<bins>", "backward_inverse_<bins>": {...}}`` (<bins> as
    ``bins_key`` gives it).  The template arguments <inverse, bins, exact>
    of both kernels are in their mangled names as ILb<0|1>ELi<n>ELb<0|1>E."""
    import re

    def name_of(mangled):
        m = re.search(r"rqs_flat_(backward_)?kernelILb([01])ELi(\d+)ELb([01])E", mangled)
        return m and (f"{m.group(1) or ''}{'inverse' if m.group(2) == '1' else 'forward'}_"
                      f"{bins_key(m.group(3), m.group(4))}")

    out = kernel_resources(ptxas, name_of)
    if not out or any("registers" not in r or "spill_store_bytes" not in r
                      for r in out.values()):
        raise SystemExit(f"build: no full ptxas report of the flat kernels: {out}")
    return out


def planar_resources(ptxas):
    """The planar kernels' instantiations: ``{"forward_<bins>",
    "inverse_<bins>", "backward_forward_<bins>", "backward_inverse_<bins>":
    {...}}`` (<bins> as ``bins_key`` gives it); the template arguments
    <inverse, bins, exact> of both kernels are in their mangled names as
    ILb<0|1>ELi<n>ELb<0|1>E."""
    import re

    def name_of(mangled):
        m = re.search(r"rqs_transposed_(backward_)?kernelILb([01])ELi(\d+)ELb([01])E", mangled)
        return m and (f"{m.group(1) or ''}{'inverse' if m.group(2) == '1' else 'forward'}_"
                      f"{bins_key(m.group(3), m.group(4))}")

    out = kernel_resources(ptxas, name_of)
    if len(out) != 16 or any("registers" not in r or "spill_store_bytes" not in r
                             for r in out.values()):
        raise SystemExit(f"build: no full ptxas report of the planar kernels: {out}")
    return out


def made_resources(ptxas):
    """The fused MADE's kernels: ``{"<kernel>_<f32|bf16>[_<argument>]":
    {...}}`` (the template's arguments are in the mangled name as Lb<0|1>E
    or Li<n>E, kBf16 first; the chain kernel's second is its tile's rows)."""
    import re

    def name_of(mangled):
        m = re.search(r"(made_[a-z_]+?_kernel)(I(?:L[bi]\d+E)+E)?", mangled)
        if not m:
            return None
        flags = re.findall(r"L[bi](\d+)E", m.group(2) or "")
        if not flags:
            return m.group(1)
        return (m.group(1) + ("_bf16" if flags[0] == "1" else "_f32") +
                "".join(f"_{f}" for f in flags[1:]))

    out = kernel_resources(ptxas, name_of)
    if not out or any("registers" not in r or "spill_store_bytes" not in r
                      for r in out.values()):
        raise SystemExit(f"build: no full ptxas report of the fused MADE: {out}")
    return out


# the planar forward's other bin counts beside the flagship's 10: 2, the
# large-D model's 8, the register path's largest (16, bins above K masked
# below it) and one above it (the loops over a runtime K)
PLANAR_BINS = (2, 8, 16, 20)


def phase_kernel():
    """The kernel against its plain version on the same CUDA tensors: the
    flagship's K at B = 2^14 and 2^14 + 37, then every other instantiation
    (PLANAR_BINS) at 2^14 + 37, both directions, each K with a round trip
    inverse(forward(x)) inside the bounds."""
    from normflows_tpu_torch.ops import spline_cuda as sc

    rng = np.random.default_rng(SEED)
    errs, rt = {}, {}
    cases = [(B, BINS) for B in (N, N + 37)] + [(N + 37, K) for K in PLANAR_BINS]
    for (B, K), inverse in itertools.product(cases, (False, True)):
        x, p = planar_inputs(rng, B, K=K)
        y, ld = sc.rqs_transposed(x, p, CODES, TAIL_BOUND, inverse)
        sync()
        yr, ldr = sc.rqs_transposed_reference(x, p, CODES, TAIL_BOUND, inverse)
        d = "inverse" if inverse else "forward"
        e = {"max_abs_y": float((y - yr).abs().max()),
             "max_abs_ld": float((ld - ldr).abs().max()),
             "excess_y": excess(y, yr, Y_TOL, Y_TOL),
             "excess_ld": excess(ld, ldr, LD_TOL, LD_TOL),
             "finite": bool(torch.isfinite(y).all() and torch.isfinite(ld).all())}
        errs[f"{d}_B{B}" + (f"_K{K}" if K != BINS else "")] = e
        if not e["finite"] or e["excess_y"] > 0 or e["excess_ld"] > 0:
            emit("kernel", ok=False, errors=errs)
            raise SystemExit(f"kernel disagrees with its plain version ({d}, B={B}, K={K})")
    # round trip inside the bounds, through the kernel both ways
    for K in (BINS, *PLANAR_BINS):
        x, p = planar_inputs(rng, N + 37, inside=True, K=K)
        y, ld_f = sc.rqs_transposed(x, p, CODES, TAIL_BOUND, False)
        x2, ld_i = sc.rqs_transposed(y, p, CODES, TAIL_BOUND, True)
        sync()
        rt[f"K{K}"] = {"excess_x": excess(x2, x, RT_TOL, RT_TOL),
                       "max_abs_ld_sum": float((ld_f + ld_i).abs().max())}
    ok = all(r["excess_x"] <= 0 and r["max_abs_ld_sum"] <= RT_LD_TOL for r in rt.values())
    emit("kernel", ok=ok, errors=errs, round_trip=rt,
         bars={"y": [Y_TOL, Y_TOL], "ld": [LD_TOL, LD_TOL], "param_std": PARAM_STD,
               "round_trip": [RT_TOL, RT_LD_TOL]})
    if not ok:
        raise SystemExit("kernel round trip inverse(forward(x)) != x")
    return errs


def counted(what, fn, planar=(0, 0), flat=(0, 0), made=(0, 0)):
    """Run one main-path phase with every kernel's launch count set to 0 just
    before it; fail unless the planar and the flat spline kernels and the
    fused MADE were launched exactly ``(forward, backward)`` times each."""
    from normflows_tpu_torch.ops import made_fused, spline_cuda, spline_flat

    counters = {"planar": spline_cuda, "flat": spline_flat, "made": made_fused}
    for m in counters.values():
        m.LAUNCHES = m.BACKWARD_LAUNCHES = 0
    out = fn()
    sync()
    got = {k: (m.LAUNCHES, m.BACKWARD_LAUNCHES) for k, m in counters.items()}
    want = {"planar": tuple(planar), "flat": tuple(flat), "made": tuple(made)}
    if got != want:
        raise SystemExit(f"{what}: (forward, backward) kernel launches {got}, expected "
                         f"{want}")
    return out, got


def phase_main_path():
    from normflows_tpu_torch.utils import set_compute_dtype

    model = build_flagship(DEVICE)
    results, launches = {}, {"forward": 0, "inverse": 0}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with torch.inference_mode():
            (x, log_q), n_s = counted(f"sample {dtype}", lambda: model.sample(N, generator=gen),
                                      planar=(2 * LAYERS, 0))
            lp, n_l = counted(f"log_prob {dtype}", lambda: model.log_prob(x), planar=(LAYERS, 0))
        n_inv, n_fwd = n_s["planar"][0], n_l["planar"][0]
        launches["inverse"] += n_inv
        launches["forward"] += n_fwd
        finite = all(bool(torch.isfinite(t).all()) for t in (x, log_q, lp))
        gap = (lp - log_q).abs()
        r = {"sample_launches": n_inv, "log_prob_launches": n_fwd, "finite": finite,
             "shape": list(x.shape), "circular_in_bounds":
                 bool((x[:, 1].abs() <= math.pi + 1e-5).all()),
             "median_abs_logq_gap": float(gap.median()),
             "max_abs_logq_gap": float(gap.max()),
             "mean_log_q": float(log_q.mean())}
        bar = LOGQ_F32 if dtype == "float32" else LOGQ_BF16
        results[dtype] = r
        if not (finite and r["circular_in_bounds"] and tuple(x.shape) == (N, 2)
                and r["median_abs_logq_gap"] <= bar):
            emit("main_path", ok=False, results=results)
            raise SystemExit(f"main path ({dtype}) failed its checks")
        if dtype == "float32":
            results["cpu"] = against_cpu("main_path", model, x, build_flagship, N_CPU)
    emit("main_path", ok=True, results=results,
         bars={"logq_f32": LOGQ_F32, "logq_bf16": LOGQ_BF16, "cpu": CPU_TOL})
    return model, launches


def against_cpu(phase, model, x, build, n):
    """The same model on the CPU (plain splines, the same weights; ``build``
    makes it) on ``n`` of the samples and on ``n`` base draws, f32."""
    cpu = build("cpu")
    cpu.load_state_dict(model.state_dict())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    with torch.inference_mode():
        xs = x[:n]
        lp_card = model.log_prob(xs).cpu()
        lp_cpu = cpu.log_prob(xs.cpu())
        z = model.q0.sample(n, generator=gen)
        xf_card, ld_card = model.forward_and_log_det(z)
        xf_cpu, ld_cpu = cpu.forward_and_log_det(z.cpu())
    r = {"samples": n, "excess_log_prob": excess(lp_card, lp_cpu, CPU_TOL, CPU_TOL),
         "max_abs_log_prob": float((lp_card - lp_cpu).abs().max()),
         "excess_forward_x": excess(xf_card.cpu(), xf_cpu, CPU_TOL, CPU_TOL),
         "max_abs_forward_x": float((xf_card.cpu() - xf_cpu).abs().max()),
         "excess_forward_ld": excess(ld_card.cpu(), ld_cpu, CPU_TOL, CPU_TOL),
         "max_abs_forward_ld": float((ld_card.cpu() - ld_cpu).abs().max())}
    if max(r["excess_log_prob"], r["excess_forward_x"], r["excess_forward_ld"]) > 0:
        emit(phase, ok=False, cpu=r)
        raise SystemExit(f"{phase}: the model on the card disagrees with the model on the CPU")
    return r


def phase_times(model):
    from normflows_tpu_torch.ops import spline_cuda as sc

    rng = np.random.default_rng(SEED + 2)
    # 16 input sets of 4.46 MB each (71 MB > the 50 MB L2): each launch reads
    # its inputs from device memory, as after the MADE's GEMM has moved on
    sets = [planar_inputs(rng, N) for _ in range(16)]
    rotation, y = itertools.cycle(sets), torch.empty(2, N, device=DEVICE)
    floor = graph_ms(lambda: torch.neg(next(rotation)[0], out=y), reps=64)
    kernel, call, plain = {}, {}, {}
    for inverse in (False, True):
        d = "inverse" if inverse else "forward"
        for times, fn, timer, reps in ((kernel, sc.rqs_transposed, graph_ms, 64),
                                       (call, sc.rqs_transposed, cuda_ms, 400),
                                       (plain, sc.rqs_transposed_reference, cuda_ms, 20)):
            rotation = itertools.cycle(sets)
            times[d] = timer(
                lambda: fn(*next(rotation), CODES, TAIL_BOUND, inverse), reps=reps)
    F, P = 2, 2 * (3 * BINS + 1)
    bytes_moved = (F + P + 2 * F) * N * 4  # x, params read once; y, ld written
    # per element: softmax max 2(K-1), exp-sum 6K, search 13K, slopes ~10,
    # rational-quadratic map ~30 operations
    ops = (2 * (BINS - 1) + 6 * BINS + 13 * BINS + 40) * F * N
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    emit("times_kernel", kernel_ms=kernel, call_ms=call, plain_ms=plain,
         bound_ms=bound_ms, bound_by=bound_by, floor_ms=floor, bytes=bytes_moved, ops=ops,
         batch=N, note="kernel_ms: device time, 64 launches in one CUDA graph, inputs "
         "rotated through 71 MB; call_ms and plain_ms: CUDA events over a loop "
         "of calls (the wrapper's host work included); floor_ms: torch.neg on the same "
         "2 x 2^14 floats, 64 launches in one CUDA graph, a reading of the launch cost, "
         "not a bound")
    return kernel, plain, bound_ms, bound_by, floor


def phase_requests(model):
    from normflows_tpu_torch.utils import set_compute_dtype

    requests = {}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with torch.inference_mode():
            x, _ = model.sample(N, generator=gen)
            r = {}
            for what, fn in (("sample", lambda: model.sample(N, generator=gen)),
                             ("log_prob", lambda: model.log_prob(x))):
                ms = host_ms(fn, reps=REQUEST_REPS)
                prof = profile(fn)
                r[what] = {"ms": ms, "samples_per_s": N / (ms / 1e3), "profile": prof,
                           "busy_share_of_median": prof["device_ms"] / ms}
        requests[dtype] = r
    emit("times_requests", requests=requests, batch=N,
         note=f"ms: host median of {REQUEST_REPS} requests, each ending in a synchronise; "
         "profile: one request under torch.profiler, device time summed over "
         "its CUDA kernels, busy_share = that over the profiled wall time; "
         "busy_share_of_median: the same device time over the unprofiled median")
    return requests


def profile(fn, top=6, warm=False):
    """One call under torch.profiler: wall time, device time of its kernels,
    their share of the wall time, and the kernels that take the most.  A
    call of ``fn`` comes first unless ``warm`` (it has just run)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if not warm:
        fn()
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a range named on the host (Optimizer.step#Adam.step) shows up on the
    # device too, spanning its kernels: count kernels only
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    heavy = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in heavy]}


def cotangents(rng, B):
    """ybar, lbar (2, B) from the numpy generator."""
    yb, lb = rng.normal(size=(2, 2, B)).astype(np.float32)
    return torch.from_numpy(yb).to(DEVICE), torch.from_numpy(lb).to(DEVICE)


def phase_kernel_backward():
    """The backward kernel against its plain version in float64 on the same
    CUDA tensors: the flagship's K at B = 2^14 and 2^14 + 37, both
    directions, ~20% of the inputs outside the bounds, and one case whose
    derivative logits are all 0; then every other instantiation
    (PLANAR_BINS) at 2^14 + 37, both directions, its logits drawn at
    SWEEP_STD (the inputs the flat sweep's bars were set on), and read at
    PARAM_STD beside it."""
    from normflows_tpu_torch.ops import spline_cuda as sc

    rng = np.random.default_rng(SEED + 3)

    def compare(B, K, std, inverse, zero_slopes=False):
        x, p = planar_inputs(rng, B, K=K, std=std)
        if zero_slopes:
            p.view(2, 3 * K + 1, B)[:, 2 * K:] = 0.0
        yb, lb = cotangents(rng, B)
        got = sc.rqs_transposed_backward(x, p, yb, lb, CODES, TAIL_BOUND, inverse)
        sync()
        args = (x, p, yb, lb)
        want = sc.rqs_transposed_backward_reference(*as_f64(args), CODES, TAIL_BOUND, inverse)
        return got, want, sc.rqs_transposed_backward_reference(*args, CODES, TAIL_BOUND,
                                                               inverse)

    errs = {}
    cases = [(N, BINS, PARAM_STD, False), (N + 37, BINS, PARAM_STD, False),
             (N + 37, BINS, PARAM_STD, True)] + [(N + 37, K, SWEEP_STD, False)
                                                 for K in PLANAR_BINS]
    for (B, K, std, zero_slopes), inverse in itertools.product(cases, (False, True)):
        d = "inverse" if inverse else "forward"
        name = f"{d}_B{B}" + (f"_K{K}" if K != BINS else "") + \
            ("_zero_slopes" if zero_slopes else "")
        got, want, _ = compare(B, K, std, inverse, zero_slopes)
        errs[name] = check_pair("kernel_backward", errs, got, want, (G_TOL, G_TOL),
                                ("dx", "dparams"))
    # a reading, not a bar: the sweep at PARAM_STD, the kernel's and the
    # float32 plain version's excess over the bars
    reading = {}
    for K, inverse in itertools.product(PLANAR_BINS, (False, True)):
        got, want, plain = compare(N + 37, K, PARAM_STD, inverse)
        reading[f"{'inverse' if inverse else 'forward'}_K{K}"] = {
            name: [excess(a, b, G_TOL, G_TOL) for a, b in zip(out, want)]
            for name, out in (("kernel", got), ("plain_f32", plain))}
    emit("kernel_backward", ok=True, errors=errs,
         bars={"dx": [G_TOL, G_TOL], "dparams": [G_TOL, G_TOL], "param_std": PARAM_STD,
               "sweep_std": SWEEP_STD},
         reference="float64", sweep_at_param_std=reading,
         note="sweep_at_param_std: [dx, dparams] excess over the bars (> 0 misses) of the "
         "kernel and of the float32 plain version, each against float64; a reading, not "
         "a bar")
    return errs


class Draws(torch.nn.Module):
    """Stands in for a model's base distribution: hands out one fixed draw
    ``(z, log_q)``, and the real base's log_prob."""

    def __init__(self, base, z, log_q):
        super().__init__()
        self.base = base
        self.z, self.log_q = z, log_q

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        return self.z.clone(), self.log_q.clone()

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


def reverse_kld_loss(num_samples):
    return lambda model, batch, generator: model.reverse_kld(num_samples,
                                                             generator=generator)


def forward_kld_loss(model, batch, generator):
    return model.forward_kld(batch)


def phase_train_path():
    """(a) one f32 step on the card against the CPU, (b) exact launch counts
    of a reverse-KL and a forward-KL step at 2^14, (c) TRAIN_STEPS bf16 steps
    from bench.py's init: finite, and the loss falls."""
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    def fixed_draws(card, cpu):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        z, log_q = card.q0.sample_and_log_prob(N_TRAIN_CPU, generator=gen)
        card.q0 = Draws(card.q0, z, log_q)
        cpu.q0 = Draws(cpu.q0, z.cpu(), log_q.cpu())

    results = {"card_vs_cpu": step_against_cpu(
        "train_path", build_flagship, N_TRAIN_CPU, fixed_draws,
        {"planar": (2 * LAYERS, 2 * LAYERS)})}
    launches = {"backward_forward": 0, "backward_inverse": 0}

    model = build_flagship(DEVICE, init_identity=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(N))
    (_, m), got = counted("reverse_kld step", lambda: step(state, None, gen),
                          planar=(2 * LAYERS, 2 * LAYERS))
    fwd, bwd = got["planar"]
    launches["backward_inverse"] += bwd
    with torch.no_grad():
        x, _ = model.sample(N, generator=gen)
    fstate, fstep = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                    forward_kld_loss)
    (_, mf), fgot = counted("forward_kld step", lambda: fstep(fstate, x, gen),
                            planar=(LAYERS, LAYERS))
    ffwd, fbwd = fgot["planar"]
    launches["backward_forward"] += fbwd
    results["launches_per_step"] = {
        "reverse_kld": {"forward": fwd, "backward": bwd, "loss": float(m["loss"])},
        "forward_kld": {"forward": ffwd, "backward": fbwd, "loss": float(mf["loss"])}}
    if not (m["finite"] and mf["finite"]):
        emit("train_path", ok=False, results=results)
        raise SystemExit("a full-width f32 training step gave a non-finite loss")

    model = set_compute_dtype(build_flagship(DEVICE, init_identity=True), "bfloat16")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(N))
    losses = []

    def train():
        for _ in range(TRAIN_STEPS):
            _, metrics = step(state, None, gen)
            losses.append(metrics["loss"])

    t0 = time.perf_counter()
    _, tgot = counted(f"{TRAIN_STEPS} bf16 steps", train,
                      planar=(2 * LAYERS * TRAIN_STEPS, 2 * LAYERS * TRAIN_STEPS))
    tfwd, tbwd = tgot["planar"]
    seconds = time.perf_counter() - t0
    launches["backward_inverse"] += tbwd
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    results["bf16_training"] = {
        "steps": TRAIN_STEPS, "seconds": seconds, "all_finite": bool(np.isfinite(losses).all()),
        "mean_first_20": first, "mean_last_20": last, "max_loss": float(losses.max()),
        "max_loss_step": int(losses.argmax()), "losses": losses.tolist(),
        "forward_launches": tfwd, "backward_launches": tbwd}
    ok = results["bf16_training"]["all_finite"] and last < first
    emit("train_path", ok=ok, results=results,
         bars={"loss": [CPU_TOL, CPU_TOL], "gradient_norm": STEP_G_TOL})
    if not ok:
        raise SystemExit("bf16 training: a loss was not finite or the loss did not fall")
    return launches


def step_against_cpu(phase, build, n, freeze_base, launches, loss_fn=None, batch=None,
                     counts=None):
    """One f32 step, make_train_step + Adam, on the card and on the CPU from
    the same weights (``build`` makes the model): a reverse-KL step on the
    same ``n`` base draws (``freeze_base(card, cpu)`` gives both models'
    bases one fixed draw), or ``loss_fn`` on ``batch`` (on the card; its
    copy on the CPU); the card's step launches the kernels exactly
    ``launches`` times (``counted``).  Every gradient leaf within 2e-3 of its
    norm, the loss within 1e-3.  With the device counters ``counts``
    (``device_counters``), the card's step also runs under ``on_card`` and
    the result's ``device_launches`` holds what they counted."""
    from normflows_tpu_torch.training import make_train_step

    card = build(DEVICE)
    cpu = build("cpu")
    cpu.load_state_dict(card.state_dict())
    freeze_base(card, cpu)
    out = {}
    for where, model in (("card", card), ("cpu", cpu)):
        state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                      loss_fn or reverse_kld_loss(n))
        b = None if batch is None else (batch if where == "card" else batch.cpu())
        on_device = counts is not None and where == "card"
        run = lambda: step(state, b)  # noqa: E731
        t0 = time.perf_counter()
        res, _ = counted(f"{phase} step on the {where}",
                         (lambda: on_card(counts, run)) if on_device else run,
                         **(launches if where == "card" else {}))
        if on_device:
            res, device_launches = res
        _, metrics = res
        out[where] = (float(metrics["loss"]), time.perf_counter() - t0,
                      {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (loss_card, s_card, g_card), (loss_cpu, s_cpu, g_cpu) = out["card"], out["cpu"]
    rel = {k: float((g_card[k] - g_cpu[k]).norm() / (g_cpu[k].norm() + 1e-12))
           for k in g_cpu if float(g_cpu[k].norm()) > 0}
    worst = max(rel, key=rel.get)
    r = {"samples": n, "loss_card": loss_card, "loss_cpu": loss_cpu,
         "excess_loss": excess(torch.tensor(loss_card), torch.tensor(loss_cpu),
                               CPU_TOL, CPU_TOL),
         "leaves": len(g_cpu), "worst_leaf": worst, "worst_relative_norm": rel[worst],
         # the leaves outside the autoregressive nets: LU, base, target
         "relative_norm": {k: v for k, v in rel.items()
                           if not k.startswith("flows.") or ".linear." in k},
         "zero_leaves_equal": all(bool((g_card[k] == 0).all()) for k in g_cpu
                                  if k not in rel),
         "seconds_card_first_step": s_card, "seconds_cpu": s_cpu}
    if counts is not None:
        r["device_launches"] = device_launches
    if r["excess_loss"] > 0 or rel[worst] > STEP_G_TOL or not r["zero_leaves_equal"]:
        emit(phase, ok=False, card_vs_cpu=r)
        raise SystemExit(f"{phase}: the training step on the card disagrees with the CPU")
    return r


def phase_times_train():
    """Step time and samples/s (host median of REQUEST_REPS steps, each ending in a
    synchronise), the profiler's view of one step, in f32 and bf16; and the
    backward kernel's own times at 2^14."""
    from normflows_tpu_torch.ops import spline_cuda as sc
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    model = build_flagship(DEVICE, init_identity=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    steps = {}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                      reverse_kld_loss(N))
        fn = lambda: step(state, None, gen)  # noqa: E731
        ms = host_ms(fn, reps=REQUEST_REPS)
        prof = profile(fn, top=8)
        steps[dtype] = {"ms": ms, "samples_per_s": N / (ms / 1e3), "profile": prof,
                        "busy_share_of_median": prof["device_ms"] / ms}

    rng = np.random.default_rng(SEED + 7)
    # 16 input sets of 4.33 MB read each (69 MB > the 50 MB L2)
    sets = [(*planar_inputs(rng, N), *cotangents(rng, N)) for _ in range(16)]
    rotation, y = itertools.cycle(sets), torch.empty(2, N, device=DEVICE)
    floor = graph_ms(lambda: torch.neg(next(rotation)[0], out=y), reps=64)
    kernel, call, plain = {}, {}, {}
    for inverse in (False, True):
        d = "inverse" if inverse else "forward"
        for times, fn, timer, reps in (
                (kernel, sc.rqs_transposed_backward, graph_ms, 64),
                (call, sc.rqs_transposed_backward, cuda_ms, 400),
                (plain, sc.rqs_transposed_backward_reference, cuda_ms, 20)):
            rotation = itertools.cycle(sets)
            times[d] = timer(
                lambda: fn(*next(rotation), CODES, TAIL_BOUND, inverse), reps=reps)
    F, P = 2, 2 * (3 * BINS + 1)
    # x, params, ybar, lbar read once; dx, dparams written once
    bytes_moved = (4 * F + 2 * P) * N * 4
    # per element: the forward's selection (~21 K + 28), the pull-back of
    # the rational-quadratic map (~130), the softmax scatter (~12 a bin and
    # logit row) and the slope scatter (~10 a knot)
    ops = (21 * BINS + 28 + 130 + 24 * BINS + 10 * (BINS + 1)) * F * N
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    emit("times_train", steps=steps, batch=N, backward_kernel={
        "kernel_ms": kernel, "call_ms": call, "plain_ms": plain, "bound_ms": bound_ms,
        "bound_by": bound_by, "floor_ms": floor, "bytes": bytes_moved, "ops": ops},
        note=f"ms: host median of {REQUEST_REPS} reverse-KL + Adam steps from bench.py's init, "
        "each ending in a synchronise; profile: one step under torch.profiler; "
        "kernel_ms: device time, 64 launches in one CUDA graph, inputs rotated "
        "through 69 MB; call_ms and plain_ms: CUDA events over a loop of calls; "
        "floor_ms: torch.neg on the same 2 x 2^14 floats in the same kind of graph")
    return kernel, plain, bound_ms, bound_by, floor, steps


# ---- large-D autoregressive NSF: the flat spline kernels ---------------------

def flat_inputs(rng, N, slab, K=LD_BINS):
    """Inputs of the flat kernel, from the numpy generator: x (N,) with ~20%
    outside +-bound, codes mixing linear and circular tails per element,
    bounds, and the parameter rows uw_t, uh_t (K, N), ud_t (K+1, N).  With
    ``slab`` the rows are one feature's slab of a (D(3K+1), N) tensor, as
    the sliced inverse hands them over; else a packed (3K+1, N) tensor."""
    S = 3 * K + 1
    codes = rng.choice([1, 2], size=N).astype(np.int32)
    bounds = np.where(codes == 1, LD_TAIL_BOUND, math.pi).astype(np.float32)
    x = (rng.uniform(-1.25, 1.25, N) * bounds).astype(np.float32)
    rows = S * LD_D if slab else S
    params = torch.from_numpy((PARAM_STD * rng.normal(size=(rows, N))).astype(np.float32))
    params = params.to(DEVICE)
    if slab:
        f = int(rng.integers(LD_D))
        params = params[f * S:(f + 1) * S]
    to = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    return to(x), params[:K], params[K:2 * K], params[2 * K:], to(codes), to(bounds)


FLAT_CASES = ((LD_BATCH, True), (LD_BATCH + 37, True), (LD_BATCH * LD_D, False))
# the forward's bin counts: 2, the models' 8 and 10, the register path's
# largest (16, bins above K masked below it) and one above it (the loops
# over a runtime K), on the sliced inverse's slab.  The runtime-tail bars
# are the JAX package's for its own kernel on its own inputs
# (tests/test_pallas.py:408-429: x ~ U(-4, 4), logits N(0, 0.3^2), linear
# tails at 4 and circular at pi in turn), and the sweep draws those: at
# PARAM_STD = 0.5 and K >= 10 float32 rounding of the knot sums, amplified
# by the inverse's steep bins, takes a few elements past them in every
# float32 evaluation, JAX's interpret-mode kernel included (PERF.md).
FLAT_BINS = (2, 8, 10, 16, 20)
SWEEP_STD = 0.3


def flat_sweep_inputs(rng, N, K):
    """The flat kernel's inputs as the JAX package's dyncodes test draws
    them, on one feature's slab of a (D(3K+1), N) tensor."""
    S = 3 * K + 1
    codes = np.where(np.arange(N) % 2 == 0, 1, 2).astype(np.int32)
    bounds = np.where(codes == 1, 4.0, math.pi).astype(np.float32)
    x = rng.uniform(-4, 4, N).astype(np.float32)
    params = torch.from_numpy((SWEEP_STD * rng.normal(size=(S * LD_D, N))).astype(np.float32))
    f = int(rng.integers(LD_D))
    params = params.to(DEVICE)[f * S:(f + 1) * S]
    to = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    return to(x), params[:K], params[K:2 * K], params[2 * K:], to(codes), to(bounds)


def phase_kernel_flat():
    """The flat kernel against its plain version (in float64) on the same
    CUDA tensors: the sliced inverse's slab at N = 4096 and 4096 + 37
    (runtime-tail bars) and packed rows at N = 262,144, the density
    direction's size (static-tail bars), both directions; the forward at
    every bin count of FLAT_BINS on the slab (flat_sweep_inputs); then the
    static-tail entry on the (B, D, 3K+1) view of a net's output, with mixed
    per-dim tails."""
    from normflows_tpu_torch.ops import splines
    from normflows_tpu_torch.ops import spline_flat as sf

    rng = np.random.default_rng(SEED + 10)
    errs = {}
    for N, slab in FLAT_CASES:
        y_tol, ld_tol = (FLAT_Y_TOL, FLAT_LD_TOL) if slab else (Y_TOL, LD_TOL)
        for inverse in (False, True):
            args = flat_inputs(rng, N, slab)
            y, ld = sf.unconstrained_rqs_dyncodes(*args, inverse)
            sync()
            want = sf.unconstrained_rqs_dyncodes_reference(*as_f64(args), inverse)
            e = check_pair("kernel_flat", errs, (y, ld), want, (y_tol, ld_tol), ("y", "ld"))
            plain = sf.unconstrained_rqs_dyncodes_reference(*args, inverse)
            e["plain_f32_excess"] = [excess(a, b, t, t)
                                     for a, b, t in zip(plain, want, (y_tol, ld_tol))]
            errs[f"{'inverse' if inverse else 'forward'}_N{N}"] = e
    # every instantiation of the forward: the bin sweep on the slab
    for K, (N, _), inverse in itertools.product(FLAT_BINS, FLAT_CASES[:2], (False, True)):
        args = flat_sweep_inputs(rng, N, K)
        y, ld = sf.unconstrained_rqs_dyncodes(*args, inverse)
        sync()
        want = sf.unconstrained_rqs_dyncodes_reference(*as_f64(args), inverse)
        errs[f"{'inverse' if inverse else 'forward'}_N{N}_K{K}"] = check_pair(
            "kernel_flat", errs, (y, ld), want, (FLAT_Y_TOL, FLAT_LD_TOL), ("y", "ld"))
    # a reading, not a bar: the same sweep at PARAM_STD (the inputs above),
    # the kernel's and the float32 plain version's excess over the bars
    reading = {}
    for K, (N, slab), inverse in itertools.product(FLAT_BINS, FLAT_CASES[:2], (False, True)):
        args = flat_inputs(rng, N, slab, K)
        got = sf.unconstrained_rqs_dyncodes(*args, inverse)
        want = sf.unconstrained_rqs_dyncodes_reference(*as_f64(args), inverse)
        plain = sf.unconstrained_rqs_dyncodes_reference(*args, inverse)
        reading[f"{'inverse' if inverse else 'forward'}_N{N}_K{K}"] = {
            name: [excess(a, b, t, t) for a, b, t in zip(out, want, (FLAT_Y_TOL, FLAT_LD_TOL))]
            for name, out in (("kernel", got), ("plain_f32", plain))}
    # the static-tail entry: x (B, D), params (D(3K+1), B) viewed (B, D, 3K+1)
    K, S = LD_BINS, 3 * LD_BINS + 1
    codes = tuple(1 + (d % 3 == 0) for d in range(LD_D))
    bounds = tuple(math.pi if c == 2 else LD_TAIL_BOUND for c in codes)
    x = (rng.uniform(-1.25, 1.25, (LD_BATCH, LD_D)) * np.asarray(bounds)).astype(np.float32)
    x = torch.from_numpy(x).to(DEVICE)
    p_t = torch.from_numpy((PARAM_STD * rng.normal(size=(LD_D * S, LD_BATCH)))
                           .astype(np.float32)).to(DEVICE)
    p = p_t.T.view(LD_BATCH, LD_D, S)
    for inverse in (False, True):
        out = sf.unconstrained_rational_quadratic_spline_flat(
            x, p[..., :K], p[..., K:2 * K], p[..., 2 * K:], codes, bounds, inverse)
        sync()
        x64, p64 = x.double(), p.double()
        ref = splines.unconstrained_rational_quadratic_spline(
            x64, p64[..., :K], p64[..., K:2 * K], p64[..., 2 * K:], inverse=inverse,
            tail_codes=torch.tensor(codes, device=DEVICE),
            tail_bound=torch.tensor(bounds, dtype=torch.float64, device=DEVICE))
        errs[f"{'inverse' if inverse else 'forward'}_natural_B{LD_BATCH}_D{LD_D}"] = \
            check_pair("kernel_flat", errs, out, ref, (Y_TOL, LD_TOL), ("y", "ld"))
    emit("kernel_flat", ok=True, errors=errs, bars={
        "runtime_tails": [FLAT_Y_TOL, FLAT_LD_TOL], "static_tails": [Y_TOL, LD_TOL],
        "param_std": PARAM_STD, "sweep_std": SWEEP_STD},
        sweep_at_param_std=reading,
        note="sweep_at_param_std: [y, ld] excess over the runtime-tail bars (> 0 misses) of "
        "the kernel and of the float32 plain version, each against float64, on the slab "
        "inputs at param_std; a reading, not a bar")
    return errs


def as_f64(args):
    """The flat kernel's operands with the floating ones in float64."""
    return [a.double() if a.is_floating_point() else a for a in args]


def check_pair(phase, errs, got, want, tols, names):
    """Max |a - b| and the excess over atol = rtol = tol of each pair of
    outputs; fail the phase unless all are finite and within their bars."""
    e = {"finite": all(bool(torch.isfinite(a).all()) for a in got)}
    for a, b, tol, name in zip(got, want, tols, names):
        e[f"max_abs_{name}"] = float((a - b).abs().max())
        e[f"excess_{name}"] = excess(a, b, tol, tol)
    if not e["finite"] or any(v > 0 for k, v in e.items() if k.startswith("excess")):
        emit(phase, ok=False, errors=errs, failed=e)
        raise SystemExit(f"{phase}: the kernel disagrees with its plain version")
    return e


def phase_kernel_flat_backward():
    """The flat backward kernel against its plain version (autograd through
    the plain spline, in float64) at the same shapes, both directions, and
    with zero derivative logits at 4096 + 37; then every instantiation: the
    bin sweep of FLAT_BINS on the slab (flat_sweep_inputs) at 4096 and
    4096 + 37."""
    from normflows_tpu_torch.ops import spline_flat as sf

    rng = np.random.default_rng(SEED + 11)
    errs = {}

    def check(key, args, N, inverse):
        yb, lb = (torch.from_numpy(a).to(DEVICE)
                  for a in rng.normal(size=(2, N)).astype(np.float32))
        got = sf.unconstrained_rqs_dyncodes_backward(*args, yb, lb, inverse)
        sync()
        want = sf.unconstrained_rqs_dyncodes_backward_reference(
            *as_f64([*args, yb, lb]), inverse)
        e = check_pair("kernel_flat_backward", errs, got, want, (FLAT_G_TOL,) * 4,
                       ("dx", "duw", "duh", "dud"))
        plain = sf.unconstrained_rqs_dyncodes_backward_reference(*args, yb, lb, inverse)
        e["plain_f32_excess"] = [excess(a, b, FLAT_G_TOL, FLAT_G_TOL)
                                 for a, b in zip(plain, want)]
        errs[key] = e

    for (N, slab), zero_slopes in [(c, False) for c in FLAT_CASES] + [(FLAT_CASES[1], True)]:
        for inverse in (False, True):
            args = flat_inputs(rng, N, slab)
            if zero_slopes:
                args[3].zero_()
            check(f"{'inverse' if inverse else 'forward'}_N{N}" + ("_zero_slopes" * zero_slopes),
                  args, N, inverse)
    # every instantiation of the backward: the bin sweep on the slab
    for K, (N, _), inverse in itertools.product(FLAT_BINS, FLAT_CASES[:2], (False, True)):
        check(f"{'inverse' if inverse else 'forward'}_N{N}_K{K}", flat_sweep_inputs(rng, N, K),
              N, inverse)
    emit("kernel_flat_backward", ok=True, errors=errs, bars={"gradients": FLAT_G_TOL,
                                                             "sweep_std": SWEEP_STD})
    return errs


def build_large_d(device, init_identity=False):
    """examples/ar_large_d_bench.py's stack: 4 x (AR RQ-spline, LULinearPermute)
    with a DiagGaussian base and target; seeds as there."""
    import normflows_tpu_torch as nft

    layers = []
    for i in range(LD_LAYERS):
        layers.append(nft.flows.AutoregressiveRationalQuadraticSpline.create(
            torch.Generator().manual_seed(SEED + i), LD_D, 1, LD_HIDDEN, num_bins=LD_BINS,
            tail_bound=LD_TAIL_BOUND, permute_mask=True, rng_seed=i,
            init_identity=init_identity, device=device))
        layers.append(nft.flows.LULinearPermute.create(
            LD_D, generator=torch.Generator().manual_seed(SEED + 100 + i), device=device))
    target = nft.distributions.DiagGaussian.create(LD_D, device=device)
    with torch.no_grad():
        target.loc.fill_(0.5)
        target.log_scale.fill_(-0.2)
    return nft.NormalizingFlow.create(nft.distributions.DiagGaussian.create(LD_D, device=device),
                                      layers, p=target, device=device)


def phase_large_d_path():
    """sample(4096) and log_prob of the samples, f32 and bf16: exactly 256
    flat launches per sample (4 layers x 64 steps), 4 per log_prob, no
    planar one; sample's log_q against log_prob; f32 on the card against
    the CPU, bf16 against f32."""
    from normflows_tpu_torch.utils import set_compute_dtype

    model = build_large_d(DEVICE)
    results, launches = {}, {"forward": 0, "inverse": 0}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with torch.inference_mode():
            (x, log_q), n_s = counted(f"large-D sample {dtype}",
                                      lambda: model.sample(LD_BATCH, generator=gen),
                                      flat=(LD_LAYERS * LD_D, 0))
            lp, n_l = counted(f"large-D log_prob {dtype}", lambda: model.log_prob(x),
                              flat=(LD_LAYERS, 0))
        launches["inverse"] += n_s["flat"][0]
        launches["forward"] += n_l["flat"][0]
        finite = all(bool(torch.isfinite(t).all()) for t in (x, log_q, lp))
        gap = (lp - log_q).abs()
        r = {"sample_launches": n_s, "log_prob_launches": n_l, "finite": finite,
             "shape": list(x.shape), "median_abs_logq_gap": float(gap.median()),
             "max_abs_logq_gap": float(gap.max()), "mean_log_q": float(log_q.mean())}
        results[dtype] = r
        bar = LOGQ_LD_F32 if dtype == "float32" else LOGQ_LD_BF16
        if not (finite and tuple(x.shape) == (LD_BATCH, LD_D)
                and r["median_abs_logq_gap"] <= bar):
            emit("large_d_path", ok=False, results=results)
            raise SystemExit(f"large-D path ({dtype}) failed its checks")
        if dtype == "float32":
            results["cpu"] = against_cpu("large_d_path", model, x, build_large_d, LD_CPU)
            x32, lp32 = x, lp
            continue
        with torch.inference_mode():
            vs_f32 = (model.log_prob(x32) - lp32).abs()
        r["log_prob_of_f32_samples_vs_f32"] = {"median_abs": float(vs_f32.median()),
                                               "max_abs": float(vs_f32.max())}
        if r["log_prob_of_f32_samples_vs_f32"]["median_abs"] > LD_BF16_VS_F32:
            emit("large_d_path", ok=False, results=results)
            raise SystemExit("large-D path: bf16 log_prob too far from f32")
    emit("large_d_path", ok=True, results=results,
         bars={"logq_f32": LOGQ_LD_F32, "logq_bf16": LOGQ_LD_BF16, "cpu": CPU_TOL,
               "bf16_vs_f32": LD_BF16_VS_F32})
    return model, launches


class Noise(torch.nn.Module):
    """Stands in for a DiagGaussian base: its reparameterised draw
    loc + exp(log_scale) * eps on fixed noise ``eps``, so that its loc and
    log_scale get their gradients as in a real draw; and its log_prob."""

    def __init__(self, base, eps):
        super().__init__()
        self.base = base
        self.eps = eps

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        z = self.base.loc + torch.exp(self.base.log_scale) * self.eps
        return z, self.base.log_prob(z)

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


def phase_large_d_train():
    """(a) one f32 reverse-KL step on the card against the CPU at 512
    samples, (b) exact flat launches of a reverse-KL step (256 + 256) and a
    forward-KL step (4 + 4) at 4096 from the bench's init, (c) 50 bf16
    steps from the bench's init: finite, and the loss falls."""
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    steps = LD_LAYERS * LD_D

    def fixed_noise(card, cpu):
        eps = torch.randn(LD_CPU, LD_D, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(SEED + 13))
        card.q0 = Noise(card.q0, eps)
        cpu.q0 = Noise(cpu.q0, eps.cpu())

    results = {"card_vs_cpu": step_against_cpu("large_d_train", build_large_d, LD_CPU,
                                               fixed_noise, {"flat": (steps, steps)})}
    launches = {"backward_forward": 0, "backward_inverse": 0, "forward": 0, "inverse": 0}

    model = build_large_d(DEVICE, init_identity=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(LD_BATCH))
    (_, m), got = counted("large-D reverse_kld step", lambda: step(state, None, gen),
                          flat=(steps, steps))
    with torch.no_grad():
        x, _ = model.sample(LD_BATCH, generator=gen)
    fstate, fstep = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                    forward_kld_loss)
    (_, mf), fgot = counted("large-D forward_kld step", lambda: fstep(fstate, x, gen),
                            flat=(LD_LAYERS, LD_LAYERS))
    launches["inverse"] += got["flat"][0]
    launches["backward_inverse"] += got["flat"][1]
    launches["forward"] += fgot["flat"][0]
    launches["backward_forward"] += fgot["flat"][1]
    results["launches_per_step"] = {
        "reverse_kld": {**got, "loss": float(m["loss"])},
        "forward_kld": {**fgot, "loss": float(mf["loss"])}}
    if not (m["finite"] and mf["finite"]):
        emit("large_d_train", ok=False, results=results)
        raise SystemExit("a large-D f32 training step gave a non-finite loss")

    model = set_compute_dtype(build_large_d(DEVICE, init_identity=True), "bfloat16")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(LD_BATCH))
    losses = []

    def train():
        for _ in range(LD_TRAIN_STEPS):
            losses.append(step(state, None, gen)[1]["loss"])

    t0 = time.perf_counter()
    _, tgot = counted(f"large-D {LD_TRAIN_STEPS} bf16 steps", train,
                      flat=(steps * LD_TRAIN_STEPS, steps * LD_TRAIN_STEPS))
    seconds = time.perf_counter() - t0
    launches["inverse"] += tgot["flat"][0]
    launches["backward_inverse"] += tgot["flat"][1]
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    results["bf16_training"] = {
        "steps": LD_TRAIN_STEPS, "seconds": seconds,
        "all_finite": bool(np.isfinite(losses).all()), "mean_first_10": first,
        "mean_last_10": last, "max_loss": float(losses.max()),
        "max_loss_step": int(losses.argmax()), "losses": losses.tolist(), "launches": tgot}
    ok = results["bf16_training"]["all_finite"] and last < first
    emit("large_d_train", ok=ok, results=results,
         bars={"loss": [CPU_TOL, CPU_TOL], "gradient_norm": STEP_G_TOL})
    if not ok:
        raise SystemExit("large-D bf16 training: a loss was not finite or did not fall")
    return launches


def flat_bound(N, backward):
    """Least time of a flat launch on N elements at K = LD_BINS, ms: the
    bytes it must move over the memory rate against its operations over the
    float32 rate (the larger).  Forward: x, 3K+1 parameters, code and bound
    read, y and ld written; backward: x, parameters, code, bound, ybar, lbar
    read, dx and 3K+1 gradients written.  Operations per element as in
    phase_times / phase_times_train."""
    K = LD_BINS
    if backward:
        words = (3 + (3 * K + 1) + 2) + (1 + (3 * K + 1))
        ops = 21 * K + 28 + 130 + 24 * K + 10 * (K + 1)
    else:
        words = (1 + (3 * K + 1) + 2) + 2
        ops = 2 * (K - 1) + 6 * K + 13 * K + 40
    t_bytes, t_ops = words * 4 * N / HBM_BYTES_PER_S, ops * N / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        words * 4 * N


# the flat kernels' timed sizes: the sliced inverse's slab, the coupled
# model's request (the static-tail entry's packed rows; forward only) and
# the large-D density direction
FLAT_TIMED = ((LD_BATCH, True), (2**14, False), (LD_BATCH * LD_D, False))


def phase_times_large_d(model, flat_res):
    """The flat kernels' device time (CUDA graph) and call time at the sizes
    the paths give them, with their bounds, their plain versions' times and,
    beside each, the launch floor: one elementwise torch operation on the
    same N floats (x -> -x) in the same kind of graph; the registers of each
    instantiation; the static-tail entry's call with its relayout; request
    and step times."""
    from normflows_tpu_torch.ops import spline_flat as sf

    rng = np.random.default_rng(SEED + 14)
    kernels, floor = {}, {}
    for N, slab in FLAT_TIMED:
        # 16 input sets: 7.7 MB at N = 4096 (L2-resident, as the slab is right
        # after the MADE wrote it), 503 MB at N = 262,144 (from device memory)
        sets = [(*flat_inputs(rng, N, slab),
                 *(torch.from_numpy(a).to(DEVICE) for a in rng.normal(size=(2, N))
                   .astype(np.float32))) for _ in range(16)]
        rotation, y = itertools.cycle(sets), torch.empty(N, device=DEVICE)
        floor[N] = graph_ms(lambda: torch.neg(next(rotation)[0], out=y), reps=64)
        for inverse in (False, True):
            d = "inverse" if inverse else "forward"
            for backward in (False, True) if N != 2**14 else (False,):
                name = f"rqs_flat_{'backward_' if backward else ''}{d}"
                fn = sf.unconstrained_rqs_dyncodes_backward if backward else \
                    sf.unconstrained_rqs_dyncodes
                plain = sf.unconstrained_rqs_dyncodes_backward_reference if backward else \
                    sf.unconstrained_rqs_dyncodes_reference
                n_args = 8 if backward else 6
                r = {}
                for key, f, timer, reps in (("ms", fn, graph_ms, 64),
                                            ("call_ms", fn, cuda_ms, 400),
                                            ("plain_ms", plain, cuda_ms, 10)):
                    rotation = itertools.cycle(sets)
                    r[key] = timer(lambda: f(*next(rotation)[:n_args], inverse), reps=reps)
                r["bound_ms"], r["bound_by"], r["bytes"] = flat_bound(N, backward)
                r["floor_ms"] = floor[N]
                kernels.setdefault(name, {})[N] = r
    # the static-tail entry with its relayout of (B, D, 3K+1) views into rows
    K, S = LD_BINS, 3 * LD_BINS + 1
    x = torch.randn(LD_BATCH, LD_D, device=DEVICE)
    p_t = PARAM_STD * torch.randn(LD_D * S, LD_BATCH, device=DEVICE)
    p = p_t.T.view(LD_BATCH, LD_D, S)
    tails = ((1,) * LD_D, (LD_TAIL_BOUND,) * LD_D)

    def natural():
        return sf.unconstrained_rational_quadratic_spline_flat(
            x, p[..., :K], p[..., K:2 * K], p[..., 2 * K:], *tails, False)

    entry = {"call_ms": cuda_ms(natural, reps=200), "device_ms": graph_ms(natural, reps=32),
             "note": "forward at (4096, 64): the three (B, D, S) -> (S, N) copies of the "
                     "parameters, the flat input's copy, the code and bound rows, and "
                     "the kernel"}
    emit("times_large_d_kernels", kernels=kernels, static_tail_entry=entry,
         floor_ms=floor, resources=flat_res,
         note="ms: device time, 64 launches in one CUDA graph, 16 input sets rotated; "
         "call_ms and plain_ms: CUDA events over a loop of calls (the wrapper's host "
         "work included); bound_ms: bytes over 3.35 TB/s or operations over 67 TFLOP/s; "
         "floor_ms: torch.neg on the same N floats, 64 launches in one CUDA graph, a "
         "reading of the launch cost, not a bound; resources: ptxas -v, per thread, "
         "by instantiation (forward_<bins>, backward_<direction>_<bins>: the kernel at "
         "that compile-time bin count; 16_masked: K <= 16; runtime: K > 16)")
    return kernels, large_d_request_and_step_times(model)


def large_d_request_and_step_times(model):
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    out = {}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        r = {}
        with torch.inference_mode():
            x, _ = model.sample(LD_BATCH, generator=gen)
            for what, fn in (("sample", lambda: model.sample(LD_BATCH, generator=gen)),
                             ("log_prob", lambda: model.log_prob(x))):
                r[what] = timed(fn, reps=LD_TIMED_REPS)
        trained = set_compute_dtype(build_large_d(DEVICE, init_identity=True),
                                    None if dtype == "float32" else dtype)
        for what, loss_fn, batch in (("reverse_kld_step", reverse_kld_loss(LD_BATCH), None),
                                     ("forward_kld_step", forward_kld_loss, x)):
            state, step = make_train_step(
                trained, torch.optim.Adam(trained.parameters(), lr=LR), loss_fn)
            r[what] = timed(lambda: step(state, batch, gen), reps=LD_TIMED_REPS)
        out[dtype] = r
    emit("times_large_d", requests_and_steps=out, batch=LD_BATCH,
         note=f"ms: host median of {LD_TIMED_REPS} calls, each ending in a synchronise; "
         "profile: one call under torch.profiler tracing the device alone, device time "
         "summed over its CUDA kernels (the heaviest kernels: PERF.md section 5); "
         "busy_share_of_median: that over the median; steps from the bench's init")
    return out


def timed(fn, batch=LD_BATCH, reps=20):
    """Host median of ``reps`` calls after one, then one call's device time
    under ``busy`` (the device traced alone, whose trace takes a fraction of
    the time to read)."""
    ms = host_ms(fn, reps=reps, warmup=1)
    prof = busy(fn)
    return {"ms": ms, "samples_per_s": batch / (ms / 1e3), "profile": prof,
            "busy_share_of_median": prof["device_ms"] / ms}


# ---- large-D density direction with the fused MADE ---------------------------

def made_case(B, F, H, R, mult, bf16, seed):
    """x (B, F) and the packed operands of a MADE with random weights (the
    residual blocks' second linear drawn like the others, not near zero),
    from the seed."""
    import normflows_tpu_torch as nft
    from normflows_tpu_torch.ops import made_fused as mf

    made = nft.nets.MADE(F, H, num_blocks=R, output_multiplier=mult, permute_mask=True,
                         rng_seed=seed, generator=torch.Generator().manual_seed(seed),
                         device=DEVICE)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for blk in made.blocks:
            for t in (blk.linear_1.weight, blk.linear_1.bias):
                t.copy_(torch.empty(t.shape).uniform_(-H ** -0.5, H ** -0.5, generator=gen))
    if bf16:
        nft.utils.set_compute_dtype(made, "bfloat16")
    x = np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32)
    return torch.from_numpy(x).to(DEVICE), [t.detach() for t in mf.pack(made)], made


def made_key(case, bf16):
    B, F, H, R, mult = case
    return f"B{B}_F{F}_H{H}_R{R}_P{F * mult}_{'bf16' if bf16 else 'f32'}"


def phase_kernel_made_fused():
    """The fused forward kernels against their plain version on the same
    CUDA tensors: f32 against it in float64, bf16 against the bf16 plain
    version (in float32, and in float64 beside) and against the f32 one;
    two calls on the same inputs give the same bits."""
    from normflows_tpu_torch.ops import made_fused as mf

    errs = {}
    for i, case in enumerate(MADE_CASES):
        for bf16 in (False, True):
            x, ops, _ = made_case(*case, bf16, SEED + 20 + i)
            out = mf.fused_resmade(x, *ops)
            again = mf.fused_resmade(x, *ops)
            sync()
            if bf16:
                e = check_pair("kernel_made_fused", errs, (out, out),
                               (mf.fused_resmade_reference(x, *ops),
                                mf.fused_resmade_reference(x.double(), *ops)),
                               (MADE_BF16_TOL,) * 2, ("out", "out_vs_float64"))
                f32 = mf.fused_resmade_reference(x, *[t.float() for t in ops])
                e["max_abs_vs_f32"] = float((out - f32).abs().max())
                e["excess_vs_f32"] = excess(out, f32, *MADE_BF16_F32)
                if e["excess_vs_f32"] > 0:
                    emit("kernel_made_fused", ok=False, errors=errs, failed=e)
                    raise SystemExit("kernel_made_fused: bf16 kernel too far from f32")
            else:
                e = check_pair("kernel_made_fused", errs, (out,),
                               (mf.fused_resmade_reference(*[t.double() for t in (x, *ops)]),),
                               (MADE_Y_TOL,), ("out",))
            e["deterministic"] = torch.equal(out, again)
            errs[made_key(case, bf16)] = e
            if not e["deterministic"]:
                emit("kernel_made_fused", ok=False, errors=errs)
                raise SystemExit("kernel_made_fused: two calls on the same inputs differ")
    emit("kernel_made_fused", ok=True, errors=errs,
         bars={"f32_vs_float64": MADE_Y_TOL, "bf16_vs_bf16_plain": MADE_BF16_TOL,
               "bf16_vs_f32_plain": MADE_BF16_F32},
         note="deterministic: a second call on the same inputs gives the same bits")
    return errs


GRAD_NAMES = ("dx", "dw0", "db0", "dw1s", "db1s", "dw2s", "db2s", "dwf", "dbf")


def phase_kernel_made_fused_backward():
    """The fused backward kernels against their plain version (the pull-back
    written out): f32 against it in float64, bf16 against the bf16 one.
    The kernels' pre-activations, read from their scratch, are held against
    the plain forward's at the forward's bar; the plain pull-back then takes
    their side of relu's step (a pre-activation within rounding of 0 may
    fall on either side in sums of another order)."""
    from normflows_tpu_torch.ops import made_fused as mf

    errs = {}
    for i, case in enumerate(MADE_CASES):
        B, _, H, R, _ = case
        for bf16 in (False, True):
            x, ops, _ = made_case(*case, bf16, SEED + 30 + i)
            g = torch.from_numpy(np.random.default_rng(SEED + 40 + i).normal(
                size=(case[0], case[1] * case[4])).astype(np.float32)).to(DEVICE)
            scratch = torch.empty((4 * R + 2) * B * H, device=DEVICE)
            got = mf.fused_resmade_backward(x, *ops, g, scratch=scratch)
            sync()
            slabs = scratch.view(4 * R + 2, B, H)
            kinks = (slabs[:R], slabs[R + 1:2 * R + 1])
            args = (x, *ops, g) if bf16 else [t.double() for t in (x, *ops, g)]
            e = check_pair("kernel_made_fused_backward", errs, kinks,
                           mf.preactivations_reference(*args[:-1]),
                           (MADE_BF16_TOL if bf16 else MADE_Y_TOL,) * 2, ("h", "z"))
            want = mf.fused_resmade_backward_reference(*args, kinks=kinks)
            e.update(check_pair("kernel_made_fused_backward", errs, got, want,
                                (MADE_BF16_TOL if bf16 else MADE_G_TOL,) * 9, GRAD_NAMES))
            again = mf.fused_resmade_backward(x, *ops, g)
            sync()
            e["deterministic"] = all(torch.equal(a, b) for a, b in zip(got, again))
            errs[made_key(case, bf16)] = e
            if not e["deterministic"]:
                emit("kernel_made_fused_backward", ok=False, errors=errs)
                raise SystemExit("kernel_made_fused_backward: two calls on the same inputs "
                                 "differ")
    emit("kernel_made_fused_backward", ok=True, errors=errs,
         bars={"f32_vs_float64": MADE_G_TOL, "bf16_vs_bf16_plain": MADE_BF16_TOL},
         note="deterministic: a second call on the same inputs gives the same bits")
    return errs


def forward_kld_grads(model, x):
    """The forward-KL loss of ``x`` and every gradient leaf, facade and
    autograd only (no optimizer)."""
    model.zero_grad(set_to_none=True)
    loss = model.forward_kld(x)
    loss.backward()
    return float(loss), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}


def relative_norms(got, want):
    return {k: float((got[k].cpu() - want[k].cpu()).norm() / (want[k].norm() + 1e-12))
            for k in want if float(want[k].norm()) > 0}


def phase_large_d_fused():
    """The large-D model with fusion on: log_prob(4096) and a forward-KL
    step in f32 and bf16 with exactly 4 fused forward launches per log_prob
    and 4 + 4 per step, none in sample or the reverse-KL step, none with
    fusion off; fusion on against off (f32 log_prob and loss within 1e-4,
    each gradient leaf within 2e-3 of its norm); bf16 log_prob against the
    f32 log_prob of the same samples; the card against the CPU at 512
    samples with fusion on; 20 bf16 forward-KL steps."""
    from normflows_tpu_torch.ops import backend
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    L, steps = LD_LAYERS, LD_LAYERS * LD_D
    launches = {"forward": 0, "backward": 0}
    results = {}
    model = build_large_d(DEVICE)
    backend.set_made_fusion(True)
    try:
        for dtype in ("float32", "bfloat16"):
            set_compute_dtype(model, None if dtype == "float32" else dtype)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            with torch.inference_mode():
                (x, log_q), _ = counted(f"fused sample {dtype}",
                                        lambda: model.sample(LD_BATCH, generator=gen),
                                        flat=(steps, 0))
                lp, n_l = counted(f"fused log_prob {dtype}", lambda: model.log_prob(x),
                                  flat=(L, 0), made=(L, 0))
                backend.set_made_fusion(False)
                lp_off, _ = counted(f"unfused log_prob {dtype}", lambda: model.log_prob(x),
                                    flat=(L, 0))
                backend.set_made_fusion(True)
                if dtype == "bfloat16":  # the f32 log_prob of the same samples
                    set_compute_dtype(model, None)
                    lp_f32 = model.log_prob(x)
                    set_compute_dtype(model, dtype)
            x = x.clone()  # a normal tensor, which autograd may save
            launches["forward"] += n_l["made"][0]
            (loss, grads), n_f = counted(f"fused forward_kld {dtype}",
                                         lambda: forward_kld_grads(model, x),
                                         flat=(L, L), made=(L, L))
            launches["forward"] += n_f["made"][0]
            launches["backward"] += n_f["made"][1]
            backend.set_made_fusion(False)
            (loss_off, grads_off), _ = counted(f"unfused forward_kld {dtype}",
                                               lambda: forward_kld_grads(model, x), flat=(L, L))
            backend.set_made_fusion(True)
            gap = (lp - log_q).abs()
            rel = relative_norms(grads, grads_off)
            worst = max(rel, key=rel.get)
            r = {"finite": all(bool(torch.isfinite(t).all()) for t in (lp, *grads.values())),
                 "median_abs_logq_gap": float(gap.median()),
                 "max_abs_log_prob_vs_unfused": float((lp - lp_off).abs().max()),
                 "excess_log_prob_vs_unfused": excess(lp, lp_off, FUSED_TOL, FUSED_TOL),
                 "loss": loss, "loss_unfused": loss_off,
                 "excess_loss_vs_unfused": excess(torch.tensor(loss), torch.tensor(loss_off),
                                                  FUSED_TOL, FUSED_TOL),
                 "worst_leaf_vs_unfused": worst, "worst_relative_norm_vs_unfused": rel[worst],
                 "launches": {"log_prob": n_l, "forward_kld": n_f}}
            results[dtype] = r
            if dtype == "float32":
                ok = r["finite"] and r["median_abs_logq_gap"] <= LOGQ_LD_F32 and max(
                    r["excess_log_prob_vs_unfused"], r["excess_loss_vs_unfused"]) <= 0 \
                    and rel[worst] <= STEP_G_TOL
            else:
                # the fused bf16 MADE keeps its activations in f32, the unfused
                # one (sample's direction) in bf16: their gap is rounding, not
                # error.  The bar is the large-D path's: the f32 log_prob of
                # the same samples within a median LD_BF16_VS_F32.
                vs_f32 = (lp - lp_f32).abs()
                r["log_prob_vs_f32"] = {"median_abs": float(vs_f32.median()),
                                        "max_abs": float(vs_f32.max())}
                r["unfused_log_prob_vs_f32_median_abs"] = float((lp_off - lp_f32).abs().median())
                ok = r["finite"] and r["log_prob_vs_f32"]["median_abs"] <= LD_BF16_VS_F32
            if not ok:
                emit("large_d_fused", ok=False, results=results)
                raise SystemExit(f"large_d_fused ({dtype}) failed its checks")
            if dtype == "float32":
                results["cpu"] = fused_against_cpu(model, x)
                x32 = x
        # the training steps through make_train_step: forward KL fused, reverse
        # KL (the sliced inverse) not
        set_compute_dtype(model, None)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
        for what, loss_fn, batch, want in (
                ("forward_kld", forward_kld_loss, x32, {"flat": (L, L), "made": (L, L)}),
                ("reverse_kld", reverse_kld_loss(LD_BATCH), None, {"flat": (steps, steps)})):
            state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                          loss_fn)
            (_, m), got = counted(f"fused {what} step", lambda: step(state, batch, gen), **want)
            launches["forward"] += got["made"][0]
            launches["backward"] += got["made"][1]
            results[f"{what}_step"] = {"loss": float(m["loss"]), "finite": m["finite"],
                                       "launches": got}
        results["bf16_training"] = fused_bf16_training(launches)
    finally:
        backend.set_made_fusion(False)
    ok = results["bf16_training"]["all_finite"] and results["bf16_training"]["falls"]
    emit("large_d_fused", ok=ok, results=results,
         bars={"fused_vs_unfused": FUSED_TOL, "gradient_norm": STEP_G_TOL, "cpu": CPU_TOL,
               "logq_f32": LOGQ_LD_F32, "bf16_vs_f32": LD_BF16_VS_F32})
    if not ok:
        raise SystemExit("large_d_fused: bf16 forward-KL training not finite or not falling")
    return launches


def fused_against_cpu(model, x):
    """The same model on the CPU with fusion on (the fused plain versions):
    log_prob of 512 samples, and the forward-KL loss and gradients."""
    cpu = build_large_d("cpu")
    cpu.load_state_dict(model.state_dict())
    xs = x[:LD_CPU]
    with torch.inference_mode():
        lp_card, lp_cpu = model.log_prob(xs).cpu(), cpu.log_prob(xs.cpu())
    (loss_card, g_card), _ = counted("fused forward_kld at 512 on the card",
                                     lambda: forward_kld_grads(model, xs),
                                     flat=(LD_LAYERS, LD_LAYERS), made=(LD_LAYERS, LD_LAYERS))
    loss_cpu, g_cpu = forward_kld_grads(cpu, xs.cpu())
    rel = relative_norms(g_card, g_cpu)
    worst = max(rel, key=rel.get)
    r = {"samples": LD_CPU, "excess_log_prob": excess(lp_card, lp_cpu, CPU_TOL, CPU_TOL),
         "max_abs_log_prob": float((lp_card - lp_cpu).abs().max()),
         "loss_card": loss_card, "loss_cpu": loss_cpu,
         "excess_loss": excess(torch.tensor(loss_card), torch.tensor(loss_cpu), CPU_TOL,
                               CPU_TOL),
         "leaves": len(g_cpu), "worst_leaf": worst, "worst_relative_norm": rel[worst]}
    if max(r["excess_log_prob"], r["excess_loss"]) > 0 or rel[worst] > STEP_G_TOL:
        emit("large_d_fused", ok=False, cpu=r)
        raise SystemExit("large_d_fused: the fused model on the card disagrees with the CPU")
    return r


def fused_bf16_training(launches):
    """LD_FUSED_STEPS bf16 forward-KL steps with fusion on, from the bench's
    init, on one batch of the target's samples: finite, and the loss falls."""
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    model = set_compute_dtype(build_large_d(DEVICE, init_identity=True), "bfloat16")
    with torch.no_grad():
        x = model.p.sample(LD_BATCH, generator=torch.Generator(device=DEVICE).manual_seed(
            SEED + 15))
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  forward_kld_loss)
    losses = []

    def train():
        for _ in range(LD_FUSED_STEPS):
            losses.append(step(state, x)[1]["loss"])

    n = LD_LAYERS * LD_FUSED_STEPS
    t0 = time.perf_counter()
    _, got = counted(f"{LD_FUSED_STEPS} fused bf16 forward-KL steps", train,
                     flat=(n, n), made=(n, n))
    seconds = time.perf_counter() - t0
    launches["forward"] += got["made"][0]
    launches["backward"] += got["made"][1]
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    return {"steps": LD_FUSED_STEPS, "seconds": seconds,
            "all_finite": bool(np.isfinite(losses).all()), "mean_first_5": first,
            "mean_last_5": last, "falls": last < first, "losses": losses.tolist(),
            "launches": got}


def made_bound(case, bf16, backward):
    """Least time of the fused MADE at ``case``, ms, and what bounds it: the
    bytes it must move (x, weights, biases and, backward, g read once; out
    or dx and the gradients written once) over the memory rate, against its
    operations over the rate of their type (bf16: the tensor cores).  The
    forward's products are 2 B (F H + 2 R H^2 + H P) operations; the
    backward's the input and weight cotangents of every product, twice
    that, and the recompute of the hidden chain, 2 B (F H + 2 R H^2)."""
    B, F, H, R, mult = case
    P = F * mult
    n_w, n_b = F * H + 2 * R * H * H + H * P, H + 2 * R * H + P
    chain = 2 * B * (F * H + 2 * R * H * H)
    ops = 2 * B * n_w * (2 if backward else 1) + (chain if backward else 0)
    w_bytes = n_w * (2 if bf16 else 4) + n_b * 4
    moved = B * F * 4 + w_bytes + B * P * 4 + (B * F * 4 + w_bytes if backward else 0)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / (BF16_OPS_PER_S if bf16 else F32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        moved, ops


# Partial products of the fused MADE's split tensor-core products
# (csrc/made_fused.cu): a float32 operand is three bf16 terms; bf16 weights
# take 3 products (one per term of the cotangent), 1 where the cotangent or
# the forward's rounded operand is bf16 already; float32 weights take the
# products of terms i, j with i + j < 3 (6 of the 9)
F32_PAIRS = 6


def made_issued_bound(case, bf16, activation="relu", backward=True):
    """The least time of the forward or the backward from the operations its
    kernels really issue: every product on the tensor cores, each partial
    product of the split counted, at 989 TFLOP/s: ``(ms, tensor_ops)``."""
    B, F, H, R, mult = case
    P = F * mult
    if not backward:
        tensor = 2 * B * (F * H + 2 * R * H * H + H * P) * (1 if bf16 else F32_PAIRS)
        return tensor / BF16_OPS_PER_S * 1e3, tensor
    wide = F32_PAIRS if not bf16 else 3  # a float32 cotangent
    last = F32_PAIRS if not bf16 else 1  # the last block's dh: bf16 in bf16
    inner = F32_PAIRS if not bf16 else (1 if activation == "relu" else 3)  # dz1
    HH = 2 * B * H * H
    tensor = 2 * (2 * B * P * H * wide + 2 * B * H * F * wide)  # dh_R, dx; dWf, dW0
    for r in range(R):
        blk = last if r == R - 1 else wide
        tensor += 2 * (HH * blk + HH * inner)  # the pull-backs and dW2, dW1
    tensor += 2 * B * (F * H + 2 * R * H * H) * (1 if bf16 else F32_PAIRS)  # the recompute
    return tensor / BF16_OPS_PER_S * 1e3, tensor


FORWARD_KERNELS = ("made_chain_kernel", "made_final_kernel")
BACKWARD_KERNELS = ("made_dh_kernel", "made_bwd_tile_kernel", "made_wgrad_kernel",
                    "made_reduce_kernel")


def made_occupancy(H, bf16, backward):
    """Blocks of each forward or backward kernel one multiprocessor holds at
    hidden width H (the CUDA occupancy calculator, from registers and shared
    memory): the theoretical occupancy; the achieved one needs a counter
    profiler this machine lacks."""
    import ctypes

    from normflows_tpu_torch.ops import made_fused as mf

    name = f"made_fused_{'backward' if backward else 'forward'}_occupancy"
    kernels = BACKWARD_KERNELS[:3] if backward else FORWARD_KERNELS
    blocks = (ctypes.c_int * len(kernels))()
    rc = getattr(mf._library(), name)(H, int(bf16), ctypes.addressof(blocks))
    if rc != 0:
        raise SystemExit(f"{name}: CUDA error {rc}")
    return dict(zip(kernels, blocks))


def kernel_us(fn, calls=10):
    """Device µs a launch of each CUDA kernel of a call of ``fn``, over
    ``calls`` calls under torch.profiler after two traced warm-up calls it
    discards: each kernel's device time over the launches the profiler
    recorded, and that count.  The profiler can drop a launch's record
    (on the H100, one of ten even after the warm-up), so the mean is taken
    over the records."""
    import re

    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as torch_profile

    fn()
    sync()
    traced = []
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=2, active=calls, repeat=1),
                       on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for _ in range(2 + calls):
            fn()
            sync()
            prof.step()
    events = traced[0]
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    total, count = {}, {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host \
                and e.self_device_time_total > 0:
            m = re.search(r"made_\w+_kernel(<[^>]*>)?", e.key)
            key = m.group(0) if m else e.key[:60]
            total[key] = total.get(key, 0.0) + e.self_device_time_total
            count[key] = count.get(key, 0) + e.count
    return {k: total[k] / count[k] for k in total}, count


def phase_times_made_fused(model, resources):
    """Device time of each fused kernel in a CUDA graph at the large-D shape,
    f32 and bf16, forward and backward; the wrapper's call time with the
    packing; the plain versions; the library yardstick: the unfused MADE
    pass (torch GEMMs and elementwise kernels) and its autograd backward,
    the same way at the same shape; the bounds; each direction's split by
    launch (profiled calls) with each kernel's registers, spills and blocks
    an SM; then log_prob(4096) and the forward-KL step, fusion off against
    on."""
    from normflows_tpu_torch.ops import backend
    from normflows_tpu_torch.ops import made_fused as mf

    case = MADE_CASES[0]
    kernels = {}
    for bf16 in (False, True):
        x, ops, made = made_case(*case, bf16, SEED + 50)
        g = torch.randn(case[0], case[1] * case[4], device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 51))
        xg = x.clone().requires_grad_()
        leaves = [xg, *made.parameters()]

        def library_forward():
            return made(xg)

        def library_forward_backward():
            return torch.autograd.grad(made(xg), leaves, g)

        backend.set_made_fusion(False)
        lib_fwd = graph_ms(library_forward, reps=16)
        lib_both = graph_ms(library_forward_backward, reps=8)
        r = {"forward": {"ms": graph_ms(lambda: mf.fused_resmade(x, *ops), reps=16),
                         "call_ms": cuda_ms(lambda: mf.made_apply_fused(made, x), reps=100),
                         "plain_ms": cuda_ms(lambda: mf.fused_resmade_reference(x, *ops),
                                             reps=10),
                         "library_ms": lib_fwd},
             "backward": {"ms": graph_ms(lambda: mf.fused_resmade_backward(x, *ops, g), reps=8),
                          "call_ms": cuda_ms(lambda: mf.fused_resmade_backward(x, *ops, g),
                                             reps=50),
                          "plain_ms": cuda_ms(
                              lambda: mf.fused_resmade_backward_reference(x, *ops, g), reps=5),
                          "library_ms": lib_both - lib_fwd,
                          "library_forward_and_backward_ms": lib_both}}
        suffix = "_bf16" if bf16 else "_f32"
        for d, names, call in (("forward", FORWARD_KERNELS, lambda: mf.fused_resmade(x, *ops)),
                               ("backward", BACKWARD_KERNELS,
                                lambda: mf.fused_resmade_backward(x, *ops, g))):
            bound, by, moved, n_ops = made_bound(case, bf16, d == "backward")
            issued_ms, tensor_ops = made_issued_bound(case, bf16, backward=d == "backward")
            launch_us, recorded = kernel_us(call)
            unseen = [k for k in names if not any(n.startswith(k) for n in recorded)]
            if unseen:
                raise SystemExit(f"times_made_fused: the profiler recorded no launch of {unseen}")
            r[d].update(bound_ms=bound, bound_by=by, bytes=moved, ops=n_ops,
                        issued_bound_ms=issued_ms, issued_tensor_ops=tensor_ops,
                        launch_us=launch_us, launches_recorded=recorded,
                        blocks_per_sm=made_occupancy(case[2], bf16, d == "backward"),
                        resources={k: v for k, v in resources.items()
                                   if k.startswith(names) and (suffix + "_" in k + "_" or not (
                                       "_f32" in k or "_bf16" in k))})
            shares = {"bound": bound / r[d]["ms"], "issued_bound": issued_ms / r[d]["ms"]}
            r[d]["shares"] = shares
            if max(shares.values()) > 1:
                raise SystemExit(f"times_made_fused: a {d} bound above its measured time: "
                                 f"{shares}")
        kernels["bfloat16" if bf16 else "float32"] = r
    emit("times_made_fused_kernels", kernels=kernels, shape=made_key(case, False)[:-4],
         note="ms: device time, calls in one CUDA graph; call_ms: CUDA events over a loop "
         "of made_apply_fused (the packing included) or of the backward wrapper; "
         "plain_ms: the plain versions; library_ms: the unfused MADE.forward (torch "
         "GEMMs, fusion off) in a CUDA graph, and for the backward its forward and "
         "autograd backward less its forward; bound_ms: bytes over 3.35 TB/s or "
         "operations over 67 TFLOP/s (f32) / 989 TFLOP/s (bf16); issued_bound_ms: the "
         "partial products the split route issues over 989 TFLOP/s; launch_us: device us "
         "a launch by kernel, over the launches_recorded of 10 profiled calls; shares: "
         "each bound over ms; "
         "blocks_per_sm: the occupancy "
         "calculator's; resources: ptxas -v, per thread")
    return kernels, fused_request_and_step_times(model)


def fused_request_and_step_times(model):
    """log_prob(4096) and the forward-KL step of the large-D model, fusion
    off then on, f32 and bf16 (random weights, the same batch)."""
    from normflows_tpu_torch.ops import backend
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    out = {}
    try:
        for dtype in ("float32", "bfloat16"):
            set_compute_dtype(model, None if dtype == "float32" else dtype)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            with torch.no_grad():
                x, _ = model.sample(LD_BATCH, generator=gen)
            trained = set_compute_dtype(build_large_d(DEVICE),
                                        None if dtype == "float32" else dtype)
            state, step = make_train_step(trained, torch.optim.Adam(trained.parameters(),
                                                                    lr=LR), forward_kld_loss)
            r = {}
            for fused in (False, True):
                backend.set_made_fusion(fused)
                with torch.inference_mode():
                    lp = timed(lambda: model.log_prob(x))
                r["fused" if fused else "unfused"] = {
                    "log_prob": lp, "forward_kld_step": timed(lambda: step(state, x, gen))}
            out[dtype] = r
    finally:
        backend.set_made_fusion(False)
    emit("times_made_fused", requests_and_steps=out, batch=LD_BATCH,
         note="ms: host median of 20 calls, each ending in a synchronise; profile: one "
         "call under torch.profiler; busy_share_of_median: its device time over the "
         "median; fusion off, then on, on the same card in one run")
    return out

# ---- the flat backward's ablation (examples/spline_bwd_ablate.py) -------------

def ablate_cases(rng):
    """(name, inverse, inputs) of the ablation checks, N = 32,768, K = 10:
    run_variant's inputs (circular at pi, unit cotangents) as the port's
    script makes them, in both directions; a mixed-tail case (linear at 5,
    circular at pi, random cotangents, x ~ N(0, 1): no linear input clamped,
    where sel_post's unmasked pull-back would meet the clip's tie), both
    directions; for full and vjp_all only, ~20% of the inputs outside
    their bounds (flat_inputs' mix at K = 10); and the mixed-tail case at the
    kernel's other bin counts, ABLATE_SWEEP_BINS (vjp_all takes K <= 16)."""
    from normflows_tpu_torch.examples import spline_bwd_ablate as script

    n = ABLATE_N
    cases = [(f"run_variant_{d}", d == "inverse", script.make_inputs(n, SEED, DEVICE))
             for d in ("inverse", "forward")]
    for d in ("forward", "inverse"):
        x, uw, uh, ud, *_ = script.make_inputs(n, SEED + 60 + (d == "inverse"), DEVICE)
        codes = torch.from_numpy(rng.choice([1, 2], size=n).astype(np.int32)).to(DEVICE)
        bounds = torch.where(codes == 1, 5.0, math.pi).to(torch.float32)
        yb, lb = (torch.from_numpy(a).to(DEVICE) for a in rng.normal(size=(2, n))
                  .astype(np.float32))
        cases.append((f"mixed_{d}", d == "inverse", (x, uw, uh, ud, codes, bounds, yb, lb)))
    K = ABLATE_BINS
    for d in ("forward", "inverse"):
        codes = rng.choice([1, 2], size=n).astype(np.int32)
        bounds = np.where(codes == 1, 5.0, math.pi).astype(np.float32)
        x = (rng.uniform(-1.25, 1.25, n) * bounds).astype(np.float32)
        p = (PARAM_STD * rng.normal(size=(3 * K + 1, n))).astype(np.float32)
        yb, lb = rng.normal(size=(2, n)).astype(np.float32)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
        cases.append((f"tails_{d}", d == "inverse",
                      (to(x), to(p[:K]), to(p[K:2 * K]), to(p[2 * K:]), to(codes), to(bounds),
                       to(yb), to(lb))))
    for K, d in itertools.product(ABLATE_SWEEP_BINS, ("forward", "inverse")):
        x, uw, uh, ud, *_ = script.make_inputs(n, SEED + 62 + K, DEVICE, K=K)
        codes = torch.from_numpy(rng.choice([1, 2], size=n).astype(np.int32)).to(DEVICE)
        bounds = torch.where(codes == 1, 5.0, math.pi).to(torch.float32)
        yb, lb = (torch.from_numpy(a).to(DEVICE) for a in rng.normal(size=(2, n))
                  .astype(np.float32))
        cases.append((f"mixed_K{K}_{d}", d == "inverse", (x, uw, uh, ud, codes, bounds, yb, lb)))
    return cases


def phase_kernel_ablate():
    """Each variant of the ablation kernel against its plain version in
    float64 on the same CUDA tensors (sel_only 1e-5, the rest the flat
    backward's 1e-3, atol = rtol), and vjp_all against full within 1e-3."""
    from normflows_tpu_torch.ops import spline_ablate as sa

    rng = np.random.default_rng(SEED + 61)
    errs = {}
    for name, inverse, args in ablate_cases(rng):
        modes = ("full", "vjp_all") if name.startswith("tails") else sa.VARIANTS
        if args[1].shape[0] > sa.MAX_BINS:
            modes = tuple(m for m in modes if m != "vjp_all")
        got = {}
        for mode in modes:
            got[mode] = sa.run_variant(mode, *args, inverse=inverse)
            sync()
            want = sa.REFERENCES[mode](*as_f64(args), inverse)
            tol = ABLATE_SEL_TOL if mode == "sel_only" else FLAT_G_TOL
            errs[f"{mode}_{name}"] = check_pair("kernel_ablate", errs, got[mode], want,
                                                (tol,) * 4, ("xg", "uwg", "uhg", "udg"))
        if "vjp_all" in got:
            errs[f"vjp_all_vs_full_{name}"] = check_pair(
                "kernel_ablate", errs, got["vjp_all"], got["full"], (FLAT_G_TOL,) * 4,
                ("xg", "uwg", "uhg", "udg"))
    emit("kernel_ablate", ok=True, errors=errs, n=ABLATE_N, bins=ABLATE_BINS,
         sweep_bins=ABLATE_SWEEP_BINS,
         bars={"sel_only": ABLATE_SEL_TOL, "sel_post_full_vjp_all": FLAT_G_TOL,
               "vjp_all_vs_full": FLAT_G_TOL})
    return errs


def phase_times_ablate(resources):
    """The port's ablation script as a user runs it (its main path: every
    launch count set to 0 before, read after), then each variant's plain
    version timed on the same inputs, with the bounds and the registers and
    spills of each instantiation (inverse, the script's direction)."""
    from normflows_tpu_torch.examples import spline_bwd_ablate as script
    from normflows_tpu_torch.ops import spline_ablate as sa

    for mode in sa.VARIANTS:
        sa.LAUNCHES[mode] = 0
    records = script.main([])
    sync()
    launches = dict(sa.LAUNCHES)
    inputs = script.make_inputs(ABLATE_N, SEED, DEVICE)
    out = {}
    for r in records:
        mode = r["mode"]
        bound_ms, bound_by, moved = script.bound(mode, ABLATE_N)
        out[mode] = {
            "ms": r["ms"], "launches": launches[mode],
            "plain_ms": cuda_ms(lambda: sa.REFERENCES[mode](*inputs, True), reps=10),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
            **resources[f"{mode}_inverse_{ABLATE_BINS}"],
            "forward_direction": resources[f"{mode}_forward_{ABLATE_BINS}"]}
        if not launches[mode]:
            raise SystemExit(f"times_ablate: the script launched no {mode} kernel")
    emit("times_ablate", variants=out, n=ABLATE_N, bins=ABLATE_BINS,
         note="ms: the script's device time of one launch, 64 launches over 16 input sets "
         "(75 MB) in one CUDA graph; plain_ms: CUDA events over 10 calls of the plain "
         "version; launches: the script's run (1 checked + 3 warm-up + 64 captured); "
         "registers, stack and spill bytes per thread from ptxas -v, of the K = 10 "
         "instantiation")
    return out


# ---- the coupled NSF of docs/getting_started.md -------------------------------

def build_coupled(device, init_identity=False):
    """docs/getting_started.md:19-25: DiagGaussian(2), 8 coupled RQ splines
    (2 blocks of hidden 64, 8 bins, linear tails at 3, reverse_mask
    alternating), TwoMoons.  Without the identity init every spline does
    work: random transform nets, and CDF logits ~ 0.5 N(0, 1)."""
    import normflows_tpu_torch as nft

    layers = [nft.flows.CoupledRationalQuadraticSpline.create(
        torch.Generator().manual_seed(SEED + i), 2, CP_BLOCKS, CP_HIDDEN,
        reverse_mask=bool(i % 2), init_identity=init_identity, device=device)
        for i in range(CP_LAYERS)]
    if not init_identity:
        randomize_cdfs(layers)
    return nft.NormalizingFlow.create(nft.distributions.DiagGaussian.create(2, device=device),
                                      layers, p=nft.distributions.TwoMoons(device=device),
                                      device=device)


def randomize_cdfs(layers):
    gen = torch.Generator().manual_seed(SEED + 70)
    with torch.no_grad():
        for layer in layers:
            for p in layer.prqct.unconditional_transform.parameters():
                p.copy_(PARAM_STD * torch.randn(p.shape, generator=gen))


def build_circular_coupled(device):
    """Circular coupled RQ splines (ind_circ [1], tail bound [5, pi]) on the
    flagship's UniformGaussian base and GaussianVonMises target, at the
    docs model's widths, random nets and CDFs."""
    import normflows_tpu_torch as nft

    layers = [nft.flows.CircularCoupledRationalQuadraticSpline.create(
        torch.Generator().manual_seed(SEED + 80 + i), 2, CP_BLOCKS, CP_HIDDEN, ind_circ=[1],
        tail_bound=np.asarray(TAIL_BOUND, np.float32), reverse_mask=bool(i % 2),
        init_identity=False, device=device) for i in range(CP_LAYERS)]
    randomize_cdfs(layers)
    base = nft.distributions.UniformGaussian.create(2, [1], SCALE, device=device)
    return nft.NormalizingFlow.create(base, layers,
                                      p=nft.distributions.GaussianVonMises(device=device),
                                      device=device)


def phase_coupled_path():
    """sample(2^14) and log_prob of the samples, f32 and bf16: exactly 16
    flat launches each (8 layers x coupling + CDF), inverse direction in
    sample, forward in log_prob; sample's log_q against log_prob; the card
    against the CPU at the same 2^14 (f32), for the docs model and for a
    circular coupled stack, so that the flat wrapper's coupling and CDF
    layouts are held against the plain spline at the size the path runs."""
    from normflows_tpu_torch.utils import set_compute_dtype

    model = build_coupled(DEVICE)
    per_pass = 2 * CP_LAYERS
    results, launches = {}, {"forward": 0, "inverse": 0}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with torch.inference_mode():
            (x, log_q), n_s = counted(f"coupled sample {dtype}",
                                      lambda: model.sample(N, generator=gen),
                                      flat=(per_pass, 0))
            lp, n_l = counted(f"coupled log_prob {dtype}", lambda: model.log_prob(x),
                              flat=(per_pass, 0))
        launches["inverse"] += n_s["flat"][0]
        launches["forward"] += n_l["flat"][0]
        finite = all(bool(torch.isfinite(t).all()) for t in (x, log_q, lp))
        gap = (lp - log_q).abs()
        r = {"sample_launches": n_s, "log_prob_launches": n_l, "finite": finite,
             "shape": list(x.shape), "median_abs_logq_gap": float(gap.median()),
             "max_abs_logq_gap": float(gap.max()), "mean_log_q": float(log_q.mean())}
        results[dtype] = r
        bar = LOGQ_F32 if dtype == "float32" else LOGQ_BF16
        if not (finite and tuple(x.shape) == (N, 2) and r["median_abs_logq_gap"] <= bar):
            emit("coupled_path", ok=False, results=results)
            raise SystemExit(f"coupled path ({dtype}) failed its checks")
        if dtype == "float32":
            results["cpu"] = against_cpu("coupled_path", model, x, build_coupled, N)
    circ = build_circular_coupled(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 81)
    with torch.inference_mode():
        (xc, _), n_c = counted("circular coupled sample", lambda: circ.sample(N, generator=gen),
                               flat=(per_pass, 0))
    launches["inverse"] += n_c["flat"][0]
    results["circular_cpu"] = against_cpu("coupled_path", circ, xc, build_circular_coupled, N)
    results["circular_in_bounds"] = bool((xc[:, 1].abs() <= math.pi + 1e-5).all())
    if not results["circular_in_bounds"]:
        emit("coupled_path", ok=False, results=results)
        raise SystemExit("coupled path: a circular sample left [-pi, pi]")
    emit("coupled_path", ok=True, results=results,
         bars={"logq_f32": LOGQ_F32, "logq_bf16": LOGQ_BF16, "cpu": CPU_TOL})
    return model, launches


def flat_float64(x, uw, uh, ud, codes, bound, inverse, mbw, mbh, md, event_axis=-1):
    """The flat entry's function (same layout, same static tails) through
    its plain version in float64; the entry itself takes float32 only."""
    from normflows_tpu_torch.ops import spline_flat as sf

    shape = x.shape
    c = sf._align(codes, shape, event_axis, torch.int32, x.device)
    b = sf._align(bound, shape, event_axis, x.dtype, x.device)

    def rows(p):
        return p.movedim(-1, 0).reshape(p.shape[-1], -1)

    y, ld = sf.unconstrained_rqs_dyncodes_reference(x.reshape(-1), rows(uw), rows(uh),
                                                    rows(ud), c, b, inverse, mbw, mbh, md)
    return y.view(shape), ld.view(shape)


class FlatCalls:
    """While entered, the coupled layers' flat spline calls pass through
    here: float64 operands go to :func:`flat_float64`, float32 ones to the
    flat entry.  With ``record`` set, each call's operands and results are
    kept on the CPU, a coupling call with the transform net's input and
    output that fed it (the nets of ``model``'s layers are hooked)."""

    def __init__(self, model=None):
        self.model, self.record, self.calls, self.net = model, False, [], None
        self.exact = False  # float32 calls through flat_float64, rounded once to float32

    def __enter__(self):
        from normflows_tpu_torch.ops import spline_flat as sf

        self.entry = sf.unconstrained_rational_quadratic_spline_flat
        sf.unconstrained_rational_quadratic_spline_flat = self
        self.hooks = [layer.prqct.transform_net.register_forward_hook(
            lambda m, inp, out, i=i: setattr(self, "net", (i, inp[0], out)))
            for i, layer in enumerate(self.model.flows)] if self.model is not None else []
        return self

    def __exit__(self, *exc):
        from normflows_tpu_torch.ops import spline_flat as sf

        sf.unconstrained_rational_quadratic_spline_flat = self.entry
        for h in self.hooks:
            h.remove()

    def __call__(self, x, uw, uh, ud, codes, bound, inverse, mbw, mbh, md, event_axis=-1):
        args = (codes, bound, inverse, mbw, mbh, md, event_axis)
        if x.dtype != torch.float32:
            y, ld = flat_float64(x, uw, uh, ud, *args)
        elif self.exact:
            y, ld = (t.float() for t in flat_float64(*(t.double() for t in (x, uw, uh, ud)), *args))
        else:
            y, ld = self.entry(x, uw, uh, ud, *args[:-1], event_axis=event_axis)
        if self.record:
            net = None
            if event_axis == -1 and self.net is not None:  # the net call just before fed it
                i, net_in, net_out = self.net
                net = (i, net_in.detach().cpu(), net_out.detach().cpu())
            cpu = lambda t: t.detach().cpu()  # noqa: E731
            call = {"x": cpu(x), "p": [cpu(uw), cpu(uh), cpu(ud)], "y": cpu(y), "ld": cpu(ld),
                    "net": net, "live": (x, uw, uh, ud), "args": args}
            if y.requires_grad:  # the cotangents the backward brings to this call
                for name, t in (("gy", y), ("gld", ld)):
                    t.register_hook(lambda g, name=name: call.__setitem__(name, g.detach().cpu()))
            self.calls.append(call)
        return y, ld


def knot_distance_ulps(x, u, bound, mbw, mbh, inverse):
    """Distance of the float32 input ``x`` from the nearest knot of its bin
    search (heights when inverting, widths otherwise), computed in float64
    from the raw logits ``u``, in float32 ulps of ``x``."""
    from normflows_tpu_torch.ops import splines

    left = torch.tensor(-bound, dtype=torch.float64)
    _, cum = splines._normalize_bins(u.double(), u.shape[-1], mbh if inverse else mbw, left,
                                     -left)
    ulp = float(np.spacing(np.float32(abs(x))))
    return float((cum - x).abs().min()) / ulp


def attribute_to_float64(calls, f64, samples):
    """For each of ``samples``: the call of the card's run whose own error
    (its float32 result against float64 on the same float32 operands) moves
    the log-density most, the spline's or the transform net's, and where
    the spline's input lay: the circular wrap, the linear-tail clamp, a bin
    edge (within 4 ulps of a knot), or inside a bin; and the sum of every
    call's own error, which against the sample's whole error says how much
    of it was carried from earlier layers and amplified."""
    local = []
    for j, c in enumerate(calls):
        codes, bound, inverse, mbw, mbh, md, axis = c["args"]
        x64 = c["x"].double()
        p64 = [p.double() for p in c["p"]]
        _, ld_ref = flat_float64(x64, *p64, *c["args"])
        spline = (c["ld"].double() - ld_ref)  # (B, d)
        net = None
        if c["net"] is not None:
            i, net_in, net_out = c["net"]
            prqct = f64.flows[i].prqct
            with torch.no_grad():
                _, ld_net = prqct._coupling_transform(x64, prqct.transform_net(net_in.double()),
                                                      inverse)
                _, ld_own = prqct._coupling_transform(x64, net_out.double(), inverse)
            net = ld_net - ld_own  # (B,): the net's float32 error, through the spline
        local.append((spline, net))
    out, where = [], {}
    for s in samples:
        best = max(((abs(float(sp[s].sum())), j, "spline") for j, (sp, _) in enumerate(local)),
                   default=(0.0, -1, "spline"))
        best_net = max(((abs(float(nt[s])), j, "net") for j, (_, nt) in enumerate(local)
                        if nt is not None), default=(0.0, -1, "net"))
        size, j, kind = max(best, best_net)
        c = calls[j]
        codes, bound, inverse, mbw, mbh, md, axis = c["args"]
        d = int(local[j][0][s].abs().argmax())
        x = float(c["x"][s, d])
        b = float(np.broadcast_to(np.asarray(bound, np.float64), (c["x"].shape[1],))[d])
        code = int(np.broadcast_to(np.asarray(codes), (c["x"].shape[1],))[d])
        ulps = knot_distance_ulps(x, c["p"][1 if inverse else 0][s, d], b, mbw, mbh, inverse)
        if kind == "net":
            cat = "ResidualNet"
        elif code == 2 and (abs(x) > b or b - abs(x) < 1e-3 * b):
            cat = "circular wrap"
        elif code == 1 and abs(x) >= b * (1 - 1e-6):
            cat = "linear-tail clamp"
        elif ulps <= 4:
            cat = "bin edge"
        else:
            cat = "inside a bin"
        where[cat] = where.get(cat, 0) + 1
        own = sum(float(sp[s].sum()) + (float(nt[s]) if nt is not None else 0.0)
                  for sp, nt in local)
        out.append({"sample": int(s), "call": j, "layer": c["net"][0] if c["net"] else None,
                    "sum_of_own_ld_errors": own,
                    "kind": "coupling" if axis == -1 else "cdf", "where": cat,
                    "ld_error": size, "x": x, "bound": b, "tail_code": code,
                    "knot_distance_ulps": ulps})
    return out, where


def vs_float64(phase, model, x, build, n):
    """The model on the card (f32) and on the CPU (f32), each against the
    same model on the CPU in float64 (plain splines, ``double()``), on the
    same ``n`` samples (log_prob) and ``n`` base draws (forward_and_log_det);
    the 20 largest |card - float64| of log_prob attributed to a spline or a
    transform net call and to where its input lay."""
    cpu, f64 = build("cpu"), build("cpu")
    cpu.load_state_dict(model.state_dict())
    f64.load_state_dict(model.state_dict())
    f64.double()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    xs = x[:n]
    with torch.inference_mode(), FlatCalls(model) as rec:
        z = model.q0.sample(n, generator=gen)
        rec.record = True
        lp_card = model.log_prob(xs).cpu().double()
        rec.record = False
        calls = rec.calls
        lp_cpu = cpu.log_prob(xs.cpu()).double()
        lp_64 = f64.log_prob(xs.cpu().double())
        xf_card, ld_card = (t.cpu().double() for t in model.forward_and_log_det(z))
        xf_cpu, ld_cpu = (t.double() for t in cpu.forward_and_log_det(z.cpu()))
        xf_64, ld_64 = f64.forward_and_log_det(z.cpu().double())
        top = torch.topk((lp_card - lp_64).abs(), 20).indices.tolist()
        attributed, where = attribute_to_float64(calls, f64, top)

    def dist(a, b):
        d = (a - b).abs()
        return {"max_abs": float(d.max()), "median_abs": float(d.median())}

    r = {"samples": n,
         "card_vs_float64": {"log_prob": dist(lp_card, lp_64), "forward_x": dist(xf_card, xf_64),
                             "forward_ld": dist(ld_card, ld_64)},
         "cpu_vs_float64": {"log_prob": dist(lp_cpu, lp_64), "forward_x": dist(xf_cpu, xf_64),
                            "forward_ld": dist(ld_cpu, ld_64)},
         "top20_card_log_prob": attributed, "top20_where": where}
    for k in ("log_prob", "forward_x", "forward_ld"):
        r[f"card_closer_{k}"] = r["card_vs_float64"][k]["max_abs"] <= \
            r["cpu_vs_float64"][k]["max_abs"]
    for i, a in enumerate(attributed):
        a["card_minus_float64"] = float(lp_card[a["sample"]] - lp_64[a["sample"]])
        a["cpu_minus_float64"] = float(lp_cpu[a["sample"]] - lp_64[a["sample"]])
    return r


def attribute_step(entry, card_calls, f64_calls, f64_model, f64_grads, names):
    """The flat spline calls' own backward error in the card's step, carried
    to the leaves ``names``.  A call's own error is what the card's
    backward gives for its float32 operands and the cotangents the step
    brought to it, less the plain backward in float64 on the same values.
    That error is pulled back to the leaves through the float64 step's
    graph (a vector-Jacobian product from the call's operands), so it reads
    as the distance it alone puts between the card's leaf and float64."""
    leaves = dict(f64_model.named_parameters())
    leaves = [leaves[k] for k in names]
    moved = [torch.zeros_like(t) for t in leaves]
    per_call = []
    for j, (c, r) in enumerate(zip(card_calls, f64_calls)):
        axis = c["args"][-1]
        cot = [c.get(k, torch.zeros_like(c[v])) for k, v in (("gy", "y"), ("gld", "ld"))]
        ops = [c["x"], *c["p"]]
        card_ops = [t.to(DEVICE).requires_grad_() for t in ops]
        f64_ops = [t.double().requires_grad_() for t in ops]
        got = torch.autograd.grad(entry(*card_ops, *c["args"][:-1], event_axis=axis), card_ops,
                                  [t.to(DEVICE) for t in cot])
        want = torch.autograd.grad(flat_float64(*f64_ops, *c["args"]), f64_ops,
                                   [t.double() for t in cot])
        own = [a.cpu().double() - b for a, b in zip(got, want)]
        pairs = [(t, e) for t, e in zip(r["live"], own) if t.requires_grad]
        carried = torch.autograd.grad([t for t, _ in pairs], leaves, [e for _, e in pairs],
                                      retain_graph=True, allow_unused=True)
        carried = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, carried)]
        moved = [m + g for m, g in zip(moved, carried)]
        per_call.append({
            "call": j, "kind": "coupling" if axis == -1 else "cdf",
            "own_rel": max(float(e.abs().max() / (w.abs().max() + 1e-300))
                           for e, w in zip(own, want)),
            "moves": {k: float(g.norm() / f64_grads[k].norm()) for k, g in zip(names, carried)}})
    out = []
    for k, m in zip(names, moved):
        top = max(per_call, key=lambda p: p["moves"][k])
        out.append({"leaf": k, "flat_backward_own": float(m.norm() / f64_grads[k].norm()),
                    "largest_call": top["call"], "largest_call_moves": top["moves"][k]})
    return out, max(p["own_rel"] for p in per_call)


def own_forward_error(calls):
    """The recorded flat calls' own forward error, each against the plain
    version in float64 on the call's own float32 operands: the largest
    |y - float64| or |log-det - float64|, and the largest excess over the
    static-tail entry's bars (Y_TOL on y, LD_TOL on log-dets)."""
    worst, over = 0.0, -math.inf
    for c in calls:
        with torch.no_grad():
            y, ld = flat_float64(c["x"].double(), *(p.double() for p in c["p"]), *c["args"])
        worst = max(worst, float((c["y"] - y).abs().max()), float((c["ld"] - ld).abs().max()))
        over = max(over, excess(c["y"], y, Y_TOL, Y_TOL), excess(c["ld"], ld, LD_TOL, LD_TOL))
    return worst, over


def step_vs_float64(build, batch):
    """One forward-KL step's gradient on the card (f32), on the CPU (f32)
    and on the CPU in float64 from the same weights and batch: each leaf's
    distance from float64 over its norm, for the card and for the CPU; the
    card's five farthest leaves, with how far the flat calls' own backward
    error alone moves each (``attribute_step``) and how far the card's step
    lies with every flat call exact (float64, rounded to float32)."""
    models = [build(DEVICE), build("cpu"), build("cpu")]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    models[2].double()
    grads, calls = [], []
    with FlatCalls() as rec:
        for m, b in zip(models, (batch, batch.cpu(), batch.cpu().double())):
            rec.calls, rec.record = [], True
            m.zero_grad(set_to_none=True)
            m.forward_kld(b).backward(retain_graph=m is models[2])  # kept for attribute_step
            grads.append({k: p.grad.detach().cpu().double() for k, p in m.named_parameters()
                          if p.grad is not None})
            calls.append(rec.calls)
        rec.record, rec.exact = False, True  # the card's step with every flat call exact
        models[0].zero_grad(set_to_none=True)
        models[0].forward_kld(batch).backward()
        grads.append({k: p.grad.detach().cpu().double() for k, p in models[0].named_parameters()
                      if p.grad is not None})
        rec.exact = False
        card, cpu, f64, exact = grads
        rel = lambda a: {k: float((a[k] - f64[k]).norm() / (f64[k].norm() + 1e-300))  # noqa: E731
                         for k in f64 if float(f64[k].norm()) > 0}
        r_card, r_cpu, r_exact = rel(card), rel(cpu), rel(exact)
        far = sorted(r_card, key=r_card.get, reverse=True)[:5]
        attributed, own_max = attribute_step(rec.entry, calls[0], calls[2], models[2], f64, far)
    gap = {k: float((card[k] - cpu[k]).norm() / (cpu[k].norm() + 1e-300)) for k in r_card}
    worst = sorted(gap, key=gap.get, reverse=True)[:5]
    for a in attributed:
        a.update(card_vs_float64=r_card[a["leaf"]], cpu_vs_float64=r_cpu[a["leaf"]],
                 card_exact_flat_vs_float64=r_exact[a["leaf"]])
    return {"samples": int(batch.shape[0]), "leaves": len(f64),
            "card_vs_float64_max": max(r_card.values()),
            "cpu_vs_float64_max": max(r_cpu.values()),
            "card_exact_flat_vs_float64_max": max(r_exact.values()),
            "card_closer_leaves": sum(r_card[k] <= r_cpu[k] for k in r_card),
            "worst_card_vs_cpu": [{"leaf": k, "card_vs_cpu": gap[k], "card_vs_float64": r_card[k],
                                   "cpu_vs_float64": r_cpu[k]} for k in worst],
            "flat_calls": len(calls[0]), "flat_backward_own_rel_max": own_max,
            "flat_forward_own_max_abs_and_excess": {"card": own_forward_error(calls[0]),
                                                    "cpu": own_forward_error(calls[1])},
            "farthest_card_leaves": attributed}


def phase_coupled_float64():
    """The card-against-CPU gap of the coupled models, read against float64:
    the docs model and the circular stack at 2^14 samples (as coupled_path
    draws them) and one forward-KL step of the docs model at 512 (as
    coupled_train); which of card and CPU lies closer to float64, where the
    card's largest log-density errors sit, and what moves the step's
    farthest leaves.  Fails if a flat call's own error on the card, against
    float64 on its own operands, exceeds the flat entry's bars."""
    results = {}
    for name, build, seed in (("docs", build_coupled, SEED), ("circular", build_circular_coupled,
                                                               SEED + 81)):
        model = build(DEVICE)
        with torch.inference_mode():
            x, _ = model.sample(N, generator=torch.Generator(device=DEVICE).manual_seed(seed))
        results[name] = vs_float64("coupled_float64", model, x, build, N)
    step = results["docs_step"] = step_vs_float64(build_coupled,
                                                  docs_data(SEED + 90)[:CP_BATCH])
    ok = step["flat_forward_own_max_abs_and_excess"]["card"][1] <= 0 and \
        step["flat_backward_own_rel_max"] <= FLAT_G_TOL
    emit("coupled_float64", ok=ok, results=results,
         bars={"flat_forward_own": [Y_TOL, LD_TOL], "flat_backward_own_rel": FLAT_G_TOL},
         note="distances from the same model on the CPU in float64 (plain splines); "
         "top20: the card's 20 largest |log_prob - float64|, each given to the call "
         "whose own float32 error moves it most; docs_step: the step's leaves, the "
         "card's farthest with the flat calls' own backward error carried to them and "
         "the card's step with every flat call exact")
    if not ok:
        raise SystemExit("coupled_float64: a flat call's own error on the card exceeds its bar")
    return results


def docs_data(seed, n=2 * CP_BATCH):
    """``n`` samples of the target on the card (docs/getting_started.md:31
    takes 1024)."""
    import normflows_tpu_torch as nft

    return nft.distributions.TwoMoons(device=DEVICE).sample(
        n, generator=torch.Generator(device=DEVICE).manual_seed(seed))


def phase_coupled_train():
    """(a) one f32 forward-KL step on the card against the CPU at 512 target
    samples, (b) exactly 16 + 16 flat launches a step, (c) the docs' loop
    (make_train_step + Adam(5e-4) on forward_kld, batches alternating between
    the halves of 1024 target samples) for 200 steps from the docs' identity
    init, f32 and bf16: finite, and the loss falls."""
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    per_pass = 2 * CP_LAYERS
    data = docs_data(SEED + 90)
    results = {"card_vs_cpu": step_against_cpu(
        "coupled_train", build_coupled, CP_BATCH, lambda card, cpu: None,
        {"flat": (per_pass, per_pass)}, forward_kld_loss, data[:CP_BATCH])}
    launches = {"forward": 0, "backward": 0}
    for dtype in ("float32", "bfloat16"):
        model = set_compute_dtype(build_coupled(DEVICE, init_identity=True),
                                  None if dtype == "float32" else dtype)
        state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                      forward_kld_loss)
        losses = []

        def train():
            for i in range(CP_TRAIN_STEPS):
                losses.append(step(state, data[i % 2 * CP_BATCH:i % 2 * CP_BATCH + CP_BATCH])[1]
                              ["loss"])

        n = per_pass * CP_TRAIN_STEPS
        t0 = time.perf_counter()
        _, got = counted(f"coupled {CP_TRAIN_STEPS} {dtype} steps", train, flat=(n, n))
        seconds = time.perf_counter() - t0
        launches["forward"] += got["flat"][0]
        launches["backward"] += got["flat"][1]
        losses = torch.stack(losses).cpu().numpy()
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        results[dtype] = {
            "steps": CP_TRAIN_STEPS, "seconds": seconds, "launches": got,
            "launches_per_step": [got["flat"][0] // CP_TRAIN_STEPS,
                                  got["flat"][1] // CP_TRAIN_STEPS],
            "all_finite": bool(np.isfinite(losses).all()), "mean_first_20": first,
            "mean_last_20": last, "losses": losses.tolist()}
        if not (results[dtype]["all_finite"] and last < first):
            emit("coupled_train", ok=False, results=results)
            raise SystemExit(f"coupled training ({dtype}): a loss was not finite or did not fall")
    emit("coupled_train", ok=True, results=results,
         bars={"loss": [CPU_TOL, CPU_TOL], "gradient_norm": STEP_G_TOL})
    return launches


def phase_times_coupled(model):
    """Request times of sample(2^14) and log_prob(2^14) and the docs' step
    time at 512, f32 and bf16, each with the profiler's view."""
    from normflows_tpu_torch.training import make_train_step
    from normflows_tpu_torch.utils import set_compute_dtype

    out = {}
    data = docs_data(SEED + 91)
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(model, None if dtype == "float32" else dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        r = {}
        with torch.inference_mode():
            x, _ = model.sample(N, generator=gen)
            r["sample"] = timed(lambda: model.sample(N, generator=gen), N)
            r["log_prob"] = timed(lambda: model.log_prob(x), N)
        trained = set_compute_dtype(build_coupled(DEVICE, init_identity=True),
                                    None if dtype == "float32" else dtype)
        state, step = make_train_step(trained, torch.optim.Adam(trained.parameters(), lr=LR),
                                      forward_kld_loss)
        r["forward_kld_step"] = timed(lambda: step(state, data[:CP_BATCH]), CP_BATCH)
        out[dtype] = r
    emit("times_coupled", requests_and_steps=out, request_batch=N, step_batch=CP_BATCH,
         note="ms: host median of 20 calls, each ending in a synchronise; profile: one "
         "call under torch.profiler, device time summed over its CUDA kernels; "
         "busy_share_of_median: that over the median; random weights for the requests, "
         "the docs' identity init for the step")
    return out


# ---- the chunked trainer: one step captured in a CUDA graph and replayed -----

KERNEL_ENTRIES = {("rqs_transposed_kernel", False): "rqs_transposed_forward",
                  ("rqs_transposed_kernel", True): "rqs_transposed_inverse",
                  ("rqs_transposed_backward_kernel", False): "rqs_transposed_backward_forward",
                  ("rqs_transposed_backward_kernel", True): "rqs_transposed_backward_inverse",
                  ("rqs_flat_kernel", False): "rqs_flat_forward",
                  ("rqs_flat_kernel", True): "rqs_flat_inverse",
                  ("rqs_flat_backward_kernel", False): "rqs_flat_backward_forward",
                  ("rqs_flat_backward_kernel", True): "rqs_flat_backward_inverse"}


def replayed(fn, top=8):
    """Run ``fn`` (replayed chunks) under torch.profiler: the launches of each
    spline kernel the profiler records, by the ``kernels`` line's names (the
    direction from the first template argument), and the profile's device
    time, wall time and heaviest kernels."""
    import re

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host]
    launches = dict.fromkeys(KERNEL_ENTRIES.values(), 0)
    for e in kernels:
        m = re.search(r"\b(rqs_(?:transposed|flat)(?:_backward)?_kernel)<(true|false)", e.key)
        if m:
            launches[KERNEL_ENTRIES[(m.group(1), m.group(2) == "true")]] += e.count
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    heavy = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return launches, {"wall_ms": wall_ms, "device_ms": device_ms,
                      "kernel_launches": sum(e.count for e in kernels),
                      "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                              for e in heavy]}


@contextlib.contextmanager
def device_counters():
    """The kernel wrappers' ``DEVICE_LAUNCHES`` (the two splines' and the
    fused MADE's) set to fresh int64 (2, 2) tensors on the card
    ([backward][inverse]) for the block, off after it.  Their adds are
    captured beside the launches of a graph captured in the block, so that
    each replay counts; the caller's name for them keeps them alive as long
    as those graphs."""
    from normflows_tpu_torch.ops import made_fused, spline_cuda, spline_flat

    modules = {"planar": spline_cuda, "flat": spline_flat, "made": made_fused}
    counts = {kind: torch.zeros(2, 2, dtype=torch.int64, device=DEVICE) for kind in modules}
    for kind, m in modules.items():
        m.DEVICE_LAUNCHES = counts[kind]
    try:
        yield counts
    finally:
        for m in modules.values():
            m.DEVICE_LAUNCHES = None


def on_card(counts, fn):
    """Run ``fn`` with the device counters ``counts`` set to 0 just before
    it; its result and what they counted, by the ``kernels`` line's names."""
    for c in counts.values():
        c.zero_()
    out = fn()
    got = {}
    for kind, stem in (("planar", "rqs_transposed"), ("flat", "rqs_flat")):
        c = counts[kind].tolist()
        for backward, inverse in itertools.product((0, 1), (0, 1)):
            got[f"{stem}_{'backward_' if backward else ''}"
                f"{'inverse' if inverse else 'forward'}"] = c[backward][inverse]
    c = counts["made"].tolist()
    got["made_fused_forward"], got["made_fused_backward"] = c[0][0], c[1][0]
    return out, got


def by_stage(chunk):
    """Have a chunk's step note how far the planar and flat Python counters
    grow over each step it runs on the host, by stage: the warm-up's steps
    and the captured one (a replay runs no Python).  Returns the notes,
    ``{stage: {kind: [forward, backward]}}``, filled in as the chunk is
    first called."""
    from normflows_tpu_torch.ops import spline_cuda, spline_flat

    modules = {"planar": spline_cuda, "flat": spline_flat}
    stages = {stage: {kind: [0, 0] for kind in modules} for stage in ("warm_up", "capture")}
    step = chunk._step

    def noted(generator):
        before = {k: (m.LAUNCHES, m.BACKWARD_LAUNCHES) for k, m in modules.items()}
        step(generator)
        stage = stages["capture" if torch.cuda.is_current_stream_capturing() else "warm_up"]
        for k, m in modules.items():
            stage[k][0] += m.LAUNCHES - before[k][0]
            stage[k][1] += m.BACKWARD_LAUNCHES - before[k][1]

    chunk._step = noted
    return stages


def check_stages(what, stages, kind, per_step):
    """The Python counters over the warm-up's steps and the captured one:
    ``per_step`` forward and as many backward launches of ``kind`` each."""
    from normflows_tpu_torch.training.loop import WARMUP_STEPS

    want = {"warm_up": [per_step * WARMUP_STEPS] * 2, "capture": [per_step] * 2}
    got = {stage: stages[stage][kind] for stage in want}
    if got != want:
        raise SystemExit(f"{what}: (forward, backward) {kind} launches by stage {got}, "
                         f"expected {want}")
    return stages


def replay_launches(what, counted_on_card, per_step, steps, profiled=None):
    """A replayed chunk's launches of each spline kernel as the device
    counters counted them, which must be exactly ``per_step`` (``{name:
    launches}`` of a step, 0 for the others) times ``steps``; beside them,
    when given, the profiler's records of the same chunk, which for each
    kernel must not exceed the count nor fall short of it by more than 5%
    (the profiler can drop records).  Returns ``{name: {"device_counter",
    "profiler"}}``."""
    want = {k: per_step.get(k, 0) * steps for k in counted_on_card}
    if counted_on_card != want:
        raise SystemExit(f"{what}: the device counters counted {counted_on_card} launches "
                         f"in a replayed chunk, expected {want}")
    if profiled is None:
        return {k: {"device_counter": n} for k, n in counted_on_card.items()}
    if any(not 0.95 * n <= profiled.get(k, 0) <= n for k, n in counted_on_card.items()):
        raise SystemExit(f"{what}: the profiler recorded {profiled} launches in a replayed "
                         f"chunk, the device counters {counted_on_card}")
    return {k: {"device_counter": n, "profiler": profiled.get(k, 0)}
            for k, n in counted_on_card.items()}


def params_of(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def leaf_gap(got, want):
    """The worst leaf of ``relative_norms(got, want)`` and its value."""
    rel = relative_norms(got, want)
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def against_eager(what, losses, eager_losses, model, eager_model):
    """The chunk's losses within CPU_TOL of the eager steps', every leaf
    within STEP_G_TOL of its norm."""
    worst, gap = leaf_gap(params_of(model), params_of(eager_model))
    r = {"excess_loss": excess(losses.cpu(), eager_losses.cpu(), CPU_TOL, CPU_TOL),
         "max_abs_loss": float((losses - eager_losses).abs().max()),
         "worst_leaf": worst, "worst_relative_norm": gap,
         "bit_equal_losses": bool(torch.equal(losses, eager_losses))}
    if r["excess_loss"] > 0 or gap > STEP_G_TOL:
        emit(what, ok=False, against_eager=r)
        raise SystemExit(f"{what}: the captured chunk disagrees with the eager steps")
    return r


def no_sync(fn):
    """Run ``fn`` with the sync debug mode at "error": a host sync inside fails."""
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def capturable_adam(model):
    return torch.optim.Adam(model.parameters(), lr=LR, capturable=True)


def nan_at(box, k, loss_fn):
    """``loss_fn`` plus a term that is NaN when the chunk's device step count
    (``box["state"].step``) equals ``k``."""
    return lambda model, batch, gen: loss_fn(model, batch, gen) + torch.where(
        box["state"].step == k, float("nan"), 0.0)


def adam_tensors(opt):
    return [v.clone() for s in opt.state.values() for v in s.values()]


def eager_steps(compute):
    """CHUNK eager reverse-KL steps (make_train_step with a capturable Adam)
    of the flagship from bench.py's init: the model and the losses."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.utils import set_compute_dtype

    model = set_compute_dtype(build_flagship(DEVICE, init_identity=True), compute)
    state, step = training.make_train_step(model, capturable_adam(model), reverse_kld_loss(N))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    return model, torch.stack([step(state, None, gen)[1]["loss"] for _ in range(CHUNK)])


def phase_chunked_train():
    """The flagship at full width, f32 and bf16: a captured chunk of CHUNK
    reverse-KL steps against as many eager steps from the same weights and
    generator seed, with the same optimizer (Adam with ``capturable=True``,
    run eagerly); the Python counters by stage (``by_stage``); the next
    chunk with no host sync, the one after under the profiler, each with
    exactly 24 planar forward and 24 backward launches a step on the device
    counters (``replay_launches``).
    In f32 also: a step made non-finite on the device leaves the parameters
    and Adam's state as they were and the chunk trains on; a checkpoint
    after the first chunk, restored in place into a fresh model's captured
    chunk, gives the second chunk within the same bars."""
    import tempfile

    from normflows_tpu_torch import training
    from normflows_tpu_torch.training.loop import WARMUP_STEPS
    from normflows_tpu_torch.utils import set_compute_dtype

    per_step = 2 * LAYERS
    per_entry = {"rqs_transposed_inverse": per_step,
                 "rqs_transposed_backward_inverse": per_step}
    results, replays = {}, {}
    for dtype in ("float32", "bfloat16"):
        compute = None if dtype == "float32" else dtype
        eager, eager_losses = eager_steps(compute)

        model = set_compute_dtype(build_flagship(DEVICE, init_identity=True), compute)
        cstate, chunk = training.make_step_chunk(model, capturable_adam(model),
                                                 reverse_kld_loss(N), CHUNK)
        stages = by_stage(chunk)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
        n = per_step * (WARMUP_STEPS + 1)
        with device_counters() as counts:
            t0 = time.perf_counter()
            (_, first), _ = counted(f"chunked {dtype}: warm-up and capture",
                                    lambda: chunk(cstate, gen), planar=(n, n))
            r = {"first_call_seconds": time.perf_counter() - t0,
                 "python_counters": check_stages(f"chunked {dtype}", stages, "planar",
                                                 per_step),
                 "against_eager": against_eager("chunked_train", first["loss"], eager_losses,
                                                model, eager)}
            checkpoint = tempfile.TemporaryDirectory() if dtype == "float32" else None
            if checkpoint:
                training.save_checkpoint(checkpoint.name, {"train": cstate, "generator": gen},
                                         step=CHUNK)
            (_, second), unsynced = on_card(counts, lambda: no_sync(lambda: chunk(cstate, gen)))
            second = second["loss"]
            replay_launches(f"chunked {dtype}: the chunk with no host sync", unsynced,
                            per_entry, CHUNK)
            after_second = {k: p.clone() for k, p in params_of(model).items()}
            (profiled, _), profiled_on_card = on_card(
                counts, lambda: replayed(lambda: chunk(cstate, gen)))
        replays[f"flagship_{dtype}"] = replay_launches(f"chunked {dtype}", profiled_on_card,
                                                       per_entry, CHUNK, profiled)
        losses = torch.cat([first["loss"], second]).cpu().numpy()
        r.update(no_host_sync=True, replayed_launches_per_chunk=replays[f"flagship_{dtype}"],
                 steps=int(cstate.step), all_finite=bool(np.isfinite(losses).all()),
                 mean_first_10=float(losses[:10].mean()), mean_last_10=float(losses[-10:].mean()))
        if not (r["all_finite"] and r["mean_last_10"] < r["mean_first_10"]):
            emit("chunked_train", ok=False, results={**results, dtype: r})
            raise SystemExit(f"chunked {dtype}: a loss was not finite or the loss did not fall")
        if checkpoint:
            with checkpoint:
                r["checkpoint"] = restored_chunk(checkpoint.name, second, after_second)
            r["non_finite_step"] = non_finite_step()
        results[dtype] = r
    emit("chunked_train", ok=True, results=results, chunk=CHUNK, batch=N,
         bars={"loss": [CPU_TOL, CPU_TOL], "leaf_relative_norm": STEP_G_TOL},
         note="against_eager: a captured chunk against as many make_train_step steps "
         "from the same weights, generator seed and optimizer (capturable Adam); "
         "python_counters: the counters' (forward, backward) launches over the "
         "warm-up's steps and over the captured step (replays do not tick them); "
         "replayed_launches_per_chunk: device_counter, the wrappers' device counters "
         "over a replayed chunk (their adds are captured beside the launches); "
         "profiler, torch.profiler's kernel records of the same chunk (it can drop "
         "records)")
    return replays


def restored_chunk(directory, want_losses, want_params):
    """A fresh flagship and capturable Adam, its chunk captured and run once,
    then the checkpoint restored in place into it: its next chunk against the
    uninterrupted run's second chunk."""
    from normflows_tpu_torch import training

    model = build_flagship(DEVICE, init_identity=True)
    state, chunk = training.make_step_chunk(model, capturable_adam(model),
                                            reverse_kld_loss(N), CHUNK)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    chunk(state, gen)
    training.restore_checkpoint(directory, {"train": state, "generator": gen}, step=CHUNK)
    losses = chunk(state, gen)[1]["loss"]
    _, gap = leaf_gap(params_of(model), want_params)
    r = {"excess_loss": excess(losses.cpu(), want_losses.cpu(), CPU_TOL, CPU_TOL),
         "max_abs_loss": float((losses - want_losses).abs().max()),
         "worst_relative_norm": gap, "steps": int(state.step),
         "bit_equal_losses": bool(torch.equal(losses, want_losses))}
    if r["excess_loss"] > 0 or r["worst_relative_norm"] > STEP_G_TOL or \
            r["steps"] != 2 * CHUNK:
        emit("chunked_train", ok=False, checkpoint=r)
        raise SystemExit("chunked_train: the chunk restored from a checkpoint disagrees")
    return r


def non_finite_step():
    """f32 flagship, a captured one-step chunk whose loss is NaN at device
    step NAN_STEP: that call leaves every parameter and Adam tensor bit for
    bit as it was, and the next calls train on; then a chunk of 10 with the
    NaN at its step 5: the loss vector holds it, Adam counted 9 updates."""
    from normflows_tpu_torch import training

    model = build_flagship(DEVICE, init_identity=True)
    opt = capturable_adam(model)
    box = {}
    state, one = training.make_step_chunk(model, opt, nan_at(box, NAN_STEP,
                                                             reverse_kld_loss(N)), 1)
    box["state"] = state
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    for _ in range(NAN_STEP):
        one(state, gen)
    params, adam = [p.detach().clone() for p in model.parameters()], adam_tensors(opt)
    nan_loss = float(one(state, gen)[1]["loss"][0])
    kept = all(torch.equal(p, q) for p, q in zip(model.parameters(), params)) and all(
        torch.equal(a, b) for a, b in zip(adam_tensors(opt), adam))
    later = torch.cat([one(state, gen)[1]["loss"] for _ in range(2)])
    moved = not all(torch.equal(p, q) for p, q in zip(model.parameters(), params))

    model = build_flagship(DEVICE, init_identity=True)
    box = {}
    state, chunk = training.make_step_chunk(model, capturable_adam(model),
                                            nan_at(box, 5, reverse_kld_loss(N)), 10)
    box["state"] = state
    losses = chunk(state, gen)[1]["loss"]
    adam_steps = float(next(iter(state.optimizer.state.values()))["step"])
    r = {"nan_step": NAN_STEP, "loss_at_nan_step": nan_loss, "unchanged_across_it": kept,
         "later_losses_finite": bool(torch.isfinite(later).all()), "moved_after": moved,
         "chunk_losses_finite": torch.isfinite(losses).tolist(), "adam_steps": adam_steps,
         "steps": int(state.step)}
    if not (math.isnan(nan_loss) and kept and moved and r["later_losses_finite"]
            and r["chunk_losses_finite"] == [i != 5 for i in range(10)]
            and adam_steps == 9 and r["steps"] == 10):
        emit("chunked_train", ok=False, non_finite_step=r)
        raise SystemExit("chunked_train: a non-finite step was not skipped on the device")
    return r


def phase_chunked_data():
    """The coupled NSF of docs/getting_started.md (random nets and CDFs, f32),
    make_chunked_train_step on CP_DATA TwoMoons points on the card, batch
    512, shuffle=False: a captured chunk of CHUNK steps against the same
    windows stepped eagerly with the same (capturable) Adam; the Python
    counters by stage; the next chunk with no host sync, the one after
    under the profiler, each with exactly 16 flat forward and 16 flat
    backward launches a step on the device counters (``replay_launches``)."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.training.loop import WARMUP_STEPS

    per_step = 2 * CP_LAYERS
    per_entry = {"rqs_flat_forward": per_step, "rqs_flat_backward_forward": per_step}
    data = docs_data(SEED + 92, CP_DATA)
    eager = build_coupled(DEVICE)
    state, step = training.make_train_step(eager, capturable_adam(eager), forward_kld_loss)
    windows = [(i * CP_BATCH) % (CP_DATA - CP_BATCH + 1) for i in range(CHUNK)]
    eager_losses = torch.stack([step(state, data[s:s + CP_BATCH])[1]["loss"]
                                for s in windows])
    model = build_coupled(DEVICE)
    cstate, chunk = training.make_chunked_train_step(
        model, capturable_adam(model), forward_kld_loss, data, CP_BATCH, CHUNK, shuffle=False)
    stages = by_stage(chunk)
    n = per_step * (WARMUP_STEPS + 1)
    with device_counters() as counts:
        (_, first), _ = counted("chunked coupled: warm-up and capture", lambda: chunk(cstate),
                                flat=(n, n))
        r = {"python_counters": check_stages("chunked coupled", stages, "flat", per_step),
             "against_eager": against_eager("chunked_data", first["loss"], eager_losses, model,
                                            eager)}
        (_, second), unsynced = on_card(counts, lambda: no_sync(lambda: chunk(cstate)))
        replay_launches("chunked coupled: the chunk with no host sync", unsynced, per_entry,
                        CHUNK)
        r["no_host_sync"] = bool(torch.isfinite(second["loss"]).all())
        (profiled, _), profiled_on_card = on_card(counts,
                                                  lambda: replayed(lambda: chunk(cstate)))
    launches = replay_launches("chunked coupled", profiled_on_card, per_entry, CHUNK, profiled)
    r.update(replayed_launches_per_chunk=launches, steps=int(cstate.step))
    emit("chunked_data", ok=True, results=r, chunk=CHUNK, batch=CP_BATCH, data=CP_DATA,
         bars={"loss": [CPU_TOL, CPU_TOL], "leaf_relative_norm": STEP_G_TOL},
         note="as chunked_train's")
    return {"coupled_float32": launches}


def timed_chunk(make, batch):
    """``make(steps) -> (state, chunk, generator)``, a fresh model's chunk.
    Host time of a chunk of TIMED_CHUNK steps ending in a synchronise, over
    TIMED_CHUNK: the median of TIMED_CHUNKS chunks after one (the capture).
    Then a PROFILED_CHUNK-step chunk of another fresh model, after its
    capture, under torch.profiler: the device time of a step and the busy
    share (a short chunk: processing the profile of a 100-step chunk's
    ~250,000 kernel records takes tens of seconds).  Returns the numbers
    and the timed chunk."""
    state, chunk, gen = make(TIMED_CHUNK)
    chunk(state, gen)
    sync()
    times = []
    for _ in range(TIMED_CHUNKS):
        t0 = time.perf_counter()
        chunk(state, gen)
        sync()
        times.append((time.perf_counter() - t0) * 1e3 / TIMED_CHUNK)
    ms = float(np.median(times))
    short, short_chunk, short_gen = make(PROFILED_CHUNK)
    short_chunk(short, short_gen)
    _, prof = replayed(lambda: short_chunk(short, short_gen))
    device_ms = prof["device_ms"] / PROFILED_CHUNK
    return {"ms": ms, "ms_each_chunk": times, "samples_per_s": batch / (ms / 1e3),
            "device_ms": device_ms, "busy_share_of_median": device_ms / ms,
            "profile": prof}, chunk


def phase_times_chunked(eager_flagship, eager_coupled):
    """Step ms and samples/s of the chunked flagship (f32, bf16) and of the
    chunked coupled forward-KL step, beside the eager steps' numbers from
    this run (times_train, times_coupled); the device ms of a step from a
    short chunk under the profiler (``timed_chunk``); the device time of the
    non-finite skip's copy and select over the flagship's parameters and
    Adam state, 20 of them in one CUDA graph."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.utils import set_compute_dtype

    def eager(e):
        return {"ms": e["ms"], "samples_per_s": e["samples_per_s"],
                "device_ms": e["profile"]["device_ms"],
                "busy_share_of_median": e["busy_share_of_median"]}

    out = {}
    for dtype in ("float32", "bfloat16"):
        def make(steps):
            model = set_compute_dtype(build_flagship(DEVICE, init_identity=True),
                                      None if dtype == "float32" else dtype)
            state, chunk = training.make_step_chunk(model, capturable_adam(model),
                                                    reverse_kld_loss(N), steps)
            return state, chunk, torch.Generator(device=DEVICE).manual_seed(SEED + 11)

        r, chunk = timed_chunk(make, N)
        r["eager"] = eager(eager_flagship[dtype])
        if dtype == "float32":
            flat, keep = chunk.flat, torch.ones((), dtype=torch.bool, device=DEVICE)
            elements = sum(live.numel() for live, _ in flat.pairs)
            skip_ms = graph_ms(lambda: (flat.save(), flat.keep_if(keep)), reps=20)
            out["skip"] = {"ms": skip_ms, "elements": elements,
                           "bound_ms": 5 * 4 * elements / HBM_BYTES_PER_S * 1e3,
                           "note": "the copy before the update (2 floats moved an "
                           "element) and the select after it (3)"}
        out[f"flagship_{dtype}"] = r
    data = docs_data(SEED + 93, CP_DATA)

    def make_coupled(steps):
        model = build_coupled(DEVICE, init_identity=True)
        state, chunk = training.make_chunked_train_step(
            model, capturable_adam(model), forward_kld_loss, data, CP_BATCH, steps)
        return state, chunk, torch.Generator(device=DEVICE).manual_seed(SEED + 12)

    r, _ = timed_chunk(make_coupled, CP_BATCH)
    r["eager"] = eager(eager_coupled["float32"]["forward_kld_step"])
    out["coupled_forward_kld_float32"] = r
    emit("times_chunked", steps=out, chunk=TIMED_CHUNK, profiled_chunk=PROFILED_CHUNK,
         flagship_batch=N, coupled_batch=CP_BATCH,
         note="ms: host time of a chunk of 100 steps ending in a synchronise, over 100, "
         f"median of {TIMED_CHUNKS} chunks after the first; device_ms: the kernels' device time of "
         "a 10-step chunk of another model built alike, under torch.profiler after "
         "its capture, over 10; busy_share_of_median: device_ms over ms; eager: "
         "the same model's make_train_step in times_train / times_coupled; the flagship "
         "from bench.py's init, the coupled model from the docs' on shuffled batches")
    return out


def phase_convergence(seed=SEED + 13):
    """bf16 flagship from bench.py's init, CONV_STEPS chunked reverse-KL
    steps (chunks of CONV_CHUNK) with Adam(5e-4) under cosine decay over
    CONV_STEPS, then KL(q||p) = E_q[log q - log p] on CONV_HELD_OUT fresh
    samples (GaussianVonMises is normalised), against CONV_KL.  Returns the
    readings and the trained model (the samplers' flagship)."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.utils import set_compute_dtype

    model = set_compute_dtype(build_flagship(DEVICE, init_identity=True), "bfloat16")
    state, chunk = training.make_step_chunk(
        model, capturable_adam(model), reverse_kld_loss(N), CONV_CHUNK,
        schedule=training.cosine_decay_schedule(LR, CONV_STEPS))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    losses = torch.cat([chunk(state, gen)[1]["loss"]
                        for _ in range(CONV_STEPS // CONV_CHUNK)]).cpu().numpy()
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        z, log_q = model.sample(CONV_HELD_OUT, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED + 14))
        kl = float(torch.mean(log_q - model.p.log_prob(z)))
    r = {"seed": seed, "steps": int(state.step), "seconds": seconds,
         "samples_per_s": CONV_STEPS * N / seconds, "kl": kl,
         "all_finite": bool(np.isfinite(losses).all()),
         "loss_every_100": losses[::100].tolist(), "mean_last_100": float(losses[-100:].mean())}
    ok = r["all_finite"] and kl <= CONV_KL
    emit("convergence", ok=ok, results=r, bar=CONV_KL, held_out=CONV_HELD_OUT)
    if not ok:
        raise SystemExit(f"convergence: KL(q||p) {kl} after {CONV_STEPS} steps exceeds "
                         f"{CONV_KL}")
    return r, model


# ---- Real NVP, trained and served ------------------------------------------

def build_real_nvp(device, K=RNVP_K, random_last=True):
    """The README's Real NVP (``examples.real_nvp_twomoons.build_model``)
    from a seeded generator; with ``random_last`` every net's zero-init last
    layer drawn ~ 0.1 N(0, 1), so that each layer does work."""
    from normflows_tpu_torch.examples.real_nvp_twomoons import build_model

    model = build_model(K, device, torch.Generator().manual_seed(SEED + 30))
    if random_last:
        gen = torch.Generator().manual_seed(SEED + 31)
        with torch.no_grad():
            for layer in model.flows:
                for net in (layer.s_net, layer.t_net):
                    w = net.linears[-1].weight
                    w.copy_(0.1 * torch.randn(w.shape, generator=gen))
    return model


def realnvp_parity():
    """The example's inputs at SEED (``real_nvp_twomoons.inputs``, drawn on
    the host): RNVP_PARITY_STEPS chunked AdamW steps in its windows on the
    card (one chunk, captured) and on the CPU, every loss within CPU_TOL.
    Returns the readings and the card's model."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import real_nvp_twomoons as example

    losses, models = {}, {}
    for where in (DEVICE, "cpu"):
        model, x_all, _ = example.inputs(RNVP_K, SEED, where)
        models[where] = model
        opt = torch.optim.AdamW(model.parameters(), lr=RNVP_LR, weight_decay=1e-5,
                                capturable=where != "cpu")
        state, chunk = training.make_chunked_train_step(
            model, opt, example.forward_kld_loss, x_all, RNVP_BATCH, RNVP_PARITY_STEPS,
            shuffle=False)
        losses[where] = chunk(state)[1]["loss"].cpu()
    gap = (losses[DEVICE] - losses["cpu"]).abs()
    return {"steps": RNVP_PARITY_STEPS, "max_abs_loss_gap": float(gap.max()),
            "gap_at_step": {i: float(gap[i]) for i in (0, 9, 24, RNVP_PARITY_STEPS - 1)},
            "loss_card_last": float(losses[DEVICE][-1]),
            "loss_cpu_last": float(losses["cpu"][-1])}, models[DEVICE]


def phase_realnvp(root):
    """(a) One f32 forward-KL step of the README's Real NVP (K = 32, random
    last layers) on RNVP_BATCH TwoMoons points on the card against the CPU
    (every gradient leaf within 2e-3 of its norm; no kernel launch: the model
    runs no kernel of the port); (b) the example's first RNVP_PARITY_STEPS
    steps on the card against the CPU (``realnvp_parity``); (c)
    ``examples.real_nvp_twomoons`` at RNVP_ITERS chunked AdamW steps
    (chunks of RNVP_CHUNK, 2^16 points on the card) and 4096 draws of the
    live model (``--no-serve``); its held-out mean log q and the draws' mean
    radius reported, the radius beside RNVP_RADIUS.  Returns (b)'s model, trained RNVP_PARITY_STEPS steps on
    the card: its draws are finite, where (c)'s may not be."""
    from normflows_tpu_torch.examples import real_nvp_twomoons

    r = {"card_vs_cpu": step_against_cpu(
        "realnvp", build_real_nvp, RNVP_BATCH, lambda card, cpu: None, {},
        loss_fn=forward_kld_loss, batch=docs_data(SEED + 32, RNVP_BATCH))}
    r["parity"], model = realnvp_parity()
    if not r["parity"]["max_abs_loss_gap"] <= CPU_TOL:
        emit("realnvp", ok=False, results=r)
        raise SystemExit("realnvp: the example's first steps on the card disagree with "
                         "the CPU")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, record = real_nvp_twomoons.main(
            ["--iters", str(RNVP_ITERS), "--k", str(RNVP_K), "--chunk", str(RNVP_CHUNK),
             "--no-serve", "--seed", str(SEED), "--device", DEVICE])
    record.pop("bundle")
    r["run"] = {**record, "printed": printed.getvalue().splitlines()[:-1],
                "ring_radius_within": bool(RNVP_RADIUS[0] <= record["ring_radius"]
                                           <= RNVP_RADIUS[1])}
    emit("realnvp", ok=True, results=r,
         bars={"leaf_relative_norm": STEP_G_TOL, "loss": [CPU_TOL, CPU_TOL],
               "parity_loss_gap": CPU_TOL},
         reported={"ring_radius": RNVP_RADIUS},
         note=f"the example's run cut to {RNVP_ITERS} of its 4,000 steps, its draws the "
              f"live model's: its held-out log q is a reading, RNVP_LOG_Q ({RNVP_LOG_Q}) "
              "the 4,000-step run's")
    return model


def bundle_bytes(path):
    return {name: os.path.getsize(os.path.join(path, name)) for name in sorted(os.listdir(path))}


def expect_launches(what, got, want):
    """``got`` (the device counters, by the kernels line's names) must be
    ``want`` for the kernels it names and 0 for every other."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise SystemExit(f"{what}: the device counters counted {got}, expected {full}")
    return {k: n for k, n in got.items() if n}


def python_launches():
    from normflows_tpu_torch.ops import made_fused, spline_cuda, spline_flat

    return sum(m.LAUNCHES + m.BACKWARD_LAUNCHES for m in (spline_cuda, spline_flat, made_fused))


def route_times(fns):
    """Host median of SERVE_REPS calls of each function of ``fns``, each
    ending in a synchronise, and one profiled call's device time over it
    (``busy``: the device traced alone)."""
    out = {}
    for route, fn in fns.items():
        ms = host_ms(fn, reps=SERVE_REPS, warmup=1)
        prof = busy(fn)
        out[route] = {"ms": ms, "device_ms": prof["device_ms"],
                      "busy_share_of_median": prof["device_ms"] / ms,
                      "kernel_launches": prof["kernel_launches"]}
    return out


def serve(what, model, root, counts, sample_launches, log_prob_launches, x, batches,
          num_samples=N, timed=False, path=None, labels=None, **export_kw):
    """Export ``model`` (``serving.save_bundle``) under ``root`` (or take
    the bundle it was saved to at ``path``), load the bundle and hold it
    against the live model, bit for bit:

    * the sampler (when ``sample_launches`` is not None) from one seed, eager
      and as the graph (after the call that captures it), against
      ``model.sample(num_samples)`` from the same seed; each request
      launches exactly ``sample_launches`` on the device counters, and the
      graphed one no kernel from Python;
    * ``log_prob`` of ``x[:b]`` for each ``b`` of ``batches`` through the one
      program, ``log_prob_launches`` each.

    With ``labels`` (a class-conditional model, exported with
    ``class_cond=True``) the requests take ``labels[:n]``.  With ``timed``:
    the three routes of a request (the live model eager, the bundle eager,
    the bundle graphed) and ``log_prob`` live and from the bundle at the
    last batch (``route_times``)."""
    from normflows_tpu_torch import serving

    if path is None:
        path = os.path.join(root, what)
        manifest = serving.save_bundle(model, path, num_samples if sample_launches is not None
                                       else None, tuple(x.shape[1:]), **export_kw)
    bundle = serving.load_bundle(path)
    manifest = bundle.manifest
    num_samples = manifest["num_samples"] or num_samples
    r = {"export_seconds": manifest["export_seconds"], "bytes": bundle_bytes(path),
         "kernel_ops": manifest["kernel_ops"], "symbolic_batch": manifest["symbolic_batch"],
         "launches": {}}
    equal = {}
    seed = SEED + 40
    ys = None if labels is None else labels[:num_samples]

    def y_of(b):
        return () if labels is None else (labels[:b],)

    with torch.inference_mode():
        if sample_launches is not None:
            live = model.sample(num_samples, ys,
                                generator=torch.Generator(device=DEVICE).manual_seed(seed))
        lives = {b: model.log_prob(x[:b], *y_of(b)) for b in batches}
    if sample_launches is not None:
        eager, got = on_card(counts, lambda: bundle.sample(seed, ys, graphed=False))
        r["launches"]["sample_eager"] = expect_launches(f"{what} sample, eager", got,
                                                        sample_launches)
        bundle.sample(seed + 1, ys)  # captures the graph
        before = python_launches()
        graphed, got = on_card(counts, lambda: bundle.sample(seed, ys))
        r["launches"]["sample_graphed"] = expect_launches(f"{what} sample, graphed", got,
                                                          sample_launches)
        r["python_launches_graphed"] = python_launches() - before
        for route, (xs, lq) in (("eager", eager), ("graphed", graphed)):
            equal[f"sample_{route}"] = bool(torch.equal(xs, live[0])
                                            and torch.equal(lq, live[1]))
        r["finite"] = bool(torch.isfinite(graphed[0]).all() and torch.isfinite(graphed[1]).all())
    for b in batches:
        lp, got = on_card(counts, lambda: bundle.log_prob(x[:b], *y_of(b)))
        r["launches"][f"log_prob_{b}"] = expect_launches(f"{what} log_prob at {b}", got,
                                                         log_prob_launches)
        equal[f"log_prob_{b}"] = bool(torch.equal(lp, lives[b]))
    r["bit_equal"] = equal
    if not all(equal.values()) or r.get("python_launches_graphed", 0) or not r.get("finite", 1):
        emit("serving_export", ok=False, failed=what, results=r)
        raise SystemExit(f"serving_export: the {what} bundle disagrees with its live model")
    if timed:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)

        def live_sample():
            with torch.inference_mode():
                return model.sample(num_samples, generator=gen)

        r["sample_ms"] = route_times({"live_eager": live_sample,
                                      "bundle_eager": lambda: bundle.sample(seed, graphed=False),
                                      "bundle_graphed": lambda: bundle.sample(seed)})
        for b in batches[-1:]:
            def live_log_prob():
                with torch.inference_mode():
                    return model.log_prob(x[:b])

            r[f"log_prob_ms_{b}"] = route_times({
                "live_eager": live_log_prob, "bundle_eager": lambda: bundle.log_prob(x[:b])})
    return r


def phase_serving_export(root, real_nvp):
    """``normflows_tpu_torch.serving`` on the card: bundles of the flagship
    (random weights, f32 and bf16), the coupled NSF (random nets and CDFs),
    the large-D model's ``log_prob`` with the fused MADE off (symbolic batch)
    and on (concrete batch of 4096), and Real NVP (``real_nvp``: the
    example's model after its first RNVP_PARITY_STEPS steps on the card,
    from ``phase_realnvp``; a model of the full run may draw non-finite
    points), each exported to the directory ``root``, loaded and held bit for bit
    against its live model, eager and graphed (``serve``), with exact
    launches on the device counters: 24 planar inverse launches a flagship
    sample, 12 forward a log_prob; 16 flat a coupled request; 4 flat and 4
    fused a large-D log_prob with fusion on; Glow's model A class-conditional
    (f32, GLOW_SERVED draws a request at given labels; no spline kernel) and
    model B's ``log_prob`` (IMG_LAYERS flat inverse launches a request).
    The request routes timed for the flagship and the coupled model at 2^14.  Returns, for each kernel,
    its launches by bundle and request."""
    from normflows_tpu_torch.ops import backend
    from normflows_tpu_torch.utils import set_compute_dtype

    results = {}
    with device_counters() as counts:
        flagship = build_flagship(DEVICE)
        x = flagship.sample(N, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 41))[0]
        for dtype in ("float32", "bfloat16"):
            set_compute_dtype(flagship, None if dtype == "float32" else dtype)
            results[f"flagship_{dtype}"] = serve(
                f"flagship_{dtype}", flagship, root, counts,
                {"rqs_transposed_inverse": 2 * LAYERS}, {"rqs_transposed_forward": LAYERS},
                x.detach(), SERVE_BATCHES, timed=True)
        del flagship
        coupled = build_coupled(DEVICE)
        per_request = 2 * CP_LAYERS
        results["coupled_float32"] = serve(
            "coupled_float32", coupled, root, counts, {"rqs_flat_inverse": per_request},
            {"rqs_flat_forward": per_request}, docs_data(SEED + 42, N), SERVE_BATCHES,
            timed=True)
        del coupled
        large = build_large_d(DEVICE)
        xl = 1.5 * torch.randn(LD_BATCH, LD_D, device=DEVICE,
                               generator=torch.Generator(device=DEVICE).manual_seed(SEED + 43))
        results["large_d_fusion_off"] = serve(
            "large_d_fusion_off", large, root, counts, None, {"rqs_flat_forward": LD_LAYERS},
            xl, (1, 1000, LD_BATCH))
        backend.set_made_fusion(True)
        try:
            results["large_d_fusion_on"] = serve(
                "large_d_fusion_on", large, root, counts, None,
                {"rqs_flat_forward": LD_LAYERS, "made_fused_forward": LD_LAYERS}, xl,
                (LD_BATCH,), symbolic_batch=False, batch_size=LD_BATCH)
        finally:
            backend.set_made_fusion(False)
        del large
        results["real_nvp"] = serve("real_nvp", real_nvp, root, counts, {}, {},
                                    docs_data(SEED + 44, RNVP_SERVED), (1, RNVP_SERVED),
                                    num_samples=RNVP_SERVED)
        # model A (class-conditional, f32): sample(seed, y) and log_prob(x, y)
        glow = build_glow(DEVICE)
        xg, yg = glow_images(GLOW_BATCH)
        glow.init_actnorm(xg, yg)
        results["glow_class_cond_float32"] = serve(
            "glow_class_cond_float32", glow, root, counts, {}, {}, xg, (1, GLOW_SERVED),
            num_samples=GLOW_SERVED, labels=yg, class_cond=True)
        del glow
        # model B's log_prob: IMG_LAYERS flat launches a request
        img = build_image_nsf(DEVICE)
        xi = image_nsf_data(IMG_BATCH)
        img.init_actnorm(xi)
        results["image_nsf_log_prob"] = serve(
            "image_nsf_log_prob", img, root, counts, None, {"rqs_flat_inverse": IMG_LAYERS},
            xi, (1, IMG_BATCH))
        del img
    emit("serving_export", ok=True, results=results, batch=N,
         note="export_seconds: torch.export of the sampler and of log_prob (save_bundle); "
         "bytes: the bundle's files; launches: the device counters over one request; "
         f"sample_ms: the request by three routes, host median of {SERVE_REPS} calls each ending in "
         "a synchronise, device_ms of one call under torch.profiler, busy share that over "
         "the median; log_prob_ms_<b>: the same at the largest batch b, live and from the "
         "bundle's one program")
    served = {}
    for bundle, r in results.items():
        for request, launched in r["launches"].items():
            for kernel, n in launched.items():
                served.setdefault(kernel, {}).setdefault(bundle, {})[request] = n
    return served


# ---- conditional flows ------------------------------------------------------

class KernelCalls:
    """While entered, the planar and flat spline operators (forward and
    backward) pass through here, and so does the static-tail flat entry: the
    first ``keep`` calls of each (operator, direction) keep copies of their
    operands and results, for holding each kernel against its plain version
    on the very inputs a model's path gave it."""

    def __init__(self, keep=2):
        self.keep, self.calls, self.saved, self.in_entry = keep, {}, [], False

    def _wrap(self, module, attr, name, inverse_at):
        real = getattr(module, attr)

        def through(*args, **kw):
            if name == "entry":
                self.in_entry = True
                try:
                    out = real(*args, **kw)
                finally:
                    self.in_entry = False
            else:
                out = real(*args, **kw)
            # a flat launch made by the static-tail entry is held to its bars
            key = ("flat_static" if name == "flat" and self.in_entry else name,
                   bool(args[inverse_at]))
            kept = self.calls.setdefault(key, [])
            if len(kept) < self.keep:
                def copy(v):
                    return v.detach().clone() if isinstance(v, torch.Tensor) else v
                kept.append(([copy(a) for a in args], kw, [copy(o) for o in out]))
            return out

        self.saved.append((module, attr, real))
        setattr(module, attr, through)

    def __enter__(self):
        from normflows_tpu_torch.ops import spline_cuda, spline_flat

        self._wrap(spline_cuda, "OP", "planar", 4)
        self._wrap(spline_cuda, "BACKWARD_OP", "planar_backward", 6)
        self._wrap(spline_flat, "OP", "flat", 6)
        self._wrap(spline_flat, "BACKWARD_OP", "flat_backward", 8)
        # the static-tail entry: (x, uw, uh, ud, codes, bound, inverse, ...)
        self._wrap(spline_flat, "unconstrained_rational_quadratic_spline_flat", "entry", 6)
        return self

    def __exit__(self, *exc):
        for module, attr, real in reversed(self.saved):
            setattr(module, attr, real)


def hold_calls(phase, calls, errs):
    """Each kept call of ``calls`` (a KernelCalls) against its plain version
    in float64 on the same operands, by the bars of the kernel's own phase:
    planar Y_TOL / LD_TOL and G_TOL, flat FLAT_Y_TOL / FLAT_LD_TOL (the
    runtime-tail bars) and FLAT_G_TOL, the static-tail entry and the flat
    launch it makes Y_TOL / LD_TOL (phase_kernel_flat's bars for each).  Adds the worst
    |difference| of each (kind, direction) to ``errs``."""
    from normflows_tpu_torch.ops import spline_cuda as sc
    from normflows_tpu_torch.ops import spline_flat as sf

    def d(v):
        return v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v

    for (name, inverse), kept in calls.calls.items():
        direction = "inverse" if inverse else "forward"
        for args, kw, out in kept:
            a = [d(v) for v in args]
            if name == "planar":
                want, tols = sc.rqs_transposed_reference(*a), (Y_TOL, LD_TOL)
            elif name == "planar_backward":
                want, tols = sc.rqs_transposed_backward_reference(*a), (G_TOL, G_TOL)
            elif name in ("flat", "flat_static"):
                want = sf.unconstrained_rqs_dyncodes_reference(*a)
                tols = (FLAT_Y_TOL, FLAT_LD_TOL) if name == "flat" else (Y_TOL, LD_TOL)
            elif name == "flat_backward":
                dx, *dp = sf.unconstrained_rqs_dyncodes_backward_reference(*a)
                want, tols = (dx, torch.cat(dp)), (FLAT_G_TOL, FLAT_G_TOL)
            else:
                want, tols = flat_float64(*a, **kw), (Y_TOL, LD_TOL)
            key = f"{name}_{direction}"
            for label, got, w, tol in zip(("out", "second"), out, want, tols):
                e = excess(got, w, tol, tol)
                entry = errs.setdefault(key, {"calls": 0, "max_abs": 0.0, "excess": -1.0})
                entry["max_abs"] = max(entry["max_abs"], float((got.double() - w).abs().max()))
                entry["excess"] = max(entry["excess"], e)
            errs[key]["calls"] += 1
            errs[key]["n"] = int(args[0].numel())
    bad = {k: v for k, v in errs.items() if v["excess"] > 0}
    if bad:
        emit(phase, ok=False, kernels=errs)
        raise SystemExit(f"{phase}: a kernel disagrees with its plain version on the "
                         f"conditional inputs: {sorted(bad)}")
    return errs


def exact_on_card(what, counts, fn, **want):
    """``fn`` with every launch counter at 0 just before it: the device
    counters (``on_card``) must give ``want`` (the ``kernels`` line's names;
    the others 0), the Python counters the same sums (``counted``)."""
    def total(stem, backward):
        b = "backward_" if backward else ""
        return want.get(f"{stem}_{b}forward", 0) + want.get(f"{stem}_{b}inverse", 0)

    (out, got), _ = counted(
        what, lambda: on_card(counts, fn),
        planar=(total("rqs_transposed", False), total("rqs_transposed", True)),
        flat=(total("rqs_flat", False), total("rqs_flat", True)))
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise SystemExit(f"{what}: device-counted launches {got}, expected {full}")
    return out, got


def add_launches(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def build_conditional(device, random_last=True):
    """Model A, ``examples.conditional_flow``'s model at its widths; with
    ``random_last``, each MADE's last layer drawn U(-1/sqrt(H), 1/sqrt(H))
    (the torch init) from a CPU generator, so that the splines do real
    work."""
    from normflows_tpu_torch.examples import conditional_flow
    from normflows_tpu_torch.nets.mlp import uniform_

    model = conditional_flow.build_model(device, seed=SEED)
    if random_last:
        gen = torch.Generator().manual_seed(SEED + 40)
        with torch.no_grad():
            for layer in model.flows[::2]:
                w = layer.mprqat.autoregressive_net.final_layer.weight
                w.copy_(uniform_(tuple(w.shape), 1.0 / math.sqrt(w.shape[1]), gen, device))
    return model


def build_conditional_layer(device, context=True):
    """Model B, ``examples/ar_large_d_bench.py:160-176``'s conditional layer:
    the autoregressive RQ spline on D = 64 features, 1 block of hidden 256,
    8 bins, a context of 8 features (none with ``context=False``, the
    unconditional twin timed beside it), permuted masks."""
    import normflows_tpu_torch as nft

    return nft.flows.AutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(SEED + 7), CB_D, 1, CB_HIDDEN,
        num_context_channels=CB_CONTEXT if context else None, num_bins=CB_BINS,
        permute_mask=True, init_identity=False, device=device).mprqat


def build_conditional_coupled(device):
    """The coupled NSF of build_coupled with a context of COND_CONTEXT
    features in every transform net, random nets and CDFs, on model A's
    target."""
    import normflows_tpu_torch as nft

    layers = [nft.flows.CoupledRationalQuadraticSpline.create(
        torch.Generator().manual_seed(SEED + 90 + i), 2, CP_BLOCKS, CP_HIDDEN,
        num_context_channels=COND_CONTEXT, reverse_mask=bool(i % 2), init_identity=False,
        device=device) for i in range(CP_LAYERS)]
    randomize_cdfs(layers)
    return nft.ConditionalNormalizingFlow.create(
        nft.distributions.DiagGaussian.create(2, device=device), layers,
        p=nft.distributions.ConditionalDiagGaussianTarget(device=device), device=device)


def conditional_pairs(n, seed):
    """``n`` (context, x) pairs of model A's target, drawn on the host."""
    from normflows_tpu_torch.examples import conditional_flow

    c, x = conditional_flow.held_out_pairs(seed)
    return c[:n].to(DEVICE), x[:n].to(DEVICE)


def phase_conditional_path():
    """Model A (``examples.conditional_flow``'s model, random last layers),
    the conditional coupled NSF (build_conditional_coupled) and model B (the
    conditional D = 64 layer, f32 and bf16) on the card:
    every planar and flat kernel call of their paths against its plain
    version (``KernelCalls``, ``hold_calls``); exact launches on the device
    counters (A: 8 planar inverse a ``sample``, 4 forward a ``log_prob``,
    4 + 4 a forward-KL step; the coupled NSF: 16 flat forward a
    ``log_prob``, 16 inverse a ``from_noise``; B: 64 flat inverse an
    ``inverse``, 1 flat forward a ``forward``, 64 + 64 the inverse's
    gradient); the fused MADE
    gate off; the card against the CPU (``log_prob`` and ``from_noise`` at
    COND_DRAWS, 1e-3, for model A and the coupled NSF; one forward-KL step's gradient leaves within 2e-3 of
    their norms, the context layers' included; model B at LD_CPU); model B's
    sliced inverse against the naive recursion on the card (the JAX
    package's bars, 1e-5 on values, 1e-4 on log-dets)."""
    from normflows_tpu_torch.ops import backend, made_fused
    from normflows_tpu_torch.utils import set_compute_dtype

    results, errs, launches = {}, {}, {}
    c, x = conditional_pairs(COND_DRAWS, SEED + 50)
    model = build_conditional(DEVICE)
    made = model.flows[0].mprqat.autoregressive_net
    backend.set_made_fusion(True)
    try:
        gate_off = not made.fuses(x, c) and not made_fused.fusable(made, x, None)
    finally:
        backend.set_made_fusion(False)
    with device_counters() as counts, KernelCalls() as calls, torch.inference_mode():
        (z, log_q), got = exact_on_card(
            "conditional sample", counts,
            lambda: model.sample(COND_DRAWS, context=c,
                                 generator=torch.Generator(DEVICE).manual_seed(SEED + 51)),
            rqs_transposed_inverse=2 * COND_LAYERS)
        add_launches(launches, got)
        lp, got = exact_on_card("conditional log_prob", counts, lambda: model.log_prob(z, c),
                                rqs_transposed_forward=COND_LAYERS)
        add_launches(launches, got)
    gap = (lp - log_q).abs()
    a = {"finite": all(bool(torch.isfinite(v).all()) for v in (z, log_q, lp)),
         "median_abs_logq_gap": float(gap.median()), "max_abs_logq_gap": float(gap.max()),
         "fused_gate_off": gate_off}
    # the card against the CPU: log_prob of target draws, from_noise
    cpu = build_conditional("cpu")
    cpu.load_state_dict(model.state_dict())
    eps = torch.randn(COND_DRAWS, 2, generator=torch.Generator().manual_seed(SEED + 52))
    with torch.inference_mode():
        pairs = {"log_prob": (model.log_prob(x, c).cpu(), cpu.log_prob(x.cpu(), c.cpu()))}
        xf, lf = model.from_noise(eps.to(DEVICE), c)
        xc, lc = cpu.from_noise(eps, c.cpu())
    pairs.update({"from_noise_x": (xf.cpu(), xc), "from_noise_log_q": (lf.cpu(), lc)})
    a["cpu"] = {k: {"excess": excess(g, w, CPU_TOL, CPU_TOL),
                    "max_abs": float((g - w).abs().max())} for k, (g, w) in pairs.items()}

    def pair_batch(n):
        cc, xx = conditional_pairs(n, SEED + 53)
        return torch.cat([xx, cc], dim=1)

    def kld(m, batch, generator):
        return m.forward_kld(batch[:, :2], batch[:, 2:])

    with device_counters() as counts, KernelCalls() as step_calls:
        a["step_card_vs_cpu"] = step_against_cpu(
            "conditional_path", build_conditional, COND_DRAWS, lambda card, cpu: None,
            {"planar": (COND_LAYERS, COND_LAYERS)}, loss_fn=kld, batch=pair_batch(COND_DRAWS),
            counts=counts)
    got = a["step_card_vs_cpu"]["device_launches"]
    want = {"rqs_transposed_forward": COND_LAYERS,
            "rqs_transposed_backward_forward": COND_LAYERS}
    if got != {k: want.get(k, 0) for k in got}:
        raise SystemExit(f"conditional forward-KL step: device-counted launches {got}, "
                         f"expected {want}")
    add_launches(launches, got)
    errs_a = hold_calls("conditional_path", calls, {})
    errs_a = hold_calls("conditional_path", step_calls, errs_a)
    a["kernels"] = errs_a
    results["model_a"] = a
    ok = a["finite"] and gate_off and a["median_abs_logq_gap"] <= LOGQ_F32 and all(
        v["excess"] <= 0 for v in a["cpu"].values())
    if not ok:
        emit("conditional_path", ok=False, results=results)
        raise SystemExit("conditional_path: model A failed its checks")

    # the conditional coupled NSF: the static-tail entry along the coupling's
    # and the CDF's layouts, 2 x CP_LAYERS flat launches a pass
    cp = build_conditional_coupled(DEVICE)
    with device_counters() as counts, KernelCalls() as calls, torch.inference_mode():
        lp_c, got = exact_on_card("conditional coupled log_prob", counts,
                                  lambda: cp.log_prob(x, c), rqs_flat_forward=2 * CP_LAYERS)
        add_launches(launches, got)
        (xf_c, lf_c), got = exact_on_card("conditional coupled from_noise", counts,
                                          lambda: cp.from_noise(eps.to(DEVICE), c),
                                          rqs_flat_inverse=2 * CP_LAYERS)
        add_launches(launches, got)
    cpu_c = build_conditional_coupled("cpu")
    cpu_c.load_state_dict(cp.state_dict())
    with torch.inference_mode():
        pairs = {"log_prob": (lp_c.cpu(), cpu_c.log_prob(x.cpu(), c.cpu()))}
        xc, lc = cpu_c.from_noise(eps, c.cpu())
    pairs.update({"from_noise_x": (xf_c.cpu(), xc), "from_noise_log_q": (lf_c.cpu(), lc)})
    coupled = {"cpu": {k: {"excess": excess(g, w, CPU_TOL, CPU_TOL),
                           "max_abs": float((g - w).abs().max())}
                       for k, (g, w) in pairs.items()},
               "finite": all(bool(torch.isfinite(v).all()) for v in (lp_c, xf_c, lf_c)),
               "kernels": hold_calls("conditional_path", calls, {})}
    results["coupled"] = coupled
    if not coupled["finite"] or any(v["excess"] > 0 for v in coupled["cpu"].values()):
        emit("conditional_path", ok=False, results=results)
        raise SystemExit("conditional_path: the conditional coupled NSF failed its checks")

    # model B
    layer = build_conditional_layer(DEVICE)
    rng = np.random.default_rng(SEED + 54)
    xb = torch.from_numpy(rng.normal(size=(CB_BATCH, CB_D)).astype(np.float32)).to(DEVICE)
    cb = torch.from_numpy(rng.normal(size=(CB_BATCH, CB_CONTEXT)).astype(np.float32)).to(DEVICE)
    b = {"fused_gate_off": not made_fused.fusable(layer.autoregressive_net, xb, None)}
    for dtype in ("float32", "bfloat16"):
        set_compute_dtype(layer, None if dtype == "float32" else dtype)
        with device_counters() as counts, KernelCalls() as calls, torch.inference_mode():
            (zi, ldi), got = exact_on_card(f"model B inverse {dtype}", counts,
                                           lambda: layer.inverse(xb, cb),
                                           rqs_flat_inverse=CB_D)
            add_launches(launches, got)
            (xr, ldr), got = exact_on_card(f"model B forward {dtype}", counts,
                                           lambda: layer.forward(zi, cb),
                                           rqs_flat_forward=1)
            add_launches(launches, got)
        r = {"finite": all(bool(torch.isfinite(v).all()) for v in (zi, ldi, xr, ldr)),
             "round_trip_max_abs_x": float((xr - xb).abs().max()),
             "round_trip_median_abs_ld": float((ldr + ldi).abs().median()),
             "kernels": hold_calls("conditional_path", calls, {})}
        if dtype == "float32":
            with torch.inference_mode():
                net = layer.autoregressive_net
                out = torch.zeros_like(xb)
                for _ in range(CB_D):  # the naive recursion, full width each pass
                    out, ld_naive = layer._elementwise_t(
                        xb.T.contiguous(), net(out, cb).T.contiguous(), inverse=True)
                    out = out.T
                ld_naive = ld_naive.sum(0)
            r["vs_naive"] = {"excess_x": excess(zi, out, 1e-5, 1e-5),
                             "max_abs_x": float((zi - out).abs().max()),
                             "excess_ld": excess(ldi, ld_naive, 1e-4, 1e-4),
                             "max_abs_ld": float((ldi - ld_naive).abs().max())}
            zi32, ldi32 = zi, ldi
            # the card against the CPU at LD_CPU, values and the gradient
            cpu = build_conditional_layer("cpu")
            cpu.load_state_dict(layer.state_dict())
            n = LD_CPU
            with torch.inference_mode():
                for name, fn in (("inverse", "inverse"), ("forward", "forward")):
                    yg, lg = getattr(layer, fn)(xb[:n], cb[:n])
                    yc, lc = getattr(cpu, fn)(xb[:n].cpu(), cb[:n].cpu())
                    r[f"cpu_{name}"] = {"excess_y": excess(yg.cpu(), yc, CPU_TOL, CPU_TOL),
                                        "excess_ld": excess(lg.cpu(), lc, CPU_TOL, CPU_TOL)}
            grads = {}
            with device_counters() as counts, KernelCalls() as gcalls:
                for where, m, xx, cc in (("card", layer, xb[:n], cb[:n]),
                                         ("cpu", cpu, xb[:n].cpu(), cb[:n].cpu())):
                    def loss(m=m, xx=xx, cc=cc):
                        zz, ll = m.inverse(xx, cc)
                        g = torch.autograd.grad((zz**2).sum() + ll.sum(),
                                                list(m.parameters()))
                        return dict(zip([k for k, _ in m.named_parameters()], g))
                    if where == "card":
                        grads[where], got = exact_on_card(
                            "model B inverse gradient", counts, loss,
                            rqs_flat_inverse=CB_D, rqs_flat_backward_inverse=CB_D)
                        add_launches(launches, got)
                    else:
                        grads[where] = loss()
            worst, gap_g = leaf_gap(grads["card"], grads["cpu"])
            r["gradient_card_vs_cpu"] = {"worst_leaf": worst, "worst_relative_norm": gap_g,
                                         "context_leaves": sorted(
                                             k for k in grads["cpu"] if "context" in k)}
            r["kernels_gradient"] = hold_calls("conditional_path", gcalls, {})
            ok = (r["finite"] and r["vs_naive"]["excess_x"] <= 0
                  and r["vs_naive"]["excess_ld"] <= 0 and gap_g <= STEP_G_TOL
                  and max(v for k in ("cpu_inverse", "cpu_forward") for v in r[k].values())
                  <= 0)
        else:
            vs = (ldi - ldi32).abs()
            r["inverse_ld_vs_f32"] = {"median_abs": float(vs.median()),
                                      "max_abs": float(vs.max())}
            ok = r["finite"] and r["inverse_ld_vs_f32"]["median_abs"] <= LD_BF16_VS_F32
        b[dtype] = r
        if not ok:
            results["model_b"] = b
            emit("conditional_path", ok=False, results=results)
            raise SystemExit(f"conditional_path: model B ({dtype}) failed its checks")
    set_compute_dtype(layer, None)
    results["model_b"] = b
    emit("conditional_path", ok=True, results=results, launches=launches,
         bars={"kernels": {"planar": [Y_TOL, LD_TOL, G_TOL],
                           "flat": [FLAT_Y_TOL, FLAT_LD_TOL, FLAT_G_TOL],
                           "entry_and_flat_static": [Y_TOL, LD_TOL]},
               "cpu": CPU_TOL, "leaf_relative_norm": STEP_G_TOL, "logq": LOGQ_F32,
               "vs_naive": [1e-5, 1e-4], "bf16_vs_f32": LD_BF16_VS_F32})
    return launches, layer


def conditional_parity():
    """The example's first COND_PARITY_STEPS steps on host-drawn inputs
    (``--host-inputs``) on the card (one captured chunk) and on the CPU:
    every loss within CPU_TOL."""
    from normflows_tpu_torch.examples import conditional_flow as example

    inputs = example.host_inputs(COND_PARITY_STEPS, COND_BATCH, SEED)
    losses = {}
    for where in (DEVICE, "cpu"):
        model = example.build_model(torch.device(where), seed=SEED)
        state, chunk = example.make_chunk(model, COND_LR, COND_BATCH, COND_PARITY_STEPS,
                                          inputs)
        losses[where] = chunk(state)[1]["loss"].cpu()
    gap = (losses[DEVICE] - losses["cpu"]).abs()
    return {"steps": COND_PARITY_STEPS, "max_abs_loss_gap": float(gap.max()),
            "loss_card_last": float(losses[DEVICE][-1]),
            "loss_cpu_last": float(losses["cpu"][-1])}


def phase_conditional_train(layer_b):
    """(a) ``conditional_parity``; (b) ``examples.conditional_flow`` as a
    user runs it: COND_ITERS chunked steps drawn on the card, then its
    held-out KL(p||q) and its draws' moments at the example's context held
    to COND_KL and COND_MOMENT_GAP (PERF.md §6); (c) model A's chunked
    step time (``timed_chunk``); (d) model B's ``inverse`` and ``forward``,
    f32 and bf16, conditional and its unconditional twin: host median of
    LD_TIMED_REPS calls and one profiled call."""
    from normflows_tpu_torch.examples import conditional_flow as example
    from normflows_tpu_torch.utils import set_compute_dtype

    r = {"parity": conditional_parity()}
    if not r["parity"]["max_abs_loss_gap"] <= CPU_TOL:
        emit("conditional_train", ok=False, results=r)
        raise SystemExit("conditional_train: the example's first steps on the card "
                         "disagree with the CPU")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, record = example.main(["--iters", str(COND_ITERS), "--chunk", str(COND_CHUNK),
                                  "--seed", str(SEED), "--device", DEVICE])
    target = np.asarray(example.SAMPLE_CONTEXT)
    gaps = {"mean": float(np.abs(np.asarray(record["sample_mean"]) - target[:2]).max()),
            "std": float(np.abs(np.asarray(record["sample_std"]) - target[2:]).max())}
    r["run"] = {**record, "printed": printed.getvalue().splitlines()[:-1], "gaps": gaps}
    ok = (record["held_out_kl"] <= COND_KL and record["draws_finite"]
          and all(gaps[k] <= COND_MOMENT_GAP[k] for k in gaps))

    def make(steps):
        model = example.build_model(torch.device(DEVICE), seed=SEED)
        state, chunk = example.make_chunk(model, COND_LR, COND_BATCH, steps)
        return state, chunk, torch.Generator(DEVICE).manual_seed(SEED + 60)

    r["chunked_step"], _ = timed_chunk(make, COND_BATCH)
    times = {}
    twin = build_conditional_layer(DEVICE, context=False)
    rng = np.random.default_rng(SEED + 61)
    xb = torch.from_numpy(rng.normal(size=(CB_BATCH, CB_D)).astype(np.float32)).to(DEVICE)
    cb = torch.from_numpy(rng.normal(size=(CB_BATCH, CB_CONTEXT)).astype(np.float32)).to(DEVICE)
    for dtype in ("float32", "bfloat16"):
        for name, m, ctx in (("conditional", layer_b, cb), ("unconditional", twin, None)):
            set_compute_dtype(m, None if dtype == "float32" else dtype)
            for direction in ("inverse", "forward"):
                def call(m=m, ctx=ctx, direction=direction):
                    with torch.inference_mode():
                        return getattr(m, direction)(xb, ctx)
                ms = host_ms(call, LD_TIMED_REPS)
                # the heaviest kernels in f32; bf16's device traced alone
                prof = profile(call) if dtype == "float32" else busy(call)
                times[f"{name}_{direction}_{dtype}"] = {
                    "ms": ms, "device_ms": prof["device_ms"],
                    "busy_share_of_median": prof["device_ms"] / ms,
                    "kernel_launches": prof["kernel_launches"],
                    "top": prof.get("top", [])[:3]}
    r["model_b_times"] = times
    emit("conditional_train", ok=ok, results=r,
         bars={"parity_loss_gap": CPU_TOL, "held_out_kl": COND_KL,
               "moment_gap": COND_MOMENT_GAP})
    if not ok:
        raise SystemExit("conditional_train: the trained example missed its bars")


# ---- Glow, the image path -------------------------------------------------------

def glow_images(n, seed=SEED, hw=32):
    """``n`` images of the example's generator (CIFAR geometry: 3 x 32 x 32,
    10 classes), dequantised on the host, and their labels, on the card."""
    from normflows_tpu_torch.examples import glow_image

    x, y = glow_image.synthetic_images(1024 + n, (3, hw, hw), seed=seed)
    x, y = glow_image.init_inputs(x, y, n, seed)
    return x.to(DEVICE), y.to(DEVICE)


def build_glow(device, random_last=True):
    """Model A, ``examples.glow_image.build_glow`` at its defaults; with
    ``random_last`` each block's output convolution drawn U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) from a CPU generator."""
    from normflows_tpu_torch.examples import glow_image
    from normflows_tpu_torch.nets.mlp import uniform_

    model = glow_image.build_glow(GLOW_L, GLOW_K, GLOW_HIDDEN, num_classes=GLOW_CLASSES,
                                  device=device, seed=SEED)
    if random_last:
        gen = torch.Generator().manual_seed(SEED + 120)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("convs.2.weight"):
                    fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                    p.copy_(uniform_(tuple(p.shape), 1.0 / math.sqrt(fan_in), gen, device))
    return model


def glow_gaps(card, cpu, x, y):
    """Model ``card`` against its copy ``cpu`` on ``x`` (on the card) and
    labels ``y``: max |difference| of every level's latents, of the log-det
    and of log_prob."""
    with torch.no_grad():
        zg, lg = card.inverse_and_log_det(x)
        zc, lc = cpu.inverse_and_log_det(x.cpu())
        pg, pc = card.log_prob(x, y), cpu.log_prob(x.cpu(), y.cpu())
    return {"latents": [float((a.cpu() - b).abs().max()) for a, b in zip(zg, zc)],
            "log_det": float((lg.cpu() - lc).abs().max()),
            "log_prob": float((pg.cpu() - pc).abs().max())}


def within(gaps, z_tol, lp_tol):
    return max(gaps["latents"]) <= z_tol and max(gaps["log_det"], gaps["log_prob"]) <= lp_tol


def spline_launches_none(counts, what, fn):
    """``fn`` with the device counters at 0: no spline or MADE kernel."""
    out, got = on_card(counts, fn)
    if any(got.values()):
        raise SystemExit(f"{what}: launched {got}; the Glow path has no spline kernel")
    return out


def gradient_gaps(card, cpu, loss, counts=None):
    """The card's gradient of ``loss(model, device)`` against the CPU's, in
    float32 and in float64 (a copy of ``cpu``; the flat spline's plain
    version in float64, ``FlatCalls``): each leaf's |difference| over its
    norm, the worst and the median; the CPU's float32 against float64
    beside.  With ``counts``, the card's pass launches no spline or MADE
    kernel."""
    grads = {}
    for where, m in (("card", card), ("float32", cpu), ("float64", copy.deepcopy(cpu).double())):
        m.zero_grad(set_to_none=True)
        device = next(m.parameters()).device
        if where == "card" and counts is not None:
            spline_launches_none(counts, "a forward-KL gradient",
                                 lambda: loss(m, device).backward())
        elif where == "float64":
            with FlatCalls():
                loss(m, device).backward()
        else:
            loss(m, device).backward()
        grads[where] = {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()}
    out = {"leaves": len(grads["float64"])}
    for name, got, want in (("card_vs_float32", "card", "float32"),
                            ("card_vs_float64", "card", "float64"),
                            ("cpu_float32_vs_float64", "float32", "float64")):
        rel = relative_norms(grads[got], grads[want])
        worst = max(rel, key=rel.get)
        out[name] = {"worst_leaf": worst, "worst_relative_norm": rel[worst],
                     "median_relative_norm": float(np.median(list(rel.values())))}
    return out


def gradient_within(gaps):
    return (gaps["median_relative_norm"] <= GLOW_G_MEDIAN
            and gaps["worst_relative_norm"] <= GLOW_G_MAX)


def phase_glow_path():
    """Model A on the card, f32 and bf16, random output convolutions:
    ``init_actnorm`` on one batch, then ``sample(GLOW_BATCH, y, temperature=
    0.7)`` and ``log_prob``; the card against the CPU on the same weights
    and GLOW_CPU images (every level's latents, the log-det, log_prob; f32
    within GLOW_Z_TOL / GLOW_LP_TOL, bf16 within GLOW_BF16_*); the f32 card
    once more with cuDNN's TF32 on (the bars must fail it); the inverse /
    forward round trip and sample's log_q against log_prob of its draws at
    the same temperature; one forward-KL gradient on the card against the
    CPU in float64 (the leaves' relative gaps, median within GLOW_G_MEDIAN
    and worst within GLOW_G_MAX), and once more with TF32 on (which must
    miss them); no spline or MADE kernel launched anywhere (device
    counters)."""
    from normflows_tpu_torch.nets import cnn
    from normflows_tpu_torch.utils import set_compute_dtype

    model = build_glow(DEVICE)
    x, y = glow_images(GLOW_BATCH)
    r = {}
    with device_counters() as counts:
        spline_launches_none(counts, "glow init_actnorm", lambda: model.init_actnorm(x, y))
        cpu = build_glow("cpu")
        cpu.load_state_dict(model.state_dict())
        gen = torch.Generator(DEVICE).manual_seed(SEED + 121)
        with torch.no_grad():
            t0 = time.perf_counter()
            xs, lq = spline_launches_none(
                counts, "glow sample", lambda: model.sample(GLOW_BATCH, y, temperature=0.7,
                                                            generator=gen))
            sync()
            r["sample_seconds"] = time.perf_counter() - t0
            model.set_temperature(0.7)
            lq_again = model.log_prob(xs, y)
            model.reset_temperature()
            lp = spline_launches_none(counts, "glow log_prob", lambda: model.log_prob(x, y))
            zr, ldr = model.inverse_and_log_det(x)
            xr, ldf = model.forward_and_log_det(zr)
        scale = float(lq.abs().median())
        r["sample"] = {"finite": bool(torch.isfinite(xs).all() and torch.isfinite(lq).all()),
                       "shape": list(xs.shape), "median_abs_log_q": scale,
                       "max_abs_log_q_gap": float((lq_again - lq).abs().max())}
        r["round_trip"] = {"max_abs_x": float((xr - x).abs().max()),
                           "max_abs_log_det": float((ldr + ldf).abs().max())}
        r["log_prob_finite"] = bool(torch.isfinite(lp).all())
        xb, yb = x[:GLOW_CPU], y[:GLOW_CPU]
        r["f32_vs_cpu"] = glow_gaps(model, cpu, xb, yb)
        prior = torch.backends.cudnn.allow_tf32
        real = cnn.fp32_convs
        try:  # the same card pass with cuDNN's TF32 on, for the bars' power
            torch.backends.cudnn.allow_tf32 = True
            cnn.fp32_convs = contextlib.nullcontext
            r["tf32_vs_cpu"] = glow_gaps(model, cpu, xb, yb)
        finally:
            cnn.fp32_convs = real
            torch.backends.cudnn.allow_tf32 = prior
        # one forward-KL gradient, the card against the CPU in float64; then
        # the card's again with cuDNN's TF32 on, forward and backward
        grad = gradient_gaps(model, cpu, lambda m, d: m.forward_kld(xb.to(d), yb.to(d)),
                             counts)
        try:
            torch.backends.cudnn.allow_tf32 = True
            cnn.fp32_convs = contextlib.nullcontext
            tf32 = gradient_gaps(model, cpu, lambda m, d: m.forward_kld(xb.to(d), yb.to(d)))
        finally:
            cnn.fp32_convs = real
            torch.backends.cudnn.allow_tf32 = prior
        grad["tf32_card_vs_float64"] = tf32["card_vs_float64"]
        r["gradient"] = grad
        f32_lp = lp
        set_compute_dtype(model, "bfloat16")
        set_compute_dtype(cpu, "bfloat16")
        with torch.no_grad():
            lp16 = spline_launches_none(counts, "glow bf16 log_prob",
                                        lambda: model.log_prob(x, y))
            xs16, _ = model.sample(GLOW_BATCH, y, temperature=0.7, generator=gen)
        r["bf16_vs_cpu"] = glow_gaps(model, cpu, xb, yb)
        r["bf16_vs_f32_card"] = {"max_abs_log_prob": float((lp16 - f32_lp).abs().max()),
                                 "median_abs_log_prob": float((lp16 - f32_lp).abs().median()),
                                 "sample_finite": bool(torch.isfinite(xs16).all())}
    r["parameters"] = sum(p.numel() for p in model.parameters())
    r["tensors"] = len(model.state_dict())
    ok = (r["sample"]["finite"] and r["log_prob_finite"] and r["bf16_vs_f32_card"]["sample_finite"]
          and r["sample"]["max_abs_log_q_gap"] <= GLOW_LOGQ_REL * scale
          and r["round_trip"]["max_abs_x"] <= GLOW_Z_TOL
          and r["round_trip"]["max_abs_log_det"] <= GLOW_LOGQ_REL * scale
          and within(r["f32_vs_cpu"], GLOW_Z_TOL, GLOW_LP_TOL)
          and not within(r["tf32_vs_cpu"], GLOW_Z_TOL, GLOW_LP_TOL)
          and within(r["bf16_vs_cpu"], GLOW_BF16_Z_TOL, GLOW_BF16_LP_TOL)
          and gradient_within(grad["card_vs_float64"])
          and not gradient_within(grad["tf32_card_vs_float64"]))
    emit("glow_path", ok=ok, results=r, batch=GLOW_BATCH, cpu_batch=GLOW_CPU,
         bars={"f32": [GLOW_Z_TOL, GLOW_LP_TOL], "bf16": [GLOW_BF16_Z_TOL, GLOW_BF16_LP_TOL],
               "tf32_must_fail": [GLOW_Z_TOL, GLOW_LP_TOL], "log_q_rel": GLOW_LOGQ_REL,
               "gradient_vs_float64": {"median": GLOW_G_MEDIAN, "max": GLOW_G_MAX}})
    if not ok:
        raise SystemExit("glow_path: model A failed its checks")


def build_image_nsf(device):
    """Model B: DiagGaussian((12, 16, 16)) and IMG_LAYERS x (an image RQ
    coupling on an alternating channel mask, its net a ConvResidualNet of 2
    blocks of hidden 128, 8 bins, linear tails at 3; Invertible1x1Conv with
    LU; ActNorm((12, 1, 1))), layer i's weights from a CPU generator."""
    import normflows_tpu_torch as nft
    from normflows_tpu_torch.nets import ConvResidualNet
    from normflows_tpu_torch.utils import create_alternating_binary_mask

    layers = []
    for i in range(IMG_LAYERS):
        gen = torch.Generator().manual_seed(SEED + 130 + i)
        layers += [
            nft.flows.PiecewiseRationalQuadraticCoupling.create(
                create_alternating_binary_mask(IMG_C, even=i % 2 == 0),
                lambda c_in, c_out: ConvResidualNet(c_in, c_out, IMG_HIDDEN, num_blocks=2,
                                                    generator=gen, device=device),
                num_bins=IMG_BINS, tails="linear", tail_bound=3.0, device=device),
            nft.flows.Invertible1x1Conv(IMG_C, use_lu=True, generator=gen, device=device),
            nft.flows.ActNorm((IMG_C, 1, 1), device=device)]
    return nft.NormalizingFlow.create(
        nft.distributions.DiagGaussian((IMG_C, IMG_HW, IMG_HW), device=device), layers,
        device=device)


def image_nsf_data(n, seed=SEED):
    """The example's CIFAR images, squeezed to (12, 16, 16) and spread over
    [-2, 2] (the splines' interior and both tails at bound 3 meet them)."""
    from normflows_tpu_torch import flows

    x, _ = glow_images(n, seed, hw=2 * IMG_HW)
    return 4.0 * (flows.Squeeze().inverse(x)[0] - 0.5)


def phase_image_nsf_path():
    """Model B on the card, f32: every flat call of ``log_prob``, ``sample``
    and a forward-KL step held against its plain version in float64 on the
    card's operands (``KernelCalls``; the static-tail entry's bars, 2e-5 /
    2e-4, and the backward's FLAT_G_TOL); exact launches on the device
    counters (the couplings run the spline's inverse in the density
    direction: IMG_LAYERS flat inverse a ``log_prob``, IMG_LAYERS forward a
    ``sample``, IMG_LAYERS inverse + IMG_LAYERS backward a step); the card
    against the CPU (log_prob and latents at GLOW_CPU; the step's gradient
    leaves within STEP_G_TOL of their norms in float64); the flat kernels'
    device time
    at this N along ``event_axis = 1`` (CUDA graph), the static-tail
    entry's with its relayout, their plain versions' and bounds; the
    requests' times.  Returns the launches and the kernels' times."""
    from normflows_tpu_torch.ops import spline_flat as sf

    model = build_image_nsf(DEVICE)
    x = image_nsf_data(IMG_BATCH)
    model.init_actnorm(x)
    launches, r = {}, {}
    gen = torch.Generator(DEVICE).manual_seed(SEED + 131)
    with device_counters() as counts, KernelCalls(keep=IMG_LAYERS) as calls:
        with torch.inference_mode():
            lp, got = exact_on_card("image NSF log_prob", counts, lambda: model.log_prob(x),
                                    rqs_flat_inverse=IMG_LAYERS)
            add_launches(launches, got)
            (xs, lq), got = exact_on_card(
                "image NSF sample", counts,
                lambda: model.sample(IMG_BATCH, generator=gen), rqs_flat_forward=IMG_LAYERS)
            add_launches(launches, got)
            lp_again = model.log_prob(xs)
        model.zero_grad(set_to_none=True)
        _, got = exact_on_card("image NSF forward-KL gradient", counts,
                               lambda: model.forward_kld(x).backward(),
                               rqs_flat_inverse=IMG_LAYERS,
                               rqs_flat_backward_inverse=IMG_LAYERS)
        add_launches(launches, got)
    r["kernels"] = hold_calls("image_nsf_path", calls, {})
    scale = float(lq.abs().median())
    r["finite"] = all(bool(torch.isfinite(v).all()) for v in (lp, xs, lq))
    r["sample_log_q_gap"] = float((lp_again - lq).abs().max())
    cpu = build_image_nsf("cpu")
    cpu.load_state_dict(model.state_dict())
    xb = x[:GLOW_CPU]
    with torch.no_grad():
        zg, lg = model.inverse_and_log_det(xb)
        zc, lc = cpu.inverse_and_log_det(xb.cpu())
        pg, pc = model.log_prob(xb), cpu.log_prob(xb.cpu())
    r["f32_vs_cpu"] = {"latents": [float((zg.cpu() - zc).abs().max())],
                       "log_det": float((lg.cpu() - lc).abs().max()),
                       "log_prob": float((pg.cpu() - pc).abs().max())}
    r["gradient"] = gradient_gaps(model, cpu, lambda m, d: m.forward_kld(xb.to(d)))
    gap = r["gradient"]["card_vs_float64"]["worst_relative_norm"]
    ok = (r["finite"] and r["sample_log_q_gap"] <= GLOW_LOGQ_REL * scale
          and within(r["f32_vs_cpu"], GLOW_Z_TOL, GLOW_LP_TOL) and gap <= STEP_G_TOL)
    if not ok:
        emit("image_nsf_path", ok=False, results=r)
        raise SystemExit("image_nsf_path: model B failed its checks")
    # the flat kernels at this N: the kept calls' operands, rotated
    times = {}
    for (name, inverse), kept in calls.calls.items():
        if name not in ("flat_static", "flat_backward", "entry"):
            continue
        d = "inverse" if inverse else "forward"
        sets = [[a for a in args] for args, kw, _ in kept]
        kws = kept[0][1]
        if name == "entry":
            rotation = itertools.cycle(sets)
            times[f"static_tail_entry_{d}"] = {
                "ms": graph_ms(lambda: sf.unconstrained_rational_quadratic_spline_flat(
                    *next(rotation), **kws), reps=16),
                "call_ms": cuda_ms(lambda: sf.unconstrained_rational_quadratic_spline_flat(
                    *next(rotation), **kws), reps=50)}
            continue
        backward = name == "flat_backward"
        fn = sf.unconstrained_rqs_dyncodes_backward if backward else sf.unconstrained_rqs_dyncodes
        plain = sf.unconstrained_rqs_dyncodes_backward_reference if backward else \
            sf.unconstrained_rqs_dyncodes_reference
        key = f"rqs_flat_{'backward_' if backward else ''}{d}"
        t = {}
        for label, f, timer, reps in (("ms", fn, graph_ms, 32), ("call_ms", fn, cuda_ms, 100),
                                      ("plain_ms", plain, cuda_ms, 5)):
            rotation = itertools.cycle(sets)
            t[label] = timer(lambda: f(*next(rotation)), reps=reps)
        t["bound_ms"], t["bound_by"], _ = flat_bound(IMG_N, backward)
        t["n"] = int(sets[0][0].numel())
        times[key] = t
    requests = {}
    for label, fn in (("log_prob", lambda: model.log_prob(x)),
                      ("sample", lambda: model.sample(IMG_BATCH, generator=gen))):
        def call(fn=fn):
            with torch.inference_mode():
                return fn()
        ms = host_ms(call, LD_TIMED_REPS)
        prof = profile(call)
        requests[label] = {"ms": ms, "device_ms": prof["device_ms"],
                           "busy_share_of_median": prof["device_ms"] / ms,
                           "kernel_launches": prof["kernel_launches"], "top": prof["top"][:4]}
    r["times"], r["requests"] = times, requests
    emit("image_nsf_path", ok=True, results=r, launches=launches, n=IMG_N,
         bars={"entry_and_flat_static": [Y_TOL, LD_TOL], "flat_backward": FLAT_G_TOL,
               "cpu": [GLOW_Z_TOL, GLOW_LP_TOL], "leaf_relative_norm": STEP_G_TOL,
               "log_q_rel": GLOW_LOGQ_REL},
         note="times: ms, device time of 32 launches in one CUDA graph over the kept "
         "calls' operands (4 sets rotated, 84 MB); call_ms, plain_ms: CUDA events over "
         "a loop of calls; static_tail_entry: the coupling's call (the (B, C*(3K+1), H, "
         "W) parameters copied into (3K+1, N) rows, the code and bound rows, the "
         "kernel); requests: host median of LD_TIMED_REPS calls, one profiled call")
    return launches, times


def kernel_shares(fn, top=12):
    """``fn`` under torch.profiler: its kernels' device time, the share of
    the convolutions' kernels (cuDNN's: names with conv, fprop, dgrad,
    wgrad, implicit or xmma, and its layout transforms), and the heaviest."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host]
    total = sum(e.self_device_time_total for e in kernels)
    words = ("conv", "fprop", "dgrad", "wgrad", "implicit", "xmma", "nchwtonhwc",
             "nhwctonchw")
    conv = sum(e.self_device_time_total for e in kernels
               if any(w in e.key.lower() for w in words))
    heavy = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"device_ms": total / 1e3, "conv_share": conv / total if total else 0.0,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in heavy]}


def glow_parity():
    """Model Q's first Q_PARITY_STEPS steps of the example (host inputs) on
    the card and on the CPU: the losses within CPU_TOL."""
    from normflows_tpu_torch.examples import glow_image

    args = glow_image.parse([*Q_ARGS, "--iters", str(Q_PARITY_STEPS), "--chunked",
                             "--host-inputs", "--seed", str(SEED)])
    x, y = glow_image.load_data(args)
    x_train, y_train = x[:-glow_image.HELD_OUT], y[:-glow_image.HELD_OUT]
    inputs = glow_image.host_inputs(x_train, y_train, Q_PARITY_STEPS, args.batch, SEED)
    losses = {}
    for where in (DEVICE, "cpu"):
        model = glow_image.build_glow(args.L, args.K, args.hidden, tuple(x.shape[1:]),
                                      args.classes, device=where, seed=SEED)
        model.init_actnorm(*(t.to(where) for t in glow_image.init_inputs(
            x_train, y_train, args.batch, SEED)))
        state, chunk = glow_image.make_chunk(model, args.lr, args.batch, x_train, y_train,
                                             inputs, chunk=Q_PARITY_STEPS)
        losses[where] = chunk(state)[1]["loss"].cpu()
    return {"steps": Q_PARITY_STEPS,
            "excess": excess(losses[DEVICE], losses["cpu"], CPU_TOL, CPU_TOL),
            "max_abs_loss_gap": float((losses[DEVICE] - losses["cpu"]).abs().max()),
            "loss_card_last": float(losses[DEVICE][-1]),
            "loss_cpu_last": float(losses["cpu"][-1])}


def run_example(args):
    """``examples.glow_image.main(args)`` with its printed lines kept."""
    from normflows_tpu_torch.examples import glow_image

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, record = glow_image.main([*args, "--seed", str(SEED), "--device", DEVICE])
    return {**record, "printed": printed.getvalue().splitlines()[:-1]}


def glow_chunk(compute, steps):
    """A fresh model A (the example's init, ActNorm set on its first batch)
    and its chunked trainer of ``steps`` steps a call on the example's
    training images, as ``examples.glow_image --chunked`` builds it."""
    from normflows_tpu_torch.examples import glow_image
    from normflows_tpu_torch.utils import set_compute_dtype

    x, y = glow_image.synthetic_images(8192, seed=SEED)
    x_train, y_train = x[:-glow_image.HELD_OUT], y[:-glow_image.HELD_OUT]
    model = set_compute_dtype(build_glow(DEVICE, random_last=False), compute)
    model.init_actnorm(*(t.to(DEVICE) for t in glow_image.init_inputs(
        x_train, y_train, GLOW_BATCH, SEED)))
    state, chunk = glow_image.make_chunk(model, 1e-3, GLOW_BATCH, x_train, y_train,
                                         chunk=steps)
    return model, state, chunk, (x_train.to(DEVICE), y_train.to(DEVICE))


def phase_glow_train():
    """(a) Model Q: its first steps on the card against the CPU
    (``glow_parity``), then the example as a replay runs it, Q_ITERS chunked
    steps on host-drawn inputs, its held-out bits/dim held to Q_BPD; (b)
    model A in bf16 as a user runs it (``examples.glow_image --chunked
    --bf16 --iters GLOW_TRAIN_ITERS``): finite losses, the mean of the last
    100 below that of the first 100; its held-out bits/dim, ms a step and
    images a second reported; for f32, a profiled chunk of
    GLOW_PROFILED_CHUNK steps of a fresh model (device time a step, busy
    share, the convolutions' share, the heaviest kernels); (c) model A in
    f32: a captured chunk of GLOW_F32_STEPS steps against as many eager
    steps (make_train_step, the same capturable Adamax, windows and
    generator), bit for bit, then a timed chunk."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import glow_image

    r = {"q_parity": glow_parity()}
    if r["q_parity"]["excess"] > 0:
        emit("glow_train", ok=False, results=r)
        raise SystemExit("glow_train: model Q's first steps on the card disagree with the CPU")
    r["q"] = run_example([*Q_ARGS, "--iters", str(Q_ITERS), "--chunked", "--host-inputs"])
    ok = r["q"]["held_out_bits_per_dim"] <= Q_BPD and r["q"]["non_finite_steps"] == 0
    a = run_example(["--chunked", "--bf16", "--iters", str(GLOW_TRAIN_ITERS), "--L",
                     str(GLOW_L), "--K", str(GLOW_K), "--hidden", str(GLOW_HIDDEN), "--batch",
                     str(GLOW_BATCH)])
    a_ok = (a["non_finite_steps"] == 0 and a["loss_mean_last_100"] < a["loss_mean_first_100"]
            and a["samples_finite"])
    r["a_bf16"] = a
    for dtype, compute in (("float32", None),):  # bf16's: PERF.md section 5
        model, state, chunk, _ = glow_chunk(compute, GLOW_PROFILED_CHUNK)
        gen = torch.Generator(DEVICE).manual_seed(SEED + 140)
        chunk(state, gen)
        sync()
        t0 = time.perf_counter()
        chunk(state, gen)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / GLOW_PROFILED_CHUNK
        prof = kernel_shares(lambda: chunk(state, gen))
        r[f"a_{dtype}_profile"] = {**prof, "ms": ms, "device_ms": prof["device_ms"] /
                                   GLOW_PROFILED_CHUNK,
                                   "busy_share": prof["device_ms"] / GLOW_PROFILED_CHUNK / ms}
        del model, state, chunk
    # (c) f32: captured against eager
    model, state, chunk, (xt, yt) = glow_chunk(None, GLOW_F32_STEPS)
    gen = torch.Generator(DEVICE).manual_seed(SEED + 141)
    t0 = time.perf_counter()
    first = chunk(state, gen)[1]["loss"]
    sync()
    first_s = time.perf_counter() - t0
    eager, _, _, _ = glow_chunk(None, GLOW_F32_STEPS)
    opt = glow_image.make_optimizer(eager, 1e-3)
    estate, step = training.make_train_step(
        eager, opt, lambda m, b, g: m.forward_kld(glow_image.dequantise(b[0], g), b[1]))
    egen = torch.Generator(DEVICE).manual_seed(SEED + 141)
    n_train = xt.shape[0]
    eager_losses = []
    for i in range(GLOW_F32_STEPS):
        s = (i * GLOW_BATCH) % (n_train - GLOW_BATCH + 1)
        estate, m = step(estate, (xt[s:s + GLOW_BATCH], yt[s:s + GLOW_BATCH]), egen)
        eager_losses.append(m["loss"])
    c = {"first_call_seconds": first_s,
         "against_eager": against_eager("glow_train", first, torch.stack(eager_losses), model,
                                        eager)}
    # cuDNN's deterministic algorithms (nets.cnn.fp32_convs): bit for bit
    c["against_eager"]["bit_equal_parameters"] = all(
        torch.equal(p, q) for p, q in zip(model.parameters(), eager.parameters()))
    if not (c["against_eager"]["bit_equal_losses"]
            and c["against_eager"]["bit_equal_parameters"]):
        emit("glow_train", ok=False, results={**r, "a_float32": c})
        raise SystemExit("glow_train: model A's f32 captured chunk is not bit-equal to its "
                         "eager steps")
    t0 = time.perf_counter()
    second = chunk(state, gen)[1]["loss"]
    sync()
    c["ms"] = (time.perf_counter() - t0) * 1e3 / GLOW_F32_STEPS
    c["images_per_s"] = GLOW_BATCH / (c["ms"] / 1e3)
    losses = torch.cat([first, second]).cpu()
    c["finite"] = bool(torch.isfinite(losses).all())
    r["a_float32"] = c
    emit("glow_train", ok=ok and a_ok and c["finite"], results=r,
         bars={"q_held_out_bits_per_dim": Q_BPD, "parity_loss": CPU_TOL,
               "against_eager": "bit for bit (losses and parameters), within "
                                f"[{CPU_TOL}, {STEP_G_TOL}] on the way"},
         note="q: model Q (examples/quality_compare.py's GLOW_CFG) through "
         "examples.glow_image --chunked --host-inputs; a_bf16: model A as "
         "examples.glow_image --chunked --bf16 runs it (seconds include the first "
         "chunk's capture; steady_step_ms leaves it out); a_<dtype>_profile: a "
         f"{GLOW_PROFILED_CHUNK}-step chunk after its capture, host ms a step, device ms "
         "a step, busy "
         "share, conv_share of the device time; a_float32: a captured chunk against "
         "as many eager steps, then a timed chunk")
    if not (ok and a_ok and c["finite"]):
        raise SystemExit("glow_train: a Glow run missed its bars")


# ---- residual flows and the small flows (PR 14) ---------------------------------

def build_residual(random_last=True, k=RES_K):
    """Model R (``examples.residual_twomoons.inputs`` at SEED, ``k`` blocks) on the CPU, with
    every net's last layer drawn ~ N(0, 1/in) and its power iteration run
    (``random_last``), ActNorm set from the first batch.  Returns ``(model,
    x_all, x_held_out)``; the card's copy is ``copy.deepcopy(model).to(DEVICE)``."""
    from normflows_tpu_torch import flows
    from normflows_tpu_torch.examples import residual_twomoons as example
    from normflows_tpu_torch.utils import update_lipschitz

    model, x_all, x_held = example.inputs(k, SEED, "cpu", RES_HIDDEN)
    if random_last:
        gen = torch.Generator().manual_seed(SEED + 150)
        with torch.no_grad():
            for flow in model.flows:
                if isinstance(flow, flows.Residual):
                    w = flow.iresblock.nnet.layers[-1].weight
                    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[1]))
        update_lipschitz(model, 50)
    model.init_actnorm(x_all[:RES_BATCH])
    return model, x_all, x_held


def residual_draws(n, seed):
    """Host draws for one training-mode ``log_prob`` of model R on ``n``
    points: each block's geometric(1/2) horizon, then its probe."""
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(RES_K):
        draws.append(rng.geometric(0.5, size=1).astype(np.float32))
        draws.append(rng.normal(size=(n, 2)).astype(np.float32))
    return draws


@contextlib.contextmanager
def fed_draws(draws):
    """``flows.residual``'s draws taken from ``draws``, in order, on the
    device and in the dtype asked for, for the block."""
    from normflows_tpu_torch.flows import residual

    queue = list(draws)
    kept = residual.draw_horizon, residual.draw_probe
    residual.draw_horizon = lambda g, n_dist, p, lamb, n, device: torch.as_tensor(
        queue.pop(0), device=device)
    residual.draw_probe = lambda g, shape, dtype, device: torch.as_tensor(
        queue.pop(0), dtype=dtype, device=device)
    try:
        yield queue
    finally:
        residual.draw_horizon, residual.draw_probe = kept


def residual_log_probs(models, x, train, draws=None):
    """``log_prob(x)`` of each model (by device; training mode on ``draws``,
    or eval mode), on the CPU."""
    from normflows_tpu_torch.examples.residual_twomoons import set_train

    out = {}
    for where, model in models.items():
        set_train(model, train)
        with torch.no_grad(), (fed_draws(draws) if train else contextlib.nullcontext()):
            out[where] = model.log_prob(x.to(where), generator=torch.Generator()).cpu()
        set_train(model, True)
    return out


def build_lipschitz_cnn(device="cpu"):
    from normflows_tpu_torch.nets import LipschitzCNN

    return LipschitzCNN([3, 32, 32, 3], [3, 1, 3], (16, 16), lipschitz_const=0.9, init_zeros=False,
                        generator=torch.Generator().manual_seed(SEED + 153), device=device)


def lipschitz_cnn_readings(net, x):
    """The net's output at ``x``, then, after its weights moved x1.5 and one
    ``update_lipschitz(net, 50)``, its u, v, scale and output again."""
    from normflows_tpu_torch.utils import update_lipschitz

    with torch.no_grad():
        out = {"y": net(x)}
        for p in net.parameters():
            if p.dim() == 4:
                p.mul_(1.5)
        update_lipschitz(net, 50)
        out["y_updated"] = net(x)
    for name, b in net.named_buffers():
        out[name] = b
    return {k: v.detach().cpu() for k, v in out.items()}


def phase_residual_path():
    """Model R at full width, f32: (a) its training-mode ``log_prob`` at
    RES_CPU held-out points on host-drawn horizons and probes, and (b) its
    eval-mode ``log_prob`` (brute-force 2-D log-dets), each the card against
    the CPU; (c) in eval mode, ``sample`` of RES_CPU draws (each block's fixed
    point iterated on the card, its test read once a block of steps) against
    ``log_prob`` of the draws, and the round trip; (d) one forward-KL
    gradient at RES_MEM_BATCH points with ``reduce_memory`` (the
    rematerialised Neumann estimator) against the same estimator without it:
    values, gradients and the peak device memory of each; (e) a LipschitzCNN
    at 3 x 16 x 16, its forward and one update_lipschitz, the card against
    the CPU in IEEE float32.  No kernel of the port runs on these paths: the
    device counters must read 0."""
    from normflows_tpu_torch.examples.residual_twomoons import set_train

    cpu, x_all, x_held = build_residual()
    card = copy.deepcopy(cpu).to(DEVICE)
    models = {DEVICE: card, "cpu": cpu}
    x = x_held[:RES_CPU]
    r, ok = {}, True
    with device_counters() as counts:
        def checks():
            got = {}
            lp = residual_log_probs(models, x, True, residual_draws(RES_CPU, SEED + 151))
            got["train_mode"] = {"excess": excess(lp[DEVICE], lp["cpu"], RES_TRAIN_TOL,
                                                  RES_TRAIN_TOL),
                                 "max_abs": float((lp[DEVICE] - lp["cpu"]).abs().max())}
            lp = residual_log_probs(models, x, False)
            got["eval_mode"] = {"excess": excess(lp[DEVICE], lp["cpu"], RES_EVAL_TOL,
                                                 RES_EVAL_TOL),
                                "max_abs": float((lp[DEVICE] - lp["cpu"]).abs().max()),
                                "mean_log_q": float(lp[DEVICE].mean())}
            set_train(card, False)
            gen = torch.Generator(DEVICE).manual_seed(SEED + 152)
            with torch.no_grad():
                sync()
                t0 = time.perf_counter()
                z0 = torch.randn(RES_CPU, 2, generator=gen, device=DEVICE)
                xs, ld = card.forward_and_log_det(z0)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                blocks = [f.iresblock.last_inverse for f in card.flows
                          if hasattr(f, "iresblock")]
                z_back, ld_back = card.inverse_and_log_det(xs)
                log_q = card.q0.log_prob(z0) - ld
                lp_x = card.log_prob(xs)
            set_train(card, True)
            got["round_trip"] = {
                "max_abs_z": float((z_back - z0).abs().max()),
                "max_abs_log_det": float((ld + ld_back).abs().max()),
                "median_abs_log_q": float((lp_x - log_q).abs().median()),
                "sample_ms": ms,
                "fixed_point_steps": [int(b["steps"]) for b in blocks],
                "fixed_point_host_reads": [b["host_reads"] for b in blocks]}
            got["round_trip"]["ok"] = (got["round_trip"]["max_abs_z"] <= RES_RT_TOL
                                       and got["round_trip"]["median_abs_log_q"] <= RES_RT_TOL)
            return got

        checked, launched = on_card(counts, checks)
        r.update(checked)
        r["launches"] = expect_launches("residual_path", launched, {})
    ok = (r["train_mode"]["excess"] <= 0 and r["eval_mode"]["excess"] <= 0
          and r["round_trip"]["ok"])
    # (d) reduce_memory against none, peak memory at RES_MEM_BATCH
    mem, grads = {}, {}
    xb = x_all[:RES_MEM_BATCH].to(DEVICE)
    for name, remat in (("reduce_memory", True), ("no_remat", False)):
        model = copy.deepcopy(card)
        for f in model.flows:
            if hasattr(f, "iresblock"):
                f.iresblock.grad_in_forward = remat
        gen = torch.Generator(DEVICE).manual_seed(SEED + 154)
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss = model.forward_kld(xb, generator=gen)
        loss.backward()
        sync()
        mem[name] = {"peak_bytes_above_start": torch.cuda.max_memory_allocated() - before,
                     "seconds": time.perf_counter() - t0, "loss": float(loss)}
        grads[name] = ({n: p.grad.detach().clone() for n, p in model.named_parameters()}, loss)
        del model, loss
    worst, gap = leaf_gap(grads["reduce_memory"][0], grads["no_remat"][0])
    mem["loss_equal"] = bool(torch.equal(grads["reduce_memory"][1], grads["no_remat"][1]))
    mem["worst_leaf"], mem["worst_relative_norm"] = worst, gap
    r["reduce_memory"] = mem
    ok = ok and mem["loss_equal"] and gap <= 1e-5
    # (e) LipschitzCNN
    net = build_lipschitz_cnn()
    net_card = copy.deepcopy(net).to(DEVICE)
    xi = torch.from_numpy(np.random.default_rng(SEED + 155).normal(
        size=(8, 3, 16, 16)).astype(np.float32))
    got = lipschitz_cnn_readings(net_card, xi.to(DEVICE))
    want = lipschitz_cnn_readings(net, xi)
    r["lipschitz_cnn"] = {k: excess(got[k], want[k], CNN_TOL, CNN_TOL) for k in got}
    ok = ok and all(v <= 0 for v in r["lipschitz_cnn"].values())
    emit("residual_path", ok=ok, results=r,
         bars={"train_mode": RES_TRAIN_TOL, "eval_mode": RES_EVAL_TOL, "round_trip": RES_RT_TOL,
               "reduce_memory_leaf": 1e-5, "lipschitz_cnn": CNN_TOL})
    if not ok:
        raise SystemExit("residual_path: a residual-flow check missed its bar")
    return launched


def residual_chunk(steps, seed):
    """Model R from the example's init (ActNorm set on its first batch) and its
    chunked trainer as ``examples.residual_twomoons`` builds it, ``steps``
    steps a call; returns ``(model, state, chunk, x_all)``."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import residual_twomoons as example

    model, x_all, _ = build_residual(random_last=False)
    model = model.to(DEVICE)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-5, capturable=True)
    state, chunk = training.make_chunked_train_step(
        model, opt, example.forward_kld_loss, x_all, RES_BATCH, steps, shuffle=False,
        update_lipschitz_iters=example.LIPSCHITZ_ITERS)
    return model, state, chunk, x_all


def phase_residual_train():
    """(a) ``examples.residual_twomoons`` as a user runs it on the card
    (RES_ITERS steps in chunks of RES_CHUNK, the power iteration inside the
    captured step): finite losses, the held-out mean log q at least
    RES_LOG_Q; the count of block calls whose horizon exceeded the cap in the
    captured steps (``flows.residual.CAPPED``); no kernel of the port; (b) a
    profiled chunk of RES_PROFILED_CHUNK steps: ms, device ms and kernels a
    step, the busy share (the kernels of a step by part are in PERF.md
    section 5, no longer read each run); (c) a
    captured chunk of RES_EAGER_STEPS steps against as many eager steps
    (``make_train_step`` with ``update_lipschitz_iters=50``, the same
    capturable AdamW, windows and generator seed)."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import residual_twomoons as example
    from normflows_tpu_torch.flows import residual

    r = {}
    capped = torch.zeros((), dtype=torch.int64, device=DEVICE)
    residual.CAPPED = capped
    printed = io.StringIO()
    try:
        with device_counters() as counts, contextlib.redirect_stdout(printed):
            (_, record), launched = on_card(counts, lambda: example.main(
                ["--iters", str(RES_ITERS), "--chunk", str(RES_CHUNK), "--seed", str(SEED),
                 "--device", DEVICE]))
        r["launches"] = expect_launches("residual_train", launched, {})
    finally:
        residual.CAPPED = None
    r["run"] = {**record, "printed": printed.getvalue().splitlines()[:-1]}
    r["capped_block_calls"] = int(capped)
    ok = (record["non_finite_steps"] == 0 and record["held_out_log_q"] >= RES_LOG_Q
          and record["samples_finite"])
    # (b) a profiled chunk
    model, state, chunk, _ = residual_chunk(RES_PROFILED_CHUNK, SEED)
    gen = torch.Generator(DEVICE).manual_seed(SEED + 160)
    chunk(state, gen)
    sync()
    t0 = time.perf_counter()
    chunk(state, gen)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / RES_PROFILED_CHUNK
    prof = kernel_shares(lambda: chunk(state, gen))
    prof.pop("conv_share")  # no convolution here (cuBLAS's xmma GEMMs match its names)
    r["profile"] = {**prof, "launches_a_step": prof["kernel_launches"] / RES_PROFILED_CHUNK,
                    "ms": ms, "device_ms": prof["device_ms"] / RES_PROFILED_CHUNK,
                    "busy_share": prof["device_ms"] / RES_PROFILED_CHUNK / ms,
                    "samples_per_s": RES_BATCH / (ms / 1e3)}
    del model, state, chunk
    # (c) captured against eager
    model, state, chunk, x_all = residual_chunk(RES_EAGER_STEPS, SEED)
    first = chunk(state, torch.Generator(DEVICE).manual_seed(SEED + 163))[1]["loss"]
    eager, _, _, _ = residual_chunk(RES_EAGER_STEPS, SEED)
    opt = torch.optim.AdamW(eager.parameters(), lr=3e-4, weight_decay=1e-5, capturable=True)
    estate, step = training.make_train_step(eager, opt, example.forward_kld_loss,
                                            update_lipschitz_iters=example.LIPSCHITZ_ITERS)
    egen = torch.Generator(DEVICE).manual_seed(SEED + 163)
    xd = x_all.to(DEVICE)
    n = xd.shape[0]
    eager_losses = []
    for i in range(RES_EAGER_STEPS):
        s = (i * RES_BATCH) % (n - RES_BATCH + 1)
        estate, m = step(estate, xd[s:s + RES_BATCH], egen)
        eager_losses.append(m["loss"])
    r["against_eager"] = against_eager("residual_train", first, torch.stack(eager_losses),
                                       model, eager)
    r["against_eager"]["bit_equal_parameters"] = all(
        torch.equal(p, q) for p, q in zip(model.parameters(), eager.parameters()))
    emit("residual_train", ok=ok, results=r,
         bars={"held_out_log_q_at_least": RES_LOG_Q, "against_eager": [CPU_TOL, STEP_G_TOL]},
         note="run: examples.residual_twomoons as a user runs it (seconds include the "
         "first chunk's capture; steady_step_ms leaves it out); profile: a "
         f"{RES_PROFILED_CHUNK}-step chunk after its capture; capped_block_calls: block "
         "calls of the captured steps whose horizon exceeded the cap (n_power_series_max)")
    if not ok:
        raise SystemExit("residual_train: model R missed its bar")
    return launched


def phase_small_flows():
    """Model P (planar and radial, K = P_K, on TwoModes): (a) each model's first
    P_PARITY_STEPS reverse-KL steps on host-drawn base noise, the card against
    the CPU; (b) ``examples.planar_radial_comparison`` as a user runs it,
    P_ITERS chunked steps a model: finite losses and the reverse KL on 4,096
    fresh draws at most P_KLD; no kernel of the port."""
    from normflows_tpu_torch.examples import planar_radial_comparison as example

    r, ok = {"parity": {}}, True
    for kind in ("planar", "radial"):
        losses = {}
        for where in (DEVICE, "cpu"):
            model = example.build_model(kind, "TwoModes", P_K, SEED, where)
            state, chunk = example.make_trainer(model, P_PARITY_STEPS,
                                                example.host_noise(P_PARITY_STEPS, SEED + 1))
            losses[where] = chunk(state)[1]["loss"].cpu()
        gap = (losses[DEVICE] - losses["cpu"]).abs()
        r["parity"][kind] = {"excess": excess(losses[DEVICE], losses["cpu"], CPU_TOL, CPU_TOL),
                             "max_abs_loss_gap": float(gap.max()),
                             "loss_card_last": float(losses[DEVICE][-1])}
        ok = ok and r["parity"][kind]["excess"] <= 0
    printed = io.StringIO()
    with device_counters() as counts, contextlib.redirect_stdout(printed):
        record, launched = on_card(counts, lambda: example.main(
            ["--prior", "TwoModes", "--kind", "planar", "radial", "--iters", str(P_ITERS),
             "--chunk", str(P_CHUNK), "--k", str(P_K), "--seed", str(SEED), "--device",
             DEVICE]))
    r["launches"] = expect_launches("small_flows", launched, {})
    r["run"] = {**record, "printed": printed.getvalue().splitlines()[:-1]}
    for run in record["runs"]:
        run["within_bar"] = (run["non_finite_steps"] == 0
                             and run["eval_reverse_kld"] <= P_KLD[run["kind"]])
        ok = ok and run["within_bar"]
    emit("small_flows", ok=ok, results=r, bars={"eval_reverse_kld_at_most": P_KLD,
                                                "parity_loss": CPU_TOL})
    if not ok:
        raise SystemExit("small_flows: a small-flow run missed its bar")
    return launched


# ---- stochastic flows, HAIS, the flow-VAE and the new bases ----------------
#
# Bars set on the CPU before any card run (float32 against float64 on the
# same inputs and draws, ``stochastic_values`` / ``snf_hmc_grads`` with
# DEVICE "cpu"; the measured gaps in PERF.md).  No kernel of the port
# runs on these paths: the device counters must read 0.
ST_N, ST_HAIS_CHAINS, ST_HAIS_BETAS = 1024, 64, 7  # 7 betas: 5 rungs
# float32 against float64 on the CPU, the largest |gap| of each reading of
# stochastic_values (before any card run); the bar, card against CPU,
# is 10x it (atol; rtol 0).  No chain's accept decision differed.
ST_F64_GAP = {"mh_z": 4.122e-07, "mh_log_det": 3.924e-05, "hmc_z": 2.003e-05,
              "hmc_log_det": 2.981e-04, "hais_z": 1.675e-06, "hais_log_w": 6.691e-06,
              "snf_z": 6.645e-07, "snf_log_q": 1.920e-05, "mixture_z": 1.816e-07,
              "mixture_from_noise": 1.305e-06, "mixture_log_prob": 6.467e-05,
              "pca_z": 4.110e-07, "pca_from_noise": 1.191e-06, "pca_log_prob": 1.371e-05,
              "affine_z": 6.326e-07, "affine_from_noise": 1.710e-06,
              "affine_log_prob": 2.562e-06}
ST_TOL = {k: (10 * v, 0.0) for k, v in ST_F64_GAP.items()}
# HAIS at the example's size (4,096 chains, 30 rungs of 10 leapfrog steps):
# TwoMoons' log normaliser by quadrature (snf_hais.two_moons_log_z, a 0.002
# grid over [-5, 5]^2; a 0.004 grid agrees to 1e-15); |log Z - LOG_Z| must be
# at most max(0.02, 4 SE), SE = std(w) / (mean(w) sqrt(n)).
LOG_Z = 0.804214
HAIS_REPS = 1  # timed samples of each route (2 before PR 18)
SNF_CHUNK, SNF_LR = 20, 1e-3  # reverse KL on the example's 1,024 draws a step
VAE_PARITY_STEPS = 50
# held-out -ELBO bars: the JAX package on the port example's initial weights
# and host-drawn inputs, seeds 0-2 (tests/test_torch_vae.py run as a script,
# before any card run): median + max(1% of |median|, spread)
# K = 10: 293.3150330, 293.4559937, 293.1141357; K = 0: 292.2012329,
# 292.9387207, 293.4273376
VAE_NEG_ELBO = {10: 293.3150329589844 + max(0.01 * 293.3150329589844,
                                            293.45599365234375 - 293.1141357421875),
                0: 292.938720703125 + max(0.01 * 292.938720703125,
                                          293.4273376464844 - 292.20123291015625)}
# The example's first VAE_PARITY_STEPS steps, float32 against float64 on the
# CPU: the losses (~540-600 nats) within 2.19e-5 of each other, relative; the
# bar, card against CPU, is 10x it
VAE_REL = 10 * 2.187e-5
# held-out NLL bars: the same for change_base (tests/test_torch_bases.py):
# median + max(0.05, spread)
# gaussian: 1.5697944, 1.5788121, 1.5848802 (seeds 0-2); mixture: 1.5615989,
# 1.5735973, 1.5825592 (the example offsets the mixture's seed by 1: 1-3)
# The example's first CB_PARITY_STEPS steps on host inputs, the card against
# the CPU: the port's standing bar, CPU_TOL (absolute), as small_flows and
# glow_train hold theirs.  (Float32 against float64 on the CPU differ by
# 3.5e-7 / 5.2e-7 over these steps, but the card's capturable Adam rounds its
# bias corrections on the device, which that reading does not exercise.)
CB_PARITY_STEPS = 20
CB_NLL = {"gaussian": 1.5788121223449707 + max(0.05, 1.5848802328109741 - 1.5697944164276123),
          "mixture": 1.5735973119735718 + max(0.05, 1.5825592279434204 - 1.5615988969802856)}


def mcmc_noise(rng, layer, n, dtype=np.float32):
    """Host draws of one MCMC layer's noise on ``n`` chains: MH's (eps, w) of
    (steps, n, 2) and (steps, n), HMC's (p_eps, u)."""
    if hasattr(layer, "proposal"):
        return (rng.normal(size=(layer.steps, n, 2)).astype(dtype),
                rng.uniform(size=(layer.steps, n)).astype(dtype))
    return rng.normal(size=(n, 2)).astype(dtype), rng.uniform(size=n).astype(dtype)


def noise_on(noise, device, dtype):
    return tuple(torch.from_numpy(a).to(device, dtype) for a in noise)


def snf_through(model, eps, noises):
    """The SNF's ``sample`` on given draws: the base's ``eps`` through every
    flow, each MCMC layer on its noise; ``(z, log_q)``."""
    from normflows_tpu_torch.flows.stochastic import mcmc_layers

    z, log_q = model.q0.from_noise(eps)
    mcmc = mcmc_layers(model.flows)
    for flow in model.flows:
        z, ld = flow(z, noise=noises[mcmc.index(flow)]) if flow in mcmc else flow(z)
        log_q = log_q - ld
    return z, log_q


def build_stochastic(mcmc="mh", target=None):
    """The example's SNF on the CPU (``mcmc`` "hmc": its HMC variant), each
    coupling net's last layer drawn ~ N(0, 0.3^2 / 64) so that the couplings
    do work."""
    from normflows_tpu_torch.examples import snf_hais

    model = snf_hais.build_snf("cpu", SEED, mcmc, target)
    gen = torch.Generator().manual_seed(SEED + 170)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "linears"):
                w = m.linears[-1].weight
                w.copy_(0.3 / math.sqrt(w.shape[1]) * torch.randn(w.shape, generator=gen))
    return model


def stochastic_models():
    """Every model of the values' checks, on the CPU in float32."""
    from normflows_tpu_torch import distributions as D, flows
    from normflows_tpu_torch.examples import change_base, snf_hais

    gen = torch.Generator().manual_seed(SEED + 171)
    affine = D.AffineGaussian((2, 3), (2, 3), 4, device="cpu")
    with torch.no_grad():
        for p in affine.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return {
        "mh": flows.MetropolisHastings(D.TwoMoons(device="cpu"),
                                       D.DiagGaussianProposal((2,), 0.3, device="cpu"), 5),
        "hmc": flows.HamiltonianMonteCarlo(D.TwoMoons(device="cpu"), 10,
                                           np.full(2, math.log(0.2)), np.zeros(2),
                                           device="cpu"),
        "hais": snf_hais.build_hais("cpu", ST_HAIS_BETAS),
        "snf": build_stochastic(),
        "mixture": change_base.build_base("mixture", "cpu"),
        "pca": D.GaussianPCA(3, 2, sigma=0.3, generator=gen, device="cpu"),
        "affine": affine,
    }


def stochastic_values(device, dtype, seed=SEED + 172):
    """Each model of :func:`stochastic_models` on ``device`` in ``dtype`` on
    host-drawn inputs and draws: MH and HMC (ST_N chains from N(0, 1.5^2)),
    HAIS (ST_HAIS_CHAINS chains), the SNF's draws (ST_N), each base's
    ``from_noise`` and ``log_prob``.  Returns float64 CPU tensors."""
    from normflows_tpu_torch.flows.stochastic import mcmc_layers

    rng = np.random.default_rng(seed)
    models = {k: m.to(device, dtype) for k, m in stochastic_models().items()}
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)  # noqa: E731
    out = {}
    with torch.no_grad():
        z = dev(1.5 * rng.normal(size=(ST_N, 2)))
        for name in ("mh", "hmc"):
            out[f"{name}_z"], out[f"{name}_log_det"] = models[name](
                z, noise=noise_on(mcmc_noise(rng, models[name], ST_N), device, dtype))
        hais = models["hais"]
        out["hais_z"], out["hais_log_w"] = hais.from_noise(
            dev(rng.normal(size=(ST_HAIS_CHAINS, 2))),
            [noise_on(mcmc_noise(rng, layer, ST_HAIS_CHAINS), device, dtype)
             for layer in hais.layers])
        snf = models["snf"]
        out["snf_z"], out["snf_log_q"] = snf_through(
            snf, dev(rng.normal(size=(ST_N, 2))),
            [noise_on(mcmc_noise(rng, layer, ST_N), device, dtype) for layer in mcmc_layers(snf)])
        mix = models["mixture"]
        eps = np.concatenate([rng.uniform(size=(ST_N, 1)), rng.normal(size=(ST_N, 2))], 1)
        out["mixture_z"], out["mixture_from_noise"] = mix.from_noise(dev(eps))
        out["mixture_log_prob"] = mix.log_prob(dev(3.0 * rng.normal(size=(ST_N, 2))))
        pca = models["pca"]
        out["pca_z"], out["pca_from_noise"] = pca.from_noise(dev(rng.normal(size=(ST_N, 2))))
        out["pca_log_prob"] = pca.log_prob(dev(rng.normal(size=(ST_N, 3))))
        aff = models["affine"]
        y = torch.from_numpy(rng.integers(0, 4, ST_N)).to(device)
        out["affine_z"], out["affine_from_noise"] = aff.from_noise(
            dev(rng.normal(size=(ST_N, 2, 3))), y)
        out["affine_log_prob"] = aff.log_prob(dev(rng.normal(size=(ST_N, 2, 3))), y)
    return {k: v.double().cpu() for k, v in out.items()}


def snf_hmc_grads(device, dtype, seed=SEED + 173):
    """The HMC SNF's reverse-KL loss on host-drawn draws (ST_N chains) with a
    trainable DiagGaussian target (loc, log_scale drawn): its value and
    every leaf's gradient (HMC's log_step_size and log_mass, the couplings'
    weights, the target's), float64 on the CPU."""
    from normflows_tpu_torch import distributions as D
    from normflows_tpu_torch.flows.stochastic import mcmc_layers

    rng = np.random.default_rng(seed)
    target = D.DiagGaussian(2, device="cpu")
    with torch.no_grad():
        target.loc.copy_(torch.from_numpy(0.5 * rng.normal(size=(1, 2))))
        target.log_scale.copy_(torch.from_numpy(0.2 * rng.normal(size=(1, 2))))
    model = build_stochastic("hmc", target).to(device, dtype)
    eps = torch.from_numpy(rng.normal(size=(ST_N, 2))).to(device, dtype)
    noises = [noise_on(mcmc_noise(rng, layer, ST_N), device, dtype) for layer in mcmc_layers(model)]
    z, log_q = snf_through(model, eps, noises)
    loss = torch.mean(log_q) - torch.mean(model.p.log_prob(z))
    loss.backward()
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def stationarity():
    """The JAX package's statistical checks on the card: 512 chains from an
    offset start under MH (200 steps, scale 1) and HMC (50 moves of 5
    leapfrog steps of 0.4) toward N(0, I): |mean| and |std - 1|."""
    from normflows_tpu_torch import distributions as D, flows

    target = D.DiagGaussian(2, device=DEVICE)
    gen = torch.Generator(DEVICE).manual_seed(SEED + 174)
    mh = flows.MetropolisHastings(target, D.DiagGaussianProposal((2,), 1.0, device=DEVICE), 200)
    hmc = flows.HamiltonianMonteCarlo(target, 5, np.full(2, math.log(0.4)), np.zeros(2),
                                      device=DEVICE)
    out = {}
    with torch.no_grad():
        z, _ = mh(5.0 + torch.randn(512, 2, generator=gen, device=DEVICE), generator=gen)
        out["mh"] = z
        z = 4.0 + torch.randn(512, 2, generator=gen, device=DEVICE)
        for _ in range(50):
            z, _ = hmc(z, generator=gen)
        out["hmc"] = z
    return {k: {"abs_mean": abs(float(z.mean())), "abs_std_gap": abs(float(z.std()) - 1.0)}
            for k, z in out.items()}


def phase_stochastic_path():
    """(a) MH, HMC, HAIS (5 rungs), the example's SNF (random coupling
    weights) and the three new bases on host-drawn inputs and draws, the
    card against the CPU within ST_TOL; (b) the HMC SNF's reverse-KL
    gradients (HMC's step size and mass, the couplings, a trainable target),
    the card against the CPU within G_TOL of each leaf's norm; (c) MH and
    HMC stationarity on the card; no kernel of the port."""
    r = {}
    with device_counters() as counts:
        def checks():
            card, cpu = stochastic_values(DEVICE, torch.float32), stochastic_values("cpu",
                                                                                  torch.float32)
            values = {k: {"excess": excess(card[k], cpu[k], *ST_TOL[k]),
                          "max_abs": float((card[k] - cpu[k]).abs().max())} for k in cpu}
            (loss_card, g_card), (loss_cpu, g_cpu) = (snf_hmc_grads(DEVICE, torch.float32),
                                                      snf_hmc_grads("cpu", torch.float32))
            return values, (loss_card, loss_cpu, relative_norms(g_card, g_cpu)), stationarity()

        (values, (loss_card, loss_cpu, gaps), stat), launched = on_card(counts, checks)
    r["launches"] = expect_launches("stochastic_path", launched, {})
    r["values"] = values
    r["gradients"] = {"loss_card": loss_card, "loss_cpu": loss_cpu, "relative_norms": gaps,
                      "worst": max(gaps.values())}
    r["stationarity"] = stat
    ok = (all(v["excess"] <= 0 for v in values.values()) and r["gradients"]["worst"] <= G_TOL
          and abs(loss_card - loss_cpu) <= CPU_TOL * (1 + abs(loss_cpu))
          and all(s["abs_mean"] < 0.15 and s["abs_std_gap"] < 0.1 for s in stat.values()))
    emit("stochastic_path", ok=ok, results=r,
         bars={"values": ST_TOL, "gradients": G_TOL, "loss": CPU_TOL,
               "stationarity": {"abs_mean": 0.15, "abs_std_gap": 0.1}})
    if not ok:
        raise SystemExit("stochastic_path: a check missed its bar")
    return launched


def phase_hais():
    """``examples.snf_hais`` as a user runs it (4,096 chains, 30 rungs):
    log Z, eager and captured, against the quadrature within max(0.02,
    4 SE); the ESS; host ms of one sample, eager and captured (its device
    time and kernels: the served HAIS of phase serving_stochastic)."""
    from normflows_tpu_torch.examples import snf_hais

    quad = snf_hais.two_moons_log_z()
    printed = io.StringIO()
    with device_counters() as counts, contextlib.redirect_stdout(printed):
        record, launched = on_card(counts, lambda: snf_hais.main(
            ["--seed", str(SEED), "--device", DEVICE, "--reps", str(HAIS_REPS)]))
    r = {"launches": expect_launches("hais", launched, {}), "quadrature_log_z": quad,
         "run": {**record, "printed": printed.getvalue().splitlines()[:-1]}}
    h = record["hais"]
    r["within"] = {}
    for name, est in (("eager", h), ("captured", h["captured"])):
        bar = max(0.02, 4 * est["log_z_se"])
        r["within"][name] = {"gap": abs(est["log_z"] - LOG_Z), "bar": bar,
                             "ok": abs(est["log_z"] - LOG_Z) <= bar and est["finite_weights"]}
    ok = (abs(quad - LOG_Z) < 1e-6 and all(v["ok"] for v in r["within"].values())
          and record["snf"]["finite"])
    emit("hais", ok=ok, results=r, bars={"log_z": LOG_Z, "log_z_gap_at_most": "max(0.02, 4 SE)"},
         note="eager_ms / captured_ms: host median of HAIS_REPS samples, each ending in a "
         "synchronise; the JAX package's figure for this ladder is in PERF.md (a CPU run)")
    if not ok:
        raise SystemExit("hais: log Z missed the quadrature")
    return launched


def phase_snf_train():
    """The SNF's reverse-KL step (the example's 1,024 draws, Adam(SNF_LR)
    capturable) in a captured chunk of SNF_CHUNK steps, MH and HMC (3
    leapfrog steps, learnable step size and mass: the double backward inside
    the graph): bit-equal to as many eager steps from the same weights and
    generator seed; ms, device ms and kernels a step; no kernel of the port."""
    from normflows_tpu_torch import training
    from normflows_tpu_torch.examples import snf_hais

    def loss_fn(model, batch, gen):
        return model.reverse_kld(ST_N, generator=gen)

    def build(mcmc):
        model = snf_hais.build_snf(DEVICE, SEED, mcmc)
        return model, torch.optim.Adam(model.parameters(), lr=SNF_LR,
                                       capturable=torch.device(DEVICE).type == "cuda")

    r, ok = {}, True
    with device_counters() as counts:
        def run():
            out = {}
            for mcmc in ("mh", "hmc"):
                model, opt = build(mcmc)
                state, chunk = training.make_step_chunk(model, opt, loss_fn, SNF_CHUNK)
                gen = torch.Generator(DEVICE).manual_seed(SEED + 176)
                losses = chunk(state, gen)[1]["loss"]
                eager, eopt = build(mcmc)
                estate, step = training.make_train_step(eager, eopt, loss_fn)
                egen = torch.Generator(DEVICE).manual_seed(SEED + 176)
                eager_losses = torch.stack([step(estate, None, egen)[1]["loss"]
                                            for _ in range(SNF_CHUNK)])
                e = {"bit_equal_losses": bool(torch.equal(losses, eager_losses)),
                     "bit_equal_parameters": all(torch.equal(p, q) for p, q in zip(
                         model.parameters(), eager.parameters())),
                     "max_abs_loss": float((losses - eager_losses).abs().max()),
                     "first": float(losses[0]), "last": float(losses[-1]),
                     "finite": bool(torch.isfinite(losses).all())}
                sync()
                t0 = time.perf_counter()
                chunk(state, gen)
                sync()
                e["profile"] = profiled_step(*training.make_step_chunk(*build(mcmc), loss_fn, 1),
                                             (time.perf_counter() - t0) * 1e3 / SNF_CHUNK)
                out[mcmc] = e
            return out

        r["variants"], launched = on_card(counts, run)
    r["launches"] = expect_launches("snf_train", launched, {})
    for e in r["variants"].values():
        ok = ok and e["bit_equal_losses"] and e["bit_equal_parameters"] and e["finite"]
    emit("snf_train", ok=ok, results=r, bars={"against_eager": "bit-equal"},
         note=f"profile: ms a step of a {SNF_CHUNK}-step chunk after its capture; device ms "
         "and kernels of one replayed step (a 1-step chunk of the same model)")
    if not ok:
        raise SystemExit("snf_train: a captured SNF chunk differs from its eager steps")
    return launched


def profiled_step(state, chunk, ms):
    """A 1-step chunk, captured at its first call, then one replay under
    torch.profiler: its kernels and device ms, and the busy share of ``ms``
    (a step's host time in a longer chunk, measured elsewhere)."""
    gen = torch.Generator(DEVICE).manual_seed(SEED + 177)
    chunk(state, gen)
    prof = kernel_shares(lambda: chunk(state, gen))
    prof.pop("conv_share")
    return {**prof, "ms": ms, "kernels_a_step": prof["kernel_launches"],
            "busy_share": prof["device_ms"] / ms}


def vae_parity():
    """The flow-VAE example's first VAE_PARITY_STEPS steps on host-drawn rows
    and encoder noise, the card against the CPU: the losses' largest
    relative gap."""
    from normflows_tpu_torch.examples import vae_flow

    x_all = torch.from_numpy(vae_flow.synthetic_digits(vae_flow.N_DIGITS, SEED))
    x_train = x_all[:-vae_flow.HELD_OUT]
    inputs = vae_flow.host_inputs(x_train, VAE_PARITY_STEPS, 256, 40, SEED + 1)
    losses = {}
    for where in (DEVICE, "cpu"):
        model = vae_flow.build_vae(784, 40, 10, SEED, where)
        state, chunk = vae_flow.make_trainer(model, x_train, 256, 1e-3, VAE_PARITY_STEPS,
                                             inputs)
        losses[where] = chunk(state)[1]["loss"].double().cpu()
    gap = ((losses[DEVICE] - losses["cpu"]).abs() / losses["cpu"].abs()).max()
    return {"steps": VAE_PARITY_STEPS, "max_relative_loss_gap": float(gap),
            "loss_card_last": float(losses[DEVICE][-1]), "loss_cpu_last": float(losses["cpu"][-1])}


def phase_vae_train():
    """(a) The flow-VAE's first VAE_PARITY_STEPS steps, the card against the
    CPU within VAE_REL of the loss; (b) ``examples.vae_flow`` (K = 10) and
    ``examples.plain_vae`` (K = 0) as a user runs them, 960 chunked steps
    each: held-out -ELBO within VAE_NEG_ELBO; ms a step, samples/s and a
    profiled epoch's kernels and busy share; no kernel of the port."""
    from normflows_tpu_torch.examples import plain_vae, vae_flow

    r = {"parity": vae_parity()}
    ok = r["parity"]["max_relative_loss_gap"] <= VAE_REL
    r["runs"] = {}
    launched_all = {}
    for k, example in ((10, vae_flow), (0, plain_vae)):
        printed = io.StringIO()
        with device_counters() as counts, contextlib.redirect_stdout(printed):
            (model, record), launched = on_card(counts, lambda: example.main(
                ["--seed", str(SEED), "--device", DEVICE]))
        expect_launches("vae_train", launched, {})
        launched_all = launched
        record["printed"] = printed.getvalue().splitlines()[:-1]
        record["within_bar"] = (record["non_finite_steps"] == 0
                                and record["held_out_neg_elbo"] <= VAE_NEG_ELBO[k])
        ok = ok and record["within_bar"]
        # one profiled step of a fresh trainer (after its capture)
        x = torch.from_numpy(vae_flow.synthetic_digits(vae_flow.N_DIGITS, SEED))
        state, chunk = vae_flow.make_trainer(vae_flow.build_vae(784, 40, k, SEED, DEVICE),
                                             x[:-vae_flow.HELD_OUT], 256, 1e-3, 1)
        record["profile"] = profiled_step(state, chunk, record["steady_step_ms"])
        r["runs"][f"k{k}"] = record
    emit("vae_train", ok=ok, results=r, bars={"held_out_neg_elbo_at_most": VAE_NEG_ELBO,
                                              "parity_relative_loss": VAE_REL})
    if not ok:
        raise SystemExit("vae_train: a VAE missed its bar")
    return launched_all


def change_base_parity():
    """Each base's first CB_PARITY_STEPS steps of ``examples.change_base
    --host-inputs`` on the card and on the CPU: the losses' largest gap."""
    from normflows_tpu_torch.examples import change_base

    out = {}
    for index, base in enumerate(change_base.BASES):
        seed = SEED + index
        x_train = change_base.draws(change_base.N_TRAIN, 100 + seed, "cpu")
        batches = change_base.host_batches(x_train, CB_PARITY_STEPS, seed)
        losses = {}
        for where in (DEVICE, "cpu"):
            model = change_base.build_model(base, seed, where)
            state, chunk = change_base.make_trainer(model, x_train, CB_PARITY_STEPS, batches)
            losses[where] = chunk(state)[1]["loss"].cpu()
        out[base] = {"max_abs_loss_gap": float((losses[DEVICE] - losses["cpu"]).abs().max()),
                     "loss_card_last": float(losses[DEVICE][-1]),
                     "loss_cpu_last": float(losses["cpu"][-1])}
    return out


def phase_change_base():
    """(a) Each base's first CB_PARITY_STEPS steps on host inputs, the card
    against the CPU within CPU_TOL; (b) ``examples.change_base
    --host-inputs`` at SEED, both bases, 2,000 chunked forward-KL steps each
    on the inputs the JAX replays that set CB_NLL trained on: held-out NLL
    within CB_NLL; a profiled step's kernels; no kernel of the port.  The
    example with its draws made on the card is not held to a bar here: the
    recipe's Gaussian base diverges at some seeds on every side (PERF.md
    §6)."""
    from normflows_tpu_torch.examples import change_base

    r = {"parity": change_base_parity()}
    ok = all(v["max_abs_loss_gap"] <= CPU_TOL for v in r["parity"].values())
    printed = io.StringIO()
    with device_counters() as counts, contextlib.redirect_stdout(printed):
        record, launched = on_card(counts, lambda: change_base.main(
            ["--seed", str(SEED), "--device", DEVICE, "--host-inputs"]))
    r["launches"] = expect_launches("change_base", launched, {})
    r["run"] = {**record, "printed": printed.getvalue().splitlines()[:-1]}
    for run in record["runs"]:
        run["within_bar"] = (run["non_finite_steps"] == 0
                             and run["held_out_nll"] <= CB_NLL[run["base"]])
        ok = ok and run["within_bar"]
    model = change_base.build_model("mixture", SEED, DEVICE)
    state, chunk = change_base.make_trainer(model, change_base.draws(
        change_base.N_TRAIN, SEED, DEVICE), 1)
    r["profile"] = profiled_step(state, chunk, record["runs"][1]["steady_step_ms"])
    emit("change_base", ok=ok, results=r,
         bars={"held_out_nll_at_most": CB_NLL, "parity_loss": CPU_TOL})
    if not ok:
        raise SystemExit("change_base: a base missed its bar")
    return launched


# ---- the rest of the sampling tier and ScanChain ------------------------------
# The samplers of ``normflows_tpu_torch.sampling`` (dual-averaging
# adaptation, annealed SMC, NeuTra HMC, NUTS) and ``ScanChain``.  On the
# flagship they run the planar kernels: each pullback evaluation (the flow's
# sampling pass) 24 inverse launches (row 1) and each gradient 24
# backward-inverse ones (row 1b); the SMC proposal's log q 12 forward
# launches and its gradient 12 backward-forward ones.
SP_CHAINS, SP_SMC, SP_RESAMPLE, SP_FLAGSHIP_CHAINS = 256, 1024, 4096, 64
# float32 against float64 on the CPU, the largest |gap| of each reading of
# sampling_values(with_flows=False) (before any card run; the resampling
# indices and flags equal); the bar, card against CPU, is 10x it (atol;
# rtol 0), as stochastic_path's.  The discrete decisions (accepts, resampling
# flags, depths, leapfrog counts, divergences) must be equal.
SP_F64_GAP = {"adapt_accept_rate": 1.633e-06, "adapt_step": 2.384e-07, "smc_z": 6.692e-06,
              "smc_log_w": 4.955e-04, "smc_log_z": 1.012e-09}
SP_TOL = {k: (10 * v, 0.0) for k, v in SP_F64_GAP.items()}
# the readings through a spline flow (NeuTra, NUTS on a pullback) run the
# planar kernel, whose operands are float32 only: the port's standing bar,
# CPU_TOL (atol = rtol), as the earlier card-against-CPU phases hold theirs
SP_FLOW_TOL = (CPU_TOL, CPU_TOL)
# NUTS's accept_prob, a tree's mean of min(1, exp(-delta)) over all its
# leaves, those past the draw's included, where a trajectory has amplified
# its rounding most: the bar is 1e-2 (atol).  It was set after an H100
# read 2.6e-3 (PERF.md §6); the CPU's own run with the weights perturbed
# (below) reads up to ~4e-3 on the chains it compares, and the phase
# reports that reading beside the card's
SP_ACCEPT_TOL = (1e-2, 0.0)
SP_TOL.update(nuts_small_accept_prob=SP_ACCEPT_TOL, nuts_flagship_accept_prob=SP_ACCEPT_TOL)
SP_DISCRETE = ("resample_idx", "smc_flags", "neutra_small_rejected", "neutra_flagship_rejected",
               "nuts_small_depth", "nuts_small_num_leapfrog", "nuts_small_diverging",
               "nuts_small_picks", "nuts_sample_depth", "nuts_sample_num_leapfrog",
               "nuts_sample_picks", "nuts_flagship_depth", "nuts_flagship_num_leapfrog",
               "nuts_flagship_diverging", "nuts_flagship_picks")
# A NUTS tree's decisions (its depth, leapfrog count, divergence, and its
# picks: the leaf of each subtree whose draw became the proposal) are U-turn
# dot products and energy comparisons that float32 on two devices can part
# at a tie; with the picks recorded, a chain whose draw lies on another
# leaf differs in a decision.  A chain can also keep every decision and
# still move its draw: its trajectory amplifies rounding (on the CPU, with
# the flows' weights times 1 + 3e-7 N(0, 1), one flagship chain of 64 keeps
# its depth and picks and moves its draw by 0.02-0.46 at each of 6 seeds).
# So the CPU runs twice, as is and perturbed: a chain that parts there (a
# decision, or the draw off SP_FLOW_TOL) is ill-conditioned on the CPU
# itself and not held to float32's bar on the card.  A chain is held where
# neither the card nor the perturbation parts it: every decision equal, the
# draw and accept_prob within their bars.  At most SP_PARTED of a reading's
# chains may part or be ill-conditioned, each counted.  Every other
# decision must be equal.
SP_PERTURB, SP_PARTED = 3e-7, 0.05
SP_TREES = {"nuts_small": ("nuts_small_z", "nuts_small_accept_prob"),
            "nuts_flagship": ("nuts_flagship_z", "nuts_flagship_accept_prob"),
            "nuts_sample": ("nuts_sample_z",)}
# P1, nuts_bench's configuration cut to the budget: 1,024 chains, max_depth 8,
# GaussianVonMises, step 0.2 before adaptation, a leaf a CUDA graph; warm-up
# 20 transitions (200 in the example), sampling 8 and 24 (64 and 256)
NUTS_CHAINS, NUTS_DEPTH, NUTS_ADAPT, NUTS_SHORT, NUTS_LONG = 1024, 8, 20, 8, 24
NUTS_PROFILED = 1  # transitions under the profiler (kernels, busy share)
# E[cos(phi - 3 x0)] under the cylinder law: I1(1) / I0(1)
GVM_COS = 0.44639
MOMENT_BARS = {"abs_mean_x0": 0.1, "abs_std_x0_gap": 0.1, "abs_cos_gap": 0.05}
# P2: NeuTra on the trained flagship (f32): 1,024 chains, 10 leapfrog steps,
# 50 adaptation iterations, NEUTRA_STEPS moves, one iteration and one move
# each a CUDA graph replayed; then NUTS on the same pullback
NEUTRA_CHAINS, NEUTRA_L, NEUTRA_ADAPT, NEUTRA_STEPS = 1024, 10, 50, 4
# NUTS on that pullback: unit mass and NN_ADAPT warm-up transitions of dual
# averaging, at NN_SEEDS seeds.  The pullback of a circular flow is
# periodic in its latent angle, so the chains wander across periods and a
# window's variance of that coordinate (Stan's diagonal mass adaptation)
# grows with the window, and the step tuned under it shrinks; the flow is
# the preconditioner.  examples/neutra_nuts.py runs this configuration at
# 3 seeds with and without the mass adaptation (PERF.md §6); a run takes
# ~20 s on an H100 (~6,900 lock-step leaves), so the phase runs one seed
NN_CHAINS, NN_DEPTH, NN_ADAPT, NN_STEPS, NN_SEEDS = 256, 8, 20, 8, 1
# P3: annealed SMC, the flagship as proposal, GaussianVonMises target
SMC_N, SMC_TEMPS, SMC_L, SMC_STEP, LOG_Z_BAR = 2**14, 16, 10, 0.2, 0.05
SCAN_CHUNK = 10  # P4: steps of the captured chunk of each variant


def moments(x, w=None):
    """|mean x0|, |std x0 - 1| and |E cos(phi - 3 x0) - I1(1)/I0(1)| of
    draws (n, 2), weighted by ``w`` (normalised) where given."""
    x = x.reshape(-1, 2).double()
    w = torch.full((x.shape[0],), 1.0 / x.shape[0], dtype=torch.float64, device=x.device) \
        if w is None else w.double()
    mean = torch.sum(w * x[:, 0])
    std = torch.sqrt(torch.sum(w * (x[:, 0] - mean) ** 2))
    cos = torch.sum(w * torch.cos(x[:, 1] - 3.0 * x[:, 0]))
    return {"abs_mean_x0": abs(float(mean)), "abs_std_x0_gap": abs(float(std) - 1.0),
            "abs_cos_gap": abs(float(cos) - GVM_COS), "mean_x0": float(mean),
            "std_x0": float(std), "mean_cos": float(cos)}


def moments_ok(m):
    return all(m[k] <= bar for k, bar in MOMENT_BARS.items())


def mild(model, seed):
    """Each MADE's final layer drawn ~ N(0, 0.3^2 / fan-in), as
    build_stochastic draws the couplings': flows that do work, with
    pullbacks smooth enough that a leapfrog trajectory's float32 rounding
    on two devices does not part (a MADE at its random init gives
    pullbacks whose trajectories diverge in a few steps)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "final_layer"):
                w = m.final_layer.weight
                w.copy_(0.3 / math.sqrt(w.shape[1]) * torch.randn(w.shape, generator=gen))
    return model


def small_spline_flow(device):
    """The flagship cut to 2 circular AR spline layers of hidden 8, on
    GaussianVonMises."""
    import normflows_tpu_torch as nft

    base = nft.distributions.UniformGaussian.create(2, [1], SCALE, device=device)
    layers = [nft.flows.CircularAutoregressiveRationalQuadraticSpline.create(
        torch.Generator().manual_seed(SEED + 180 + i), 2, 1, 8, ind_circ=[1], num_bins=BINS,
        tail_bound=np.asarray(TAIL_BOUND, np.float32), permute_mask=True, rng_seed=3 * i,
        init_identity=True, device=device) for i in range(2)]
    return nft.NormalizingFlow.create(
        base, layers, p=nft.distributions.GaussianVonMises(device=device), device=device)


def sampling_models(with_flows=True, perturb=None):
    """Every model of the sampling checks, on the CPU in float32; with
    ``perturb`` (a seed) each flow parameter times (1 + SP_PERTURB N(0, 1))."""
    from normflows_tpu_torch import distributions as D

    out = {"two_moons": D.TwoMoons(device="cpu"), "diag": D.DiagGaussian(2, device="cpu")}
    if with_flows:
        out.update(small=mild(small_spline_flow("cpu"), SEED + 187),
                   flagship=mild(build_flagship("cpu", init_identity=True), SEED + 188))
        if perturb is not None:
            gen = torch.Generator().manual_seed(perturb)
            with torch.no_grad():
                for p in (*out["small"].parameters(), *out["flagship"].parameters()):
                    p.mul_(1 + SP_PERTURB * torch.randn(p.shape, generator=gen))
    return out


class Separable(torch.nn.Module):
    """log p(x0, phi) = -x0^2 / 2 + cos(phi): smooth and periodic in phi (a
    circular spline flow's pullback of it has no jump where the flow wraps
    phi) and without GaussianVonMises' coupling of phi to 3 x0, whose
    trajectories are chaotic: two devices' float32 rounding parts them
    within ~20 leapfrog steps."""

    def log_prob(self, x, context=None):
        return -0.5 * x[:, 0] ** 2 + torch.cos(x[:, 1])


def rejected(x):
    """A chain's move was rejected where its draw equals the one before."""
    return (x[1:] == x[:-1]).all(-1)


def sampling_values(device, dtype, seed=SEED + 181, with_flows=True, perturb=None):
    """Each sampler on host-drawn inputs and draws, on ``device`` in
    ``dtype``: adapt_step_size (HMC on TwoMoons), systematic_resample,
    AnnealedSMC (DiagGaussian proposal to TwoMoons), and with ``with_flows``
    (float32 only: the planar kernel's operands are float32) NeuTraHMC on
    the small flow and on the flagship, NUTS transitions on the pullbacks of
    Separable through them and a short NUTS sample (on a card each NUTS leaf
    a replayed CUDA graph).  With ``perturb`` (see sampling_models) only
    the NUTS readings, on the same draws.  Returns float64 (or integer) CPU
    tensors."""
    from normflows_tpu_torch import flows
    from normflows_tpu_torch.sampling import (NUTS, AnnealedSMC, NeuTraHMC, PullbackTarget,
                                              adapt_step_size, systematic_resample)

    rng = np.random.default_rng(seed)
    m = {k: v.to(device, dtype) for k, v in sampling_models(with_flows, perturb).items()}
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)  # noqa: E731
    normal = lambda *s: dev(rng.normal(size=s))  # noqa: E731
    uniform = lambda *s: dev(rng.uniform(size=s))  # noqa: E731
    out = {}
    hmc = flows.HamiltonianMonteCarlo(m["two_moons"], 4, np.zeros(2, np.float32),
                                      np.zeros(2, np.float32), device=device).to(dtype)
    n, k, rest = SP_CHAINS, SP_SMC, perturb is None
    z0, noise = 1.5 * normal(n, 2), (normal(8, n, 2), normal(8, n, 2), uniform(8, n))
    if rest:
        tuned, info = adapt_step_size(hmc, z0, 8, noise=noise)
        out["adapt_accept_rate"], out["adapt_step"] = info["accept_rate"], tuned.log_step_size
    log_w, u = 3.0 * normal(SP_RESAMPLE), uniform()
    if rest:
        particles = torch.arange(SP_RESAMPLE, dtype=dtype, device=device)[:, None]
        out["resample_idx"] = systematic_resample(log_w, particles, u=u)[0][:, 0].long()
    eps0, noise = normal(k, 2), [(uniform(), normal(k, 2), uniform(k)) for _ in range(7)]
    if rest:
        smc = AnnealedSMC.create(m["diag"], m["two_moons"], num_temps=8, num_leapfrog=5,
                                 step_size=0.2)
        out["smc_z"], out["smc_log_w"], out["smc_log_z"] = smc.from_noise(eps0, noise)
        out["smc_flags"] = smc.last_resampled.long()
    if not with_flows:
        return {k: (v.detach().cpu().long() if k in SP_DISCRETE else v.detach().double().cpu())
                for k, v in out.items()}
    # (chains, adaptation iterations, moves, NUTS depth): the flagship's cut
    # to what the CPU side runs in a few seconds.  No adaptation here: dual
    # averaging's first iterates try steps up to 10x the initial one, whose
    # trajectories part on two devices within a few leapfrog steps
    # (adapt_step_size's own reading above holds the adaptation)
    for name, (chains, adapt, moves, depth) in (("small", (n, 0, 3, 5)),
                                                ("flagship", (SP_FLAGSHIP_CHAINS, 0, 2, 4))):
        model = m[name]
        noise = (torch.cat([normal(chains, 1), uniform(chains, 1)], 1),
                 (normal(adapt, chains, 2), normal(adapt, chains, 2), uniform(adapt, chains)),
                 (normal(moves, chains, 2), uniform(moves, chains)))
        if rest:
            sampler = NeuTraHMC.create(model, num_leapfrog=3)
            x, info = sampler.sample(chains, moves, num_adapt=adapt, noise=noise)
            out[f"neutra_{name}_x"] = x
            out[f"neutra_{name}_rejected"] = rejected(x).long()
        # NUTS on the pullback of Separable (see there)
        nuts = NUTS.create(PullbackTarget(model, Separable()), 2, step_size=0.3,
                           max_depth=depth, device=device).to(dtype)
        z, st = nuts.transition(normal(chains, 2), noise=(
            normal(chains, 2), uniform(depth, chains), uniform(depth, chains),
            uniform(depth, 2 ** (depth - 1), chains)))
        out[f"nuts_{name}_z"], out[f"nuts_{name}_accept_prob"] = z, st["accept_prob"]
        for key in ("depth", "num_leapfrog", "diverging", "picks"):
            out[f"nuts_{name}_{key}"] = st[key].long()
    nuts = NUTS.create(PullbackTarget(m["small"], Separable()), 2, step_size=0.5, max_depth=4,
                       device=device).to(dtype)
    c = 16
    zs, info = nuts.sample(c, 3, num_adapt=0, noise=(normal(c, 2), [
        (normal(c, 2), uniform(4, c), uniform(4, c), uniform(4, 8, c)) for _ in range(3)]))
    out["nuts_sample_z"], out["nuts_sample_step"] = zs, info["step_size"]
    out["nuts_sample_inv_mass"] = info["inv_mass"]
    for key in ("depth", "num_leapfrog", "picks"):
        out[f"nuts_sample_{key}"] = info[key].long()
    return {k: (v.detach().cpu().long() if k in SP_DISCRETE else v.detach().double().cpu())
            for k, v in out.items()}


def scan_chain_vs_unrolled(counts):
    """The flagship's layers as one ScanChain against the same layers
    unrolled in a Composite (the same log-det accumulation): ``sample`` and
    ``log_prob`` at N bit for bit, with the same launches on the device
    counters (24 inverse a sample, 12 forward a log_prob)."""
    import normflows_tpu_torch as nft

    unrolled = build_flagship(DEVICE)
    layers = list(unrolled.flows)
    scan = nft.NormalizingFlow.create(unrolled.q0, [nft.ScanChain.create(layers)],
                                      p=unrolled.p, device=DEVICE)
    composite = nft.NormalizingFlow.create(unrolled.q0, [nft.Composite(layers)], p=unrolled.p,
                                           device=DEVICE)
    r, launched = {}, {}
    with torch.no_grad():
        for name, model in (("unrolled", composite), ("scan_chain", scan)):
            gen = torch.Generator(DEVICE).manual_seed(SEED + 182)
            (x, log_q), a = exact_on_card(f"sampling_path {name} sample", counts,
                                          lambda: model.sample(N, generator=gen),
                                          rqs_transposed_inverse=2 * LAYERS)
            lp, b = exact_on_card(f"sampling_path {name} log_prob", counts,
                                  lambda: model.log_prob(x), rqs_transposed_forward=LAYERS)
            r[name] = (x, log_q, lp)
            add_launches(launched, a)
            add_launches(launched, b)
    equal = {k: bool(torch.equal(a, b)) for k, a, b in zip(("x", "log_q", "log_prob"),
                                                            r["unrolled"], r["scan_chain"])}
    return equal, launched


def tree_parted(a, b, tree):
    """The chains (last axis) of a NUTS reading ``tree`` whose recorded
    decisions differ between the value sets ``a`` and ``b`` (a sample's:
    at any step)."""
    return sum((a[k] != b[k]).reshape(-1, a[k].shape[-1]).any(0).long()
               for k in SP_DISCRETE if k.startswith(tree + "_")) > 0


def tree_off(a, b, tree):
    """The chains whose draws lie off SP_FLOW_TOL between ``a`` and ``b``."""
    za, zb = a[SP_TREES[tree][0]], b[SP_TREES[tree][0]]
    off = ((za - zb).abs() > SP_FLOW_TOL[0] * (1 + zb.abs())).any(-1)
    return off.reshape(-1, off.shape[-1]).any(0) if off.dim() > 1 else off


def phase_sampling_path():
    """The samplers on host-drawn draws, the card against the port on the
    CPU (values within SP_TOL, every discrete decision equal; NUTS's chains
    as SP_PARTED says), and the flagship as one ScanChain against its
    layers unrolled, bit for bit."""
    launched = {}
    with device_counters() as counts:
        card, got = on_card(counts, lambda: sampling_values(DEVICE, torch.float32))
        add_launches(launched, got)
        cpu = sampling_values("cpu", torch.float32)
        shaken = sampling_values("cpu", torch.float32, perturb=SEED + 189)  # NUTS only
        equal, got = scan_chain_vs_unrolled(counts)
        add_launches(launched, got)
    trees, keep = {}, {}
    for tree, readings in SP_TREES.items():
        parted = tree_parted(card, cpu, tree)
        ill = tree_parted(cpu, shaken, tree) | tree_off(cpu, shaken, tree)
        held = ~parted & ~ill
        for k in readings:
            keep[k] = held
        z = readings[0]
        axis = 1 if cpu[z].dim() == 3 else 0
        rows = held.nonzero()[:, 0]
        gaps = {k: float((cpu[k] - shaken[k]).abs().index_select(axis if k == z else 0,
                                                                rows).max())
                for k in readings} if len(rows) else {}
        trees[tree] = {"chains": int(held.numel()), "parted_on_card": int(parted.sum()),
                       "ill_conditioned_on_cpu": int(ill.sum()),
                       "parted_and_ill": int((parted & ill).sum()), "held": int(held.sum()),
                       "perturbed_cpu_max_abs_on_held": gaps}
    discrete = {k: bool(torch.equal(card[k], cpu[k])) for k in SP_DISCRETE
                if not any(k.startswith(t + "_") for t in SP_TREES)}

    def held(k):
        a, b = card[k], cpu[k]
        if k in keep:  # the chains on the last axis (a sample's draws: (steps, chains, dim))
            axis = 1 if a.dim() == 3 else 0
            rows = keep[k].nonzero()[:, 0]
            a, b = a.index_select(axis, rows), b.index_select(axis, rows)
        return {"excess": excess(a, b, *SP_TOL.get(k, SP_FLOW_TOL)),
                "max_abs": float((a - b).abs().max())}

    values = {k: held(k) for k in cpu if k not in SP_DISCRETE}
    ok = (all(discrete.values()) and all(v["excess"] <= 0 for v in values.values())
          and all(equal.values())
          and all(t["chains"] - t["held"] <= SP_PARTED * t["chains"] for t in trees.values()))
    emit("sampling_path", ok=ok, discrete_equal=discrete, values=values, nuts_trees=trees,
         parted_or_ill_at_most=SP_PARTED, perturbation=SP_PERTURB,
         scan_chain_bit_equal=equal, launches={k: v for k, v in launched.items() if v},
         bars={"values": SP_TOL, "flow_values": SP_FLOW_TOL},
         note="card against the port on the CPU, float32, on host-drawn draws; the "
         "flagship's NeuTra and NUTS at 64 chains; NUTS values held on the chains that "
         "neither the card nor the perturbed CPU parts; the ScanChain check at 2^14")
    if not ok:
        raise SystemExit("sampling_path: a check missed its bar")
    return launched


def phase_nuts():
    """P1: nuts_bench's configuration (1,024 chains, max_depth 8, step 0.2
    before adaptation, GaussianVonMises) cut to NUTS_ADAPT warm-up and
    NUTS_SHORT / NUTS_LONG sampling transitions; the moment bars on the
    longer run's draws.  No kernel of the port runs here."""
    from normflows_tpu_torch.examples import nuts_bench

    with device_counters() as counts:
        record, launched = on_card(counts, lambda: nuts_bench.run(
            NUTS_CHAINS, NUTS_SHORT, NUTS_LONG, NUTS_ADAPT, NUTS_DEPTH, DEVICE, seed=SEED,
            profiled=NUTS_PROFILED))
    m = record["moments"]
    stats = {"abs_mean_x0": abs(m["mean_x0"]), "abs_std_x0_gap": abs(m["std_x0"] - 1.0),
             "abs_cos_gap": abs(m["mean_cos"] - GVM_COS)}
    ok = moments_ok(stats) and math.isfinite(record["ms_per_transition_all_chains"])
    emit("nuts", ok=ok, results=record, moment_gaps=stats, bars=MOMENT_BARS,
         launches=expect_launches("nuts", launched, {}),
         cuts={"num_adapt": f"{NUTS_ADAPT} (nuts_bench: 200)",
               "steps": f"{NUTS_SHORT} / {NUTS_LONG} (nuts_bench: 64 / 256)"})
    if not ok:
        raise SystemExit("nuts: a moment missed its bar")
    return launched


def hmc_launches(trajectories, L, per_eval):
    """Planar launches of ``trajectories`` HMC trajectories of L leapfrog
    steps on a flow target: (2L + 2) evaluations and 2L gradients each."""
    return (2 * L + 2) * per_eval * trajectories, 2 * L * per_eval * trajectories


def phase_neutra_smc(model):
    """P2: NeuTraHMC on the trained flagship (f32) and NUTS on the same
    pullback at NN_SEEDS seeds, the moment bars on their pushed-forward
    draws; P3: annealed SMC with the flagship as proposal, |log Z| and the
    weighted moments, eager (``from_noise`` on the generator's draws) and
    with a rung graph (``sample`` on the card), bit-equal; the device
    counters' planar launches equal to the counts the formulas give; the
    replays' device time under the profiler."""
    from normflows_tpu_torch.distributions.base import draw_noise
    from normflows_tpu_torch.sampling import NUTS, AnnealedSMC, NeuTraHMC, PullbackTarget
    from normflows_tpu_torch.utils import set_compute_dtype
    from normflows_tpu_torch import distributions as D

    set_compute_dtype(model, "float32")
    r, launched = {}, {}
    with device_counters() as counts:
        # P2: one warm-up iteration of each replayed loop adds to the count
        gen = torch.Generator(DEVICE).manual_seed(SEED + 183)
        sampler = NeuTraHMC.create(model, num_leapfrog=NEUTRA_L)
        sync()
        t0 = time.perf_counter()
        (x, info), got = on_card(counts, lambda: sampler.sample(
            NEUTRA_CHAINS, NEUTRA_STEPS, num_adapt=NEUTRA_ADAPT, generator=gen))
        sync()
        seconds = time.perf_counter() - t0
        inv, bwd = hmc_launches(2 * (NEUTRA_ADAPT + 1) + NEUTRA_STEPS + 1, NEUTRA_L, 2 * LAYERS)
        want = {"rqs_transposed_inverse": inv + 2 * LAYERS,
                "rqs_transposed_backward_inverse": bwd}
        # the device time of the replays: one adaptation iteration's and one
        # move's replay under the profiler, times their replays
        prof = {k: kernel_shares(g.replay) for k, g in sampler.last_graphs.items()}
        for v in prof.values():
            v.pop("conv_share", None)
        device_ms = (prof["adapt"]["device_ms"] * NEUTRA_ADAPT
                     + prof["move"]["device_ms"] * NEUTRA_STEPS)
        r["neutra"] = {"seconds": seconds, "moments": moments(x),
                       "final_step_size": float(info["final_step_size"][0]),
                       "accept_rate_last_10": float(info["accept_rate"][-10:].mean()),
                       "replay_profiles": prof, "replays_device_ms": device_ms,
                       "busy_share": device_ms / (seconds * 1e3),
                       "launches": expect_launches("neutra", got, want), "finite":
                           bool(torch.isfinite(x).all())}
        add_launches(launched, got)
        r["neutra_nuts"] = []
        for k in range(NN_SEEDS):
            gen = torch.Generator(DEVICE).manual_seed(SEED + 184 + k)
            nuts = NUTS.create(PullbackTarget(model), 2, step_size=0.2, max_depth=NN_DEPTH,
                               device=DEVICE)
            sync()
            t0 = time.perf_counter()

            def nuts_draws():
                us, info = nuts.sample(NN_CHAINS, NN_STEPS, num_adapt=NN_ADAPT,
                                       adapt_mass=False, generator=gen)
                with torch.no_grad():
                    return model.forward(us.reshape(-1, 2)), info

            (x, info), got = on_card(counts, nuts_draws)
            sync()
            seconds = time.perf_counter() - t0
            # a gradient a leaf and a transition's start, and the leaf graph's
            # warm-up leaf (the NUTS is new: one capture)
            evals = info["leaves_total"] + info["transitions"] + 1
            want = {"rqs_transposed_inverse": 2 * LAYERS * (evals + 1),
                    "rqs_transposed_backward_inverse": 2 * LAYERS * evals}
            r["neutra_nuts"].append({
                "seed": SEED + 184 + k, "seconds": seconds, "moments": moments(x),
                "step_size": float(info["step_size"]), "mean_depth": float(info["mean_depth"]),
                "divergence_rate": float(info["divergence_rate"]),
                "transitions": info["transitions"], "leaves_total": info["leaves_total"],
                "host_reads_total": info["host_reads_total"],
                "launches": expect_launches("neutra_nuts", got, want)})
            add_launches(launched, got)
        # P3: the rung graph's sample, then the eager ladder on the draws the
        # generator gave it (the proposal's noise, then a temperature's)
        smc = AnnealedSMC.create(model, D.GaussianVonMises(device=DEVICE), num_temps=SMC_TEMPS,
                                 num_leapfrog=SMC_L, step_size=SMC_STEP)
        gen = torch.Generator(DEVICE).manual_seed(SEED + 185)
        rungs = SMC_TEMPS - 1
        fwd, bwd = hmc_launches(1, SMC_L, LAYERS)
        per_rung = {"rqs_transposed_forward": fwd + 2 * LAYERS,
                    "rqs_transposed_backward_forward": bwd}
        timed = {}
        for route in ("graphs", "eager"):
            gen.manual_seed(SEED + 185)
            if route == "eager":
                eps0 = draw_noise(model.q0.noise_spec, (2,), SMC_N, generator=gen,
                                  device=DEVICE)
                noises = [(torch.rand((), generator=gen, device=DEVICE),
                           torch.randn(SMC_N, 2, generator=gen, device=DEVICE),
                           torch.rand(SMC_N, generator=gen, device=DEVICE))
                          for _ in range(rungs)]
                run = lambda: smc.from_noise(eps0, noises)  # noqa: E731
            else:
                run = lambda: smc.sample(SMC_N, generator=gen)  # noqa: E731
            sync()
            t0 = time.perf_counter()
            out, got = on_card(counts, run)
            sync()
            # the first sample adds its warm-up rung
            n_rungs = rungs + (1 if route == "graphs" else 0)
            want = {"rqs_transposed_inverse": 2 * LAYERS,
                    **{k: v * n_rungs for k, v in per_rung.items()}}
            timed[route] = {"ms": (time.perf_counter() - t0) * 1e3, "out": out,
                            "flags": smc.last_resampled.clone(),
                            "launches": expect_launches(f"smc {route}", got, want)}
            if route == "graphs":
                graph = smc.last_graph
            add_launches(launched, got)
        eager = timed["eager"]["out"]
        bit_equal = (all(bool(torch.equal(a, b)) for a, b in zip(eager, timed["graphs"]["out"]))
                     and bool(torch.equal(timed["eager"]["flags"], timed["graphs"]["flags"])))
        flags = timed["eager"]["flags"]
        # the device time of a sample: one rung's replay under the profiler,
        # times the rungs (every rung runs the same kernels)
        prof = kernel_shares(graph.replay)
        prof.pop("conv_share", None)
        device_ms = prof["device_ms"] * rungs
    particles, log_w, log_z = eager
    w = torch.softmax(log_w.double(), 0)
    r["smc"] = {"log_z": float(log_z), "ess": float(1.0 / torch.sum(w * w)),
                "moments_weighted": moments(particles, w),
                "resampled": flags.long().tolist(), "eager_ms": timed["eager"]["ms"],
                "graphs_ms": timed["graphs"]["ms"], "graphs_bit_equal_to_eager": bit_equal,
                "rung_profile": prof, "device_ms": device_ms,
                "busy_share_graphs": device_ms / timed["graphs"]["ms"],
                "busy_share_eager": device_ms / timed["eager"]["ms"],
                "launches": {k: v["launches"] for k, v in timed.items()},
                "finite": bool(torch.isfinite(particles).all() and torch.isfinite(log_w).all())}
    ok = (moments_ok(r["neutra"]["moments"]) and r["neutra"]["finite"]
          and all(moments_ok(v["moments"]) for v in r["neutra_nuts"])
          and abs(r["smc"]["log_z"]) <= LOG_Z_BAR and moments_ok(r["smc"]["moments_weighted"])
          and bit_equal and r["smc"]["finite"])
    emit("neutra_smc", ok=ok, results=r, bars={"moments": MOMENT_BARS, "abs_log_z": LOG_Z_BAR},
         sizes={"neutra": [NEUTRA_CHAINS, NEUTRA_L, NEUTRA_ADAPT, NEUTRA_STEPS],
                "neutra_nuts": [NN_CHAINS, NN_DEPTH, NN_ADAPT, NN_STEPS, NN_SEEDS],
                "smc": [SMC_N, SMC_TEMPS, SMC_L, SMC_STEP]},
         note="the convergence phase's flagship, sampled in float32; NeuTra on the card "
         "(one adaptation iteration and one move each a CUDA graph, a warm-up iteration "
         "each; busy share: the replays' device time over the call's wall time, warm-ups "
         "and captures included); NUTS with unit mass (a leaf a CUDA graph); SMC's sample "
         "(a temperature captured once after a warm-up rung, replayed for each; graphs_ms "
         "includes the warm-up and the capture), then from_noise on the same draws, eager "
         "(eager_ms excludes drawing them)")
    if not ok:
        raise SystemExit("neutra_smc: a check missed its bar")
    return launched


# phase serving_stochastic: bundles of the models whose sampler the JAX
# package's export_sampler serves past plain flows, at the widths of the
# stochastic and sampling phases: the SNF of examples/snf_hais.py (MH, and its HMC
# variant) at 1,024 draws, its HAIS (4,096 chains, 30 rungs of 10 leapfrog
# steps), annealed SMC with the convergence phase's flagship as proposal
# (SMC_N particles, SMC_TEMPS temperatures, SMC_L leapfrog steps of
# SMC_STEP), and model R in eval mode at 2^14 draws with its log_prob on a
# symbolic batch.  Depth is cut, widths kept: a program's export, save and
# load grow with its graph's nodes, which each layer adds, and the phase
# holds a budget of ~60 s: the SNF to
# SS_SNF_BLOCKS of its 4 coupling + MCMC blocks, the flagship proposal to
# its first SS_SMC_LAYERS of 12 layers (trained), model R to SS_RES_K of 16
# blocks.
SS_SNF_N, SS_HAIS_N, SS_RES_N = 1024, 4096, 2**14
SS_SNF_BLOCKS, SS_SMC_LAYERS, SS_RES_K = 2, 3, 2
SS_BATCHES = (1, 7, 4096)  # model R's log_prob requests through its one program


def scan_extra_calls():
    """How many calls of its body more than its length the installed torch's
    eager ``scan`` makes (torch 2.11's runs element 0 twice, once to size its
    outputs; torch 2.13's once): a served program's loops are scans."""
    calls = []

    def body(carry, x):
        calls.append(x)
        return carry + x, x

    with torch.no_grad():
        torch.ops.higher_order.scan(body, [torch.zeros(())], [torch.arange(3.0)], ())
    return len(calls) - 3


def ss_bundle(what, root, counts, model, n, live, want, event_shape=None, seed=SEED + 190):
    """Save ``model``'s bundle under ``root`` (``event_shape`` None: its
    sampler alone), load it, and hold its sampler from ``seed`` against
    ``live(generator)``, the live model on a generator seeded alike, bit for
    bit: the program eagerly and, where its route is graphed, as the CUDA
    graph (after the call that captures it).  Each request launches exactly
    ``want`` on the device counters, and is the one timed (host ms ending in
    a synchronise; the live model's is its first call, SMC's capture of its
    rung graph included).  Device ms: CUDA events around one replay of the
    graph (its kernels and the gaps between them), or, on the eager route,
    torch.profiler's kernel time of one request.  Returns the readings, the
    bundle, the program's output and the launches counted."""
    from normflows_tpu_torch import serving

    path = os.path.join(root, what)
    t0 = time.perf_counter()
    manifest = serving.save_bundle(model, path, n, event_shape)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = serving.load_bundle(path)
    load_s = time.perf_counter() - t0

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        want_out, live_ms = timed(lambda: live(torch.Generator(DEVICE).manual_seed(seed)))
    routes = {"program_eager": lambda: bundle.sample(seed, graphed=False)}
    if manifest["route"] == "graphed":
        routes["program_graphed"] = lambda: bundle.sample(seed)
    r = {"route": manifest["route"], "export_seconds": manifest["export_seconds"],
         "save_seconds": save_s, "load_seconds": load_s, "bytes": bundle_bytes(path),
         "kernel_ops": manifest["kernel_ops"], "outputs": manifest["outputs"],
         "launches": {}, "bit_equal": {}, "max_abs_diff": {}, "request_ms": {"live": live_ms}}
    launched, outs = {}, {}
    for route, fn in routes.items():
        if route == "program_graphed":
            bundle.sample(seed + 1)  # captures the graph
        (outs[route], r["request_ms"][route]), got = on_card(counts, lambda: timed(fn))
        r["launches"][route] = expect_launches(f"{what} {route}", got, want)
        add_launches(launched, got)
        r["bit_equal"][route] = all(bool(torch.equal(a, b)) for a, b in zip(outs[route], want_out))
        r["max_abs_diff"][route] = [float((a.double() - b.double()).abs().max())
                                    for a, b in zip(outs[route], want_out)]
    r["finite"] = all(bool(torch.isfinite(a).all()) for a in outs["program_eager"])
    if bundle._graph is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        bundle._graph.replay()
        end.record()
        sync()
        device_ms, source = start.elapsed_time(end), "CUDA events around one graph replay"
    else:
        device_ms, source = profile(routes["program_eager"], warm=True)["device_ms"], \
            "torch.profiler, one eager request"
    r["device_ms"] = {"ms": device_ms, "source": source,
                      "busy_share": {route: device_ms / ms for route, ms in r["request_ms"].items()}}
    return r, bundle, outs["program_eager"], launched


def phase_serving_stochastic(root, trained):
    """``serving`` on the card for the SNF (MH and HMC), HAIS, annealed SMC
    on the trained flagship's first SS_SMC_LAYERS layers and model R (eval
    mode), cut as their constants say: each bundle against its
    live model, bit for bit (``ss_bundle``); the served HAIS's log Z against
    LOG_Z within the ``hais`` phase's bar, the served SMC's |log Z| within
    LOG_Z_BAR; the SMC bundle's planar launches a request equal to the
    counts worked out from its program (per temperature one evaluation of
    the proposal's log-density for the reweighting and SMC_L + 1 of its
    value and gradient in the move; the proposal's draw 2 inverse launches a
    layer), the others none; model R's fixed-point steps a request and its
    log_prob at SS_BATCHES through one program.  Each of the SMC program's
    scans (over the temperatures, and over each move's leapfrog steps) runs
    its body ``scan_extra_calls()`` more times than its length."""
    from normflows_tpu_torch import NormalizingFlow
    from normflows_tpu_torch import distributions as D
    from normflows_tpu_torch.examples import snf_hais
    from normflows_tpu_torch.examples.residual_twomoons import set_train
    from normflows_tpu_torch.sampling import AnnealedSMC
    from normflows_tpu_torch.utils import set_compute_dtype

    r, launched, t_phase = {}, {}, time.perf_counter()
    extra = scan_extra_calls()
    rung_bodies, move_evals = SMC_TEMPS - 1 + extra, SMC_L + 1 + extra
    smc_want = {"rqs_transposed_inverse": 2 * SS_SMC_LAYERS,
                "rqs_transposed_forward": rung_bodies * (1 + move_evals) * SS_SMC_LAYERS,
                "rqs_transposed_backward_forward": rung_bodies * move_evals * SS_SMC_LAYERS}
    with device_counters() as counts:
        for mcmc in ("mh", "hmc"):
            model = snf_hais.build_snf(DEVICE, SEED, mcmc)
            model.flows = torch.nn.ModuleList(list(model.flows)[:2 * SS_SNF_BLOCKS])
            r[f"snf_{mcmc}"], *_ = ss_bundle(
                f"snf_{mcmc}", root, counts, model, SS_SNF_N,
                lambda g, m=model: m.sample(SS_SNF_N, generator=g), {})
        hais = snf_hais.build_hais(DEVICE)
        r["hais"], _, out, _ = ss_bundle("hais", root, counts, hais, SS_HAIS_N,
                                         lambda g: hais.sample(SS_HAIS_N, generator=g), {})
        est = snf_hais.estimates(*out)
        bar = max(0.02, 4 * est["log_z_se"])
        r["hais"]["estimates"] = {**est, "gap": abs(est["log_z"] - LOG_Z), "bar": bar}
        set_compute_dtype(trained, "float32")
        proposal = NormalizingFlow(trained.q0, list(trained.flows)[:SS_SMC_LAYERS], trained.p)
        smc = AnnealedSMC.create(proposal, D.GaussianVonMises(device=DEVICE),
                                 num_temps=SMC_TEMPS, num_leapfrog=SMC_L, step_size=SMC_STEP)
        r["smc"], _, out, got = ss_bundle("smc", root, counts, smc, SMC_N,
                                          lambda g: smc.sample(SMC_N, generator=g), smc_want)
        add_launches(launched, got)
        particles, log_w, log_z = out
        w = torch.softmax(log_w.double(), 0)
        r["smc"].update(log_z=float(log_z), ess=float(1.0 / torch.sum(w * w)),
                        moments_weighted=moments(particles, w), launches_predicted=smc_want,
                        scan_extra_calls=extra)
        model, _, x_held = build_residual(k=SS_RES_K)
        model = copy.deepcopy(model).to(DEVICE)
        set_train(model, False)
        x = x_held.to(DEVICE).repeat(2, 1)[:max(SS_BATCHES)]
        r["residual"], bundle, _, _ = ss_bundle(
            "residual", root, counts, model, SS_RES_N,
            lambda g: model.sample(SS_RES_N, generator=g), {}, event_shape=(2,))
        r["residual"]["fixed_point_steps"] = [
            int(f.iresblock.last_inverse["steps"]) for f in model.flows
            if hasattr(f, "iresblock")]
        with torch.no_grad():
            want = {b: model.log_prob(x[:b]) for b in SS_BATCHES}
        r["residual"]["log_prob_bit_equal"] = {
            b: bool(torch.equal(bundle.log_prob(x[:b]), want[b])) for b in SS_BATCHES}
        r["residual"]["log_prob_ms"] = {b: host_ms(lambda b=b: bundle.log_prob(x[:b]),
                                                   reps=1, warmup=0) for b in SS_BATCHES}
    seconds = time.perf_counter() - t_phase
    bundles = [r[k] for k in ("snf_mh", "snf_hmc", "hais", "smc", "residual")]
    ok = (all(all(b["bit_equal"].values()) and b["finite"] for b in bundles)
          and all(r["residual"]["log_prob_bit_equal"].values())
          and r["hais"]["estimates"]["gap"] <= bar and r["hais"]["estimates"]["finite_weights"]
          and abs(r["smc"]["log_z"]) <= LOG_Z_BAR)
    emit("serving_stochastic", ok=ok, results=r, phase_seconds=seconds,
         bars={"hais_log_z": LOG_Z, "hais_gap_at_most": "max(0.02, 4 SE)",
               "smc_abs_log_z": LOG_Z_BAR, "bundles": "bit-equal to the live model"},
         sizes={"snf": [SS_SNF_N, SS_SNF_BLOCKS], "hais": SS_HAIS_N,
                "smc": [SMC_N, SMC_TEMPS, SMC_L, SMC_STEP, SS_SMC_LAYERS],
                "residual": [SS_RES_N, SS_RES_K, RES_HIDDEN], "log_prob_batches": SS_BATCHES},
         note="request_ms: host time of the one checked request a route, ending in a "
         "synchronise (live: the live model's first sample on a generator, SMC's capture of "
         "its rung graph included; program_graphed: the replay after the capturing call); "
         "device_ms: see its source, over each route's ms the busy shares; export_seconds: "
         "the manifest's (the programs' export), save_seconds the whole save_bundle")
    if not ok:
        raise SystemExit("serving_stochastic: a bundle missed its bar")
    return launched


def stacked_equal(scan, unrolled, prefix="flows.0.stacked."):
    """Every tensor of a ScanChain model (``scan``: name -> tensor) equal,
    bit for bit, to the unrolled model's: a stacked tensor's slice i to
    layer i's (``flows.i.<path>``), any other by its name."""
    for name, t in scan.items():
        if name.startswith(prefix):
            path = name[len(prefix):]
            if not all(torch.equal(t[i], unrolled[f"flows.{i}.{path}"])
                       for i in range(t.shape[0])):
                return False
        elif not torch.equal(t, unrolled[name]):
            return False
    return len(unrolled) == sum(t.shape[0] if n.startswith(prefix) else 1
                                for n, t in scan.items())


def phase_scan_chain():
    """P4: the flagship as one ScanChain against the unrolled flagship, a
    captured chunk of SCAN_CHUNK bf16 reverse-KL steps each (2^14, Adam
    5e-4, capturable), from the same weights and generator state: the
    parameters bit-equal, the losses bit-equal or within 1e-6 relative (the
    log-det accumulation: the facade subtracts each layer's log-det from
    log q in turn, ScanChain sums its layers' first, as JAX's scan does),
    24 inverse and 24 backward-inverse planar launches a replayed step."""
    import normflows_tpu_torch as nft
    from normflows_tpu_torch import training
    from normflows_tpu_torch.utils import set_compute_dtype

    out, launched = {}, {}
    with device_counters() as counts:
        for name in ("unrolled", "scan_chain"):
            model = build_flagship(DEVICE, init_identity=True)
            if name == "scan_chain":
                model.flows = torch.nn.ModuleList([nft.ScanChain.create(list(model.flows))])
            set_compute_dtype(model, "bfloat16")
            state, chunk = training.make_step_chunk(model, capturable_adam(model),
                                                    reverse_kld_loss(N), SCAN_CHUNK)
            gen = torch.Generator(DEVICE).manual_seed(SEED + 186)
            chunk(state, gen)  # the warm-up, the capture and a first chunk
            gen.manual_seed(SEED + 187)
            sync()
            t0 = time.perf_counter()
            (_, metrics), got = on_card(counts, lambda: chunk(state, gen))
            losses = metrics["loss"]
            sync()
            ms = (time.perf_counter() - t0) * 1e3 / SCAN_CHUNK
            replay_launches(f"scan_chain {name}", got,
                            {"rqs_transposed_inverse": 2 * LAYERS,
                             "rqs_transposed_backward_inverse": 2 * LAYERS}, SCAN_CHUNK)
            add_launches(launched, got)
            out[name] = {"losses": losses.clone(), "ms_per_step": ms,
                         "params": {n: p.detach() for n, p in model.named_parameters()}}
    a, b = out["unrolled"], out["scan_chain"]
    params_equal = stacked_equal(b["params"], a["params"])
    rel = float(((a["losses"] - b["losses"]).abs() / a["losses"].abs().clamp(min=1e-30)).max())
    ok = params_equal and rel <= 1e-6
    emit("scan_chain", ok=ok, params_bit_equal=params_equal,
         losses_bit_equal=bool(torch.equal(a["losses"], b["losses"])),
         losses_max_relative_gap=rel, ms_per_step={k: v["ms_per_step"] for k, v in out.items()},
         launches={k: v for k, v in launched.items() if v}, chunk=SCAN_CHUNK,
         bar={"losses_relative": 1e-6, "operation": "log-det accumulation (facade: log q - "
              "ld_i layer by layer; ScanChain: the layers' log-dets summed, then subtracted)"})
    if not ok:
        raise SystemExit("scan_chain: the ScanChain chunk disagrees with the unrolled one")
    return launched


# ---- the native loader and the data- and chain-parallel tier (PR 18) --------
# Bars fixed before the first card run of these phases:
# * the world of 1 (NCCL, in-process): make_reverse_kld_step's loss,
#   gradients and parameters after Adam bit-equal to make_train_step's on the
#   same generator (averaging over one rank is the identity);
# * the world of 2 (gloo over CUDA tensors, both ranks on the one card):
#   the averaged loss within DP2_LOSS_REL of the single-process 2^14 step's,
#   each gradient leaf within DP2_GRAD_REL of its norm (the leaves that are
#   0 there exactly 0), both ranks bit-equal, and each rank's Adam update
#   bit-equal to Adam's on the rank's averaged gradient from the initial
#   weights.  Reason for 1e-5: the same float32 sums over the batch in
#   another order (two halves, then their mean); on the CPU that moves the
#   flagship's gradient leaves by at most 3.2e-7 of their norm (1.2e-7 over
#   the whole gradient, the loss not at all: `python -m tests.test_torch_parallel`,
#   this step at 2^14 against its two halves, run before any card run);
# * HAIS through parallel_chain_sample: at world 1 the chains bit-equal to
#   HAIS.sample on the same generator; at world 2 every chain's draw within
#   CHAIN_Z_TOL and its log weight within CHAIN_W_TOL (atol, rtol) of the
#   single-process chain's, no chain excused (each chain's arithmetic is the
#   same elementwise code whatever the batch, so bits are expected; the bar
#   leaves room for a last-bit difference of a kernel chosen by batch size);
#   log Z within max(0.02, 4 SE) of the quadrature (PR 15's bar);
# * the loader: native batches with jitter and logit off bit-equal to the
#   plain producer and to utils.preprocessing; with the logit on within 1e-6
#   (tests/test_data_loader.py's bar); jittered batches bit-equal across 1
#   and 4 workers; batches through prefetch_to_device bit-equal on the card.
DP_SEED = SEED + 190  # the generator of the data-parallel steps' draws
DP2_LOSS_REL, DP2_GRAD_REL = 1e-5, 1e-5
DP_TIMED = 3  # steps of each route in each of six alternating blocks
DP_AVERAGE_REPS = 20  # timed calls of the gradient average alone
CHAIN_SEED, CHAINS = SEED + 191, 4096
CHAIN_Z_TOL, CHAIN_W_TOL = (1e-6, 1e-6), (1e-5, 1e-6)
LOADER_BATCHES, LOADER_NUMPY_BATCHES = 200, 10  # timed host batches, native / plain
GLOW_LOADER_STEPS, GLOW_PROFILED = 3, 1  # timed steps of each feed, profiled steps


def busy(fn):
    """``fn`` once under torch.profiler tracing the device only (no host
    operators recorded, so the profiler adds little host time): the call's
    wall time, its kernels' device time and their ratio, its copies'
    (memcpy, memset) device time, over the same call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if not e.key.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "copy_ms": sum(e.self_device_time_total for e in copies) / 1e3,
            "kernel_launches": sum(e.count for e in kernels)}


def uint8_images(n, seed=SEED):
    """``examples.glow_image.synthetic_images`` as the uint8 images they
    quantise (x = round(255 c) / 255), and their labels."""
    from normflows_tpu_torch.examples import glow_image

    x, y = glow_image.synthetic_images(n, seed=seed)
    return (x * 255.0).round().to(torch.uint8).numpy(), y.numpy()


def phase_loader():
    """The native loader (``data.NativeImageLoader``, built with g++ from
    the checkout) at CIFAR-10 geometry: its batches against the plain
    producer and ``utils.preprocessing``, across worker counts, and copied
    to the card through ``prefetch_to_device``; host batches/s."""
    from normflows_tpu_torch import data
    from normflows_tpu_torch.data import native_loader
    from normflows_tpu_torch.utils import preprocessing

    t0 = time.perf_counter()
    native_loader._library()
    build_s = time.perf_counter() - t0
    images, labels = uint8_images(2048)
    r = {"build_seconds": build_s, "shape": list(images.shape[1:]), "batch": GLOW_BATCH}

    def take(k, **kw):
        loader = data.NativeImageLoader(images, labels, batch_size=GLOW_BATCH, **kw)
        out = [next(loader) for _ in range(k)]
        loader.close()
        return out

    plain = dict(shuffle=False, jitter=False, logit=False)
    native, numpy_ = take(2, **plain), take(2, force_numpy=True, **plain)
    scale = preprocessing.Scale()
    want = [scale(torch.from_numpy(images[i * GLOW_BATCH:(i + 1) * GLOW_BATCH]).double()
                  / 255.0).float() for i in range(2)]
    r["plain_bit_equal"] = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                               for a, b in zip(native, numpy_))
    r["preprocessing_bit_equal"] = all(torch.equal(a[0], w) for a, w in zip(native, want))
    (xl, _, _), = take(1, shuffle=False, jitter=False)
    logit = preprocessing.Logit(alpha=0.05)(want[0].double()).float()
    r["logit_excess"] = excess(xl, logit, 1e-6, 1e-6)
    jittered = [take(20, seed=SEED, num_workers=w, logit=False) for w in (1, 4)]
    r["workers_bit_equal"] = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                                 for a, b in zip(*jittered))
    host = take(12, seed=SEED)
    loader = data.NativeImageLoader(images, labels, batch_size=GLOW_BATCH, seed=SEED)
    stream = data.prefetch_to_device(loader, size=2, device=DEVICE)
    on_card = [next(stream) for _ in range(12)]
    sync()
    r["prefetch_bit_equal"] = all(
        x.device.type == torch.device(DEVICE).type and torch.equal(x.cpu(), hx)
        and torch.equal(y.cpu(), hy)
        and e == he for (x, y, e), (hx, hy, he) in zip(on_card, host))
    loader.close()
    # host batches a second at the defaults (jitter and logit on)
    for what, k, kw in (("native_4_workers", LOADER_BATCHES, {}),
                        ("native_1_worker", LOADER_BATCHES // 4, {"num_workers": 1}),
                        ("plain_numpy", LOADER_NUMPY_BATCHES, {"force_numpy": True})):
        loader = data.NativeImageLoader(images, labels, batch_size=GLOW_BATCH, seed=SEED, **kw)
        next(loader)
        t0 = time.perf_counter()
        for _ in range(k):
            next(loader)
        r[f"{what}_batches_per_s"] = k / (time.perf_counter() - t0)
        loader.close()
    loader = data.NativeImageLoader(images, labels, batch_size=GLOW_BATCH, seed=SEED)
    stream = data.prefetch_to_device(loader, size=2, device=DEVICE)
    next(stream)
    sync()
    t0 = time.perf_counter()
    for _ in range(LOADER_BATCHES):
        next(stream)
    sync()
    r["prefetched_to_card_batches_per_s"] = LOADER_BATCHES / (time.perf_counter() - t0)
    loader.close()
    ok = (r["plain_bit_equal"] and r["preprocessing_bit_equal"] and r["logit_excess"] <= 0
          and r["workers_bit_equal"] and r["prefetch_bit_equal"])
    emit("loader", ok=ok, results=r,
         note="batches/s: the host's rate over the timed batches after one (native: the "
              "loader's C++ threads; prefetched: delivered on the card through pinned "
              "memory and a copy stream, ending in a synchronise)")
    if not ok:
        raise SystemExit("loader: a batch differed")


def flagship_step_reference(launches):
    """The single-process 2^14 reverse-KL step (``make_train_step``, Adam(LR))
    of ``examples.nsf_cylinder.build_model`` on the generator DP_SEED."""
    from normflows_tpu_torch.examples import nsf_cylinder
    from normflows_tpu_torch.training import make_train_step

    model = nsf_cylinder.build_model(DEVICE)
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(N))
    gen = torch.Generator(DEVICE).manual_seed(DP_SEED)
    with device_counters() as counts:
        (_, metrics), launches["train_step"] = exact_on_card(
            "make_train_step", counts, lambda: step(state, None, gen), **FLAGSHIP_STEP)
    return model, state, step, metrics


def leaves(model, what):
    """The parameters (``what="param"``) or their gradients, by name (a
    parameter without a gradient left out)."""
    return {n: (p.grad if what == "grad" else p).detach().clone()
            for n, p in model.named_parameters() if what == "param" or p.grad is not None}


FLAGSHIP_STEP = {"rqs_transposed_inverse": 2 * LAYERS,
                 "rqs_transposed_backward_inverse": 2 * LAYERS}


def parallel_rank(rank, root, address):
    """A rank of the world of two on the one card (gloo over CUDA tensors:
    NCCL refuses two ranks on one card), spawned by phase_data_parallel: the
    flagship's make_reverse_kld_step at 2^14 on the generator DP_SEED, then
    HAIS through parallel_chain_sample, then the sharded tier
    (``sharded_modes``); its results go to ``root``."""
    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.examples import nsf_cylinder, snf_hais

    parallel.initialize_distributed(address, 2, rank, device=DEVICE, backend="gloo",
                                    timeout=600)
    mesh = parallel.make_mesh(devices=DEVICE)
    model = nsf_cylinder.build_model(DEVICE)
    state, step = parallel.make_reverse_kld_step(
        model, torch.optim.Adam(model.parameters(), lr=LR), mesh, N)
    gen = torch.Generator(DEVICE).manual_seed(DP_SEED)
    out = {}
    with device_counters() as counts:
        (_, metrics), out["launches"] = exact_on_card(
            f"rank {rank}'s data-parallel step", counts, lambda: step(state, gen),
            **FLAGSHIP_STEP)
        out["loss"], out["finite"] = float(metrics["loss"]), metrics["finite"]
        out["grads"] = {n: g.cpu() for n, g in leaves(model, "grad").items()}
        out["params"] = {n: p.cpu() for n, p in leaves(model, "param").items()}
        run = parallel.parallel_chain_sample(snf_hais.build_hais(DEVICE), mesh, CHAINS)
        (z, log_w), out["chain_launches"] = exact_on_card(f"rank {rank}'s chains", counts,
                                                          lambda: run(CHAIN_SEED))
        out["chains"] = (z.cpu(), log_w.cpu())
        sharded_modes(rank, root, counts, out)
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_of_two(root):
    """Spawn the world of two once (parallel_rank), its files in ``root``; a
    rank that fails raises here.  Returns each rank's results."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(root, f"127.0.0.1:{free_port()}"), nprocs=2,
                       join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True)
             for r in range(2)]
    return ranks, seconds


def phase_data_parallel(root):
    """The flagship's data-parallel reverse-KL step at 2^14, Adam(LR): the
    world of 1 (NCCL, in-process) bit-equal to make_train_step, its step
    time against make_train_step's; the world of 2 on the one card (its
    files in ``root``) against the single-process step; the planar launches
    a step a rank.  Returns the world of two's results (phase chains reads
    its chains, the sharded phases their parts) and the launches."""
    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.examples import nsf_cylinder
    from normflows_tpu_torch.parallel.data_parallel import average_over

    launches = {}
    ref, ref_state, ref_step, ref_metrics = flagship_step_reference(launches)
    mesh = parallel.make_mesh(devices=DEVICE)
    model = nsf_cylinder.build_model(DEVICE)
    init = leaves(model, "param")
    state, step = parallel.make_reverse_kld_step(
        model, torch.optim.Adam(model.parameters(), lr=LR), mesh, N)
    gen = torch.Generator(DEVICE).manual_seed(DP_SEED)
    with device_counters() as counts:
        (_, metrics), launches["world_1"] = exact_on_card(
            "data-parallel step", counts, lambda: step(state, gen), **FLAGSHIP_STEP)
    r = {"backend": torch.distributed.get_backend(), "world": torch.distributed.get_world_size(),
         "world_1": {
             "loss": float(metrics["loss"]), "loss_make_train_step": float(ref_metrics["loss"]),
             "loss_bit_equal": bool(torch.equal(metrics["loss"], ref_metrics["loss"])),
             "grads_bit_equal": all(torch.equal(a, b) for a, b in zip(
                 leaves(model, "grad").values(), leaves(ref, "grad").values())),
             "params_bit_equal": all(torch.equal(a, b) for a, b in zip(
                 leaves(model, "param").values(), leaves(ref, "param").values()))}}
    want = {n: g.cpu() for n, g in leaves(ref, "grad").items()}
    want_loss = float(ref_metrics["loss"])
    # step ms: make_train_step's eager step against the world of 1's, in turns
    times = {"make_train_step": [], "data_parallel": []}
    for route in ("make_train_step", "data_parallel") * 3:
        fn = (lambda: ref_step(ref_state, None, gen)) if route == "make_train_step" \
            else (lambda: step(state, gen))
        times[route].append(host_ms(fn, reps=DP_TIMED, warmup=1))
    r["step_ms"] = {k: float(np.median(v)) for k, v in times.items()}
    r["step_ms_blocks"] = times
    r["samples_per_s"] = {k: N / (v / 1e3) for k, v in r["step_ms"].items()}
    r["step_ms_difference"] = r["step_ms"]["data_parallel"] - r["step_ms"]["make_train_step"]
    # the gradient average alone (a flat cat, the all-reduce, the divide, the
    # copies back) on the step's gradients: host and device time
    average = average_over(mesh, "data", list(model.parameters()))
    loss = metrics["loss"]
    r["average_ms"] = host_ms(lambda: average(loss), reps=DP_AVERAGE_REPS)
    r["average_device_ms"] = cuda_ms(lambda: average(loss), reps=DP_AVERAGE_REPS)
    r["global_draw_floats_a_rank"] = N * 2
    del ref, ref_state, model, state
    ranks, seconds = world_of_two(root)
    r["world_2"] = {"spawn_and_run_seconds": seconds,
                    "sharded_modes_seconds": ranks[0]["sharded_seconds"],
                    "launches_per_rank": [x["launches"] for x in ranks]}
    r["launches_per_step"] = {"make_train_step": launches["train_step"],
                              "world_1": launches["world_1"]}
    r0, r1 = ranks
    rel = {n: float((r0["grads"][n] - g).norm() / g.norm()) for n, g in want.items()
           if float(g.norm()) > 0}
    worst = max(rel, key=rel.get)
    # Adam's update on rank 0's averaged gradient, from the initial weights
    adam = nsf_cylinder.build_model(DEVICE)
    with torch.no_grad():
        for n, p in adam.named_parameters():
            p.copy_(init[n])
            p.grad = r0["grads"][n].to(DEVICE)
    torch.optim.Adam(adam.parameters(), lr=LR).step()
    w2 = r["world_2"]
    w2.update({
        "loss": r0["loss"], "loss_single_process": want_loss,
        "loss_rel": abs(r0["loss"] - want_loss) / abs(want_loss),
        "leaves": len(want), "worst_leaf": worst, "worst_leaf_rel": rel[worst],
        "zero_leaves_zero": all(bool((r0["grads"][n] == 0).all()) for n in want if n not in rel),
        "ranks_bit_equal": r0["loss"] == r1["loss"] and all(
            torch.equal(r0[k][n], r1[k][n]) for k in ("grads", "params") for n in want),
        "adam_update_bit_equal": all(torch.equal(p.detach().cpu(), r0["params"][n])
                                     for n, p in adam.named_parameters()),
        "finite": r0["finite"] and r1["finite"]})
    ok = (r["world_1"]["loss_bit_equal"] and r["world_1"]["grads_bit_equal"]
          and r["world_1"]["params_bit_equal"] and w2["finite"]
          and w2["loss_rel"] <= DP2_LOSS_REL and w2["worst_leaf_rel"] <= DP2_GRAD_REL
          and w2["zero_leaves_zero"] and w2["ranks_bit_equal"] and w2["adam_update_bit_equal"])
    emit("data_parallel", ok=ok, results=r,
         bars={"world_1": "bit-equal to make_train_step", "world_2_loss_rel": DP2_LOSS_REL,
               "world_2_grad_leaf_rel": DP2_GRAD_REL},
         note=f"step_ms: host medians of {DP_TIMED} steps each ending in a synchronise, in "
              "six blocks alternating (train, data-parallel), the median block; "
              f"average_ms / average_device_ms: the gradient average alone, host median of "
              f"{DP_AVERAGE_REPS} calls ending in a synchronise / CUDA events over as many; "
              "each rank draws the global 2^14 x 2 base floats; the world of 2 runs on one "
              "card with gloo (both ranks' kernels share it), so it is held for values, not "
              "timed")
    if not ok:
        raise SystemExit("data_parallel: a data-parallel step disagreed with the "
                         "single-process step")
    total = {}
    for got in [launches["train_step"], launches["world_1"]] + [x["launches"] for x in ranks]:
        add_launches(total, got)
    return ranks, total


def phase_glow_loader():
    """Glow model A (``examples.glow_image.build_glow``, f32), forward-KL
    ``make_data_parallel_step`` at batch 128 with Adamax as in glow_image,
    the world of 1: fed from ``NativeImageLoader(logit=False)`` over the
    uint8 images (the example's Scale(255/256) and Jitter(1/256) law)
    through ``prefetch_to_device``, against the same steps on a batch
    already on the card: images/s and busy share over the same steps."""
    from normflows_tpu_torch import data, parallel
    from normflows_tpu_torch.examples import glow_image

    images, labels = uint8_images(4096)
    x = torch.from_numpy(images).float() / 255.0
    y = torch.from_numpy(labels)
    model = glow_image.build_glow(GLOW_L, GLOW_K, GLOW_HIDDEN, num_classes=GLOW_CLASSES,
                                  device=DEVICE, seed=SEED)
    model.init_actnorm(*(t.to(DEVICE) for t in glow_image.init_inputs(x, y, GLOW_BATCH,
                                                                       SEED)))
    state, step = parallel.make_data_parallel_step(
        model, glow_image.make_optimizer(model, 1e-3),
        lambda m, b, g: m.forward_kld(b[0], b[1]), parallel.make_mesh(devices=DEVICE))
    loader = data.NativeImageLoader(images, labels, batch_size=GLOW_BATCH, seed=SEED,
                                    logit=False)
    stream = data.prefetch_to_device(loader, size=2, device=DEVICE)
    resident = next(stream)[:2]
    losses = []

    def fed(k):
        for _ in range(k):
            xb, yb, _ = next(stream)
            losses.append(step(state, (xb, yb))[1]["loss"])

    def on_card(k):
        for _ in range(k):
            losses.append(step(state, resident)[1]["loss"])

    fed(2)
    on_card(2)
    sync()
    times = {"loader": [], "on_card": []}
    for route in ("loader", "on_card", "on_card", "loader"):
        fn = fed if route == "loader" else on_card
        t0 = time.perf_counter()
        fn(GLOW_LOADER_STEPS)
        sync()
        times[route].append((time.perf_counter() - t0) * 1e3 / GLOW_LOADER_STEPS)
    r = {"batch": GLOW_BATCH, "timed_steps": GLOW_LOADER_STEPS, "step_ms_blocks": times,
         "step_ms": {k: float(np.mean(v)) for k, v in times.items()}}
    r["images_per_s"] = {k: GLOW_BATCH / (v / 1e3) for k, v in r["step_ms"].items()}
    r["loader_over_on_card"] = r["images_per_s"]["loader"] / r["images_per_s"]["on_card"]
    for route, fn in (("loader", fed), ("on_card", on_card)):
        r[f"profiled_{route}"] = {"steps": GLOW_PROFILED, **busy(lambda: fn(GLOW_PROFILED))}
    loader.close()
    losses = torch.stack(losses).cpu()
    r["all_finite"] = bool(torch.isfinite(losses).all())
    r["loss_first"], r["loss_last"] = float(losses[0]), float(losses[-1])
    ok = r["all_finite"]
    emit("glow_loader", ok=ok, results=r,
         note="step_ms: host time of each block of timed steps ending in a synchronise, over "
              "the steps, blocks in turns (loader, on card, on card, loader); profiled_*: "
              f"{GLOW_PROFILED} more steps of each feed under torch.profiler tracing the device "
              "only: device_ms the kernels' time, wall_ms the same steps' host time, "
              "busy_share their ratio, copy_ms the copies' device time")
    if not ok:
        raise SystemExit("glow_loader: a loss was not finite")


def phase_chains(ranks):
    """HAIS of ``examples.snf_hais`` (4,096 chains, 30 rungs) through
    ``parallel_chain_sample``: the world of 1 bit-equal to ``HAIS.sample``
    on the same generator, the world of 2's shards (phase data_parallel)
    stacked in rank order against it, log Z against the quadrature."""
    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.examples import snf_hais

    hais = snf_hais.build_hais(DEVICE)
    with torch.no_grad():
        want_z, want_w = hais.sample(CHAINS, generator=torch.Generator(DEVICE).manual_seed(
            CHAIN_SEED))
    run = parallel.parallel_chain_sample(hais, parallel.make_mesh(devices=DEVICE), CHAINS)
    with device_counters() as counts:
        (z1, w1), got = exact_on_card("chains", counts, lambda: run(CHAIN_SEED))
    z2 = torch.cat([x["chains"][0] for x in ranks]).to(DEVICE)
    w2 = torch.cat([x["chains"][1] for x in ranks]).to(DEVICE)
    quad = snf_hais.two_moons_log_z()

    def chains_off(z, w):
        bad_z = (z - want_z).abs() > CHAIN_Z_TOL[0] + CHAIN_Z_TOL[1] * want_z.abs()
        bad_w = (w - want_w).abs() > CHAIN_W_TOL[0] + CHAIN_W_TOL[1] * want_w.abs()
        return int((bad_z.any(1) | bad_w).sum())

    r = {"chains": CHAINS, "rungs": len(hais.layers),
         "world_1_bit_equal": bool(torch.equal(z1, want_z) and torch.equal(w1, want_w)),
         "world_2_chains_off": chains_off(z2, w2),
         "world_2_chains_bit_equal": int(((z2 == want_z).all(1) & (w2 == want_w)).sum()),
         "world_2_max_abs_z": float((z2 - want_z).abs().max()),
         "world_2_max_abs_log_w": float((w2 - want_w).abs().max()),
         "launches_per_rank": [x["chain_launches"] for x in ranks],
         "quadrature_log_z": quad}
    for name, (z, w) in (("world_1", (z1, w1)), ("world_2", (z2, w2))):
        est = snf_hais.estimates(z, w)
        bar = max(0.02, 4 * est["log_z_se"])
        r[f"{name}_log_z"] = {"log_z": est["log_z"], "gap": abs(est["log_z"] - LOG_Z),
                              "bar": bar, "ess": est["ess"],
                              "ok": abs(est["log_z"] - LOG_Z) <= bar and est["finite_weights"]}
    ok = (r["world_1_bit_equal"] and r["world_2_chains_off"] == 0
          and r["world_1_log_z"]["ok"] and r["world_2_log_z"]["ok"]
          and abs(quad - LOG_Z) < 1e-6)
    emit("chains", ok=ok, results=r, bars={"world_2_z": CHAIN_Z_TOL,
                                           "world_2_log_w": CHAIN_W_TOL,
                                           "log_z_gap_at_most": "max(0.02, 4 SE)"})
    if not ok:
        raise SystemExit("chains: a chain or log Z missed its bar")
    return {k: v for k, v in got.items() if v}


# The sharded tier (tensor parallelism, FSDP, pipelining, sharded
# checkpoints): the flagship at full width, two f32 reverse-KL steps at 2^14
# with Adam(LR) from bench.py's init (the first moves the zero final layers,
# so that the second's hidden-layer gradients are not zero), in the world of
# two of phase_data_parallel (gloo over CUDA tensors: it carries all-reduce,
# all-gather, reduce-scatter and broadcast there, not send / recv) and, for
# tensor parallelism and FSDP, in the world of 1 (NCCL, in-process).  The
# world of 2's bars: the loss and each gradient leaf of the second step are
# phase_data_parallel's (float32 summation order: the loss within
# DP2_LOSS_REL, each leaf within DP2_GRAD_REL of its own norm, the leaves
# that are 0 there exactly 0); the parameters after the second Adam step
# each within SHARDED_PARAM_REL of the norm of the single-process leaf's
# move over the two steps (Adam divides each gradient entry by its root
# mean square, so the relative gap of a small entry passes whole into its
# update: two orders above the gradients' bar), the leaves that did not
# move bit-equal; the ranks' losses, and their copies of every replicated
# gradient and parameter, bit-equal.
SHARDED_SEED = SEED + 192  # the generator of the sharded steps' draws
SHARDED_PARAM_REL = 1e-3
SHARDED_STEPS = 2
SHARDED_TIMED = 4  # steps of each route in each of four alternating blocks
PIPE_STAGES, PIPE_MICRO = 2, 4  # 6 layers a stage, microbatches of 4,096
PIPE_TOL = 1e-5  # make_pipeline_apply against the layers in turn: z and log-det
PIPE_STEP = {k: PIPE_MICRO * v // PIPE_STAGES for k, v in FLAGSHIP_STEP.items()}


def sharded_blocks(model, what="param", optimizer=None):
    """``{name: (local block, sharded dim or None)}`` of ``model``'s
    parameters (``what="param"``), their gradients (``"grad"``) or, with
    ``optimizer``, their Adam moments (``{name: {key: ...}}``), on the CPU."""
    from torch.distributed.tensor import DTensor, Shard

    def block(t, ref):
        dims = [p.dim for p in getattr(ref, "placements", ()) if isinstance(p, Shard)]
        local = t.to_local() if isinstance(t, DTensor) else t
        return local.detach().cpu().clone(), (dims[0] if dims else None)

    out = {}
    for name, p in model.named_parameters():
        if optimizer is not None:
            out[name] = {k: block(v, p) for k, v in optimizer.state[p].items() if k != "step"}
        elif what == "grad":
            if p.grad is not None:
                out[name] = block(p.grad, p)
        else:
            out[name] = block(p, p)
    return out


def whole(ranks_blocks):
    """The whole tensors from the ranks' ``sharded_blocks``: a sharded leaf
    concatenated in rank order, a replicated one rank 0's (the ranks' copies
    must be equal: ``replicas_equal``)."""
    first = ranks_blocks[0]
    out = {}
    for name, v in first.items():
        if isinstance(v, dict):
            out[name] = whole([{k: b[name][k] for k in v} for b in ranks_blocks])
            continue
        t, dim = v
        out[name] = t if dim is None else torch.cat([b[name][0] for b in ranks_blocks], dim)
    return out


def replicas_equal(ranks_blocks):
    """Whether every replicated leaf is bit-equal across the ranks."""
    return all(torch.equal(v[0], b[name][0]) for name, v in ranks_blocks[0].items()
               if not isinstance(v, dict) and v[1] is None for b in ranks_blocks[1:])


def local_bytes(model, optimizer=None):
    """Bytes of ``model``'s parameters this rank holds (and, with
    ``optimizer``, of its Adam moments)."""
    from torch.distributed.tensor import DTensor

    def n(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.numel() * t.element_size()

    total = sum(n(p) for p in model.parameters())
    if optimizer is not None:
        total += sum(n(v) for st in optimizer.state.values() for k, v in st.items()
                     if k != "step")
    return total


def sharded_steps(step, state, counts, what, want, gen, batch=None):
    """SHARDED_STEPS steps, each with exact launches; the last metrics and
    the losses."""
    losses, launches = [], {}
    for i in range(SHARDED_STEPS):
        (state, metrics), got = exact_on_card(f"{what}, step {i}", counts,
                                              lambda: step(state, batch, gen), **want)
        add_launches(launches, got)
        losses.append(float(metrics["loss"]))
    return state, metrics, losses, launches


def adam_factory(params):
    return torch.optim.Adam(params, lr=LR)


def sharded_modes(rank, root, counts, out):
    """A rank's part of the sharded tier (module comment above): tensor
    parallelism over {"model": 2}, FSDP over {"data": 2}, the pipeline over
    {"stage": 2}, the tensor-parallel state checkpointed, restored into a
    fresh step's state and onto FSDP's layout, and one step resumed from it,
    the pipeline's state checkpointed; its readings go into ``out``."""
    from normflows_tpu_torch import parallel, training
    from normflows_tpu_torch.examples import nsf_cylinder

    seconds = {}

    def gen(seed=SHARDED_SEED):
        return torch.Generator(DEVICE).manual_seed(seed)

    t0 = time.perf_counter()
    mesh = parallel.make_mesh({"model": 2}, devices=DEVICE)
    tp, tp_step = parallel.make_tensor_parallel_step(
        nsf_cylinder.build_model(DEVICE), adam_factory, reverse_kld_loss(N), mesh)
    tp, metrics, losses, launches = sharded_steps(
        tp_step, tp, counts, f"rank {rank}'s tensor-parallel step", FLAGSHIP_STEP, gen())
    out["tp"] = {"losses": losses, "launches": launches, "collectives": metrics["collectives"],
                 "grads": sharded_blocks(tp.model, "grad"), "params": sharded_blocks(tp.model),
                 "param_bytes": local_bytes(tp.model),
                 "state_bytes": local_bytes(tp.model, tp.optimizer)}
    seconds["tp"] = time.perf_counter() - t0

    # the checkpoint of that state, restored into a fresh step's state, and
    # one step of each from it
    t0 = time.perf_counter()
    training.save_checkpoint(os.path.join(root, "tp_checkpoint"), tp)
    out["ckpt_saved"] = {"params": sharded_blocks(tp.model),
                         "moments": sharded_blocks(tp.model, optimizer=tp.optimizer),
                         "step": tp.step}
    fresh, fresh_step = parallel.make_tensor_parallel_step(
        nsf_cylinder.build_model(DEVICE), adam_factory, reverse_kld_loss(N), mesh)
    fresh = training.restore_checkpoint(os.path.join(root, "tp_checkpoint"), fresh)
    restored = sharded_blocks(fresh.model)
    restored_moments = sharded_blocks(fresh.model, optimizer=fresh.optimizer)
    out["ckpt_restored_equal"] = (
        fresh.step == tp.step
        and all(torch.equal(restored[n][0], v[0]) for n, v in out["ckpt_saved"]["params"].items())
        and all(torch.equal(restored_moments[n][k][0], v[0])
                for n, m in out["ckpt_saved"]["moments"].items() for k, v in m.items()))
    tp, m1 = tp_step(tp, None, gen(SHARDED_SEED + 1))
    fresh, m2 = fresh_step(fresh, None, gen(SHARDED_SEED + 1))
    out["ckpt_resumed"] = {
        "losses": (float(m1["loss"]), float(m2["loss"])),
        "bit_equal": bool(torch.equal(m1["loss"], m2["loss"])) and all(
            torch.equal(a[0], b[0]) for a, b in zip(sharded_blocks(tp.model).values(),
                                                     sharded_blocks(fresh.model).values()))}
    del fresh, tp
    data = parallel.make_mesh({"data": 2}, devices=DEVICE)
    rows = parallel.batch_sharding(data, 2)

    def fsdp_loss(m, batch, generator):
        return m.reverse_kld(N, z_sharding=rows, generator=generator)

    onto, _ = parallel.make_fsdp_step(nsf_cylinder.build_model(DEVICE), adam_factory,
                                      fsdp_loss, data)
    onto = training.restore_checkpoint(os.path.join(root, "tp_checkpoint"), onto)
    out["ckpt_onto_fsdp"] = {"params": sharded_blocks(onto.model),
                             "moments": sharded_blocks(onto.model, optimizer=onto.optimizer),
                             "step": onto.step}
    del onto
    seconds["sharded_checkpoint"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fsdp, fsdp_step = parallel.make_fsdp_step(nsf_cylinder.build_model(DEVICE), adam_factory,
                                              fsdp_loss, data)
    fsdp, metrics, losses, launches = sharded_steps(
        fsdp_step, fsdp, counts, f"rank {rank}'s FSDP step", FLAGSHIP_STEP, gen())
    out["fsdp"] = {"losses": losses, "launches": launches,
                   "collectives": metrics["collectives"],
                   "grads": sharded_blocks(fsdp.model, "grad"),
                   "params": sharded_blocks(fsdp.model),
                   "param_bytes": local_bytes(fsdp.model),
                   "state_bytes": local_bytes(fsdp.model, fsdp.optimizer)}
    del fsdp
    seconds["fsdp"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stages = parallel.make_mesh({"stage": PIPE_STAGES}, devices=DEVICE)
    flagship = nsf_cylinder.build_model(DEVICE)
    z = flagship.q0.sample_and_log_prob(N, generator=gen(SHARDED_SEED + 3))[0]
    apply = parallel.make_pipeline_apply(flagship.flows, stages, num_microbatches=PIPE_MICRO)
    with torch.no_grad():
        (zo, ld), out["pipe_apply_launches"] = exact_on_card(
            f"rank {rank}'s pipelined flows", counts, lambda: apply(z),
            rqs_transposed_inverse=PIPE_STEP["rqs_transposed_inverse"])
    out["pipe_apply"] = (zo.cpu(), ld.cpu(), dict(apply.stages.counts))
    pipe, pipe_step = parallel.make_pipeline_train_step(
        nsf_cylinder.build_model(DEVICE), adam_factory, stages, num_microbatches=PIPE_MICRO,
        objective="reverse_kld", num_samples=N)
    g = gen()
    with KernelCalls() as calls:
        (pipe, metrics), first = exact_on_card(f"rank {rank}'s pipelined step 0", counts,
                                               lambda: pipe_step(pipe, None, g), **PIPE_STEP)
    out["pipe_kernels"] = hold_calls("pipeline", calls, {})
    (pipe, metrics2), second = exact_on_card(f"rank {rank}'s pipelined step 1", counts,
                                             lambda: pipe_step(pipe, None, g), **PIPE_STEP)
    launches = dict(first)
    add_launches(launches, second)
    out["pipe"] = {"losses": [float(metrics["loss"]), float(metrics2["loss"])],
                   "launches_per_step": second, "launches": launches,
                   "collectives": metrics2["collectives"], "stage": rank,
                   "grads": {n: p.grad.detach().cpu().clone()
                             for n, p in pipe.model.named_parameters() if p.grad is not None},
                   "params": {n: p.detach().cpu().clone()
                              for n, p in pipe.model.named_parameters()},
                   "held_layers": len(pipe.model.flows),
                   "param_bytes": local_bytes(pipe.model),
                   "state_bytes": local_bytes(pipe.model, pipe.optimizer)}
    seconds["pipeline"] = time.perf_counter() - t0
    # every stage writes its layers (phase_sharded_checkpoint restores them)
    t0 = time.perf_counter()
    training.save_checkpoint(os.path.join(root, "pipe_checkpoint"), pipe)
    seconds["sharded_checkpoint"] += time.perf_counter() - t0
    del pipe
    out["sharded_seconds"] = seconds


def flagship_two_steps():
    """The single-process reference of the sharded phases:
    ``make_train_step`` on ``examples.nsf_cylinder.build_model``, Adam(LR),
    SHARDED_STEPS reverse-KL steps on the generator SHARDED_SEED; its
    model, state, step, losses, last gradients and initial parameters (on
    the CPU)."""
    from normflows_tpu_torch.examples import nsf_cylinder
    from normflows_tpu_torch.training import make_train_step

    model = nsf_cylinder.build_model(DEVICE)
    init = {n: p.cpu() for n, p in leaves(model, "param").items()}
    state, step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                  reverse_kld_loss(N))
    gen = torch.Generator(DEVICE).manual_seed(SHARDED_SEED)
    losses = []
    for _ in range(SHARDED_STEPS):
        state, metrics = step(state, None, gen)
        losses.append(float(metrics["loss"]))
    grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return model, state, step, losses, grads, init


def gaps(got, want):
    """The gradient ``got`` against ``want``: each leaf's gap over its own
    norm, the worst of them (held to DP2_GRAD_REL); the whole gradient's gap
    over its norm; whether the leaves that are 0 in ``want`` are 0."""
    whole_norm = float(torch.cat([w.reshape(-1) for w in want.values()]).norm())
    gap = {n: float((got[n].to(w.device) - w).norm()) for n, w in want.items()}
    own = {n: gap[n] / float(w.norm()) for n, w in want.items() if float(w.norm()) > 0}
    worst = max(own, key=own.get)
    return {"leaves": len(want), "nonzero_leaves": len(own),
            "whole_gradient_rel": float(np.sqrt(sum(g * g for g in gap.values()))) / whole_norm,
            "worst_leaf": worst, "worst_leaf_rel": own[worst],
            "zero_leaves_zero": all(bool((got[n] == 0).all()) for n in want if n not in own)}


def param_gaps(got, want, init):
    """The parameters ``got`` after the steps against ``want``, the
    single-process ones: each leaf's gap over the norm of ``want``'s move
    from ``init``, the worst of them (held to SHARDED_PARAM_REL), the
    largest gap of an entry; whether the leaves that did not move are
    bit-equal."""
    moved = {n: float((w - init[n]).norm()) for n, w in want.items()}
    rel = {n: float((got[n] - w).norm()) / moved[n] for n, w in want.items() if moved[n] > 0}
    worst = max(rel, key=rel.get)
    return {"worst_param": worst, "worst_param_rel": rel[worst],
            "max_abs_param": max(float((got[n] - w).abs().max()) for n, w in want.items()),
            "unmoved_params_equal": all(torch.equal(got[n], want[n]) for n in want
                                        if n not in rel)}


def world_1_against_train_step(make, counts, what):
    """A sharded step over a mesh of one rank (NCCL, in-process): the
    SHARDED_STEPS steps bit-equal to ``make_train_step``'s (losses, every
    gradient, every parameter), then its step time against it, in turns."""
    from torch.distributed.tensor import DTensor

    ref_model, ref_state, ref_step, ref_losses, _, _ = flagship_two_steps()
    state, step = make()
    gen = torch.Generator(DEVICE).manual_seed(SHARDED_SEED)
    state, metrics, losses, launches = sharded_steps(step, state, counts, what,
                                                     FLAGSHIP_STEP, gen)

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    got = dict(state.model.named_parameters())
    r = {"losses": losses, "losses_make_train_step": ref_losses,
         "losses_bit_equal": losses == ref_losses,
         "grads_bit_equal": all(torch.equal(local(got[n].grad), p.grad)
                                for n, p in ref_model.named_parameters() if p.grad is not None),
         "params_bit_equal": all(torch.equal(local(got[n]).detach(), p.detach())
                                 for n, p in ref_model.named_parameters()),
         "collectives_per_step": metrics["collectives"],
         "param_bytes": local_bytes(state.model),
         "state_bytes": local_bytes(state.model, state.optimizer),
         "state_bytes_one_process": local_bytes(ref_model, ref_state.optimizer)}
    times = {"make_train_step": [], "sharded": []}
    for route in ("make_train_step", "sharded", "sharded", "make_train_step"):
        fn = (lambda: ref_step(ref_state, None, gen)) if route == "make_train_step" \
            else (lambda: step(state, None, gen))
        times[route].append(host_ms(fn, reps=SHARDED_TIMED, warmup=1))
    r["step_ms"] = {k: float(np.median(v)) for k, v in times.items()}
    r["step_ms_blocks"] = times
    return r, launches


def world_2_against_train_step(ranks, key, ref):
    """The world of two's ``key`` steps (each rank's blocks) against the
    single-process steps ``ref`` (flagship_two_steps): the losses, every
    gradient leaf over its norm, every parameter after the last step over
    its move; the ranks' copies of the replicated leaves."""
    model, _, _, want_losses, want_grads, init = ref
    r0, r1 = (x[key] for x in ranks)
    grads = whole([r0["grads"], r1["grads"]])
    params = whole([r0["params"], r1["params"]])
    want_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return {"losses": r0["losses"], "losses_single_process": want_losses,
            "loss_rel": abs(r0["losses"][-1] - want_losses[-1]) / abs(want_losses[-1]),
            "ranks_losses_equal": r0["losses"] == r1["losses"],
            "replicated_grads_equal": replicas_equal([r0["grads"], r1["grads"]]),
            "replicated_params_equal": replicas_equal([r0["params"], r1["params"]]),
            "launches_per_rank": [r0["launches"], r1["launches"]],
            "collectives_per_step": r0["collectives"],
            "param_bytes_per_rank": [r0["param_bytes"], r1["param_bytes"]],
            "state_bytes_per_rank": [r0["state_bytes"], r1["state_bytes"]],
            **gaps(grads, want_grads), **param_gaps(params, want_params, init)}


def world_2_ok(w):
    return (w["loss_rel"] <= DP2_LOSS_REL and w["worst_leaf_rel"] <= DP2_GRAD_REL
            and w["zero_leaves_zero"] and w["worst_param_rel"] <= SHARDED_PARAM_REL
            and w["unmoved_params_equal"] and w["ranks_losses_equal"]
            and w["replicated_grads_equal"] and w["replicated_params_equal"])


WORLD_2_BARS = {"world_2_loss_rel": DP2_LOSS_REL,
                "world_2_each_gradient_leaf_over_its_norm": DP2_GRAD_REL,
                "world_2_each_parameter_leaf_over_its_move": SHARDED_PARAM_REL,
                "world_2_ranks": "losses and replicated leaves bit-equal"}


def phase_tensor_parallel(ranks, ref):
    """``parallel.make_tensor_parallel_step`` on the flagship (each MADE's
    hidden layers column- and row-parallel): over {"model": 1} (NCCL)
    bit-equal to make_train_step, its step time against it; over {"model":
    2} in the world of two (each rank 256 of the 512 hidden units) against
    the single-process steps; collectives a step, parameter bytes a rank."""
    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.examples import nsf_cylinder

    model = ref[0]
    with device_counters() as counts:
        r1, launches = world_1_against_train_step(
            lambda: parallel.make_tensor_parallel_step(
                nsf_cylinder.build_model(DEVICE), adam_factory, reverse_kld_loss(N),
                parallel.make_mesh({"model": 1}, devices=DEVICE)),
            counts, "tensor-parallel step over {model: 1}")
    w2 = world_2_against_train_step(ranks, "tp", ref)
    w2["hidden_width_a_rank"] = int(ranks[0]["tp"]["params"][
        "flows.0.mprqat.autoregressive_net.blocks.0.linear_0.weight"][0].shape[0])
    w2["param_bytes_one_process"] = sum(p.numel() * 4 for p in model.parameters())
    ok = (r1["losses_bit_equal"] and r1["grads_bit_equal"] and r1["params_bit_equal"]
          and world_2_ok(w2) and w2["hidden_width_a_rank"] == HIDDEN // 2)
    emit("tensor_parallel", ok=ok, results={"world_1": r1, "world_2": w2,
                                           "world_2_seconds": ranks[0]["sharded_seconds"]["tp"]},
         bars={"world_1": "bit-equal to make_train_step", **WORLD_2_BARS},
         note=f"{SHARDED_STEPS} f32 reverse-KL steps at 2^14 from bench.py's init, the last "
              "held; step_ms: host medians of blocks of steps ending in a synchronise, in "
              "turns; the world of 2 shares the one card over gloo, held for values, not "
              "timed; collectives: a step's on each mesh axis by kind")
    if not ok:
        raise SystemExit("tensor_parallel: a tensor-parallel step disagreed with the "
                         "single-process step")
    total = dict(launches)
    for x in ranks:
        add_launches(total, x["tp"]["launches"])
    return total


def phase_fsdp(ranks, ref):
    """``parallel.make_fsdp_step`` on the flagship (the leaves of at least
    2^14 elements and their Adam moments sharded): over {"data": 1} (NCCL)
    bit-equal to make_train_step; over {"data": 2} in the world of two (each
    rank its 2^13 rows of the global draw) against the single-process steps;
    bytes of parameters and moments a rank against one process's."""
    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.examples import nsf_cylinder

    model = ref[0]
    mesh = parallel.make_mesh({"data": 1}, devices=DEVICE)
    rows = parallel.batch_sharding(mesh, 2)
    with device_counters() as counts:
        r1, launches = world_1_against_train_step(
            lambda: parallel.make_fsdp_step(
                nsf_cylinder.build_model(DEVICE), adam_factory,
                lambda m, b, g: m.reverse_kld(N, z_sharding=rows, generator=g), mesh),
            counts, "FSDP step over {data: 1}")
    w2 = world_2_against_train_step(ranks, "fsdp", ref)
    one = r1["state_bytes_one_process"]
    w2["state_bytes_over_one_process"] = [b / one for b in w2["state_bytes_per_rank"]]
    big = sum(p.numel() for p in model.parameters() if p.numel() >= 2**14)
    w2["share_of_parameters_in_leaves_of_2^14"] = big / sum(p.numel()
                                                            for p in model.parameters())
    ok = (r1["losses_bit_equal"] and r1["grads_bit_equal"] and r1["params_bit_equal"]
          and world_2_ok(w2) and max(w2["state_bytes_over_one_process"]) < 0.6)
    emit("fsdp", ok=ok, results={"world_1": r1, "world_2": w2,
                                "world_2_seconds": ranks[0]["sharded_seconds"]["fsdp"]},
         bars={"world_1": "bit-equal to make_train_step", **WORLD_2_BARS,
               "state_bytes_over_one_process_below": 0.6},
         note="state bytes: the parameters and Adam's two moments a rank holds between "
              "steps (the gathered whole leaves live only inside a step)")
    if not ok:
        raise SystemExit("fsdp: an FSDP step disagreed with the single-process step, or a "
                         "rank held more than 0.6 of one process's state")
    total = dict(launches)
    for x in ranks:
        add_launches(total, x["fsdp"]["launches"])
    return total


def phase_pipeline(ranks, ref):
    """``parallel.make_pipeline_apply`` and ``make_pipeline_train_step`` on
    the flagship in the world of two: PIPE_STAGES stages of 6 layers,
    PIPE_MICRO microbatches of 4,096: the pipelined flows against the layers
    in turn, two reverse-KL steps' losses, each stage's gradients and its
    parameters after them against the single-process steps (the world of
    two's bars), the stages' copies of the base's parameters bit-equal, each
    stage's planar launches exact (2 x 6 x 4 a direction a step), its kernel
    calls against their plain versions."""
    from normflows_tpu_torch.examples import nsf_cylinder

    model, _, _, losses, grads, init = ref
    flagship = nsf_cylinder.build_model(DEVICE)
    z = flagship.q0.sample_and_log_prob(
        N, generator=torch.Generator(DEVICE).manual_seed(SHARDED_SEED + 3))[0]
    with torch.no_grad():
        zs, lds = flagship.forward_and_log_det(z)
    zs, lds = zs.cpu(), lds.cpu()
    per = LAYERS // PIPE_STAGES
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    r = {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO, "microbatch": N // PIPE_MICRO,
         "apply": [], "steps": [], "kernel_calls": [x["pipe_kernels"] for x in ranks],
         "world_2_seconds": ranks[0]["sharded_seconds"]["pipeline"]}
    ok = True
    for x in ranks:
        zo, ld, broadcasts = x["pipe_apply"]
        a = {"max_abs_z": float((zo - zs).abs().max()), "max_abs_log_det": float(
            (ld - lds).abs().max()), "z_excess": excess(zo, zs, PIPE_TOL, PIPE_TOL),
             "log_det_excess": excess(ld, lds, PIPE_TOL, PIPE_TOL),
             "broadcasts": broadcasts, "launches": x["pipe_apply_launches"]}
        r["apply"].append(a)
        p = x["pipe"]
        s = p["stage"]

        def mine(n):
            """Whether stage s holds the leaf ``n``: its layers, the base."""
            return not n.startswith("flows.") or int(n.split(".")[1]) // per == s

        want = {n: g for n, g in grads.items() if mine(n)}
        same = set(p["grads"]) == set(want) and set(p["params"]) == {n for n in params
                                                                       if mine(n)}
        g = {**gaps(p["grads"], want), **param_gaps(p["params"], {
            n: w for n, w in params.items() if mine(n)}, init)} if same else {}
        st = {"stage": s, "losses": p["losses"], "losses_single_process": losses,
              "loss_rel": abs(p["losses"][-1] - losses[-1]) / abs(losses[-1]),
              "held_layers": p["held_layers"], "launches_per_step": p["launches_per_step"],
              "collectives_per_step": p["collectives"], "param_bytes": p["param_bytes"],
              "state_bytes": p["state_bytes"], "same_leaves": same, **g}
        r["steps"].append(st)
        ok = ok and a["z_excess"] <= 0 and a["log_det_excess"] <= 0 and same \
            and st["loss_rel"] <= DP2_LOSS_REL and st["worst_leaf_rel"] <= DP2_GRAD_REL \
            and st["zero_leaves_zero"] and st["worst_param_rel"] <= SHARDED_PARAM_REL \
            and st["unmoved_params_equal"] and st["held_layers"] == per
    p0, p1 = (x["pipe"] for x in ranks)
    r["ranks_losses_equal"] = p0["losses"] == p1["losses"]
    r["replicated_params_equal"] = all(torch.equal(v, p1["params"][n])
                                       for n, v in p0["params"].items()
                                       if not n.startswith("flows."))
    ok = ok and r["ranks_losses_equal"] and r["replicated_params_equal"]
    emit("pipeline", ok=ok, results=r,
         bars={"apply_z_and_log_det": (PIPE_TOL, PIPE_TOL), **WORLD_2_BARS,
               "launches_a_stage_a_step": PIPE_STEP},
         note="hops are broadcasts between neighbouring stages (gloo over CUDA tensors "
              "carries no send / recv); the microbatches' GEMMs run at 4,096 rows, another "
              "cuBLAS kernel than at 16,384")
    if not ok:
        raise SystemExit("pipeline: the pipeline disagreed with the layers in turn")
    total = {}
    for x in ranks:
        add_launches(total, x["pipe_apply_launches"])
        add_launches(total, x["pipe"]["launches"])
    return total


def phase_sharded_checkpoint(ranks, root):
    """The tensor-parallel state of the world of two (after its steps)
    through ``training.save_checkpoint`` (every rank its blocks): restored
    into a fresh step's state bit-equal and one step from it bit-equal to
    the uninterrupted step (in the world); restored onto FSDP's layout
    ({"data": 2}) equal to the saved values; restored here, in the world of
    one, into make_train_step's plain state and into a {"model": 1}
    tensor-parallel state, each equal to the saved values, and one step of
    each from it bit-equal to the other's.  The pipeline's state (each stage
    its layers) restored here into the whole flow, every layer the one its
    stage held."""
    from normflows_tpu_torch import parallel, training
    from normflows_tpu_torch.examples import nsf_cylinder

    t0 = time.perf_counter()
    saved = whole([x["ckpt_saved"]["params"] for x in ranks])
    saved_moments = whole([x["ckpt_saved"]["moments"] for x in ranks])
    onto = whole([x["ckpt_onto_fsdp"]["params"] for x in ranks])
    onto_moments = whole([x["ckpt_onto_fsdp"]["moments"] for x in ranks])

    def equal(params, moments):
        return all(torch.equal(params[n], v) for n, v in saved.items()) and all(
            torch.equal(moments[n][k], v) for n, m in saved_moments.items()
            for k, v in m.items())

    path = os.path.join(root, "tp_checkpoint")
    model = nsf_cylinder.build_model(DEVICE)
    plain = training.TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    plain = training.restore_checkpoint(path, plain)
    from normflows_tpu_torch.training import make_train_step
    _, plain_step = make_train_step(plain.model, plain.optimizer, reverse_kld_loss(N))
    tp, tp_step = parallel.make_tensor_parallel_step(
        nsf_cylinder.build_model(DEVICE), adam_factory, reverse_kld_loss(N),
        parallel.make_mesh({"model": 1}, devices=DEVICE))
    tp = training.restore_checkpoint(path, tp)

    def plain_blocks(state):
        return ({n: b[0] for n, b in sharded_blocks(state.model).items()},
                {n: {k: b[0] for k, b in m.items()}
                 for n, m in sharded_blocks(state.model, optimizer=state.optimizer).items()})

    r = {"world_2_restored_bit_equal": all(x["ckpt_restored_equal"] for x in ranks),
         "world_2_resumed": [x["ckpt_resumed"] for x in ranks],
         "onto_fsdp_equal": equal(onto, onto_moments)
         and all(x["ckpt_onto_fsdp"]["step"] == x["ckpt_saved"]["step"] for x in ranks),
         "world_1_plain_equal": equal(*plain_blocks(plain)) and plain.step == SHARDED_STEPS,
         "world_1_tp_equal": equal(*plain_blocks(tp)) and tp.step == SHARDED_STEPS,
         "bytes_saved": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))}
    gen = SHARDED_SEED + 1
    plain, m1 = plain_step(plain, None, torch.Generator(DEVICE).manual_seed(gen))
    tp, m2 = tp_step(tp, None, torch.Generator(DEVICE).manual_seed(gen))
    r["world_1_resumed_bit_equal"] = bool(torch.equal(m1["loss"], m2["loss"])) and all(
        torch.equal(a, b) for a, b in zip(plain_blocks(plain)[0].values(),
                                          plain_blocks(tp)[0].values()))
    del plain, tp
    model = nsf_cylinder.build_model(DEVICE)
    pipe = training.restore_checkpoint(
        os.path.join(root, "pipe_checkpoint"),
        training.TrainState(model, torch.optim.Adam(model.parameters(), lr=LR)))
    held = {n: v for x in ranks for n, v in x["pipe"]["params"].items()}
    r["pipeline_into_one_process_equal"] = pipe.step == SHARDED_STEPS and set(held) == {
        n for n, _ in model.named_parameters()} and all(
        torch.equal(p.detach().cpu(), held[n]) for n, p in model.named_parameters())
    r["world_1_seconds"] = time.perf_counter() - t0
    r["world_2_seconds"] = ranks[0]["sharded_seconds"]["sharded_checkpoint"]
    ok = (r["world_2_restored_bit_equal"] and all(x["bit_equal"] for x in r["world_2_resumed"])
          and r["onto_fsdp_equal"] and r["world_1_plain_equal"] and r["world_1_tp_equal"]
          and r["world_1_resumed_bit_equal"] and r["pipeline_into_one_process_equal"])
    emit("sharded_checkpoint", ok=ok, results=r,
         bars={"all": "bit-equal"},
         note="torch.distributed.checkpoint: each rank writes its blocks; a restore reads "
              "the blocks its template's placements ask for")
    if not ok:
        raise SystemExit("sharded_checkpoint: a restored or resumed state differed")


# ---- the four reference examples ----------------------------------------------------
#
# Each runs at its JAX script's widths, layer counts and batch; the one cut is
# the step count, REF_ITERS of the scripts' 20,000 (circular_nsf), 3,000
# (neural_spline_twomoons), 2,000 (augmented_flow) and 4,000 (image_density).
REF_EXAMPLES = ("circular_nsf", "neural_spline_twomoons", "augmented_flow", "image_density")
REF_ITERS, REF_CHUNK = 500, 100
REF_PARITY_CHUNK, REF_PARITY_CALLS = 10, 5  # the first 50 steps, card against CPU
# where the card and the CPU part: the relative move of every weight of the
# card's twin that measures the recipe's own sensitivity, and the steps held
# whatever it says
REF_TWIN_REL, REF_MIN_HELD = 1e-6, 10
REF_CPU_PROCESSES = 4  # the CPU's parity runs, one thread each, beside the card
REF_BATCH = {"circular_nsf": 1024, "neural_spline_twomoons": 512, "augmented_flow": 1024,
             "image_density": 512}
REF_LR = {"circular_nsf": 1e-4, "neural_spline_twomoons": 1e-3, "augmented_flow": 1e-4,
          "image_density": 1e-4}
REF_LAYERS = {"circular_nsf": 20, "neural_spline_twomoons": 16}
# planar launches (the kernels line's names) of a forward-KL step, a log_prob
# and a draw: one forward launch a layer in the density direction and its
# backward; two inverse launches a layer in the D = 2 recursion of a draw
REF_STEP = {k: {"rqs_transposed_forward": n, "rqs_transposed_backward_forward": n}
            for k, n in REF_LAYERS.items()}
REF_LOG_PROB = {k: {"rqs_transposed_forward": n} for k, n in REF_LAYERS.items()}
REF_DRAW = {k: {"rqs_transposed_inverse": 2 * n} for k, n in REF_LAYERS.items()}
# the bars (lo, hi): the JAX package's replays of each example at REF_ITERS
# steps from the port's initial weights on the example's host inputs
# (``python -m tests.test_torch_reference_examples --example NAME --seeds 0-2
# --iters 500``; PERF.md section 6): a density bar at seed SEED's
# value and the larger of 0.05 and the seeds' spread (max - min) past it; a
# shape reading within the seeds' range widened by the same
REF_BARS = {
    "circular_nsf": {
        "held_out_forward_kld": (-math.inf, 3.0651569 + max(0.05, 3.0651569 - 3.0474586)),
        "in_range": (1.0, 1.0)},
    "neural_spline_twomoons": {
        "held_out_nll": (-math.inf, 1.5966432 + max(0.05, 1.6189573 - 1.5966432)),
        "mean_radius": (2.0515532 - max(0.05, 2.0872729 - 2.0515532),
                        2.0872729 + max(0.05, 2.0872729 - 2.0515532))},
    "augmented_flow": {
        "standard_mean_radius": (1.8247597 - max(0.05, 2.0429716 - 1.8247597),
                                 2.0429716 + max(0.05, 2.0429716 - 1.8247597)),
        "augmented_std": (1.3166854 - max(0.05, 1.5567813 - 1.3166854),
                          1.5567813 + max(0.05, 1.5567813 - 1.3166854))},
    "image_density": {
        "held_out_log_q": (-3.2371361 - max(0.05, -3.2264464 - -3.2371361), math.inf),
        "bright_share": (0.6395264 - max(0.05, 0.6641846 - 0.6395264), 1.0)},
}


def reference_chunk(name, where, steps):
    """``(model, state, chunk)`` of example ``name`` on ``where`` as its
    ``--host-inputs`` run at SEED builds it, with host inputs for ``steps``
    steps and REF_PARITY_CHUNK steps a call."""
    from normflows_tpu_torch.examples import (augmented_flow, circular_nsf, image_density,
                                              neural_spline_twomoons)

    batch, lr, c = REF_BATCH[name], REF_LR[name], REF_PARITY_CHUNK
    if name == "circular_nsf":
        model = circular_nsf.build_model(where, seed=SEED)
        state, chunk = circular_nsf.make_chunk(
            model, lr, batch, c, circular_nsf.host_inputs(steps, batch, SEED))
    elif name == "neural_spline_twomoons":
        model = neural_spline_twomoons.build_model(where, seed=SEED)
        state, chunk = neural_spline_twomoons.make_chunk(
            model, lr, batch, c, neural_spline_twomoons.pool(SEED),
            neural_spline_twomoons.host_inputs(steps, batch, SEED))
    elif name == "augmented_flow":
        model = augmented_flow.initialised_model(where, seed=SEED)
        state, chunk = augmented_flow.make_chunk(
            model, lr, batch, 1000, c, augmented_flow.host_inputs(steps, batch, SEED))
    else:
        model = image_density.build_model(where, seed=SEED)
        data = image_density.training_pool(image_density.smiley_image(), SEED, where, True)
        state, chunk = image_density.make_chunk(model, lr, batch, c, data)
    return model, state, chunk


def first_gradients(model, state, chunk):
    """The gradient of every parameter of the chunk's loss on its first
    step's host inputs, at the initial weights; the model's gradients are
    left as they were (none)."""
    loss = chunk.loss_fn(model, chunk.batch_fn(state.step, None), None)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads


def reference_cpu(name):
    """Example ``name``'s first REF_PARITY_CALLS x REF_PARITY_CHUNK steps
    on the CPU on its host inputs at SEED (drawn for the card's steps), in a
    process of its own on one thread: ``(losses, first gradients)``."""
    torch.set_num_threads(1)
    model, state, chunk = reference_chunk(name, "cpu",
                                          REF_PARITY_CHUNK * (REF_PARITY_CALLS + 1))
    grads = first_gradients(model, state, chunk)
    return torch.cat([chunk(state)[1]["loss"] for _ in range(REF_PARITY_CALLS)]), grads


def parity_losses(name, perturb=None):
    """``(model, state, chunk, losses, first gradients)``: example
    ``name``'s chunk on the card (REF_PARITY_CALLS + 1 calls' host inputs),
    the losses of its first REF_PARITY_CALLS calls and the first step's
    gradients, with the host ms of a step over the calls after the first
    (the capture) as ``chunk.ms``; with ``perturb``, every parameter first
    scaled by (1 + perturb N(0, 1)) entry by entry."""
    steps = REF_PARITY_CHUNK * (REF_PARITY_CALLS + 1)
    model, state, chunk = reference_chunk(name, DEVICE, steps)
    grads = first_gradients(model, state, chunk)
    if perturb is not None:
        gen = torch.Generator().manual_seed(SEED + 210)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen).to(DEVICE))
    got = []
    for c in range(REF_PARITY_CALLS):
        if c == 1:
            sync()
            t0 = time.perf_counter()
        got.append(chunk(state)[1]["loss"])
    losses = torch.cat(got).cpu()
    chunk.ms = (time.perf_counter() - t0) * 1e3 / (steps - 2 * REF_PARITY_CHUNK)
    return model, state, chunk, losses, grads


def parity_horizon(card, other):
    """The number of leading steps whose losses lie within CPU_TOL (atol
    and rtol) of each other."""
    tol = CPU_TOL + CPU_TOL * other.abs()
    over = ((card - other).abs() > tol).nonzero()
    return int(over[0, 0]) if len(over) else len(card)


def card_parity(name, counts):
    """Example ``name``'s first REF_PARITY_CALLS x REF_PARITY_CHUNK steps
    on its host inputs at SEED on the card (``parity_losses``), then the
    host ms of a step, one more call's busy share and planar launches, and
    a draw's planar launches, on the device counters ``counts``; the
    card's losses and first gradients under ``"losses"`` and ``"grads"``
    for ``hold_parity``."""
    model, state, chunk, losses, grads = parity_losses(name)
    prof, launched = on_card(counts, lambda: busy(lambda: chunk(state)))
    eps = torch.full((16, *model.q0.noise_shape), 0.5, device=DEVICE)
    _, drawn = on_card(counts, lambda: model.from_noise(eps))
    return {"steps": REF_PARITY_CHUNK * REF_PARITY_CALLS, "losses": losses, "grads": grads,
            "ms": chunk.ms, "samples_per_s": REF_BATCH[name] / (chunk.ms / 1e3),
            "busy_share": prof["busy_share"], "device_ms": prof["device_ms"] / REF_PARITY_CHUNK,
            "kernel_launches": prof["kernel_launches"] / REF_PARITY_CHUNK,
            "launches": {"step": replay_launches(name, launched, REF_STEP.get(name, {}),
                                                 REF_PARITY_CHUNK),
                         "draw": replay_launches(name, drawn, REF_DRAW.get(name, {}), 1)}}


def hold_parity(name, r, cpu):
    """The card's first steps ``r`` (``card_parity``) against the CPU's,
    ``cpu`` (``reference_cpu(name)``): the first step's gradient, every
    leaf within STEP_G_TOL of its norm, and every loss within CPU_TOL.
    Where a loss leaves CPU_TOL, the recipe's own sensitivity sets how far
    the bar reaches: the card's twin with every weight moved by REF_TWIN_REL
    (relative) keeps CPU_TOL of the card for its first ``h`` steps, and the
    CPU must keep it for as many, at least REF_MIN_HELD."""
    losses, grads = r.pop("losses"), r.pop("grads")
    cpu_losses, cpu_grads = cpu
    worst, gap = leaf_gap(grads, cpu_grads)
    held = parity_horizon(losses, cpu_losses)
    r.update(excess=excess(losses, cpu_losses, CPU_TOL, CPU_TOL),
             max_abs_loss_gap=float((losses - cpu_losses).abs().max()),
             steps_within_cpu_tol=held, first_gradient_worst_leaf=worst,
             first_gradient_worst_relative_norm=gap)
    want = len(losses)
    if held < want:
        twin = parity_losses(name, REF_TWIN_REL)[3]
        want = parity_horizon(losses, twin)
        r["twin"] = {"relative_perturbation": REF_TWIN_REL, "steps_within_cpu_tol": want,
                     "abs_loss_gap": (twin - losses).abs().tolist(),
                     "cpu_abs_loss_gap": (cpu_losses - losses).abs().tolist()}
    if held < max(want, REF_MIN_HELD) or gap > STEP_G_TOL:
        emit("reference_examples", ok=False, example=name, parity=r)
        raise SystemExit(f"reference_examples: {name}'s first steps on the card disagree "
                         f"with the CPU")
    return r


def reference_bars(name, record):
    """Which of REF_BARS[name] the record misses (none: []); every example
    also wants 0 non-finite steps and finite draws."""
    missed = [k for k in ("non_finite_steps",) if record[k] != 0]
    missed += [] if record["draws_finite"] else ["draws_finite"]
    for key, (lo, hi) in REF_BARS.get(name, {}).items():
        if not lo <= record[key] <= hi:
            missed.append(key)
    return missed


def phase_reference_examples():
    """The four reference examples of ``normflows_tpu_torch.examples``
    (circular_nsf, neural_spline_twomoons, augmented_flow, image_density),
    each at its JAX script's widths and depths: (a) its first steps on the
    card (``card_parity``: its step time, busy share and the planar
    launches of a replayed step and of a draw) against the CPU's, run in
    REF_CPU_PROCESSES processes beside the card's work and held once the
    card is done (``hold_parity``); (b) the example as a replay runs it,
    ``--host-inputs --seed SEED`` at REF_ITERS steps, its numbers held to
    REF_BARS, with 0 non-finite steps; the planar launches of the whole run
    on the device counters: (2 warm-up + REF_ITERS) steps, a log_prob and a
    draw.  Returns the run's launches
    by the ``kernels`` line's names."""
    import importlib
    from concurrent.futures import ProcessPoolExecutor

    from normflows_tpu_torch.training.loop import WARMUP_STEPS

    out, total, ok = {}, {}, True
    # the CPU's parity runs in processes of their own while the card works
    spawn = torch.multiprocessing.get_context("spawn")
    with device_counters() as counts, \
            ProcessPoolExecutor(REF_CPU_PROCESSES, mp_context=spawn) as pool:
        cpu = {name: pool.submit(reference_cpu, name) for name in REF_EXAMPLES}
        for name in REF_EXAMPLES:
            module = importlib.import_module(f"normflows_tpu_torch.examples.{name}")
            r = {"parity": card_parity(name, counts)}
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                (_, record), launched = on_card(counts, lambda: module.main(
                    ["--iters", str(REF_ITERS), "--chunk", str(REF_CHUNK), "--host-inputs",
                     "--seed", str(SEED), "--device", DEVICE]))
            want = {k: (WARMUP_STEPS + REF_ITERS) * REF_STEP.get(name, {}).get(k, 0)
                    + REF_LOG_PROB.get(name, {}).get(k, 0) + REF_DRAW.get(name, {}).get(k, 0)
                    for k in launched}
            if launched != want:
                raise SystemExit(f"reference_examples: {name}'s run launched {launched}, "
                                 f"expected {want}")
            add_launches(total, launched)
            missed = reference_bars(name, record)
            ok = ok and not missed
            r["run"] = {**record, "printed": printed.getvalue().splitlines()[:-1],
                        "launches": launched, "missed": missed}
            out[name] = r
        for name in REF_EXAMPLES:
            hold_parity(name, out[name]["parity"], cpu[name].result())
    bars = {name: {k: [None if math.isinf(v) else v for v in b] for k, b in kb.items()}
            for name, kb in REF_BARS.items()}
    emit("reference_examples", ok=ok, results=out, bars=bars,
         parity_bars={"loss": [CPU_TOL, CPU_TOL], "first_gradient_leaf_relative_norm": STEP_G_TOL,
                      "twin_relative_perturbation": REF_TWIN_REL, "min_steps_held": REF_MIN_HELD},
         iters=REF_ITERS, note="parity: the first steps on host inputs, card against CPU; "
         "ms and samples_per_s: host time of a step over 4 calls of 10 steps after the "
         "capture; busy_share, device_ms: one more call under the profiler (device only); "
         "run: the example's main at --host-inputs --seed SEED, cut to REF_ITERS steps")
    if not ok:
        raise SystemExit("reference_examples: an example missed its bars")
    return total


PHASES = ("kernel", "main_path", "times_kernel", "times_requests", "kernel_backward",
          "train_path",
          "times_train", "kernel_flat", "kernel_flat_backward", "large_d_path",
          "large_d_train", "times_large_d", "kernel_made_fused", "kernel_made_fused_backward",
          "large_d_fused", "times_made_fused", "kernel_ablate", "times_ablate", "coupled_path",
          "coupled_train", "coupled_float64", "times_coupled", "chunked_train", "chunked_data",
          "times_chunked", "convergence", "conditional_path", "conditional_train",
          "glow_path", "image_nsf_path", "glow_train", "reference_examples", "realnvp",
          "serving_export", "residual_path", "residual_train", "small_flows",
          "stochastic_path", "hais", "snf_train", "vae_train", "change_base",
          "sampling_path", "nuts", "neutra_smc", "scan_chain", "serving_stochastic", "loader",
          "data_parallel", "glow_loader", "chains", "tensor_parallel", "fsdp", "pipeline",
          "sharded_checkpoint")


def phases_chosen(argv):
    """``--phases a,b,...`` (names of PHASES; device and build always run,
    and so does a phase whose result a chosen one takes): the set chosen,
    or None, every phase and the kernels line, without it."""
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of the port (module docstring).")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all, and the kernels line)")
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    chosen = set(filter(None, args.phases.split(",")))
    unknown = chosen - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; the phases are {', '.join(PHASES)}")
    return chosen


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import normflows_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port beside this script: {exc}",
              file=sys.stderr)
        return 2
    torch.manual_seed(SEED)
    chosen = phases_chosen(sys.argv[1:])

    def want(*names):
        """Whether any of ``names`` runs: every phase without ``--phases``,
        else those chosen (a phase runs too where a chosen one takes its
        result)."""
        return chosen is None or any(n in chosen for n in names)

    smi = phase_device()
    resources, made_res, flat_res, planar_res = phase_build()
    if want("kernel"):
        errs = phase_kernel()
    if want("main_path", "times_kernel", "times_requests"):
        model, launches = phase_main_path()
    if want("times_kernel"):
        kernel_ms, plain_ms, bound_ms, bound_by, floor_ms = phase_times(model)
    if want("times_requests"):
        phase_requests(model)
    model = None
    if want("kernel_backward"):
        bwd_errs = phase_kernel_backward()
    if want("train_path"):
        bwd_launches = phase_train_path()
    if want("times_train", "times_chunked"):
        bwd_kernel_ms, bwd_plain_ms, bwd_bound_ms, bwd_bound_by, bwd_floor_ms, \
            eager_flagship = phase_times_train()
    if want("kernel_flat"):
        flat_errs = phase_kernel_flat()
    if want("kernel_flat_backward"):
        flat_bwd_errs = phase_kernel_flat_backward()
    if want("large_d_path", "times_large_d", "times_made_fused"):
        ld_model, ld_launches = phase_large_d_path()
    if want("large_d_train"):
        ld_train_launches = phase_large_d_train()
    if want("times_large_d"):
        flat_times, _ = phase_times_large_d(ld_model, flat_res)
    if want("kernel_made_fused"):
        made_errs = phase_kernel_made_fused()
    if want("kernel_made_fused_backward"):
        made_bwd_errs = phase_kernel_made_fused_backward()
    if want("large_d_fused"):
        made_launches = phase_large_d_fused()
    if want("times_made_fused"):
        made_times, _ = phase_times_made_fused(ld_model, made_res)
    ld_model = None
    if want("kernel_ablate"):
        ablate_errs = phase_kernel_ablate()
    if want("times_ablate"):
        ablate_times = phase_times_ablate(resources)
    if want("coupled_path", "times_coupled", "times_chunked"):
        cp_model, cp_launches = phase_coupled_path()
    if want("coupled_train"):
        cp_train_launches = phase_coupled_train()
    if want("coupled_float64"):
        phase_coupled_float64()
    if want("times_coupled", "times_chunked"):
        eager_coupled = phase_times_coupled(cp_model)
    cp_model = None
    if want("chunked_train"):
        flagship_replays = phase_chunked_train()
    if want("chunked_data"):
        coupled_replays = phase_chunked_data()
    if want("times_chunked"):
        phase_times_chunked(eager_flagship, eager_coupled)
    if want("convergence", "neutra_smc", "serving_stochastic"):
        _, trained = phase_convergence()
    if want("conditional_path", "conditional_train"):
        cond_launches, layer_b = phase_conditional_path()
    if want("conditional_train"):
        phase_conditional_train(layer_b)
    layer_b = None
    if want("glow_path"):
        phase_glow_path()
    if want("image_nsf_path"):
        img_launches, img_times = phase_image_nsf_path()
    if want("glow_train"):
        phase_glow_train()
    if want("reference_examples"):
        ref_launches = phase_reference_examples()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bundles_") as root:
        if want("realnvp", "serving_export"):
            real_nvp = phase_realnvp(root)
        if want("serving_export"):
            served = phase_serving_export(root, real_nvp)
    new_paths = [f() for name, f in (("residual_path", phase_residual_path),
                                     ("residual_train", phase_residual_train),
                                     ("small_flows", phase_small_flows)) if want(name)]
    stochastic_vae = [f() for name, f in (("stochastic_path", phase_stochastic_path),
                                          ("hais", phase_hais), ("snf_train", phase_snf_train),
                                          ("vae_train", phase_vae_train),
                                          ("change_base", phase_change_base)) if want(name)]
    sampling = [f() for name, f in (("sampling_path", phase_sampling_path),
                                    ("nuts", phase_nuts),
                                    ("neutra_smc", lambda: phase_neutra_smc(trained)),
                                    ("scan_chain", phase_scan_chain)) if want(name)]
    if want("serving_stochastic"):
        with tempfile.TemporaryDirectory() as root:
            served_stochastic = phase_serving_stochastic(root, trained)
    trained = None
    if want("loader"):
        phase_loader()
    world = ("data_parallel", "glow_loader", "chains", "tensor_parallel", "fsdp", "pipeline",
             "sharded_checkpoint")
    if want(*world):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as world_root:
            ranks, dp_launches = phase_data_parallel(world_root)
            if want("glow_loader"):
                phase_glow_loader()
            parallel_paths = [dp_launches, phase_chains(ranks) if want("chains") else {}]
            ref = flagship_two_steps() if want("tensor_parallel", "fsdp", "pipeline") else None
            sharded_paths = [f(ranks, ref) for name, f in (
                ("tensor_parallel", phase_tensor_parallel), ("fsdp", phase_fsdp),
                ("pipeline", phase_pipeline)) if want(name)]
            ref = None
            if want("sharded_checkpoint"):
                phase_sharded_checkpoint(ranks, world_root)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if chosen is not None:  # the kernels line wants every phase
        print(json.dumps({"ok": True, "phases": sorted(chosen), "device": device}))
        return 0

    kernels = []
    for d in ("forward", "inverse"):
        worst = [e for k, e in errs.items() if k.startswith(d) and "_K" not in k]
        kernels.append({
            "name": f"rqs_transposed_{d}",
            "route": "cuda",
            "source": "normflows_tpu_torch/csrc/rqs_transposed.cu",
            "replaces": "normflows_tpu/ops/spline_pallas.py:559",
            "launches": launches[d],
            "max_abs_err": max(e["max_abs_y"] for e in worst),
            "max_abs_err_logdet": max(e["max_abs_ld"] for e in worst),
            "ms": kernel_ms[d],
            "plain_ms": plain_ms[d],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "floor_ms": floor_ms,
            "resources": {k: v for k, v in planar_res.items() if k.startswith(d)},
            "launches_replayed": {run: r[f"rqs_transposed_{d}"]
                                  for run, r in flagship_replays.items()},
        })
    for d in ("forward", "inverse"):
        worst = [e for k, e in bwd_errs.items() if k.startswith(d) and "_K" not in k]
        kernels.append({
            "name": f"rqs_transposed_backward_{d}",
            "route": "cuda",
            "source": "normflows_tpu_torch/csrc/rqs_transposed.cu",
            "replaces": "normflows_tpu/ops/spline_pallas.py:591",
            "launches": bwd_launches[f"backward_{d}"],
            "max_abs_err": max(max(e["max_abs_dx"], e["max_abs_dparams"]) for e in worst),
            "max_abs_err_dx": max(e["max_abs_dx"] for e in worst),
            "max_abs_err_dparams": max(e["max_abs_dparams"] for e in worst),
            "ms": bwd_kernel_ms[d],
            "plain_ms": bwd_plain_ms[d],
            "bound_ms": bwd_bound_ms,
            "bound_by": bwd_bound_by,
            "library_ms": None,
            "floor_ms": bwd_floor_ms,
            "resources": {k: v for k, v in planar_res.items()
                          if k.startswith(f"backward_{d}")},
            "launches_replayed": {run: r[f"rqs_transposed_backward_{d}"]
                                  for run, r in flagship_replays.items()},
        })
    # the flat kernels: times at the size the large-D path gives each (the
    # sliced inverse's 4096 in the sampling direction, the density
    # direction's 4096 x 64), the other size beside it; launches on the
    # large-D path and on the coupled one (its forward-KL steps launch the
    # forward direction and its backward)
    for d, n_path in (("forward", LD_BATCH * LD_D), ("inverse", LD_BATCH)):
        for backward, errs_of, launched in ((False, flat_errs, ld_launches[d]),
                                            (True, flat_bwd_errs,
                                             ld_train_launches[f"backward_{d}"])):
            name = f"rqs_flat_{'backward_' if backward else ''}{d}"
            if not backward:
                launched += ld_train_launches[d]
            coupled = (cp_train_launches["backward"] if d == "forward" else 0) if backward \
                else cp_launches[d] + (cp_train_launches["forward"] if d == "forward" else 0)
            worst = [v for k, e in errs_of.items() if k.startswith(d)
                     for n, v in e.items() if n.startswith("max_abs")]
            t = flat_times[name]
            kernels.append({
                "name": name,
                "route": "cuda",
                "source": "normflows_tpu_torch/csrc/rqs_flat.cu",
                "replaces": "normflows_tpu/ops/spline_pallas.py:" + ("313" if backward else "303"),
                "launches": launched + coupled,
                "launches_by_path": {"large_d": launched, "coupled": coupled},
                "max_abs_err": max(worst),
                "ms": t[n_path]["ms"],
                "plain_ms": t[n_path]["plain_ms"],
                "bound_ms": t[n_path]["bound_ms"],
                "bound_by": t[n_path]["bound_by"],
                "library_ms": None,
                "n": n_path,
                "floor_ms": t[n_path]["floor_ms"],
                "by_n": {str(n): {k: v for k, v in r.items() if k != "bytes"}
                         for n, r in t.items()},
                "resources": {k: v for k, v in flat_res.items()
                              if k.startswith("backward_" + d if backward else d)},
                "launches_replayed": {run: r[name] for run, r in coupled_replays.items()},
            })
    # the fused MADE: times at the large-D shape, f32 (bf16 beside)
    for d, errs_of in (("forward", made_errs), ("backward", made_bwd_errs)):
        t = {dt: made_times[dt][d] for dt in made_times}
        worst = [v for e in errs_of.values() for n, v in e.items() if n.startswith("max_abs")]
        kernels.append({
            "name": f"made_fused_{d}",
            "route": "cuda",
            "source": "normflows_tpu_torch/csrc/made_fused.cu",
            "replaces": "normflows_tpu/ops/made_pallas.py:" + ("89" if d == "forward" else "117"),
            "launches": made_launches[d],
            "max_abs_err": max(worst),
            "ms": t["float32"]["ms"],
            "plain_ms": t["float32"]["plain_ms"],
            "bound_ms": t["float32"]["bound_ms"],
            "bound_by": t["float32"]["bound_by"],
            "library_ms": t["float32"]["library_ms"],
            "shape": made_key(MADE_CASES[0], False)[:-4],
            "bf16": {k: t["bfloat16"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms")},
        })
        # the issued operations' bound, the launches, ptxas
        for dt, entry in (("float32", kernels[-1]), ("bfloat16", kernels[-1]["bf16"])):
            entry.update({k: t[dt][k] for k in ("issued_bound_ms", "launch_us",
                                                "launches_recorded", "blocks_per_sm",
                                                "resources", "shares")})
    # the ablation's variants: the script's run on run_variant's inputs
    for mode, t in ablate_times.items():
        kernels.append({
            "name": f"rqs_flat_ablate_{mode}",
            "route": "cuda",
            "source": "normflows_tpu_torch/csrc/rqs_flat_ablate.cu",
            "replaces": "examples/spline_bwd_ablate.py:51",
            "launches": t["launches"],
            "max_abs_err": max(v for k, e in ablate_errs.items() if k.startswith(mode + "_")
                               for n, v in e.items() if n.startswith("max_abs")),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "n": ABLATE_N,
            "registers": t["registers"],
            "stack_bytes": t["stack_bytes"],
            "spill_store_bytes": t["spill_store_bytes"],
            "spill_load_bytes": t["spill_load_bytes"],
        })
    for entry in kernels:
        entry["launches_served"] = served.get(entry["name"], {})
        # the conditional paths' launches (phase conditional_path) count too,
        # and the image path's (phase image_nsf_path)
        entry["launches_conditional"] = cond_launches.get(entry["name"], 0)
        entry["launches_image"] = img_launches.get(entry["name"], 0)
        # the residual and small flows' paths (0: no kernel of the port there)
        entry["launches_residual_small"] = sum(p.get(entry["name"], 0) for p in new_paths)
        # stochastic flows, HAIS, the VAEs and the new bases (0: no kernel there)
        entry["launches_stochastic_vae"] = sum(p.get(entry["name"], 0) for p in stochastic_vae)
        # the samplers and ScanChain (rows 1 and 1b; 0 for the rest)
        entry["launches_sampling"] = sum(p.get(entry["name"], 0) for p in sampling)
        # the data- and chain-parallel tier: the flagship's step through
        # make_train_step, the world of 1 and both ranks of the world of 2
        # (rows 1 and 1b; 0 for the rest: HAIS and Glow run no kernel of the port)
        entry["launches_parallel"] = sum(p.get(entry["name"], 0) for p in parallel_paths)
        # the sharded tier: tensor parallelism and FSDP at worlds 1 and 2, the
        # pipeline's two stages (rows 1 and 1b; 0 for the rest)
        entry["launches_sharded"] = sum(p.get(entry["name"], 0) for p in sharded_paths)
        # the bundles of phase serving_stochastic (the SMC bundle's program
        # requests: rows 1 and 1b; 0 for the rest)
        entry["launches_served_stochastic"] = served_stochastic.get(entry["name"], 0)
        # the reference examples' runs (phase reference_examples: rows 1 and 1b
        # in circular_nsf and neural_spline_twomoons; 0 for the rest)
        entry["launches_examples"] = ref_launches.get(entry["name"], 0)
        entry["launches"] += (entry["launches_conditional"] + entry["launches_image"]
                              + entry["launches_sampling"] + entry["launches_parallel"]
                              + entry["launches_sharded"] + entry["launches_served_stochastic"]
                              + entry["launches_examples"])
        if entry["name"] in img_times:  # the flat kernels at model B's N, event_axis 1
            entry["image_nsf"] = img_times[entry["name"]]
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
