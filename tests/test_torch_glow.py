"""Glow's layers in the port against the JAX package on the CPU, from the same
weights (``load_jax_leaves``) and numpy inputs: ``Conv2d`` and ``ConvNet2d``
(float32 and bfloat16), ``ActNorm`` (both data-dependent inits) and the net
``ActNorm``, ``BatchNorm``, ``Permute``, ``Invertible1x1Conv`` and
``InvertibleAffine`` (LU and dense), ``Squeeze``, ``GlowBlock`` in each split
mode (values, log-dets, its init and gradients), ``transforms.Logit`` /
``Shift``, the bases ``ClassCondDiagGaussian`` and ``GlowBase``, and the
preprocessing helpers.

Bars: the JAX package's own, values 1e-5 and log-dets 1e-4 (absolute and
relative), gradients atol 1e-4 / rtol 1e-3; a bfloat16 convolution 1e-2
(both sides round each output to bfloat16 once, after float32 sums taken
in different orders, so an output can land one bfloat16 step, 2^-8
relative, apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu import transforms as jtransforms
from normflows_tpu.distributions.base import one_hot as jone_hot
from normflows_tpu.nets import cnn as jcnn
from normflows_tpu.utils import nn as jnn
from normflows_tpu.utils import preprocessing as jpre
from normflows_tpu.utils import set_compute_dtype as jax_set_compute_dtype
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import transforms
from normflows_tpu_torch.distributions.base import one_hot
from normflows_tpu_torch.nets import cnn
from normflows_tpu_torch.utils import nn as tnn
from normflows_tpu_torch.utils import preprocessing, set_compute_dtype
from tests.helpers import assert_close
from tests.test_torch_conditional import jcall, leaves_of, ported

torch.set_num_threads(2)

Y_TOL, LD_TOL = 1e-5, 1e-4
G_ATOL, G_RTOL = 1e-4, 1e-3
BF16_TOL = 1e-2
KEY = jax.random.key(3)


def image(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def both_directions(jm, tm, x, y_tol=Y_TOL, ld_tol=LD_TOL):
    """``forward`` and ``inverse`` of a JAX flow and its port on ``x``, the
    JAX pair in one jitted call."""
    want = jcall(lambda m, a: (m.forward(a), m.inverse(a)), jm, jnp.asarray(x))
    for direction, (yj, ldj) in zip(("forward", "inverse"), want):
        with torch.no_grad():
            yt, ldt = getattr(tm, direction)(t(x))
        assert_close(yt.numpy(), np.asarray(yj), atol=y_tol, rtol=y_tol, msg=direction)
        assert_close(ldt.numpy(), np.asarray(ldj), atol=ld_tol, rtol=ld_tol, msg=direction)


# ---- nets/cnn.py -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_nets_match_jax(dtype):
    """``Conv2d`` (3x3 with bias, 1x1 zeros) and ``ConvNet2d`` (with and
    without its net ActNorm, leaky 0.2) on 2 x 4 x 6 x 6 images;
    ``set_compute_dtype`` reaches the convolutions, whose bf16 output is
    rounded to bfloat16 before the bias."""
    tol = Y_TOL if dtype == "float32" else BF16_TOL
    x = image(0, 2, 4, 6, 6)
    for kernel in (3, 1):
        jm = jcnn.Conv2d.create(KEY, 4, 5, kernel)
        tm = ported(jm, cnn.Conv2d(4, 5, kernel, device="cpu"))
        with torch.no_grad():
            tm.bias.copy_(t(image(1, 5)))
        jm = jm.replace(bias=jnp.asarray(tm.bias.detach().numpy()))
        if dtype == "bfloat16":
            jm, tm = jax_set_compute_dtype(jm, dtype), set_compute_dtype(tm, dtype)
        with torch.no_grad():
            assert_close(tm(t(x)).numpy(), np.asarray(jm(jnp.asarray(x))), atol=tol,
                         rtol=tol)
    for actnorm in (False, True):
        jm = jcnn.ConvNet2d.create(KEY, (4, 8, 8, 6), (3, 1, 3), leaky=0.2, init_zeros=False,
                                   actnorm=actnorm)
        tm = ported(jm, cnn.ConvNet2d((4, 8, 8, 6), (3, 1, 3), leaky=0.2, init_zeros=False,
                                      actnorm=actnorm, device="cpu"))
        if dtype == "bfloat16":
            jm, tm = jax_set_compute_dtype(jm, dtype), set_compute_dtype(tm, dtype)
            assert all(c.compute_dtype == torch.bfloat16 for c in tm.convs)
        with torch.no_grad():
            assert_close(tm(t(x)).numpy(), np.asarray(jm(jnp.asarray(x))), atol=tol,
                         rtol=tol)


def test_fp32_convs_restores_the_callers_setting():
    """Each float32 convolution turns cuDNN's TF32 off for its call and hands
    the caller's setting back, whatever it was."""
    prior = torch.backends.cudnn.allow_tf32
    conv = cnn.Conv2d(2, 2, 3, device="cpu")
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            with cnn.fp32_convs():
                assert torch.backends.cudnn.allow_tf32 is False
            conv(torch.zeros(1, 2, 4, 4))
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cudnn.allow_tf32 = prior


# ---- flows/normalization.py, utils/nn.py ActNorm -----------------------------

@pytest.mark.parametrize("direction", ["density", "sampling"])
def test_actnorm_inits_match_jax(direction):
    """``data_dep_init`` (density batch) or ``data_dep_init_forward``
    (sampling batch) on an image batch, per-channel (C, 1, 1), and on a
    vector batch: the same ``s``, ``t``, ``initialized`` and output as
    JAX's."""
    for shape, x in (((3, 1, 1), image(2, 8, 3, 4, 4, scale=2.0) + 1.0),
                     ((5,), image(3, 16, 5, scale=3.0) - 2.0)):
        jm = jflows.ActNorm.create(shape)
        tm = ported(jm, tflows.ActNorm(shape, device="cpu"))
        if direction == "density":
            jm2, zj = jm.data_dep_init(jnp.asarray(x))
            zt = tm.data_dep_init(t(x))
        else:
            jm2, zj = jm.data_dep_init_forward(jnp.asarray(x))
            zt = tm.data_dep_init_forward(t(x))
        assert bool(tm.initialized) and bool(jm2.initialized)
        for name in ("s", "t"):
            assert_close(getattr(tm, name).detach().numpy(), np.asarray(getattr(jm2, name)),
                         atol=Y_TOL, rtol=Y_TOL, msg=name)
        assert_close(zt.detach().numpy(), np.asarray(zj), atol=Y_TOL, rtol=Y_TOL)
        both_directions(jm2, tm, x)
    jnet = jnn.ActNorm.create((3, 1, 1))
    tnet = ported(jnet, tnn.ActNorm((3, 1, 1), device="cpu"))
    with torch.no_grad():
        tnet.actnorm.s.copy_(t(image(4, 1, 3, 1, 1)))
    jnet = jnet.replace(actnorm=jnet.actnorm.replace(
        s=jnp.asarray(tnet.actnorm.s.detach().numpy())))
    x = image(5, 2, 3, 4, 4)
    with torch.no_grad():
        assert_close(tnet(t(x)).numpy(), np.asarray(jnet(jnp.asarray(x))), atol=Y_TOL,
                     rtol=Y_TOL)


def test_batchnorm_matches_jax():
    x = image(6, 32, 4, scale=2.0) + 0.5
    yj, ldj = jflows.BatchNorm().forward(jnp.asarray(x))
    yt, ldt = tflows.BatchNorm().forward(t(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


# ---- flows/mixing.py, flows/reshape.py ---------------------------------------

@pytest.mark.parametrize("mode,channels", [("shuffle", 6), ("swap", 5)])
def test_permute_matches_jax(mode, channels):
    jm = jflows.Permute.create(channels, mode, key=KEY)
    tm = ported(jm, tflows.Permute(channels, mode, device="cpu"))
    both_directions(jm, tm, image(7, 3, channels, 2, 2))


@pytest.mark.parametrize("kind", ["conv_lu", "conv_dense", "affine_lu", "affine_dense"])
def test_invertible_linear_matches_jax(kind):
    """``Invertible1x1Conv`` on 2 x 6 x 4 x 4 images (the log-det counts the
    16 positions) and ``InvertibleAffine`` on 5 x 6 vectors, with LU and
    dense weights; the LU factors (``P``, ``sign_S`` from JAX's
    factorisation) and the weights carried across, ``forward`` applying
    W^-1 and ``inverse`` W, and ``data_dep_init`` the density pass."""
    layer, lu = kind.split("_")
    jcls, tcls = ((jflows.Invertible1x1Conv, tflows.Invertible1x1Conv) if layer == "conv"
                  else (jflows.InvertibleAffine, tflows.InvertibleAffine))
    jm = jcls.create(6, use_lu=lu == "lu", key=KEY)
    tm = ported(jm, tcls(6, use_lu=lu == "lu", device="cpu"))
    if lu == "lu":  # off the orthogonal init: a generic L, U and scale
        rng = np.random.default_rng(8)
        jm = jm.replace(L=jm.L + 0.1 * rng.normal(size=(6, 6)).astype(np.float32),
                        log_S=jm.log_S + 0.2)
        tm = ported(jm, tm)
    x = image(9, 2, 6, 4, 4) if layer == "conv" else image(9, 5, 6)
    both_directions(jm, tm, x)
    assert_close(tm.data_dep_init(t(x)).detach().numpy(),
                 np.asarray(jm.data_dep_init(jnp.asarray(x))[1]), atol=Y_TOL, rtol=Y_TOL)


def test_squeeze_matches_jax():
    """Depth-to-space forward, space-to-depth inverse, each other's inverse."""
    x = image(10, 2, 8, 4, 6)
    both_directions(jflows.Squeeze(), tflows.Squeeze(), x)
    sq = tflows.Squeeze()
    z = t(image(11, 2, 3, 6, 4))
    assert torch.equal(sq.forward(sq.inverse(z)[0])[0], z)


# ---- flows/affine/glow.py --------------------------------------------------

@pytest.mark.parametrize("split_mode,channels", [("channel", 5), ("channel_inv", 5),
                                                 ("checkerboard", 4)])
def test_glow_block_matches_jax(split_mode, channels):
    """A ``GlowBlock`` (hidden 8, a random output conv, so the coupling does
    work) in each split mode, odd channels included: values and log-dets
    both ways after ``data_dep_init`` on a batch, and the gradient of a
    density-direction loss."""
    jm = jflows.GlowBlock.create(KEY, channels, 8, split_mode=split_mode, init_zeros=False)
    tm = ported(jm, tflows.GlowBlock(channels, 8, split_mode=split_mode, init_zeros=False,
                                     device="cpu"))
    x = image(12, 4, channels, 4, 4)
    from normflows_tpu import combine, partition
    from normflows_tpu_torch.interop import _torch_name

    def everything(jm, x):
        jm, z = jm.data_dep_init(x)
        diff, rest = partition(jm)
        grads = jax.grad(lambda d: jnp.sum(combine(d, rest).inverse(x)[1]))(diff)
        return z, jm.forward(x), jm.inverse(x), grads

    zj, fwd, inv, gj = jax.jit(everything)(jm, jnp.asarray(x))
    zt = tm.data_dep_init(t(x))
    assert_close(zt.detach().numpy(), np.asarray(zj), atol=Y_TOL, rtol=Y_TOL)
    for direction, (yj, ldj) in (("forward", fwd), ("inverse", inv)):
        with torch.no_grad():
            yt, ldt = getattr(tm, direction)(t(x))
        assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL, msg=direction)
        assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL, msg=direction)
    want = {_torch_name(k): v for k, v in leaves_of(gj).items()}
    tm.inverse(t(x))[1].sum().backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert_close(g.numpy(), want[name], atol=G_ATOL, rtol=G_RTOL, msg=name)


# ---- transforms.py -----------------------------------------------------------

def test_logit_and_shift_match_jax():
    u = np.random.default_rng(13).uniform(0.02, 0.98, size=(3, 2, 4, 4)).astype(np.float32)
    jm, tm = jtransforms.Logit(alpha=0.05), transforms.Logit(0.05)
    zj, ldj = jm.inverse(jnp.asarray(u))
    zt, ldt = tm.inverse(t(u))
    assert_close(zt.numpy(), np.asarray(zj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    both_directions(jm, tm, np.asarray(zj))
    both_directions(jtransforms.Shift(shift=-0.5), transforms.Shift(-0.5), u)


# ---- distributions/base.py ---------------------------------------------------

@pytest.mark.parametrize("base", ["class_cond", "glow_base", "glow_base_classes"])
def test_bases_match_jax(base):
    """``log_prob`` at labels (integer and one-hot) and ``from_noise``
    against JAX's parameters; the temperature (set in place) moves the
    log-scale by log T in both."""
    shape, nc, n = (4, 2, 2), 3, 6
    rng = np.random.default_rng(14)
    if base == "class_cond":
        jm = jdist.ClassCondDiagGaussian.create(shape, nc)
        tm = tdist.ClassCondDiagGaussian(shape, nc, device="cpu")
        names = ("loc", "log_scale")
    else:
        classes = nc if base == "glow_base_classes" else None
        jm = jdist.GlowBase.create(shape, classes)
        tm = tdist.GlowBase(shape, classes, device="cpu")
        names = ("loc", "loc_logs", "log_scale", "log_scale_logs") + (
            ("loc_cc", "log_scale_cc") if classes else ())
    jm = jm.replace(**{k: jnp.asarray(0.3 * rng.normal(size=getattr(jm, k).shape),
                                      jnp.float32) for k in names})
    tm = ported(jm, tm)
    y = rng.integers(0, nc, size=n)
    z, eps = image(15, n, *shape), image(16, n, *shape)
    for temperature in (None, 0.7):
        jt = jm.replace(temperature=temperature)
        tm.temperature = temperature
        for labels in (y, np.eye(nc, dtype=np.float32)[y]):
            assert_close(tm.log_prob(t(z), t(labels)).detach().numpy(),
                         np.asarray(jt.log_prob(jnp.asarray(z), jnp.asarray(labels))),
                         atol=LD_TOL, rtol=LD_TOL)
        loc, log_scale = jt._params(jnp.asarray(y) if base != "class_cond"
                                    else jone_hot(jnp.asarray(y), nc))
        zt, lpt = tm.from_noise(t(eps), t(y))
        assert_close(zt.detach().numpy(), np.asarray(loc + jnp.exp(log_scale) * eps),
                     atol=Y_TOL, rtol=Y_TOL)
        assert_close(lpt.detach().numpy(), np.asarray(jt.log_prob(jnp.asarray(zt.detach()
                                                                               .numpy()),
                                                                   jnp.asarray(y))),
                     atol=LD_TOL, rtol=LD_TOL)
    assert torch.equal(one_hot(t(y), nc), t(np.eye(nc, dtype=np.float32)[y]))
    gen = torch.Generator().manual_seed(0)
    zs, lps = tm.sample_and_log_prob(5, generator=gen)
    assert zs.shape == (5, *shape) and lps.shape == (5,)


# ---- utils/preprocessing.py, utils/eval.py ---------------------------------

def test_preprocessing_matches_jax(monkeypatch):
    """``Scale``, ``Jitter`` (on JAX's uniform draws), ``Logit`` and its
    inverse.  (The bits/dim helpers are held against JAX's in
    tests/test_torch_multiscale.py, on a Glow.)"""
    x = np.random.default_rng(17).uniform(0.05, 0.95, size=(4, 3, 8, 8)).astype(np.float32)
    noise = jax.random.uniform(jax.random.key(1), x.shape)
    monkeypatch.setattr(preprocessing, "uniform_noise", lambda shape, **kw: t(noise))
    want = jpre.Jitter(1 / 256)(jpre.Scale()(jnp.asarray(x)), jax.random.key(1))
    got = preprocessing.Jitter(1 / 256)(preprocessing.Scale()(t(x)))
    assert_close(got.numpy(), np.asarray(want), atol=Y_TOL, rtol=Y_TOL)
    jl, tl = jpre.Logit(0.05), preprocessing.Logit(0.05)
    assert_close(tl(t(x)).numpy(), np.asarray(jl(jnp.asarray(x))), atol=Y_TOL, rtol=Y_TOL)
    assert_close(tl.inverse(tl(t(x))).numpy(), x, atol=Y_TOL, rtol=Y_TOL)

