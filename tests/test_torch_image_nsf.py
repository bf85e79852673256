"""The image path of the coupling splines in the port against the JAX package
on the CPU, from the same weights and numpy inputs: ``ConvResidualNet``
(with and without an image context), ``PiecewiseRationalQuadraticCoupling``
on (N, C, H, W) inputs (its parameters laid out along ``event_axis = 1``,
the per-channel tails broadcast over H and W; with the unconditional CDF
on per-pixel parameters), ``PiecewiseRationalQuadraticCDF`` on images, and
a tiny model B (the image NSF that ``chip_smoke.py`` drives at the squeezed
CIFAR geometry: couplings on a ``ConvResidualNet``, ``Invertible1x1Conv``,
``ActNorm``): values, log-dets and gradients.  The JAX side runs its CPU
path (the jnp spline with codes and bounds broadcast over H and W); the
port runs the flat entry's plain version, which the CUDA kernel is held
against on the card.

Bars: values 1e-5, log-dets 1e-4, gradients atol 1e-4 / rtol 1e-3 (the JAX
package's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflows_tpu as jnf
import normflows_tpu_torch as nft
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.nets.resnet import ConvResidualNet as JConvResidualNet
from normflows_tpu.utils import masks as jmasks
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.interop import _torch_name
from normflows_tpu_torch.nets import ConvResidualNet
from normflows_tpu_torch.utils import masks as tmasks
from tests.helpers import assert_close
from tests.test_torch_conditional import jcall, leaves_of, ported

torch.set_num_threads(2)

Y_TOL, LD_TOL = 1e-5, 1e-4
G_ATOL, G_RTOL = 1e-4, 1e-3
KEY = jax.random.key(11)


def image(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def both_directions(jm, tm, x, y_tol=Y_TOL, ld_tol=LD_TOL):
    want = jcall(lambda m, a: (m.forward(a), m.inverse(a)), jm, jnp.asarray(x))
    for direction, (yj, ldj) in zip(("forward", "inverse"), want):
        with torch.no_grad():
            yt, ldt = getattr(tm, direction)(t(x))
        assert_close(yt.numpy(), np.asarray(yj), atol=y_tol, rtol=y_tol, msg=direction)
        assert_close(ldt.numpy(), np.asarray(ldj), atol=ld_tol, rtol=ld_tol, msg=direction)


@pytest.mark.parametrize("context", [False, True], ids=["plain", "context"])
def test_conv_residual_net_matches_jax(context):
    """A ``ConvResidualNet`` (2 blocks of hidden 8) on 3 x 4 x 4 images, with
    a 2-channel image context concatenated at the input and gating each
    block."""
    cc = 2 if context else None
    jm = JConvResidualNet.create(KEY, 3, 5, 8, context_channels=cc)
    tm = ported(jm, ConvResidualNet(3, 5, 8, context_channels=cc, device="cpu"))
    x, c = image(1, 2, 3, 4, 4), image(2, 2, 2, 4, 4)
    args = (jnp.asarray(x), jnp.asarray(c) if context else None)
    want = jcall(lambda m, a, b: m(a, b), jm, *args)
    with torch.no_grad():
        got = tm(t(x), t(c) if context else None)
    assert_close(got.numpy(), np.asarray(want), atol=Y_TOL, rtol=Y_TOL)


def coupling_pair(apply_cdf=False, channels=4, hidden=8, bins=4, hw=4, even=True):
    """A 4-D ``PiecewiseRationalQuadraticCoupling`` on an alternating channel
    mask (linear tails at 3), its net a ``ConvResidualNet``; with
    ``apply_cdf`` the identity channels take a per-pixel CDF."""
    mask = np.asarray(jmasks.create_alternating_binary_mask(channels, even=even))
    jm = jflows.PiecewiseRationalQuadraticCoupling.create(
        mask, lambda i, o: JConvResidualNet.create(KEY, i, o, hidden), num_bins=bins,
        tails="linear", tail_bound=3.0, apply_unconditional_transform=apply_cdf,
        img_shape=(hw, hw) if apply_cdf else None)
    tm = tflows.PiecewiseRationalQuadraticCoupling.create(
        tmasks.create_alternating_binary_mask(channels, even=even),
        lambda i, o: ConvResidualNet(i, o, hidden, device="cpu"), num_bins=bins,
        tails="linear", tail_bound=3.0, apply_unconditional_transform=apply_cdf,
        img_shape=(hw, hw) if apply_cdf else None, device="cpu")
    return jm, tm


@pytest.mark.parametrize("apply_cdf", [False, True], ids=["coupling", "with_cdf"])
def test_image_coupling_matches_jax(apply_cdf):
    """The 4-D coupling on 3 x 4 x 4 x 4 inputs (some beyond the tail bound,
    so both tails and the interior run), both directions; the CDF, when
    on, with random per-pixel parameters."""
    jm, tm = coupling_pair(apply_cdf)
    if apply_cdf:
        cdf = jm.unconditional_transform
        rng = np.random.default_rng(3)
        cdf = cdf.replace(**{k: jnp.asarray(rng.uniform(size=getattr(cdf, k).shape),
                                            jnp.float32)
                             for k in ("unnormalized_widths", "unnormalized_heights",
                                       "unnormalized_derivatives")})
        jm = jm.replace(unconditional_transform=cdf)
        assert tuple(tm.unconditional_transform.unnormalized_widths.shape) == (2, 4, 4, 4)
    tm = ported(jm, tm)
    assert tm.net_hidden == 8
    both_directions(jm, tm, image(4, 3, 4, 4, 4, scale=2.0))


def test_image_cdf_matches_jax():
    """``PiecewiseRationalQuadraticCDF`` on (3, 4, 4) events, random init,
    linear tails at per-channel bounds 2, 3, 4 broadcast over H and W."""
    bound = (2.0, 3.0, 4.0)
    jm = jflows.PiecewiseRationalQuadraticCDF.create((3, 4, 4), num_bins=5, tails="linear",
                                                     tail_bound=np.asarray(bound),
                                                     identity_init=False, key=KEY)
    tm = ported(jm, tflows.PiecewiseRationalQuadraticCDF(
        (3, 4, 4), num_bins=5, tails="linear", tail_bound=np.asarray(bound),
        identity_init=False, device="cpu"))
    assert tm.tail_bound == bound
    both_directions(jm, tm, image(5, 2, 3, 4, 4, scale=2.5))


def model_b_pair(layers=2, channels=4, hw=4, hidden=8, bins=4):
    """Model B cut to size: DiagGaussian((C, H, W)) and ``layers`` x
    (coupling on an alternating channel mask, ``Invertible1x1Conv`` with LU,
    ``ActNorm((C, 1, 1))``), both sides from the same weights."""
    jl, tl = [], []
    for i in range(layers):
        jc, tc = coupling_pair(channels=channels, hidden=hidden, bins=bins, hw=hw,
                               even=i % 2 == 0)
        jl += [jc, jflows.Invertible1x1Conv.create(channels, use_lu=True,
                                                   key=jax.random.key(20 + i)),
               jflows.ActNorm.create((channels, 1, 1))]
        tl += [tc, tflows.Invertible1x1Conv(channels, use_lu=True, device="cpu"),
               tflows.ActNorm((channels, 1, 1), device="cpu")]
    jm = jnf.NormalizingFlow.create(jdist.DiagGaussian.create((channels, hw, hw)), jl)
    tm = nft.NormalizingFlow.create(tdist.DiagGaussian((channels, hw, hw), device="cpu"), tl,
                                    device="cpu")
    return jm, ported(jm, tm)


def test_model_b_matches_jax():
    """Tiny model B after ``init_actnorm`` on a batch: ``log_prob``,
    ``forward_and_log_det`` of base draws, and the gradient of
    ``forward_kld`` (the JAX side in one jitted call)."""
    jm, tm = model_b_pair()
    x, z = image(6, 5, 4, 4, 4, scale=1.5), image(7, 5, 4, 4, 4)

    def everything(jm, x, z):
        jm = jm.init_actnorm(x)
        diff, rest = jnf.partition(jm)
        grads = jax.grad(lambda d: jnf.combine(d, rest).forward_kld(x))(diff)
        return jm, jm.log_prob(x), jm.forward_and_log_det(z), grads

    jm, lpj, (yj, ldj), gj = jax.jit(everything)(jm, jnp.asarray(x), jnp.asarray(z))
    tm.init_actnorm(t(x))
    assert all(bool(f.initialized) for f in tm.flows[2::3])
    with torch.no_grad():
        assert_close(tm.log_prob(t(x)).numpy(), np.asarray(lpj), atol=LD_TOL, rtol=LD_TOL)
        y, ld = tm.forward_and_log_det(t(z))
    assert_close(y.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
    assert_close(ld.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    tm.forward_kld(t(x)).backward()
    want = {_torch_name(k): v for k, v in leaves_of(gj).items()}
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert_close(g.numpy(), want[name], atol=G_ATOL, rtol=G_RTOL, msg=name)
