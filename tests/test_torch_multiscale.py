"""Glow's multiscale path of the port against the JAX package on the CPU:
``MultiscaleFlow`` (class-conditional, on ``ClassCondDiagGaussian`` bases,
and unconditional with ``transforms.Logit`` on ``GlowBase`` ones) and
``ClassCondFlow``: values, log-dets, gradients, ``init_actnorm``,
temperature, save / load and a class-conditional serving bundle; one
Adamax step against optax's; the chunked trainer with Adamax; and 20 steps
of ``normflows_tpu_torch.examples.glow_image`` against the JAX package's
replay of them.  Sizes: L <= 2, K <= 2, hidden <= 16, images 3 x 8 x 8.
Bars: values 1e-5 and log-densities 1e-4 (relative, the JAX package's
own), gradients atol 1e-4 / rtol 1e-3; the replayed losses 1e-4.

Run as a script, it trains the reduced Glow of
``examples/quality_compare.py`` (``GLOW_CFG``: L = 2, K = 4, hidden 64,
8 x 8 x 3 images of 4 classes, batch 64, Adamax 1e-3 with L2 1e-5, 800
steps; the last 1,024 of 4,096 images held out) through the JAX package on
the port example's model and host-drawn inputs of each seed (``replay``),
and prints one JSON line a seed with its held-out bits/dim: the quality
bar of the port's model Q (PERF.md section 6, PR 13).

    JAX_PLATFORMS=cpu python -m tests.test_torch_multiscale [--seeds 0-2]
        [--iters 800]
"""

import argparse
import copy
import functools
import importlib.util
import json
import math
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
import normflows_tpu_torch as nft
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu import transforms as jtransforms
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import serving, training, transforms
from normflows_tpu_torch.examples import glow_image
from normflows_tpu_torch.interop import _torch_name
from tests.helpers import assert_close
from tests.test_torch_conditional import jax_model_of, leaves_of, ported

torch.set_num_threads(2)

Y_TOL, LD_TOL = 1e-5, 1e-4
G_ATOL, G_RTOL = 1e-4, 1e-3
REPO = Path(__file__).resolve().parents[1]
# examples/quality_compare.py's GLOW_CFG, 800 steps: model Q
Q = dict(L=2, K=4, hidden=64, batch=64, lr=1e-3, classes=4, hw=8, images=4096, iters=800)


def jax_glow_module():
    spec = importlib.util.spec_from_file_location("jax_glow_image_example",
                                                  REPO / "examples" / "glow_image.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def image(seed, *shape):
    return np.random.default_rng(seed).uniform(0.05, 0.95, size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def glow_levels(L, K, hidden, shape, make_block, make_base):
    """The example's level layout (``build_glow``) from the given makers."""
    C, H, W = shape
    q0, levels, merges = [], [], []
    for i in range(L):
        levels.append([make_block(i * K + j, C * 2 ** (L + 1 - i), hidden)
                       for j in range(K)])
        if i > 0:
            latent = (C * 2 ** (L - i), H // 2 ** (L - i), W // 2 ** (L - i))
        else:
            latent = (C * 2 ** (L + 1), H // 2**L, W // 2**L)
        q0.append(make_base(latent))
    return q0, levels, L - 1


@functools.lru_cache(maxsize=None)
def jax_block(channels, hidden):
    """A JAX GlowBlock as a template (``jax_model_of`` gives it the port's
    tensors): made once per shape, since making one compiles its eager
    operations."""
    return jflows.GlowBlock.create(jax.random.key(channels), channels, hidden)


def glow_pair(class_cond=True, logit=False, L=2, K=2, hidden=8, shape=(3, 8, 8), nc=3,
              seed=0):
    """A JAX ``MultiscaleFlow`` and its port holding the same tensors:
    class-conditional on ``ClassCondDiagGaussian`` bases, or unconditional on
    ``GlowBase`` ones, with ``transforms.Logit`` when ``logit``; every
    block's output convolution and every base drawn at random (the
    couplings and the bases then do work)."""
    jq0, jlevels, n_merges = glow_levels(
        L, K, hidden, shape, lambda k, c, h: jax_block(c, h),
        lambda s: (jdist.ClassCondDiagGaussian.create(s, nc) if class_cond
                   else jdist.GlowBase.create(s)))
    jm = jnf.MultiscaleFlow.create(
        jq0, [lv + [jflows.Squeeze()] for lv in jlevels], [jflows.Merge()] * n_merges,
        transform=jtransforms.Logit(alpha=0.05) if logit else None, class_cond=class_cond)
    tq0, tlevels, _ = glow_levels(
        L, K, hidden, shape, lambda k, c, h: tflows.GlowBlock(c, h, device="cpu"),
        lambda s: (tdist.ClassCondDiagGaussian(s, nc, device="cpu") if class_cond
                   else tdist.GlowBase(s, device="cpu")))
    tm = nft.MultiscaleFlow(tq0, [lv + [tflows.Squeeze()] for lv in tlevels],
                            [tflows.Merge() for _ in range(n_merges)],
                            transform=transforms.Logit(0.05) if logit else None,
                            class_cond=class_cond)
    tm = ported(jm, tm)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith("convs.2.weight") or name.startswith("q0."):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    return jax_model_of(tm, jm), tm


def jax_draws(key, n, shapes, nc=None):
    """JAX ``MultiscaleFlow.sample``'s draws from ``key``: the labels (where
    ``nc``) and each level's unit normal noise."""
    keys = jax.random.split(key, len(shapes) + 1)
    y = None if nc is None else np.asarray(jax.random.randint(keys[-1], (n,), 0, nc))
    return y, [np.asarray(jax.random.normal(keys[i], (n, *s))) for i, s in enumerate(shapes)]


def feed(monkeypatch, module, y, eps):
    """``module``'s ``draw_labels`` and ``draw_noise`` give ``y`` and then the
    tensors of ``eps`` in turn."""
    noise = iter([t(e) for e in eps])
    monkeypatch.setattr(module, "draw_labels", lambda *a, **kw: t(y))
    monkeypatch.setattr(module, "draw_noise", lambda *a, **kw: next(noise))


def check_grads(tm, want):
    got = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
    assert set(got) == set(want)
    for name, g in got.items():
        assert_close(g.numpy(), want[name], atol=G_ATOL, rtol=G_RTOL, msg=name)


# ---- MultiscaleFlow, ClassCondFlow -------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """The two models of the multiscale tests, made once a file (each JAX
    model's making compiles its eager operations): a class-conditional
    Glow (L = 2, K = 2, hidden 8) and an unconditional one with ``Logit``
    on ``GlowBase`` bases (L = 2, K = 1, hidden 4), 3 x 8 x 8.  Tests take
    deep copies of the port's."""
    return {"class_cond": glow_pair(class_cond=True),
            "logit_glow_base": glow_pair(class_cond=False, logit=True, K=1, hidden=4)}


def torch_glow(K=1, hidden=4, seed=0):
    """A port-only class-conditional Glow (L = 2, 3 x 8 x 8, 3 classes)."""
    return glow_image.build_glow(2, K, hidden, (3, 8, 8), 3, device="cpu", seed=seed)


@pytest.mark.parametrize("kind", ["class_cond", "logit_glow_base"])
def test_multiscale_matches_jax(kind, pairs, monkeypatch):
    """``init_actnorm`` on a batch (every ActNorm's s and t), then
    ``log_prob``, the latents and log-det of ``inverse_and_log_det``,
    ``forward_and_log_det`` of them, ``sample`` at temperature 0.7 on JAX's
    labels and noise, and the gradient of ``forward_kld`` (the JAX side in
    one jitted call)."""
    class_cond = kind == "class_cond"
    jm, tm = pairs[kind]
    tm = copy.deepcopy(tm)
    x = image(1, 6, 3, 8, 8)
    y = np.array([0, 2, 1, 1, 0, 2]) if class_cond else None
    ty = t(y) if class_cond else None
    key = jax.random.key(4)

    def everything(jm, x, y):
        jm = jm.init_actnorm(x, y)
        zs, ld = jm.inverse_and_log_det(x)
        diff, rest = jnf.partition(jm)
        grads = jax.grad(lambda d: jnf.combine(d, rest).forward_kld(x, y))(diff)
        return (jm, jm.log_prob(x, y), zs, ld, jm.forward_and_log_det(zs),
                jm.sample(key, 5, temperature=0.7), grads)

    jm, lpj, jzs, jld, _, (xj, lqj), gj = jax.jit(everything)(
        jm, jnp.asarray(x), None if y is None else jnp.asarray(y))
    tm.init_actnorm(t(x), ty)
    want = {_torch_name(k): v for k, v in leaves_of(jm).items() if "flows[2]" in k}
    got = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}
    for name, v in want.items():
        assert_close(got[name].detach().numpy(), v, atol=Y_TOL, rtol=Y_TOL, msg=name)
    with torch.no_grad():
        lp = tm.log_prob(t(x), ty)
        zs, ld = tm.inverse_and_log_det(t(x))
        xr, ldr = tm.forward_and_log_det(zs)
    assert_close(lp.numpy(), np.asarray(lpj), atol=LD_TOL, rtol=LD_TOL)
    for a, b in zip(zs, jzs):
        assert_close(a.numpy(), np.asarray(b), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ld.numpy(), np.asarray(jld), atol=LD_TOL, rtol=LD_TOL)
    assert_close(xr.numpy(), x, atol=1e-4, rtol=1e-4)
    assert_close((ldr + ld).numpy(), np.zeros(6), atol=LD_TOL * abs(float(ld[0])), rtol=0)
    yd, eps = jax_draws(key, 5, [q.shape for q in jm.q0], 3 if class_cond else None)
    feed(monkeypatch, nft.core.facades, yd, eps)
    with torch.no_grad():
        xs, lq = tm.sample(5, temperature=0.7)
    assert_close(xs.numpy(), np.asarray(xj), atol=1e-4, rtol=1e-4)
    assert_close(lq.numpy(), np.asarray(lqj), atol=LD_TOL, rtol=LD_TOL)
    assert all(q.temperature is None for q in tm.q0)
    tm.forward_kld(t(x), ty).backward()
    check_grads(tm, {_torch_name(k): v for k, v in leaves_of(gj).items()})


def test_bits_per_dim_match_jax(pairs):
    """``utils.eval.bits_per_dim`` and ``bits_per_dim_dataset`` (NaN rows
    left out) of the class-conditional Glow on logit-space data, with the
    reference's aliases, against JAX's."""
    from normflows_tpu.utils import eval as jeval
    from normflows_tpu_torch.utils import eval as teval

    jm, tm = pairs["class_cond"]
    z = np.random.default_rng(17).normal(size=(4, 3, 8, 8)).astype(np.float32)
    y = np.array([0, 1, 2, 1])
    log_prob = jax.jit(jm.log_prob)
    jitted = type("Jitted", (), {"log_prob": staticmethod(log_prob)})
    with torch.no_grad():
        got = teval.bitsPerDim(tm, t(z), t(y)).numpy()
    assert np.isfinite(got).all()
    assert_close(got, np.asarray(jeval.bitsPerDim(jitted, jnp.asarray(z), jnp.asarray(y))),
                 atol=LD_TOL, rtol=LD_TOL)
    bad = z.copy()
    bad[1] = np.nan
    batches = [(bad[:2], y[:2]), (z[2:], y[2:])]
    with torch.no_grad():
        got = teval.bitsPerDimDataset(tm, [(t(a), t(b)) for a, b in batches])
    want = jeval.bitsPerDimDataset(jitted, [(jnp.asarray(a), jnp.asarray(b))
                                            for a, b in batches])
    assert np.isfinite(got) and abs(got - float(want)) <= LD_TOL * abs(float(want))


def test_temperature_save_load_and_bundle(tmp_path):
    """The temperature is set in place and ``sample(temperature=)`` hands the
    bases back as it found them; ``save`` / ``load`` keep ``log_prob`` bit
    for bit; a class-conditional bundle (``serving.save_bundle(...,
    class_cond=True)``) serves ``sample(seed, y)`` and ``log_prob(x, y)`` bit
    for bit against the live model, its noise one tensor a level."""
    tm = torch_glow()
    x, y = t(image(2, 4, 3, 8, 8)), torch.tensor([0, 1, 2, 0])
    tm.init_actnorm(x, y)
    assert tm.set_temperature(0.5) is tm and all(q.temperature == 0.5 for q in tm.q0)
    with torch.no_grad():
        tm.sample(3, temperature=0.9, generator=torch.Generator().manual_seed(0))
    assert all(q.temperature == 0.5 for q in tm.q0)
    tm.reset_temperature()
    assert all(q.temperature is None for q in tm.q0)
    tm.save(str(tmp_path / "glow.pt"))
    loaded = nft.MultiscaleFlow.load(str(tmp_path / "glow.pt"))
    with torch.no_grad():
        assert torch.equal(loaded.log_prob(x, y), tm.log_prob(x, y))
    with pytest.raises(ValueError, match="class_cond=True"):
        serving.export_log_prob(tm, (3, 8, 8))
    manifest = serving.save_bundle(tm, str(tmp_path / "bundle"), 6, (3, 8, 8),
                                   class_cond=True)
    assert manifest["class_cond"] and manifest["noise_spec"] is None
    assert [lv[1] for lv in manifest["noise_levels"]] == [[24, 2, 2], [6, 4, 4]]
    bundle = serving.load_bundle(str(tmp_path / "bundle"))
    labels = torch.tensor([2, 0, 1, 1, 0, 2], dtype=torch.int32)
    xs, lq = bundle.sample(3, labels)
    with torch.no_grad():
        xl, lql = tm.sample(6, labels, generator=torch.Generator().manual_seed(3))
        assert torch.equal(xs, xl) and torch.equal(lq, lql)
        for b in (1, 4):
            assert torch.equal(bundle.log_prob(x[:b], y[:b]), tm.log_prob(x[:b], y[:b]))
    with pytest.raises(ValueError, match="needs the labels"):
        bundle.sample(3)


def test_multiscale_on_fixed_bases_samples():
    """A multiscale model whose bases hold buffers only (``DiagGaussian(...,
    trainable=False)``) draws on their device and dtype; its samples' log q
    is ``log_prob`` of them."""
    model = torch_glow()
    model.q0 = torch.nn.ModuleList(tdist.DiagGaussian(q.shape, trainable=False, device="cpu")
                                   for q in model.q0)
    model.class_cond = False
    with torch.no_grad():
        x, log_q = model.sample(3, generator=torch.Generator().manual_seed(0))
        assert x.shape == (3, 3, 8, 8)
        assert_close(model.log_prob(x).numpy(), log_q.numpy(), atol=LD_TOL, rtol=LD_TOL)


def test_class_cond_flow_matches_jax(monkeypatch):
    """``ClassCondFlow`` (a GlowBlock of hidden 4 and a Squeeze on 4 x 4 x 4, a
    class-conditional base on 1 x 8 x 8): ``log_prob``, ``forward_kld``'s
    gradient and ``sample`` on JAX's labels and noise."""
    jm = jnf.ClassCondFlow.create(jdist.ClassCondDiagGaussian.create((4, 4, 4), 3),
                                  [jflows.GlowBlock.create(jax.random.key(5), 4, 4),
                                   jflows.Squeeze()])
    tm = nft.ClassCondFlow(tdist.ClassCondDiagGaussian((4, 4, 4), 3, device="cpu"),
                           [tflows.GlowBlock(4, 4, device="cpu"), tflows.Squeeze()])
    tm = ported(jm, tm)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith("convs.2.weight") or name.startswith("q0."):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    jm = jax_model_of(tm, jm)
    x, y = np.random.default_rng(7).normal(size=(5, 1, 8, 8)).astype(np.float32), \
        np.array([0, 1, 2, 2, 1])
    key = jax.random.key(8)

    def everything(jm, x, y):
        diff, rest = jnf.partition(jm)
        grads = jax.grad(lambda d: jnf.combine(d, rest).forward_kld(x, y))(diff)
        return jm.log_prob(x, y), grads, jm.sample(key, 4)

    lpj, gj, (xj, lqj) = jax.jit(everything)(jm, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        assert_close(tm.log_prob(t(x), t(y)).numpy(), np.asarray(lpj), atol=LD_TOL,
                     rtol=LD_TOL)
    tm.forward_kld(t(x), t(y)).backward()
    check_grads(tm, {_torch_name(k): v for k, v in leaves_of(gj).items()})
    kq, _ = jax.random.split(key)
    kq, ky = jax.random.split(kq)
    yd = np.asarray(jax.random.randint(ky, (4,), 0, 3))
    feed(monkeypatch, tdist.base, yd, [np.asarray(jax.random.normal(kq, (4, 4, 4, 4)))])
    with torch.no_grad():
        xs, lq = tm.sample(4)
    assert_close(xs.numpy(), np.asarray(xj), atol=1e-4, rtol=1e-4)
    assert_close(lq.numpy(), np.asarray(lqj), atol=LD_TOL, rtol=LD_TOL)


# ---- Adamax and the chunk ------------------------------------------------------

def test_adamax_steps_match_optax():
    """Three steps of ``torch.optim.Adamax(lr, weight_decay=1e-5)`` against
    ``optax.chain(add_decayed_weights(1e-5), adamax(lr))`` on the same
    parameters and gradients (the infinity moment max(b2 nu, |g| + eps)):
    within 1e-6 of each parameter's values."""
    rng = np.random.default_rng(9)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    opt = optax.chain(optax.add_decayed_weights(1e-5), optax.adamax(1e-3))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    topt = torch.optim.Adamax(list(tp.values()), lr=1e-3, weight_decay=1e-5)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = t(g[k])
        topt.step()
        for k, p in tp.items():
            assert_close(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6, msg=k)


def test_chunk_with_adamax_and_warmup_cosine():
    """A chunk of 4 steps with ``torch.optim.Adamax`` (and the
    warmup-cosine schedule, which matches optax's to 1e-9) against the same
    steps taken eagerly with ``make_train_step`` on the CPU: bit for bit,
    Adamax's state (``exp_avg``, ``exp_inf``, ``step``) in the chunk's
    flat buffers; a non-finite loss keeps the whole update."""
    sched = training.warmup_cosine_decay_schedule(0.0, 6e-3, 2, 10, 6e-3 * 0.05)
    ref = optax.warmup_cosine_decay_schedule(0.0, 6e-3, 2, 10, end_value=6e-3 * 0.05)
    counts = np.arange(12)
    assert_close(sched(torch.tensor(counts)).numpy(),
                 np.array([float(ref(int(c))) for c in counts]), atol=1e-9, rtol=0)
    x = t(image(10, 16, 3, 8, 8))
    y = torch.tensor([0, 1, 2, 0] * 4)

    def fresh():
        m = torch_glow()
        m.init_actnorm(x[:8], y[:8])
        return m, torch.optim.Adamax(m.parameters(), lr=1e-3, weight_decay=1e-5)

    def loss_fn(m, b, g):
        return m.forward_kld(b[0], b[1])

    model, opt = fresh()
    state, chunk = training.make_chunked_train_step(model, opt, loss_fn, (x, y), 8, 4,
                                                    shuffle=False, schedule=sched)
    losses = chunk(state)[1]["loss"]
    eager, eopt = fresh()
    _, step = training.make_train_step(eager, eopt, loss_fn)
    estate = training.TrainState(eager, eopt)
    for i in range(4):
        for group in eopt.param_groups:
            group["lr"] = sched(torch.tensor(i))
        s = (i * 8) % (16 - 8 + 1)
        estate, m = step(estate, (x[s:s + 8], y[s:s + 8]))
        assert torch.equal(m["loss"], losses[i])
    for (name, p), q in zip(model.named_parameters(), eager.parameters()):
        assert torch.equal(p, q), name
    held = opt.state[next(model.parameters())]
    assert set(held) == {"exp_avg", "exp_inf", "step"} and int(held["step"]) == 4
    before = [p.detach().clone() for p in model.parameters()]
    inf_before = held["exp_inf"].clone()
    nan_state, nan_chunk = training.make_step_chunk(
        model, opt, lambda m, b, g: m.forward_kld(x[:8], y[:8]) * float("nan"), 2)
    assert not torch.isfinite(nan_chunk(nan_state)[1]["loss"]).any()
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), before))
    assert torch.equal(held["exp_inf"], inf_before) and int(held["step"]) == 4


# ---- the example against the JAX package's replay ---------------------------

def q_args(seed, iters, **over):
    cfg = {**Q, "iters": iters, **over}
    return ["--L", str(cfg["L"]), "--K", str(cfg["K"]), "--hidden", str(cfg["hidden"]),
            "--batch", str(cfg["batch"]), "--lr", str(cfg["lr"]),
            "--image-size", str(cfg["hw"]), "--classes", str(cfg["classes"]),
            "--images", str(cfg["images"]), "--iters", str(cfg["iters"]),
            "--seed", str(seed), "--chunked", "--host-inputs", "--device", "cpu"]


def replay(seed, iters, **over):
    """The JAX package trains the port example's model Q (its weights drawn
    from ``seed`` and ActNorm-initialised by the port) on the port
    example's host-drawn inputs of ``seed`` with the JAX script's optimizer
    and non-finite rule; returns the losses, the trained model and its
    held-out bits/dim on the port example's held-out inputs."""
    cfg = {**Q, "iters": iters, **over}
    shape = (3, cfg["hw"], cfg["hw"])
    x, y = glow_image.synthetic_images(cfg["images"], shape, cfg["classes"], seed)
    x_train, y_train = x[:-glow_image.HELD_OUT], y[:-glow_image.HELD_OUT]
    tmodel = glow_image.build_glow(cfg["L"], cfg["K"], cfg["hidden"], shape, cfg["classes"],
                                   device="cpu", seed=seed)
    tmodel.init_actnorm(*glow_image.init_inputs(x_train, y_train, cfg["batch"], seed))
    jmodel = jax_model_of(tmodel, jax_glow_module().build_glow(
        cfg["L"], cfg["K"], cfg["hidden"], shape, cfg["classes"]))
    xs, ys = (a.numpy() for a in glow_image.host_inputs(x_train, y_train, iters,
                                                         cfg["batch"], seed))
    opt = optax.chain(optax.add_decayed_weights(glow_image.WEIGHT_DECAY),
                      optax.adamax(cfg["lr"]))
    diff, rest = jnf.partition(jmodel)
    opt_state = opt.init(diff)

    @jax.jit
    def step(diff, opt_state, xb, yb):
        loss, grads = jax.value_and_grad(
            lambda d: jnf.combine(d, rest).forward_kld(xb, yb))(diff)
        finite = jnp.isfinite(loss)
        grads = jax.tree.map(lambda g: jnp.where(finite, g, 0.0), grads)
        updates, opt_state = opt.update(grads, opt_state, diff)
        return optax.apply_updates(diff, updates), opt_state, loss

    losses = []
    for i in range(iters):
        diff, opt_state, loss = step(diff, opt_state, xs[i], ys[i].astype(np.int32))
        losses.append(loss)
    losses = np.asarray(jnp.stack(losses))
    model = jnf.combine(diff, rest)
    xe, ye = glow_image.held_out_inputs(x, y, seed)
    nll = -np.asarray(jax.jit(lambda m, a, b: m.log_prob(a, b))(
        model, jnp.asarray(xe.numpy()), jnp.asarray(ye.numpy().astype(np.int32))),
        np.float64)
    dims = math.prod(shape)
    bpd = float(np.nansum(nll / np.log(2) / dims + 8) / np.sum(~np.isnan(nll)))
    return losses, model, bpd


def test_example_training_replays_through_jax():
    """20 host-input chunked steps of the example (L = 2, K = 1, hidden 16) on
    the CPU against the JAX package's replay of them: every loss within
    1e-4, the held-out bits/dim within 1e-4."""
    over = dict(K=1, hidden=16, images=1024 + 320)
    losses, _, bpd = replay(0, 20, **over)
    _, record = glow_image.main(q_args(0, 20, **over))
    got = np.asarray(record["losses_every_100"])
    assert_close(got, losses[::100], atol=LD_TOL, rtol=LD_TOL)
    assert abs(record["final_loss"] - float(losses[-1])) <= LD_TOL * abs(float(losses[-1]))
    assert abs(record["held_out_bits_per_dim"] - bpd) <= 1e-4
    assert record["non_finite_steps"] == 0 and record["samples_finite"]


def _seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-2", help="a seed or a range, e.g. 0-2")
    ap.add_argument("--iters", type=int, default=Q["iters"])
    args = ap.parse_args(argv)
    for seed in _seeds(args.seeds):
        t0 = time.time()
        losses, _, bpd = replay(seed, args.iters)
        print(json.dumps({"held_out_bits_per_dim": bpd, "final_loss": float(losses[-1]),
                          "losses_every_100": losses[::100].tolist(),
                          "non_finite_steps": int((~np.isfinite(losses)).sum()),
                          "seconds": time.time() - t0, "seed": seed, "iters": args.iters,
                          "config": Q, "device": "jax " + jax.default_backend()}),
              flush=True)


if __name__ == "__main__":
    main()
