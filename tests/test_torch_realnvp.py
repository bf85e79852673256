"""Real NVP in the port (``nets.MLP``, ``utils.nn.ClampExp``,
``flows.affine.coupling``, ``flows.reshape``) against the JAX package, from
the same weights (``load_jax_leaves``) and numpy inputs, on the CPU:

* ``MLP`` with each output function, a leaky slope and ``init_zeros``;
  dropout only in training mode;
* ``AffineConstFlow``, ``CCAffineConst``, ``AffineCoupling`` (each scale
  map, and without scale), ``MaskedAffineFlow`` (with its non-finite guard)
  and ``AffineCouplingBlock``: values and log-dets both ways, on non-zero
  weights so that every layer does work;
* ``Split`` and ``Merge`` in all four modes;
* the README's model (examples/real_nvp_twomoons.py) cut to K = 4:
  ``log_prob`` and every gradient leaf of ``forward_kld``, and a short
  ``make_chunked_train_step`` run with AdamW that lowers the loss;
* the example's own inputs and training (``real_nvp_twomoons.inputs``,
  sequential windows) cut to K = 4, against the JAX package's replay of
  them (:func:`replay`).

Bars: 1e-5 on a layer's values and log-dets, 1e-4 on the model's
log-densities and gradient leaves (tests/test_torch_coupling.py's)."""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from examples.real_nvp_twomoons import build_model as jax_real_nvp
from normflows_tpu.flows.affine import coupling as jcoupling
from normflows_tpu.flows.reshape import Merge as JMerge
from normflows_tpu.flows.reshape import Split as JSplit
from normflows_tpu.nets import MLP as JMLP
from normflows_tpu.training.loop import make_chunked_train_step
from normflows_tpu.utils.nn import ClampExp as JClampExp
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import training
from normflows_tpu_torch.examples import real_nvp_twomoons
from normflows_tpu_torch.examples.real_nvp_twomoons import build_model as torch_real_nvp
from normflows_tpu_torch.examples.real_nvp_twomoons import forward_kld_loss
from normflows_tpu_torch.flows.affine import coupling as tcoupling
from normflows_tpu_torch.interop import _torch_name, load_jax_leaves
from normflows_tpu_torch.nets import MLP
from normflows_tpu_torch.nets.mlp import Linear
from normflows_tpu_torch.utils.nn import ClampExp
from tests.helpers import assert_close

torch.set_num_threads(2)

Y_TOL, TOL, B = 1e-5, 1e-4, 128


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def perturbed(jmodel, seed, std=0.1):
    """Every float leaf of two or more axes (the weights, and AffineConst's
    s and t) plus noise of ``std``: the last layers of ``init_zeros`` nets
    do work then."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda leaf: leaf + std * rng.normal(size=leaf.shape).astype(np.float32)
        if jnp.issubdtype(leaf.dtype, jnp.floating) and leaf.ndim >= 2 else leaf, jmodel)


def ported(jmodel, tmodel):
    return load_jax_leaves(tmodel, leaves_of(jmodel))


def inputs(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy: JAX hands out read-only views


def real_nvp_pair(K=4, seed=0):
    """The README's model cut to K layers, JAX's and the port's, with every
    net's last layer perturbed from zero."""
    jm = perturbed(jax_real_nvp(K, jax.random.key(seed)), seed + 5)
    return jm, ported(jm, torch_real_nvp(K, "cpu"))


# ---- MLP ----------------------------------------------------------------

MLP_CASES = {
    "plain": {},
    "leaky": {"leaky": 0.2},
    "init_zeros": {"init_zeros": True},
    "sigmoid": {"output_fn": "sigmoid", "score_scale": 0.5, "output_scale": 2.0},
    "relu": {"output_fn": "relu"},
    "tanh": {"output_fn": "tanh", "output_scale": 3.0},
    "clampexp": {"output_fn": "clampexp", "leaky": 0.1},
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_matches_jax(case):
    kw = MLP_CASES[case]
    jm = JMLP.create(jax.random.key(1), [3, 16, 16, 5], **kw)
    tm = ported(jm, MLP([3, 16, 16, 5], device="cpu", **kw))
    x = inputs(2, (B, 3))
    with torch.no_grad():
        got = tm(t(x))
    assert_close(got.numpy(), np.asarray(jm(jnp.asarray(x))), atol=Y_TOL, rtol=Y_TOL)
    if kw.get("init_zeros"):
        assert not tm.linears[-1].weight.any() and tm.linears[0].weight.any()


def test_mlp_arguments():
    assert len(MLP(layers=[2, 4, 2], device="cpu").linears) == 2
    with pytest.raises(TypeError, match="either"):
        MLP([2, 2], layers=[2, 2], device="cpu")
    with pytest.raises(TypeError, match="required"):
        MLP(device="cpu")
    with pytest.raises(NotImplementedError, match="output function"):
        MLP([2, 2], output_fn="softmax", device="cpu")


def test_mlp_dropout_only_in_training():
    """In training mode the last layer's input is dropped out with draws
    from the generator (the same seed, the same mask); in eval mode the
    MLP is JAX's without dropout."""
    jm = JMLP.create(jax.random.key(3), [3, 32, 4], dropout_rate=0.5)
    tm = ported(jm, MLP([3, 32, 4], dropout=0.5, device="cpu"))
    x = t(inputs(4, (B, 3)))
    with torch.no_grad():
        a = tm(x, generator=torch.Generator().manual_seed(0))
        b = tm(x, generator=torch.Generator().manual_seed(0))
        c = tm(x, generator=torch.Generator().manual_seed(1))
        tm.eval()
        off = tm(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, off)
    assert_close(off.numpy(), np.asarray(jm(jnp.asarray(x.numpy()))), atol=Y_TOL, rtol=Y_TOL)


def test_clamp_exp_matches_jax():
    x = inputs(5, (B, 3)) * 3
    assert_close(ClampExp(0.7)(t(x)).numpy(), np.asarray(JClampExp(lam=0.7)(jnp.asarray(x))),
                 atol=Y_TOL, rtol=Y_TOL)


# ---- affine flows ------------------------------------------------------------

def _mlp_pair(seed, sizes):
    jm = JMLP.create(jax.random.key(seed), sizes, init_zeros=True)
    return jm, MLP(sizes, init_zeros=True, device="cpu")


def affine_const():
    return (jcoupling.AffineConstFlow.create((4,)),
            tcoupling.AffineConstFlow.create((4,), device="cpu"))


def affine_const_broadcast():
    # s and t of shape (1, 3, 1): the log-det counts the 5 positions
    return (jcoupling.AffineConstFlow.create((3, 1)),
            tcoupling.AffineConstFlow.create((3, 1), device="cpu"))


def affine_const_no_scale():
    return (jcoupling.AffineConstFlow.create((4,), scale=False),
            tcoupling.AffineConstFlow.create((4,), scale=False, device="cpu"))


def coupling(scale=True, scale_map="exp"):
    def make():
        jm, tm = _mlp_pair(6, [2, 16, 4 if scale else 2])
        return (jcoupling.AffineCoupling(param_map=jm, scale=scale, scale_map=scale_map),
                tcoupling.AffineCoupling(tm, scale, scale_map))
    return make


def masked_affine():
    (js, ts), (jt, tt) = _mlp_pair(7, [4, 16, 4]), _mlp_pair(8, [4, 16, 4])
    b = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    return (jcoupling.MaskedAffineFlow.create(jnp.asarray(b), t=jt, s=js),
            tcoupling.MaskedAffineFlow.create(b, t=tt, s=ts, device="cpu"))


def masked_affine_shift_only():
    jt, tt = _mlp_pair(9, [4, 16, 4])
    b = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    return (jcoupling.MaskedAffineFlow.create(jnp.asarray(b), t=jt),
            tcoupling.MaskedAffineFlow.create(b, t=tt, device="cpu"))


def block(mode, scale_map="exp"):
    def make():
        jm, tm = _mlp_pair(10, [2, 16, 4])
        return (jcoupling.AffineCouplingBlock.create(jm, scale_map=scale_map, split_mode=mode),
                tcoupling.AffineCouplingBlock.create(tm, scale_map=scale_map, split_mode=mode))
    return make


LAYERS = {
    "affine_const": (affine_const, (B, 4)),
    "affine_const_broadcast": (affine_const_broadcast, (B, 3, 5)),
    "affine_const_no_scale": (affine_const_no_scale, (B, 4)),
    "coupling_exp": (coupling(), None),
    "coupling_sigmoid": (coupling(scale_map="sigmoid"), None),
    "coupling_sigmoid_inv": (coupling(scale_map="sigmoid_inv"), None),
    "coupling_shift": (coupling(scale=False), None),
    "masked_affine": (masked_affine, (B, 4)),
    "masked_affine_shift_only": (masked_affine_shift_only, (B, 4)),
    "block_channel": (block("channel"), (B, 4)),
    "block_checkerboard_sigmoid": (block("checkerboard", "sigmoid"), (B, 4)),
}


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_affine_layer_matches_jax(name, direction):
    make, shape = LAYERS[name]
    jl, tl = make()
    jl = perturbed(jl, 11)
    tl = ported(jl, tl)
    if shape is None:  # a coupling takes the split pair
        z = [inputs(12, (B, 2)), inputs(13, (B, 2))]
        (jz, jld), (tz, tld) = getattr(jl, direction)([jnp.asarray(a) for a in z]), \
            getattr(tl, direction)([t(a) for a in z])
        pairs = list(zip(tz, jz))
    else:
        z = inputs(12, shape)
        (jz, jld), (tz, tld) = getattr(jl, direction)(jnp.asarray(z)), \
            getattr(tl, direction)(t(z))
        pairs = [(tz, jz)]
    for got, want in pairs:
        assert_close(got.detach().numpy(), np.asarray(want), atol=Y_TOL, rtol=Y_TOL)
    assert tld.shape == (B,)
    assert_close(tld.detach().numpy(), np.asarray(jld), atol=Y_TOL, rtol=Y_TOL)


def test_cc_affine_const_matches_jax():
    jl = perturbed(jcoupling.CCAffineConst.create((4,), 3), 14)
    tl = ported(jl, tcoupling.CCAffineConst.create((4,), 3, device="cpu"))
    z = inputs(15, (B, 4))
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(16).integers(0, 3, B)]
    for direction in ("forward", "inverse"):
        jz, jld = getattr(jl, direction)(jnp.asarray(z), jnp.asarray(y))
        tz, tld = getattr(tl, direction)(t(z), t(y))
        assert_close(tz.detach().numpy(), np.asarray(jz), atol=Y_TOL, rtol=Y_TOL)
        assert_close(tld.detach().numpy(), np.asarray(jld), atol=Y_TOL, rtol=Y_TOL)


def test_masked_affine_guards_non_finite_net_outputs():
    """A net output that is not finite counts as 0, as in the JAX package."""
    class Poisoned(torch.nn.Module):
        def forward(self, x):
            return torch.where(x[:, :1] > 0, float("inf"), 1.0).expand_as(x)

    layer = tcoupling.MaskedAffineFlow.create([1.0, 0.0], t=Poisoned(), s=Poisoned(),
                                              device="cpu")
    z = t(inputs(17, (B, 2)))
    out, ld = layer.forward(z)
    assert torch.isfinite(out).all() and torch.isfinite(ld).all()
    neg = z[:, 0] <= 0
    assert torch.equal(ld[~neg], torch.zeros(int((~neg).sum())))
    assert torch.allclose(out[~neg, 1], z[~neg, 1])


# ---- Split / Merge ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["channel", "channel_inv", "checkerboard",
                                  "checkerboard_inv"])
@pytest.mark.parametrize("shape", [(B, 6), (B, 3, 4, 6)], ids=["flat", "image"])
def test_split_and_merge_match_jax(mode, shape):
    z = inputs(18, shape)
    (j1, j2), jld = JSplit(mode=mode).forward(jnp.asarray(z))
    (t1, t2), tld = tflows.Split(mode).forward(t(z))
    for got, want in ((t1, j1), (t2, j2)):
        assert got.shape == want.shape and np.array_equal(got.numpy(), np.asarray(want))
    assert not tld.any() and tld.shape == (B,)
    back, _ = tflows.Split(mode).inverse([t1, t2])
    assert torch.equal(back, t(z))
    merged, _ = tflows.Merge(mode).forward([t1, t2])
    jmerged, _ = JMerge(mode=mode).forward([j1, j2])
    assert np.array_equal(merged.numpy(), np.asarray(jmerged))
    (m1, m2), _ = tflows.Merge(mode).inverse(merged)
    assert torch.equal(m1, t1) and torch.equal(m2, t2)
    with pytest.raises(NotImplementedError):
        tflows.Split("rows")


# ---- the README's model -------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return real_nvp_pair()


def moons(seed, n=256):
    return np.asarray(jnf.distributions.TwoMoons().sample(jax.random.key(seed), n))


def test_model_log_prob_and_gradients_match_jax(pair):
    jm, tm = pair
    x = moons(19)
    assert_close(tm.log_prob(t(x)).detach().numpy(), np.asarray(jm.log_prob(jnp.asarray(x))),
                 atol=TOL, rtol=TOL)
    diff, rest = jnf.partition(jm)
    vj, gj = jax.value_and_grad(lambda d: jnf.combine(d, rest).forward_kld(jnp.asarray(x)))(
        diff)
    want = dict(ported(jnf.combine(gj, rest), torch_real_nvp(4, "cpu")).named_parameters())
    tm.zero_grad()
    loss = tm.forward_kld(t(x))
    loss.backward()
    assert_close(float(loss.detach()), float(vj), atol=TOL, rtol=TOL)
    named = dict(tm.named_parameters())
    assert named.keys() == want.keys() and len(named) == 2 + 4 * 2 * 6
    for name, p in named.items():
        assert_close(p.grad.numpy(), want[name].detach().numpy(), atol=TOL, rtol=TOL,
                     msg=name)


def test_chunked_training_lowers_the_loss():
    """Two chunks of 25 AdamW steps on 2^12 TwoMoons points from the
    identity init: the second chunk's mean loss lies below the first's."""
    model = torch_real_nvp(4, "cpu", torch.Generator().manual_seed(0))
    data = model.p.sample(2**12, generator=torch.Generator().manual_seed(1))
    opt = torch.optim.AdamW(model.parameters(), lr=5e-3, weight_decay=1e-5)
    state, chunk = training.make_chunked_train_step(model, opt, forward_kld_loss, data, 256,
                                                    chunk_len=25)
    gen = torch.Generator().manual_seed(2)
    first = chunk(state, gen)[1]["loss"]
    second = chunk(state, gen)[1]["loss"]
    assert torch.isfinite(first).all() and torch.isfinite(second).all()
    assert float(second.mean()) < float(first.mean()) - 0.1
    assert int(state.step) == 50



def test_example_training_replays_through_jax():
    """The example's inputs (``real_nvp_twomoons.inputs``) at seed 0 cut to
    K = 4: 40 sequential AdamW steps of the port on the CPU against the JAX
    package's replay of them (:func:`replay`), every
    loss and the held-out log q within 1e-4."""
    want = replay(0, iters=40, K=4, chunk=10)
    model, x_all, x_held_out = real_nvp_twomoons.inputs(4, 0)
    opt = torch.optim.AdamW(model.parameters(), lr=5e-4, weight_decay=1e-5)
    state, chunk = training.make_chunked_train_step(model, opt, forward_kld_loss, x_all, 512,
                                                    chunk_len=10, shuffle=False)
    losses = torch.cat([chunk(state)[1]["loss"] for _ in range(4)])
    assert_close(losses.numpy(), want["losses"], atol=TOL, rtol=TOL)
    with torch.no_grad():
        log_q = float(torch.mean(model.log_prob(x_held_out)))
    assert_close(log_q, want["held_out_log_q"], atol=TOL, rtol=TOL)


# ---- the example replayed through the JAX package ----------------------------
#
# The port's Real NVP example (``real_nvp_twomoons``) draws its inputs on the
# host from a seed: the weights, training points and held-out points.
# ``replay`` trains the JAX package's model on them with its
# ``make_chunked_train_step`` and ``optax.adamw(lr, weight_decay=1e-5)`` in the
# same sequential windows, on the CPU, so that a run of the example on any
# device and this replay differ only by the arithmetic of their frameworks
# and devices.  At full size, one JSON line a seed, with the example's keys:
#
#     JAX_PLATFORMS=cpu python -m tests.test_torch_realnvp [--seeds 0-7]
#         [--iters 4000] [--k 32] [--batch 512] [--lr 5e-4] [--chunk 100]


def jax_model_of(tmodel, K):
    """The JAX package's Real NVP holding the port model's weights: the
    inverse of ``interop.load_jax_leaves`` (a ``Linear``'s (out, in)
    weight transposed back to (in, out))."""
    jmodel = jax_real_nvp(K, jax.random.key(0))
    tensors = {**dict(tmodel.named_parameters()), **dict(tmodel.named_buffers())}
    paths, treedef = jax.tree_util.tree_flatten_with_path(jmodel)
    leaves = []
    for path, leaf in paths:
        name = _torch_name(jax.tree_util.keystr(path))
        value = np.array(tensors[name].detach().cpu())  # a copy: jnp.asarray may alias it
        owner, _, attr = name.rpartition(".")
        if attr == "weight" and isinstance(tmodel.get_submodule(owner), Linear):
            value = value.T
        if value.shape != leaf.shape:
            raise ValueError(f"{name}: the port's {value.shape}, JAX's {leaf.shape}")
        leaves.append(jnp.asarray(value, leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def replay(seed, iters=4000, K=32, batch=512, lr=5e-4, chunk=100):
    """Train the JAX package's model on the example's inputs at ``seed``;
    returns the record."""
    tmodel, x_all, x_held_out = real_nvp_twomoons.inputs(K, seed)
    jmodel = jax_model_of(tmodel, K)
    x_all, x_held_out = x_all.numpy(), x_held_out.numpy()
    state, chunk_fn = make_chunked_train_step(
        jmodel, optax.adamw(lr, weight_decay=1e-5),
        lambda m, b, key: m.forward_kld(b), x_all, batch, chunk, shuffle=False)
    key = jax.random.key(seed)
    losses = []
    t0 = time.time()
    for _ in range(iters // chunk):
        state, metrics = chunk_fn(state, key)
        losses.append(np.asarray(metrics["loss"]))
    losses = np.concatenate(losses)
    seconds = time.time() - t0
    model = jnf.combine(state.diff, state.rest)
    n = real_nvp_twomoons.HELD_OUT
    z, _ = model.sample(jax.random.key(seed + 3), n)
    return {"final_kld": float(losses[-1]),
            "train_log_q": float(jnp.mean(model.log_prob(x_all[:n]))),
            "held_out_log_q": float(jnp.mean(model.log_prob(x_held_out))),
            "ring_radius": float(jnp.mean(jnp.linalg.norm(z, axis=1))),
            "losses_every_100": losses[::100].tolist(),
            "non_finite_steps": int((~np.isfinite(losses)).sum()),
            "losses": losses, "seconds": seconds, "seed": seed, "iters": iters, "k": K,
            "batch": batch, "chunk": chunk, "device": "jax " + jax.default_backend()}


def _seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-7", help="a seed or a range, e.g. 0-7")
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--chunk", type=int, default=100)
    args = ap.parse_args(argv)
    for seed in _seeds(args.seeds):
        record = replay(seed, args.iters, args.k, args.batch, args.lr, args.chunk)
        record.pop("losses")
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
