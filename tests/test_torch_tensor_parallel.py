"""The port's tensor parallelism, FSDP and sharded checkpoints
(``normflows_tpu_torch.parallel.tensor_parallel``, ``training.checkpoint``)
in a world of four CPU processes joined by gloo, against the JAX package's
``parallel`` on conftest's virtual devices and against the single-process
port.  It mirrors tests/test_tensor_parallel.py and
tests/test_sharded_checkpoint.py.

One world is started for the module and runs every check; the JAX
package's steps and the single-process port's are computed while it runs,
on the same weights (``load_jax_leaves``) and inputs:

* the AR NSF of tests/test_tensor_parallel.py (hidden 64, 2 layers, its
  weights perturbed so that the splines do work) under a tensor-parallel
  step on ``{"data": 2, "model": 2}``, one Adam(1e-3) step of forward KL
  against JAX's ``make_tensor_parallel_step`` on ``{"data": 2, "model":
  4}`` and against ``training.make_train_step``; with JAX's test's loss,
  ``forward_kld(b) + 0.1 reverse_kld(16)`` on JAX's own draws (a stub base
  hands them out; the sampling direction's recursion), against
  ``make_train_step`` (JAX's compile of that step alone takes ~12 s on
  the virtual devices); the MADE's hidden layers really sharded, column
  and row; with Megatron's f planted without its all-reduce, the gradient
  misses the bar that chip_smoke.py holds a sharded step's leaves to
  (1e-5 of each leaf's own norm), which the sound step meets;
* the MLP coupling model (hidden 64, 4 layers) the same way, forward KL;
  with hidden 51, which the axis does not divide: nothing sharded, the
  same step; the caller's model untouched by a tensor-parallel step and
  then an FSDP step built from it;
* FSDP over the model axis (``min_size`` 64 x 64) on the MLP model: the
  hidden weights and their Adam moments sharded, the step against JAX's
  ``make_fsdp_step`` and the single-process port;
* a class-conditional Glow (L = 2, K = 2, hidden 32, 3 x 8 x 8) whose
  coupling nets' convolutions are sharded out- and in-channel, one SGD(1e-3)
  step of forward KL;
* checkpoints: tensor-parallel and FSDP state saved after two steps,
  restored into a fresh step's state, bit-equal, and one more step from it
  bit-equal to the uninterrupted step; tensor-parallel state restored onto
  ``{"data": 1, "model": 4}``, onto the FSDP layout and, after the world
  ends, onto a single process's plain state; ``CheckpointManager`` restores
  the layout and keeps the newest directories;
* an optimizer passed where the steps take a factory raises.

Bars: against JAX, its own: the loss 1e-5, every parameter after the step
1e-6 (Glow 1e-4 / 1e-5); against the single-process port 1e-6 (the loss
relative, the parameters absolute); checkpoints exact.
"""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
import normflows_tpu_torch as tnf
from normflows_tpu import parallel as jparallel
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import training
from normflows_tpu_torch.nets import MLP
from tests.test_tensor_parallel import _ar_nsf_model, _mlp_coupling_model
from tests.test_torch_conditional import ported
from tests.test_torch_multiscale import glow_pair
from tests.test_torch_parallel import Draw, free_port, join_world, start_world

torch.set_num_threads(2)

JAX_LOSS, JAX_LEAF = 1e-5, 1e-6
GLOW_LOSS, GLOW_LEAF = 1e-4, 1e-5
PORT_TOL = 1e-6
BATCH, N_REV, LR = 16, 16, 1e-3

WORKER = '''
import os
import sys
import time
import torch
from torch.distributed.tensor import DTensor, Shard

rank, world, addr, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
from normflows_tpu_torch import parallel, training
from normflows_tpu_torch.parallel import tensor_parallel
from normflows_tpu_torch.parallel.tensor_parallel import sharded_dim

parallel.initialize_distributed(addr, world, rank, device="cpu", timeout=120)
inp = torch.load(inputs, weights_only=False)
mesh = parallel.make_mesh({"data": 2, "model": 2}, devices="cpu")
rows = parallel.batch_sharding(mesh, 2)
got = {}


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def params(model):
    return {n: full(p) for n, p in model.named_parameters()}


def specs(model):
    """(name, sharded dim, local shape, global shape) of the sharded leaves."""
    return [(n, next(p.dim for p in t.placements if isinstance(p, Shard)),
             tuple(t.to_local().shape), tuple(t.shape))
            for n, t in [*model.named_parameters(), *model.named_buffers()]
            if isinstance(t, DTensor)]


def adam(ps):
    return torch.optim.Adam(ps, lr=inp["lr"])


class Draw(torch.nn.Module):
    """Hands out JAX's global draw ``(z, log_q)``; the real base's log_prob."""

    def __init__(self, base, z, log_q):
        super().__init__()
        self.base, self.z, self.log_q = base, z, log_q

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        return self.z.clone(), self.log_q.clone()

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


# ---- tensor parallelism: the MADE nets ----
made = inp["made"]
made.q0 = Draw(made.q0, *inp["draw"])


def made_loss(m, b, g):
    return m.forward_kld(b) + 0.1 * m.reverse_kld(inp["n_rev"], z_sharding=rows)


def unreduced(ctx, g):
    """Megatron's f with its all-reduce left out: a planted fault."""
    return g, None


sound_f = tensor_parallel._EnterModel.backward
for key, loss_fn in (("made", made_loss), ("made_fkld", lambda m, b, g: m.forward_kld(b)),
                     ("made_fkld_unreduced", lambda m, b, g: m.forward_kld(b))):
    if key == "made_fkld_unreduced":
        tensor_parallel._EnterModel.backward = staticmethod(unreduced)
    state, step = parallel.make_tensor_parallel_step(made, adam, loss_fn, mesh)
    state, metrics = step(state, parallel.shard_batch(inp["x"], mesh))
    tensor_parallel._EnterModel.backward = sound_f
    got[key] = {"loss": float(metrics["loss"]), "params": params(state.model),
                "specs": specs(state.model), "collectives": metrics["collectives"],
                "grads": {n: full(p.grad) for n, p in state.model.named_parameters()
                          if p.grad is not None}}

# ---- the MLP nets, and a hidden width the axis does not divide ----
for key in ("mlp", "mlp51"):
    model = inp[key]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, step = parallel.make_tensor_parallel_step(model, adam,
                                                     lambda m, b, g: m.forward_kld(b), mesh)
    state, metrics = step(state, parallel.shard_batch(inp["x"], mesh))
    got[key] = {"loss": float(metrics["loss"]), "params": params(state.model),
                "specs": specs(state.model)}
    if key == "mlp":
        # the caller's model survives: an FSDP step from it too, its tensors untouched
        fs, fstep = parallel.make_fsdp_step(model, adam, lambda m, b, g: m.forward_kld(b),
                                            mesh, axis="model", min_size=64 * 64)
        fs, fmetrics = fstep(fs, parallel.shard_batch(inp["x"], mesh))
        moments = [(n, type(v).__name__, sharded_dim(v.placements, v.device_mesh, "model"))
                   for n, p in fs.model.named_parameters() if isinstance(p, DTensor)
                   for k, v in fs.optimizer.state[p].items() if k != "step"]
        got["fsdp"] = {"loss": float(fmetrics["loss"]), "params": params(fs.model),
                       "specs": specs(fs.model), "moments": moments,
                       "collectives": fmetrics["collectives"]}
        got["caller_untouched"] = all(
            torch.equal(before[n], p) and not isinstance(p, DTensor)
            for n, p in model.named_parameters())

# ---- Glow's convolution nets, SGD (their inputs made after the world started) ----
for _ in range(1200):
    if os.path.exists(f"{out}/glow.pt"):
        break
    time.sleep(0.1)
inp.update(torch.load(f"{out}/glow.pt", weights_only=False))
glow = inp["glow"]
state, step = parallel.make_tensor_parallel_step(
    glow, lambda groups: torch.optim.SGD(groups, lr=inp["lr"]),
    lambda m, b, g: m.forward_kld(*b), mesh)
state, metrics = step(state, (parallel.shard_batch(inp["images"], mesh),
                              parallel.shard_batch(inp["labels"], mesh)))
got["glow"] = {"loss": float(metrics["loss"]), "params": params(state.model),
               "specs": specs(state.model)}

# ---- checkpoints ----
def rev_loss(m, b, g):
    return m.reverse_kld(64, z_sharding=rows, generator=g)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def tp_state(on_mesh, model_key="ckpt"):
    return parallel.make_tensor_parallel_step(inp[model_key], adam, rev_loss, on_mesh)


def locals_equal(a, b):
    ta = dict([*a.model.named_parameters(), *a.model.named_buffers()])
    tb = dict([*b.model.named_parameters(), *b.model.named_buffers()])
    same = all(torch.equal(full(ta[n]), full(tb[n])) for n in ta)
    placed = all((getattr(ta[n], "placements", None) == getattr(tb[n], "placements", None))
                 for n in ta)
    sa = [v for p in a.optimizer.state.values() for v in p.values()]
    sb = [v for p in b.optimizer.state.values() for v in p.values()]
    moments = len(sa) == len(sb) and all(torch.equal(full(x), full(y)) for x, y in zip(sa, sb))
    return same and placed and moments and a.step == b.step


def roundtrip(make, directory):
    state, step = make()
    for i in range(2):
        state, _ = step(state, None, gen(i))
    training.save_checkpoint(directory, state)
    fresh, fresh_step = make()
    restored = training.restore_checkpoint(directory, fresh)
    equal = locals_equal(restored, state)
    state, m1 = step(state, None, gen(99))
    restored, m2 = fresh_step(restored, None, gen(99))
    return {"restored_equal": equal, "losses": (float(m1["loss"]), float(m2["loss"])),
            "resumed_equal": locals_equal(state, restored) and torch.equal(m1["loss"], m2["loss"]),
            "sharded": len(specs(state.model)) > 0, "params": params(state.model)}


root = inp["root"]
got["tp_roundtrip"] = roundtrip(lambda: tp_state(mesh), f"{root}/tp")
fsdp_mesh = parallel.make_mesh({"data": 4}, devices="cpu")
rows4 = parallel.batch_sharding(fsdp_mesh, 2)


def fsdp_state(model_key="ckpt_mlp"):
    return parallel.make_fsdp_step(inp[model_key], adam,
                                   lambda m, b, g: m.reverse_kld(64, z_sharding=rows4,
                                                                 generator=g),
                                   fsdp_mesh, min_size=2 ** 10)


got["fsdp_roundtrip"] = roundtrip(fsdp_state, f"{root}/fsdp")

# tensor-parallel state onto another mesh, onto FSDP's layout
state, step = tp_state(mesh)
state, _ = step(state, None, gen(0))
training.save_checkpoint(f"{root}/cross", state)
got["cross_saved"] = {"params": params(state.model),
                      "moments": {n: {k: full(v) for k, v in state.optimizer.state[p].items()}
                                  for n, p in state.model.named_parameters()}}
other = parallel.make_mesh({"data": 1, "model": 4}, devices="cpu")
onto, _ = tp_state(other)
onto = training.restore_checkpoint(f"{root}/cross", onto)
got["cross_mesh"] = {"params": params(onto.model), "specs": specs(onto.model),
                     "mesh": [(tuple(t.device_mesh.mesh_dim_names), tuple(t.device_mesh.shape))
                              for t in onto.model.parameters() if isinstance(t, DTensor)]}
fsdp_onto, _ = parallel.make_fsdp_step(inp["ckpt"], adam, rev_loss, fsdp_mesh,
                                       min_size=2 ** 10)
fsdp_onto = training.restore_checkpoint(f"{root}/cross", fsdp_onto)
got["cross_fsdp"] = {"params": params(fsdp_onto.model),
                     "moments": {n: {k: full(v) for k, v in fsdp_onto.optimizer.state[p].items()}
                                 for n, p in fsdp_onto.model.named_parameters()},
                     "fsdp_sharded": [(n, sharded_dim(t.placements, t.device_mesh, "data"))
                                      for n, t in fsdp_onto.model.named_parameters()
                                      if isinstance(t, DTensor)]}

# the manager: the template's layout, the newest kept
manager = training.CheckpointManager(f"{root}/manager", max_to_keep=2)
for s in (1, 2, 3):
    manager.save(s, state)
template, _ = tp_state(mesh)
restored = manager.restore(template)
got["manager"] = {"steps": manager.all_steps(), "equal": locals_equal(restored, state)}
torch.save(got, f"{out}/rank{rank}.pt")
print("WORLDOK", rank, flush=True)
'''


def perturbed(jmodel, seed, std=0.1):
    """Every float weight of two or more axes plus noise of ``std`` (the
    masks kept): the zero last layers then do work."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("mask") or x.ndim < 2 \
                or not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        return x + std * rng.normal(size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jmodel)


def jax_ar_nsf():
    return perturbed(_ar_nsf_model(hidden=64, K=2), 11)


def torch_ar_nsf(hidden=64, layers=2):
    return tnf.NormalizingFlow.create(
        tdist.UniformGaussian.create(2, [1], np.array([1.0, 2 * np.pi], np.float32),
                                     device="cpu"),
        [tflows.CircularAutoregressiveRationalQuadraticSpline.create(
            torch.Generator().manual_seed(i), 2, 1, hidden, ind_circ=[1], num_bins=4,
            tail_bound=np.array([5.0, np.pi], np.float32), permute_mask=True, rng_seed=i,
            device="cpu") for i in range(layers)],
        p=tdist.GaussianVonMises(device="cpu"), device="cpu")


def torch_mlp_coupling(hidden=64, layers=4):
    gen = torch.Generator().manual_seed(7)
    flows = [tflows.MaskedAffineFlow.create(
        torch.tensor([i % 2, (i + 1) % 2], dtype=torch.float32),
        t=MLP.create(gen, [2, hidden, hidden, 2], init_zeros=True, device="cpu"), s=None,
        device="cpu") for i in range(layers)]
    return tnf.NormalizingFlow.create(tdist.DiagGaussian(2, device="cpu"), flows,
                                      p=tdist.TwoMoons(device="cpu"), device="cpu")


def jax_after(step, port_like, *args):
    """The loss of one step of the JAX package's ``(step_fn, diff, rest,
    opt_state)`` and the parameters after it, named as the port's."""
    step_fn, diff, rest, opt_state = step
    new, _, loss = step_fn(diff, opt_state, *args)
    after = ported(jnf.combine(new, rest), port_like)
    return float(loss), {n: p.detach() for n, p in after.named_parameters()}


def port_after(model, loss_fn, batch, opt=None, grads=False):
    """The single-process port's loss and parameters after one step (and,
    with ``grads``, the step's gradients)."""
    opt = opt or torch.optim.Adam(model.parameters(), lr=LR)
    state, step = training.make_train_step(model, opt, loss_fn)
    _, metrics = step(state, batch)
    out = (float(metrics["loss"]), {n: p.detach().clone() for n, p in model.named_parameters()})
    if grads:
        out += ({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """What each rank of the world of four sent back, beside the JAX
    package's and the single-process port's results on the same inputs.
    The world starts once the MADE and MLP models are made; the Glow model,
    slower to make, follows in a second file that the ranks wait for; the
    JAX steps compile and run on a thread beside both."""
    root = tmp_path_factory.mktemp("tensor_parallel_world")
    x = np.random.default_rng(1).normal(size=(BATCH, 2)).astype(np.float32)
    jm_made = jax_ar_nsf()
    key = jax.random.key(2)
    z, log_q = jax.jit(lambda k: jm_made.q0.sample_and_log_prob(jax.random.split(k)[0],
                                                                 N_REV))(key)
    draw = (torch.from_numpy(np.array(z)), torch.from_numpy(np.array(log_q)))
    jm_mlp = perturbed(_mlp_coupling_model(), 12)
    jm_mlp51 = perturbed(_mlp_coupling_model(hidden=51, K=2), 13)

    def made():
        return ported(jm_made, torch_ar_nsf())

    def mlp():
        return ported(jm_mlp, torch_mlp_coupling())

    def mlp51():
        return ported(jm_mlp51, torch_mlp_coupling(51, 2))

    mesh = jparallel.make_mesh({"data": 2, "model": 4})
    xs = jparallel.shard_batch(jnp.asarray(x), mesh)

    def fkld(m, b, k):
        return m.forward_kld(b)

    pool = ThreadPoolExecutor(1)
    jax_jobs = {
        "jax_made_fkld": pool.submit(lambda: jax_after(jparallel.make_tensor_parallel_step(
            jm_made, optax.adam(LR), fkld, mesh, donate=False), made(), xs, key)),
        "jax_mlp": pool.submit(lambda: jax_after(jparallel.make_tensor_parallel_step(
            jm_mlp, optax.adam(LR), fkld, mesh, donate=False), mlp(), xs, jax.random.key(3))),
        "jax_mlp51": pool.submit(lambda: jax_after(jparallel.make_tensor_parallel_step(
            jm_mlp51, optax.adam(LR), fkld, mesh, donate=False), mlp51(), xs,
            jax.random.key(4))),
        "jax_fsdp": pool.submit(lambda: jax_after(jparallel.make_fsdp_step(
            jm_mlp, optax.adam(LR), fkld, mesh, axis="model", min_size=64 * 64,
            donate=False), mlp(), xs, jax.random.key(5)))}
    torch.save({"made": made(), "draw": draw, "x": torch.from_numpy(x), "n_rev": N_REV,
                "lr": LR, "mlp": mlp(), "mlp51": mlp51(), "ckpt": made(), "ckpt_mlp": mlp(),
                "root": str(root)}, root / "inputs.pt")
    script = root / "worker.py"
    script.write_text(WORKER)
    procs = start_world(script, [f"127.0.0.1:{free_port()}", str(root / "inputs.pt"),
                                 str(root)], world=4)
    try:
        jm_glow, tm_glow = glow_pair(class_cond=True, L=2, K=2, hidden=32, nc=10)
        images = np.random.default_rng(20).uniform(0.01, 0.99,
                                                   (BATCH, 3, 8, 8)).astype(np.float32)
        labels = np.random.default_rng(21).integers(0, 10, BATCH)
        jm_glow = jax.jit(lambda m, x, y: m.init_actnorm(x, y))(
            jm_glow, jnp.asarray(images), jnp.asarray(labels))

        def glow():
            return ported(jm_glow, copy.deepcopy(tm_glow))

        torch.save({"glow": glow(), "images": torch.from_numpy(images),
                    "labels": torch.from_numpy(labels)}, root / "glow.tmp")
        os.replace(root / "glow.tmp", root / "glow.pt")
        jax_jobs["jax_glow"] = pool.submit(lambda: jax_after(
            jparallel.make_tensor_parallel_step(
                jm_glow, optax.sgd(LR), lambda m, b, k: m.forward_kld(*b), mesh,
                donate=False), glow(),
            (jparallel.shard_batch(jnp.asarray(images), mesh),
             jparallel.shard_batch(jnp.asarray(labels), mesh)), jax.random.key(6)))
        tm = made()
        tm.q0 = Draw(tm.q0, *draw)
        ref = {"port_made": port_after(
            tm, lambda m, b, g: m.forward_kld(b) + 0.1 * m.reverse_kld(N_REV),
            torch.from_numpy(x)),
            "port_made_fkld": port_after(made(), lambda m, b, g: m.forward_kld(b),
                                         torch.from_numpy(x), grads=True)}
        for k, build in (("mlp", mlp), ("mlp51", mlp51)):
            ref[f"port_{k}"] = port_after(build(), lambda m, b, g: m.forward_kld(b),
                                          torch.from_numpy(x))
        g = glow()
        ref["port_glow"] = port_after(g, lambda m, b, g_: m.forward_kld(*b),
                                      (torch.from_numpy(images), torch.from_numpy(labels)),
                                      torch.optim.SGD(g.parameters(), lr=LR))
        ref.update({k: job.result() for k, job in jax_jobs.items()})
    finally:
        pool.shutdown()
        outs = join_world(procs)
    assert all(f"WORLDOK {r}" in out for r, out in enumerate(outs))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)]
    # the tensor-parallel checkpoint onto a single process's plain state
    single = made()
    plain = training.restore_checkpoint(
        str(root / "cross"), training.TrainState(single, torch.optim.Adam(single.parameters(),
                                                                          lr=LR)))
    return {"ranks": ranks, "plain": plain, **ref}


def hold(got, port, jax_ref=None, loss_tol=JAX_LOSS, leaf_tol=JAX_LEAF):
    """A sharded step's loss and parameters after it, the same on every
    rank, against the single-process port's and JAX's (where given)."""
    r0 = got[0]
    for r in got[1:]:
        assert r["loss"] == r0["loss"]
        for n, p in r0["params"].items():
            assert torch.equal(p, r["params"][n]), n
    loss, params = port
    assert abs(r0["loss"] - loss) <= PORT_TOL * abs(loss)
    assert r0["params"].keys() == params.keys()
    for n, p in r0["params"].items():
        assert float((p - params[n]).abs().max()) <= PORT_TOL, n
    if jax_ref is None:
        return
    jloss, jparams = jax_ref
    assert abs(r0["loss"] - jloss) <= loss_tol
    assert r0["params"].keys() == jparams.keys()
    for n, p in r0["params"].items():
        assert float((p - jparams[n]).abs().max()) <= leaf_tol, n


def test_made_net_matches_one_process_and_jax(world):
    hold([r["made_fkld"] for r in world["ranks"]], world["port_made_fkld"][:2],
         world["jax_made_fkld"])


def test_missing_collective_misses_the_gradient_bar(world):
    """Megatron's f without its all-reduce (a planted fault in the backward
    of each column-parallel layer's input) misses the bar that
    chip_smoke.py holds each gradient leaf of a sharded step to, 1e-5 of
    the single-process leaf's own norm; the sound step meets it."""
    *_, want = world["port_made_fkld"]

    def worst(got):
        return max(float((got[n] - w).norm() / w.norm()) for n, w in want.items()
                   if float(w.norm()) > 0)

    r0 = world["ranks"][0]
    assert r0["made_fkld"]["grads"].keys() == want.keys()
    assert worst(r0["made_fkld"]["grads"]) <= 1e-5
    assert worst(r0["made_fkld_unreduced"]["grads"]) > 1e-2


def test_made_net_in_both_directions_matches_one_process(world):
    hold([r["made"] for r in world["ranks"]], world["port_made"])


def test_made_weights_are_model_sharded(world):
    specs = world["ranks"][0]["made"]["specs"]
    # each AR layer: a residual block's column weight, bias and mask, its row
    # weight and mask, the row-parallel final layer's weight and mask
    assert len(specs) == 2 * 7
    dims = {(n.rsplit(".", 2)[-2], n.rsplit(".", 1)[-1]): d for n, d, _, _ in specs}
    assert dims[("linear_0", "weight")] == 0 and dims[("linear_0", "bias")] == 0
    assert dims[("linear_1", "weight")] == 1 and dims[("final_layer", "weight")] == 1
    for _, d, local, whole in specs:
        assert local[d] * 2 == whole[d]
    # per step: 3 MADE passes a layer (1 of forward_kld, 2 of reverse_kld's
    # recursion), each 2 all-reduces forward and 1 + an all-gather backward on
    # the model axis; one average over the data axis
    assert world["ranks"][0]["made"]["collectives"] == {
        "model": {"all_reduce": 18, "all_gather": 6}, "data": {"all_reduce": 1}}


def test_mlp_net_matches_one_process_and_jax(world):
    hold([r["mlp"] for r in world["ranks"]], world["port_mlp"], world["jax_mlp"])
    assert {d for _, d, _, _ in world["ranks"][0]["mlp"]["specs"]} == {0, 1}


def test_indivisible_hidden_falls_back_replicated(world):
    assert world["ranks"][0]["mlp51"]["specs"] == []
    hold([r["mlp51"] for r in world["ranks"]], world["port_mlp51"], world["jax_mlp51"])


def test_callers_model_survives_both_steps(world):
    assert all(r["caller_untouched"] for r in world["ranks"])


def test_fsdp_matches_one_process_and_jax(world):
    hold([r["fsdp"] for r in world["ranks"]], world["port_mlp"], world["jax_fsdp"])
    assert len(world["ranks"][0]["fsdp"]["specs"]) == 4  # the 64 x 64 hidden weights
    assert world["ranks"][0]["fsdp"]["collectives"]["model"] == {
        "all_gather": 4, "reduce_scatter": 4}


def test_fsdp_shards_optimizer_moments(world):
    moments = world["ranks"][0]["fsdp"]["moments"]
    assert len(moments) == 8
    assert all(kind == "DTensor" and dim is not None for _, kind, dim in moments)


def test_glow_conv_nets_match_one_process_and_jax(world):
    hold([r["glow"] for r in world["ranks"]], world["port_glow"], world["jax_glow"],
         GLOW_LOSS, GLOW_LEAF)
    dims = {d for n, d, _, _ in world["ranks"][0]["glow"]["specs"] if n.endswith("weight")}
    assert dims == {0, 1}  # out-channel (column) and in-channel (row) convolutions


@pytest.mark.parametrize("kind", ["tp_roundtrip", "fsdp_roundtrip"])
def test_sharded_checkpoint_roundtrip(world, kind):
    for r in world["ranks"]:
        got = r[kind]
        assert got["sharded"] and got["restored_equal"] and got["resumed_equal"]
        assert got["losses"][0] == got["losses"][1]


def test_restore_onto_another_mesh_and_fsdp(world):
    for r in world["ranks"]:
        saved = r["cross_saved"]
        for key in ("cross_mesh", "cross_fsdp"):
            for n, p in saved["params"].items():
                assert torch.equal(p, r[key]["params"][n]), (key, n)
        assert set(r["cross_mesh"]["mesh"]) == {(("data", "model"), (1, 4))}
        assert r["cross_mesh"]["specs"]
        assert all(local[d] * 4 == whole[d] for _, d, local, whole in r["cross_mesh"]["specs"])
        assert r["cross_fsdp"]["fsdp_sharded"]
        for n, moments in saved["moments"].items():
            for k, v in moments.items():
                assert torch.equal(v, r["cross_fsdp"]["moments"][n][k]), (n, k)


def test_restore_onto_one_process(world):
    saved = world["ranks"][0]["cross_saved"]
    plain = world["plain"]
    for n, p in plain.model.named_parameters():
        assert torch.equal(p.detach(), saved["params"][n]), n
        for k, v in plain.optimizer.state[p].items():
            assert torch.equal(v, saved["moments"][n][k]), (n, k)
    assert plain.step == 1


def test_manager_restores_sharded_layout(world):
    for r in world["ranks"]:
        assert r["manager"] == {"steps": [2, 3], "equal": True}


def test_parallel_modes_example_runs_one_process(capsys):
    """``examples.parallel_modes`` as one process on the CPU: every mode's
    loss the single-process loss (a world of one computes alike)."""
    from normflows_tpu_torch.examples import parallel_modes

    record = parallel_modes.main(["--device", "cpu"])
    assert record["ranks"] == 1 and len(record["losses"]) == 6
    assert record["largest_gap"] <= PORT_TOL * abs(record["losses"]["single_process"])
    assert record["tensor_parallel_sharded_leaves"] > 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"ranks": 1')


def test_fusion_and_dropout_refused_under_a_model_axis():
    """The fused MADE computes on whole weights: a tensor-parallel step
    with fusion on and a MADE sharded raises, and so does a sharded MADE's
    pass once fusion is turned on; a sharded net with dropout raises (it
    would draw a mask a shard).  A world of one in this process."""
    import torch.distributed as dist

    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.ops import backend

    parallel.make_mesh(devices="cpu")
    try:
        mesh = parallel.make_mesh({"model": 1}, devices="cpu")
        loss = lambda m, b, g: m.forward_kld(b)  # noqa: E731
        adam = lambda ps: torch.optim.Adam(ps, lr=LR)  # noqa: E731
        x = torch.zeros(4, 2)
        backend.set_made_fusion(True)
        with pytest.raises(RuntimeError, match="must stay off under a model axis"):
            parallel.make_tensor_parallel_step(torch_ar_nsf(), adam, loss, mesh)
        backend.set_made_fusion(False)
        state, step = parallel.make_tensor_parallel_step(torch_ar_nsf(), adam, loss, mesh)
        backend.set_made_fusion(True)
        with pytest.raises(RuntimeError, match="must stay off under a model axis"):
            state.model.flows[0].mprqat.autoregressive_net(x)
        backend.set_made_fusion(False)
        dropped = tnf.NormalizingFlow.create(
            tdist.DiagGaussian(2, device="cpu"),
            [tflows.MaskedAffineAutoregressive.create(None, 2, 64, dropout_probability=0.1,
                                                      device="cpu")], device="cpu")
        with pytest.raises(ValueError, match="dropout in a sharded MADE"):
            parallel.make_tensor_parallel_step(dropped, adam, loss, mesh)
    finally:
        backend.set_made_fusion(False)
        dist.destroy_process_group()


def test_optimizer_instance_refused():
    """The sharded steps build their optimizer on parameters they made: an
    optimizer in the factory's place raises."""
    from normflows_tpu_torch.training.loop import build_optimizer

    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(TypeError, match="factory"):
        build_optimizer(torch.optim.Adam([p], lr=LR), [p])
    assert isinstance(build_optimizer(lambda ps: torch.optim.SGD(ps, lr=LR), [p]),
                      torch.optim.SGD)
