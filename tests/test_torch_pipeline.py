"""The port's pipeline parallelism (``normflows_tpu_torch.parallel.pipeline``)
in a world of four CPU processes joined by gloo, one stage a rank, against
the JAX package's ``parallel.pipeline`` on a ``{"stage": 4}`` mesh of
conftest's virtual devices and against the layers run in turn in one
process.  It mirrors tests/test_pipeline.py.

One world is started for the module and runs every check; the JAX
package's pipelines and the single-process port's loops are computed while
it runs, on the same weights (``load_jax_leaves``; the JAX layers' weights
perturbed, their masks kept, so that the splines do work) and inputs:

* 8 circular AR RQ-spline layers (hidden 32, 4 bins), 8 microbatches of a
  batch of 32: ``make_pipeline_apply``'s forward, inverse (``reverse``)
  and default microbatch count; the gradients of ``sum(z^2) + sum(log_det)``
  with respect to each stage's layers, and to the input, against the
  single-process port taken microbatch by microbatch and summed in the
  pipeline's order (JAX's gradients through its pipeline reach these tests
  through the training steps' parameters);
* 4 AR RQ-spline layers with a context (one a stage): a per-sample context
  (32 x 3) that rides with its microbatch, and a 1-D context whose length
  equals the batch, passed whole;
* a depth the stages do not divide, a batch the microbatches do not divide
  and a heterogeneous stack raise;
* ``make_pipeline_train_step`` on DiagGaussian + the 8 layers + TwoMoons,
  two Adam(1e-3) steps of forward KL on 256 TwoMoons points and two of
  reverse KL on 64 draws from JAX's unit normals (a stub base maps them),
  each against JAX's pipelined step and the single-process port: the
  losses and each stage's layers after them; each rank holds its stage's
  two layers and their moments only;
* the forward-KL state through ``training.save_checkpoint``: every stage's
  layers and moments restored bit-equal into a fresh pipelined state, one
  step from each bit-equal, and the checkpoint restored into one process's
  whole flow, every layer the one its stage held.

Bars: against JAX, its own: z 1e-5, log-det 1e-4, the training losses
1e-5 and the parameters after them 1e-5; against the single-process port
1e-6 (atol = rtol: the flows and the gradients), the losses and parameters
after two Adam steps 1e-5; checkpoints exact.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
import normflows_tpu_torch as tnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu import parallel as jparallel
from normflows_tpu.parallel.pipeline import make_pipeline_apply as jax_pipeline
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import training
from tests.helpers import assert_close
from tests.test_torch_parallel import free_port, join_world, start_world
from tests.test_torch_conditional import ported
from tests.test_torch_tensor_parallel import perturbed

torch.set_num_threads(2)

Z_TOL, LD_TOL, TRAIN_TOL = 1e-5, 1e-4, 1e-5
PORT_TOL, PORT_TRAIN_TOL = 1e-6, 1e-5
K, K_CTX, HIDDEN, BATCH, M, N_TRAIN, N_REV, LR = 8, 4, 32, 32, 8, 256, 64, 1e-3

WORKER = '''
import sys
import torch

rank, world, addr, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
from normflows_tpu_torch import parallel, training

parallel.initialize_distributed(addr, world, rank, device="cpu", timeout=120)
inp = torch.load(inputs, weights_only=False)
mesh = parallel.make_mesh({"stage": 4}, devices="cpu")
layers = inp["layers"]
got = {}
with torch.no_grad():
    got["forward"] = parallel.make_pipeline_apply(layers, mesh, num_microbatches=8)(inp["z"])
    got["inverse"] = parallel.make_pipeline_apply(layers, mesh, num_microbatches=8,
                                                  reverse=True)(inp["z"])
    got["default"] = parallel.make_pipeline_apply(layers, mesh)(inp["z"])
apply = parallel.make_pipeline_apply(layers, mesh, num_microbatches=8)
z = inp["z"].clone().requires_grad_(True)
zo, ld = apply(z)
mine = [(i, n, p) for i, layer in enumerate(layers) for n, p in layer.named_parameters()
        if any(layer is l for l in apply.stages.layers)]
grads = torch.autograd.grad((zo ** 2).sum() + ld.sum(), [z] + [p for _, _, p in mine])
got["grads"] = {"input": grads[0],
                "layers": {(i, n): g for (i, n, _), g in zip(mine, grads[1:])},
                "broadcasts": dict(apply.stages.counts)}
with torch.no_grad():
    pipe = parallel.make_pipeline_apply(inp["ctx_layers"], mesh, num_microbatches=8)
    got["ctx"] = (pipe(inp["z"], inp["ctx"]), pipe(inp["z"], 0 * inp["ctx"]))
    got["ctx_1d"] = parallel.make_pipeline_apply(inp["ctx1d_layers"], mesh,
                                                 num_microbatches=8)(inp["z"], inp["ctx1d"])
got["errors"] = []
for make, call in ((lambda: parallel.make_pipeline_apply(layers[:6], mesh), None),
                   (lambda: parallel.make_pipeline_apply(layers, mesh, num_microbatches=8),
                    lambda f: f(inp["z"][:30])),
                   (lambda: parallel.make_pipeline_apply(inp["mixed"], mesh), None)):
    try:
        f = make()
        call(f)
    except ValueError as exc:
        got["errors"].append(str(exc))


class Draws(torch.nn.Module):
    """The base on JAX's unit normals, a step's in turn (``from_noise``: the
    draws depend on its parameters, as JAX's do); its own log_prob."""

    def __init__(self, base, noise):
        super().__init__()
        self.base, self.noise = base, list(noise)

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        return self.base.from_noise(self.noise.pop(0))

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


def adam(ps):
    return torch.optim.Adam(ps, lr=inp["lr"])


def stage_state(state):
    """This stage's parameters and Adam moments by name, and the step."""
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            {n: {k: v.clone() for k, v in state.optimizer.state[p].items()}
             for n, p in state.model.named_parameters()}, state.step)


for objective in ("forward_kld", "reverse_kld"):
    model = inp["model"]
    if objective == "reverse_kld":
        model.q0 = Draws(model.q0, inp["noise"])
    state, step = parallel.make_pipeline_train_step(
        model, adam, mesh, num_microbatches=8, objective=objective, num_samples=inp["n_rev"])
    losses = []
    for _ in range(2):
        state, metrics = step(state, inp["x"] if objective == "forward_kld" else None)
        losses.append(float(metrics["loss"]))
    got[objective] = {"losses": losses, "collectives": metrics["collectives"],
                      "layers": {n: p.detach().clone()
                                 for n, p in state.model.flows.named_parameters()},
                      "held_layers": len(state.model.flows),
                      "moments": sum(1 for s in state.optimizer.state.values() if s),
                      "params": sum(1 for _ in state.model.parameters())}
    if objective == "forward_kld":
        # every stage's layers through a checkpoint, restored into a fresh
        # step's state, and one step of each from there
        training.save_checkpoint(f"{out}/checkpoint", state)
        fresh, fresh_step = parallel.make_pipeline_train_step(
            inp["model"], adam, mesh, num_microbatches=8, objective=objective)
        fresh = training.restore_checkpoint(f"{out}/checkpoint", fresh)
        saved, restored = stage_state(state), stage_state(fresh)
        state, m1 = step(state, inp["x"])
        fresh, m2 = fresh_step(fresh, inp["x"])
        got["checkpoint"] = {"saved": saved, "restored": restored,
                             "losses": (float(m1["loss"]), float(m2["loss"])),
                             "resumed": stage_state(state), "resumed_fresh": stage_state(fresh)}
torch.save(got, f"{out}/rank{rank}.pt")
print("WORLDOK", rank, flush=True)
'''


def jax_layers(seed=0):
    key = jax.random.key(0)
    return perturbed([jflows.CircularAutoregressiveRationalQuadraticSpline.create(
        jax.random.fold_in(key, i), 2, 1, HIDDEN, ind_circ=[1], num_bins=4,
        tail_bound=jnp.array([5.0, np.pi]), permute_mask=True, rng_seed=0)
        for i in range(K)], 30 + seed)


def torch_layers():
    return [tflows.CircularAutoregressiveRationalQuadraticSpline.create(
        None, 2, 1, HIDDEN, ind_circ=[1], num_bins=4,
        tail_bound=np.array([5.0, np.pi], np.float32), permute_mask=True, rng_seed=0,
        device="cpu") for _ in range(K)]


def jax_ctx_layers(seed, channels):
    key = jax.random.key(seed)
    return [jflows.AutoregressiveRationalQuadraticSpline.create(
        jax.random.fold_in(key, i), 2, 1, 24, num_context_channels=channels, num_bins=4,
        permute_mask=True, init_identity=False) for i in range(K_CTX)]


def torch_ctx_layers(channels):
    return [tflows.AutoregressiveRationalQuadraticSpline.create(
        None, 2, 1, 24, num_context_channels=channels, num_bins=4, permute_mask=True,
        init_identity=False, device="cpu") for _ in range(K_CTX)]


def port_layers(jlayers, tlayers):
    return list(ported(jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), jlayers),
                        tnf.NormalizingFlow(tdist.DiagGaussian(2, device="cpu"),
                                            tlayers)).flows)


def sequential(layers, z, context=None, reverse=False):
    ld = torch.zeros(z.shape[0])
    for layer in (reversed(layers) if reverse else layers):
        z, dl = layer.inverse(z, context) if reverse else layer.forward(z, context)
        ld = ld + dl
    return z, ld


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """What each rank of the world of four sent back, beside the JAX
    package's pipelines and the single-process port's loops on the same
    inputs (computed while the world runs)."""
    root = tmp_path_factory.mktemp("pipeline_world")
    jl = jax_layers()
    jl_ctx, jl_ctx1d = jax_ctx_layers(5, 3), jax_ctx_layers(8, BATCH)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(BATCH, 2)).astype(np.float32)
    ctx = rng.normal(size=(BATCH, 3)).astype(np.float32)
    ctx1d = rng.normal(size=(BATCH,)).astype(np.float32)
    x = np.asarray(jdist.TwoMoons().sample(jax.random.key(17), N_TRAIN))
    jmodel = jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), jl, p=jdist.TwoMoons())
    rkey = jax.random.key(3)
    # the unit normals of JAX's DiagGaussian.sample_and_log_prob in each step
    noise = [t(jax.random.normal(jax.random.fold_in(rkey, i), (N_REV, 2))) for i in range(2)]

    def layers():
        return port_layers(jl, torch_layers())

    def model():
        return ported(jmodel, tnf.NormalizingFlow(tdist.DiagGaussian(2, device="cpu"),
                                                   torch_layers(), p=tdist.TwoMoons(
                                                       device="cpu")))

    mixed = layers()[:4]
    mixed[2] = tflows.Planar.create((2,), device="cpu")
    torch.save({"layers": layers(), "z": t(z), "ctx_layers": port_layers(
        jl_ctx, torch_ctx_layers(3)), "ctx": t(ctx), "ctx1d_layers": port_layers(
        jl_ctx1d, torch_ctx_layers(BATCH)), "ctx1d": t(ctx1d), "mixed": mixed,
        "model": model(), "x": t(x), "noise": noise, "n_rev": N_REV, "lr": LR},
        root / "inputs.pt")
    mesh = jparallel.make_mesh({"stage": 4}, devices=jax.devices()[:4])
    zj = jnp.asarray(z)
    def jax_ctx():
        pipe = jax.jit(jax_pipeline(jl_ctx, mesh, num_microbatches=M))
        return pipe(zj, jnp.asarray(ctx)), pipe(zj, 0 * jnp.asarray(ctx))

    def jax_train(objective, batch, key):
        step_fn, diff, rest, opt_state = jparallel.make_pipeline_train_step(
            jmodel, optax.adam(LR), mesh, num_microbatches=M, objective=objective,
            num_samples=N_REV, donate=False)
        losses = []
        for i in range(2):
            diff, opt_state, loss = step_fn(diff, opt_state, batch, jax.random.fold_in(key, i))
            losses.append(float(loss))
        # the stacked (stage, layer) leaves as the port's layers, in run order
        stack = jnf.combine(diff["stack"], rest[0])
        unstacked = [jax.tree.map(lambda a: a[s, j], stack) for s in range(4)
                     for j in range(2)]
        return losses, port_layers(unstacked, torch_layers())

    # the JAX package's pipelines compile on threads while the world runs
    script = root / "worker.py"
    script.write_text(WORKER)
    procs = start_world(script, [f"127.0.0.1:{free_port()}", str(root / "inputs.pt"),
                                 str(root)], world=4)
    pool = ThreadPoolExecutor(3)
    jobs = {"jax_train_forward_kld": pool.submit(jax_train, "forward_kld", jnp.asarray(x),
                                                 jax.random.key(0)),
            "jax_train_reverse_kld": pool.submit(jax_train, "reverse_kld", None, rkey),
            "jax_forward": pool.submit(jax.jit(jax_pipeline(jl, mesh, num_microbatches=M)),
                                       zj),
            "jax_inverse": pool.submit(jax.jit(jax_pipeline(jl, mesh, num_microbatches=M,
                                                            reverse=True)), zj),
            "jax_ctx": pool.submit(jax_ctx),
            "jax_ctx_1d": pool.submit(jax.jit(jax_pipeline(jl_ctx1d, mesh, num_microbatches=M)),
                                      zj, jnp.asarray(ctx1d))}
    try:
        # the single-process port
        ref = {}
        tl = layers()
        ref["port_forward"] = sequential(tl, t(z))
        ref["port_inverse"] = sequential(tl, t(z), reverse=True)
        # the gradients microbatch by microbatch, summed in the pipeline's
        # order (the last microbatch first)
        params = [(i, n, p) for i, layer in enumerate(tl) for n, p in layer.named_parameters()]
        mb, g_in, g_sum = BATCH // M, [None] * M, None
        for m in reversed(range(M)):
            zg = t(z)[m * mb:(m + 1) * mb].requires_grad_(True)
            zo, ld = sequential(tl, zg)
            g = torch.autograd.grad((zo ** 2).sum() + ld.sum(), [zg] + [p for _, _, p in params])
            g_in[m] = g[0]
            g_sum = list(g[1:]) if g_sum is None else [a + b for a, b in zip(g_sum, g[1:])]
        ref["port_grads"] = (torch.cat(g_in), {(i, n): gp for (i, n, _), gp in zip(params,
                                                                                    g_sum)})
        cl = port_layers(jl_ctx, torch_ctx_layers(3))
        ref["port_ctx"] = sequential(cl, t(z), t(ctx))
        ref["port_ctx_1d"] = sequential(port_layers(jl_ctx1d, torch_ctx_layers(BATCH)), t(z),
                                        t(ctx1d))
        for objective in ("forward_kld", "reverse_kld"):
            m = model()
            pending = list(noise)

            def loss_fn(m, b, g):
                if objective == "forward_kld":
                    return m.forward_kld(b)
                zz, log_q = m.q0.from_noise(pending.pop(0))
                zz, ld = sequential(list(m.flows), zz)
                return torch.mean(log_q - ld) - torch.mean(m.p.log_prob(zz))

            state, step = training.make_train_step(
                m, torch.optim.Adam(m.parameters(), lr=LR), loss_fn)
            losses = [float(step(state, t(x))[1]["loss"]) for _ in range(2)]
            ref[f"port_{objective}"] = (losses, list(m.flows))
        ref.update({k.replace("train_", ""): job.result() for k, job in jobs.items()})
    finally:
        pool.shutdown()
        outs = join_world(procs)
    assert all(f"WORLDOK {r}" in out for r, out in enumerate(outs))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)]
    # the four stages' checkpoint restored into one process's whole flow
    whole = model()
    ref["one_process"] = training.restore_checkpoint(
        str(root / "checkpoint"),
        training.TrainState(whole, torch.optim.Adam(whole.parameters(), lr=LR)))
    return {"ranks": ranks, **ref}


def hold_apply(got, port, jax_ref):
    """A pipelined ``(z, log_det)``, the same on every rank, against the
    single-process loop and JAX's pipeline."""
    z0, ld0 = got[0]
    for z, ld in got[1:]:
        assert torch.equal(z, z0) and torch.equal(ld, ld0)
    assert_close(z0.numpy(), port[0].detach().numpy(), atol=PORT_TOL, rtol=PORT_TOL)
    assert_close(ld0.numpy(), port[1].detach().numpy(), atol=PORT_TOL, rtol=PORT_TOL)
    assert_close(z0.numpy(), np.asarray(jax_ref[0]), atol=Z_TOL, rtol=0)
    assert_close(ld0.numpy(), np.asarray(jax_ref[1]), atol=LD_TOL, rtol=0)


def test_forward_matches_sequential(world):
    hold_apply([r["forward"] for r in world["ranks"]], world["port_forward"],
               world["jax_forward"])


def test_inverse_matches_sequential(world):
    hold_apply([r["inverse"] for r in world["ranks"]], world["port_inverse"],
               world["jax_inverse"])


def test_default_microbatch_count(world):
    hold_apply([r["default"] for r in world["ranks"]], world["port_forward"],
               world["jax_forward"])


def test_gradients_match_sequential(world):
    port_input, port_layers_ = world["port_grads"]
    held = set()
    for stage, r in enumerate(world["ranks"]):
        got = r["grads"]
        assert_close(got["input"].numpy(), port_input.numpy(), atol=PORT_TOL, rtol=PORT_TOL)
        assert len(got["layers"]) == len(port_layers_) // 4  # this stage's two layers
        for key, g in got["layers"].items():
            assert_close(g.numpy(), port_layers_[key].numpy(), atol=PORT_TOL, rtol=PORT_TOL,
                         msg=str(key))
            held.add(key)
        # a hop a microbatch to and from each neighbour, forward and backward;
        # one broadcast to replicate the result, one for the input's gradient
        hops = M * (2 if 0 < stage < 3 else 1)
        assert got["broadcasts"] == {"broadcast": 2 * hops + 2}
    assert held == set(port_layers_)


def test_per_sample_context_matches_sequential(world):
    hold_apply([r["ctx"][0] for r in world["ranks"]], world["port_ctx"], world["jax_ctx"][0])
    got, zeroed = world["ranks"][0]["ctx"]
    assert float((got[0] - zeroed[0]).abs().max()) > 1e-4  # the context matters
    assert_close(zeroed[0].numpy(), np.asarray(world["jax_ctx"][1][0]), atol=Z_TOL, rtol=0)


def test_unbatched_context_length_equal_to_batch(world):
    hold_apply([r["ctx_1d"] for r in world["ranks"]], world["port_ctx_1d"],
               world["jax_ctx_1d"])


@pytest.mark.parametrize("index,match", [(0, "divisible"), (1, "microbatches"),
                                         (2, "homogeneous")])
def test_misfits_raise(world, index, match):
    for r in world["ranks"]:
        assert match in r["errors"][index]


@pytest.mark.parametrize("objective", ["forward_kld", "reverse_kld"])
def test_train_step_matches_sequential(world, objective):
    port_losses, port_flows = world[f"port_{objective}"]
    jax_losses, jax_flows = world[f"jax_{objective}"]
    order = list(range(K))[::-1] if objective == "forward_kld" else list(range(K))
    for s, r in enumerate(world["ranks"]):
        got = r[objective]
        assert got["losses"] == world["ranks"][0][objective]["losses"]
        assert_close(got["losses"], port_losses, atol=PORT_TRAIN_TOL, rtol=PORT_TRAIN_TOL)
        assert_close(got["losses"], jax_losses, atol=TRAIN_TOL, rtol=0)
        assert {int(n.split(".")[0]) for n in got["layers"]} == set(order[2 * s:2 * s + 2])
        for name, p in got["layers"].items():
            k, rest = name.split(".", 1)
            want = dict(port_flows[int(k)].named_parameters())[rest]
            assert_close(p.numpy(), want.detach().numpy(), atol=PORT_TRAIN_TOL,
                         rtol=PORT_TRAIN_TOL, msg=name)
            # JAX's layers are in the order they run
            jwant = dict(jax_flows[order.index(int(k))].named_parameters())[rest]
            assert_close(p.numpy(), jwant.detach().numpy(), atol=TRAIN_TOL, rtol=0, msg=name)


def test_stage_sharded_state(world):
    for r in world["ranks"]:
        for objective in ("forward_kld", "reverse_kld"):
            got = r[objective]
            assert got["held_layers"] == 2
            # Adam's moments for this stage's two layers and the base's two
            # parameters only
            per_layer = len(list(torch_layers()[0].parameters()))
            assert got["moments"] == got["params"] == 2 * per_layer + 2


def test_checkpoint_restores_each_stage(world):
    """Every stage writes its own layers: a fresh pipelined state restores
    its stage's layers and moments bit-equal, and one step from it is
    bit-equal to the uninterrupted step."""
    for s, r in enumerate(world["ranks"]):
        c = r["checkpoint"]
        for (saved, restored) in (("saved", "restored"), ("resumed", "resumed_fresh")):
            params, moments, step = c[saved]
            params2, moments2, step2 = c[restored]
            assert step == step2 and params.keys() == params2.keys()
            for n, p in params.items():
                assert torch.equal(p, params2[n]), (s, n)
                assert moments[n].keys() == moments2[n].keys()
                for k, v in moments[n].items():
                    assert torch.equal(v, moments2[n][k]), (s, n, k)
        assert c["losses"][0] == c["losses"][1]
        # the stage's layers are its own: those the forward-KL order gives it
        order = list(range(K))[::-1]
        assert {int(n.split(".")[1]) for n in c["saved"][0] if n.startswith("flows.")} \
            == set(order[2 * s:2 * s + 2])


def test_checkpoint_restores_into_one_process(world):
    """The four stages' checkpoint restored into one process's whole flow:
    every layer and its moments the stage's that held it, q0's rank 0's."""
    state = world["one_process"]
    seen = set()
    for r in world["ranks"]:
        params, moments, step = r["checkpoint"]["saved"]
        assert state.step == step
        whole = dict(state.model.named_parameters())
        for n, p in params.items():
            assert torch.equal(whole[n].detach(), p), n
            for k, v in state.optimizer.state[whole[n]].items():
                assert torch.equal(v, moments[n][k]), (n, k)
            seen.add(n)
    assert seen == set(dict(state.model.named_parameters()))
