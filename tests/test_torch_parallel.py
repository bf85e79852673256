"""The port's data- and chain-parallel tier (``normflows_tpu_torch.parallel``)
in a world of two CPU processes joined by gloo, against the single-process
port and against the JAX package's ``parallel`` on a ``{"data": 2}`` mesh of
conftest's virtual devices.

One world is spawned for the module (about 4.5 s to start) and runs every
check; each test reads its part of what the ranks sent back:

* ``make_mesh``'s rules (the default, -1, a 2-D ``{"data": 1, "chain": 2}``
  mesh, sizes that do not make the world), ``shard_batch`` /
  ``shard_chains`` (contiguous blocks in rank order; an indivisible batch
  raises) and ``replicate`` (rank 0's values in fresh storage, the caller's
  module untouched);
* ``make_data_parallel_step`` on Real NVP cut to 4 layers, forward KL on a
  batch of 64 split over the ranks: the averaged loss and gradients against
  the single-process ``make_train_step`` on the whole batch and against
  JAX's ``make_data_parallel_step`` (and ``jax.grad``) on the same weights
  and batch; both ranks' parameters equal after the Adam step;
* ``make_reverse_kld_step`` on the flagship cut to 2 layers of hidden 64,
  on JAX's own global draw (re-derived from its key and handed to the port
  through a stub base, as tests/test_torch_training.py does): against JAX's
  ``make_reverse_kld_step`` and against the single-process step;
* ``parallel_chain_sample`` of a 3-rung HAIS: the shards stacked in rank
  order against the single-process ``sample`` on the same generator (bit
  for bit), and, on JAX's draws, against JAX's ``parallel_chain_sample``;
* ``reverse_kld(z_sharding=...)`` of a conditional flow whose context has a
  row a sample: the ranks' losses average to the single-process loss;
* ``make_eval_step`` and ``data.prefetch_to_device``'s ``mesh`` form: each
  rank's rows.

Bars: 1e-4 (atol = rtol) against JAX, as tests/test_torch_training.py and
test_torch_realnvp.py; against the single-process port 1e-6 (the same
float32 arithmetic, summed over half the rows, then averaged); HAIS against
JAX at tests/test_torch_stochastic.py's 1e-6 (z) and 1e-5 (log w).
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
import normflows_tpu_torch as tnf
from examples.real_nvp_twomoons import build_model as jax_real_nvp
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu import parallel as jparallel
from normflows_tpu.sampling import HAIS as JHAIS
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import training
from normflows_tpu_torch.examples.real_nvp_twomoons import build_model as torch_real_nvp
from normflows_tpu_torch.interop import load_jax_leaves
from normflows_tpu_torch.nets import MLP
from normflows_tpu_torch.sampling import HAIS
from tests.helpers import assert_close
from tests.test_torch_realnvp import perturbed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, PORT_TOL = 1e-4, 1e-6
HAIS_Z_TOL, HAIS_W_TOL = 1e-6, 1e-5
BATCH, N_KLD, CHAINS, LR = 64, 256, 64, 1e-3
SCALE = np.array([1.0, 2 * np.pi], np.float32)
TAIL_BOUND = np.array([5.0, np.pi], np.float32)

WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    from torch import nn

    rank, world, addr, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                      sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    from normflows_tpu_torch import data, parallel, training

    parallel.initialize_distributed(addr, world, rank, device="cpu", timeout=60)
    got = {"local_batch": parallel.process_local_batch(32),
           "device_batch": parallel.local_device_batch(32)}
    for f in (parallel.process_local_batch, parallel.local_device_batch):
        try:
            f(33)
        except ValueError:
            got.setdefault("indivisible_raised", []).append(f.__name__)
    inp = torch.load(inputs, weights_only=False)

    # ---- meshes ----
    mesh = parallel.make_mesh(devices="cpu")
    got["default_mesh"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    m2 = parallel.make_mesh({"data": 1, "chain": 2}, devices="cpu")
    got["mesh_2d"] = (m2.mesh_dim_names, tuple(m2.mesh.shape), m2.get_local_rank("chain"),
                      m2.get_local_rank("data"))
    got["mesh_fill"] = tuple(parallel.make_mesh({"data": -1, "chain": 1},
                                                devices="cpu").mesh.shape)
    got["mesh_errors"] = []
    for shapes in ({"data": 3}, {"data": -1, "chain": -1}, {"data": 2, "chain": 2}):
        try:
            parallel.make_mesh(shapes, devices="cpu")
        except ValueError as exc:
            got["mesh_errors"].append(str(exc))
    x = torch.arange(24.0).reshape(8, 3)
    got["shard"] = parallel.shard_batch(x, mesh)
    got["shard_chain_axis"] = parallel.shard_chains(x, m2, "chain")
    got["shard_data_axis_of_2d"] = parallel.shard_batch(x, m2, "data")
    try:
        parallel.shard_batch(x[:7], mesh)
    except ValueError:
        got["shard_indivisible_raised"] = True
    torch.manual_seed(rank)
    mine = nn.Linear(3, 2)
    before = {k: v.clone() for k, v in mine.state_dict().items()}
    rep = parallel.replicate(mine, mesh)
    got["replicated"] = {k: v.detach().clone() for k, v in rep.state_dict().items()}
    got["untouched"] = all(torch.equal(before[k], v) for k, v in mine.state_dict().items())
    got["fresh_storage"] = all(a.data_ptr() != b.data_ptr()
                               for a, b in zip(rep.parameters(), mine.parameters()))
    t = torch.full((2,), float(rank))
    rt = parallel.replicate({"t": [t]}, mesh)["t"][0]
    got["replicated_tensor"] = (rt.clone(), float(t[0]), rt.data_ptr() != t.data_ptr())

    # ---- forward-KL data-parallel step ----
    model = inp["realnvp"]
    if rank == 1:  # the step makes rank 0's weights every rank's
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    state, step = parallel.make_data_parallel_step(
        model, torch.optim.Adam(model.parameters(), lr=inp["lr"]),
        lambda m, b, g: m.forward_kld(b), mesh)
    with torch.no_grad():
        local_loss = float(model.forward_kld(parallel.shard_batch(inp["x"], mesh)))
    state, metrics = step(state, parallel.shard_batch(inp["x"], mesh))
    got["dp"] = {"loss": float(metrics["loss"]), "finite": metrics["finite"],
                 "local_loss": local_loss,
                 "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None},
                 "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                 "step": state.step}

    # ---- reverse-KL data-parallel step on the global draw ----
    class GlobalDraw(nn.Module):
        def __init__(self, base, z, log_q):
            super().__init__()
            self.base, self.z, self.log_q = base, z, log_q

        @property
        def event_shape(self):
            return self.base.event_shape

        def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
            assert num_samples == self.z.shape[0]
            return self.z.clone(), self.log_q.clone()

        def log_prob(self, z, context=None):
            return self.base.log_prob(z, context)

    flag = inp["flagship"]
    flag.q0 = GlobalDraw(flag.q0, *inp["kld_draw"])
    state, step = parallel.make_reverse_kld_step(
        flag, torch.optim.Adam(flag.parameters(), lr=inp["lr"]), mesh, inp["n_kld"])
    state, metrics = step(state)
    got["kld"] = {"loss": float(metrics["loss"]),
                  "grads": {n: p.grad.clone() for n, p in flag.named_parameters()
                            if p.grad is not None}}

    # ---- reverse_kld(z_sharding=...) with a context of a row a sample ----
    cond = inp["conditional"]
    sharding = parallel.batch_sharding(mesh, 2)
    with torch.no_grad():
        got["conditional_kld"] = float(cond.reverse_kld(
            inp["chains"], inp["context"], z_sharding=sharding,
            generator=torch.Generator().manual_seed(inp["chain_seed"])))

    # ---- chains ----
    hais = inp["hais"]
    run = parallel.parallel_chain_sample(hais, mesh, inp["chains"])
    got["chains_seeded"] = run(inp["chain_seed"])
    jax_noise = inp["hais_jax_noise"]
    hais.draw_noise = lambda n, generator=None: jax_noise
    got["chains_jax_draws"] = parallel.parallel_chain_sample(hais, mesh, inp["chains"])(0)
    try:
        parallel.parallel_chain_sample(nn.Linear(2, 2), mesh, 8)
    except TypeError as exc:
        got["chains_refused"] = str(exc)

    # ---- evaluation and the loader's mesh form ----
    ev = parallel.make_eval_step(inp["realnvp_eval"], lambda m, b: m.log_prob(b), mesh)
    got["eval"] = ev(parallel.shard_batch(inp["x"], mesh))
    loader = data.NativeImageLoader(inp["images"], inp["labels"], batch_size=8,
                                    shuffle=False, jitter=False, num_workers=1)
    stream = data.prefetch_to_device(loader, size=2, device="cpu", mesh=mesh)
    got["prefetched"] = [next(stream)[:2] for _ in range(2)]
    loader.close()
    torch.save(got, f"{out}/rank{rank}.pt")
    print("WORLDOK", rank, flush=True)
''')


def free_port():
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("sockets unavailable")
        return s.getsockname()[1]


def start_world(script, args, world=2, env_of=None):
    """Start ``script`` as ``world`` processes (rank, world, *args);
    ``env_of(rank)`` adds to a rank's environment."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(script), str(r), str(world), *args],
                             env={**env, **(env_of(r) if env_of else {})},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def join_world(procs, timeout=150):
    """Each process's output; each must exit 0 within ``timeout`` s."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail("the world's processes timed out:\n" + "\n".join(outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def jax_flagship(layers=2, hidden=64):
    base = jdist.UniformGaussian.create(2, [1], jnp.asarray(SCALE))
    return jnf.NormalizingFlow.create(base, [
        jflows.CircularAutoregressiveRationalQuadraticSpline.create(
            jax.random.key(i), 2, 1, hidden, ind_circ=[1], num_bins=10,
            tail_bound=jnp.asarray(TAIL_BOUND), permute_mask=True, rng_seed=i,
            init_identity=False) for i in range(layers)], p=jdist.GaussianVonMises())


def torch_flagship(layers=2, hidden=64):
    return tnf.NormalizingFlow.create(
        tdist.UniformGaussian.create(2, [1], SCALE, device="cpu"),
        [tflows.CircularAutoregressiveRationalQuadraticSpline.create(
            torch.Generator().manual_seed(i), 2, 1, hidden, ind_circ=[1], num_bins=10,
            tail_bound=TAIL_BOUND, permute_mask=True, rng_seed=i, init_identity=False,
            device="cpu") for i in range(layers)],
        p=tdist.GaussianVonMises(device="cpu"), device="cpu")


def hais_pair():
    jprior = jdist.DiagGaussian.create(2)
    jtarget = jdist.DiagGaussian.create(2).replace(loc=jnp.full((1, 2), 1.0),
                                                   log_scale=jnp.full((1, 2), -0.3))
    betas = np.linspace(1.0, 0.0, 5)
    jh = JHAIS.create(betas, jprior, jtarget, num_leapfrog=3, step_size=jnp.full(2, 0.3),
                      log_mass=jnp.zeros(2))
    th = HAIS.create(betas, tdist.DiagGaussian(2, device="cpu"),
                     tdist.DiagGaussian(2, device="cpu"), 3, np.full(2, 0.3), np.zeros(2),
                     device="cpu")
    return jh, load_jax_leaves(th, leaves_of(jh))


def jax_hais_noise(key, layers, n):
    """The draws JAX's ``HAIS.sample(key, n)`` makes: the prior's normals,
    then each rung's momentum normals and accept uniforms."""
    keys = jax.random.split(key, layers + 1)
    out = [jax.random.normal(keys[0], (n, 2))]
    for k in keys[1:]:
        kp, ka = jax.random.split(k)
        out.append((jax.random.normal(kp, (n, 2)), jax.random.uniform(ka, (n,))))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return t(out[0]), [(t(p), t(u)) for p, u in out[1:]]


def jax_step_grads(step, tmodel_like, *args):
    """The loss of one step of the JAX package's ``(step_fn, diff, rest,
    opt_state)`` built with ``optax.sgd(1.0)``, and its gradients (the
    parameters before less after) laid out as the port's parameters (by
    name, weights transposed)."""
    step_fn, diff, rest, opt_state = step
    new, _, loss = step_fn(diff, opt_state, *args)
    grads = jax.tree.map(lambda a, b: a - b, diff, new)
    as_port = load_jax_leaves(tmodel_like, leaves_of(jnf.combine(grads, rest)))
    return float(loss), {n: p.detach() for n, p in as_port.named_parameters()}


class Draw(torch.nn.Module):
    """Test-only ``q0``: hands out one given draw ``(z, log_q)``, and the
    real base's ``log_prob``."""

    def __init__(self, base, z, log_q):
        super().__init__()
        self.base, self.z, self.log_q = base, z, log_q

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        assert num_samples == self.z.shape[0]
        return self.z.clone(), self.log_q.clone()

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


def single_process_step(model, loss_fn, batch=None):
    state, step = training.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LR), loss_fn)
    _, metrics = step(state, batch)
    return float(metrics["loss"]), {n: p.grad for n, p in model.named_parameters()
                                    if p.grad is not None}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """What each rank of the world of two sent back, beside the JAX
    package's and the single-process port's results on the same inputs
    (computed while the world runs)."""
    root = tmp_path_factory.mktemp("parallel_world")
    jm_rnvp = perturbed(jax_real_nvp(4, jax.random.key(3)), 8)
    x = np.random.default_rng(4).normal(size=(BATCH, 2)).astype(np.float32)
    jm_flag = jax_flagship()
    key = jax.random.key(6)
    z, log_q = jax.jit(lambda k: jm_flag.q0.sample_and_log_prob(jax.random.split(k)[0],
                                                                 N_KLD))(key)
    kld_draw = (torch.from_numpy(np.array(z)), torch.from_numpy(np.array(log_q)))
    jh, th = hais_pair()
    hkey = jax.random.key(8)
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, size=(32, 3, 2, 2), dtype=np.uint8)
    labels = rng.integers(0, 10, size=32)

    def rnvp():
        return load_jax_leaves(torch_real_nvp(4, "cpu"), leaves_of(jm_rnvp))

    def flagship():
        return load_jax_leaves(torch_flagship(), leaves_of(jm_flag))

    gen = torch.Generator().manual_seed(12)
    cond = tnf.ConditionalNormalizingFlow(
        tdist.ConditionalDiagGaussian(2, MLP.create(gen, [3, 16, 4], device="cpu")),
        [tflows.MaskedAffineFlow.create(torch.tensor([1.0, 0.0]),
                                        t=MLP.create(gen, [2, 16, 2], device="cpu"),
                                        s=MLP.create(gen, [2, 16, 2], device="cpu"),
                                        device="cpu")],
        p=tdist.ConditionalDiagGaussian(2, MLP.create(gen, [3, 16, 4], device="cpu")))
    context = torch.from_numpy(np.random.default_rng(13).normal(
        size=(CHAINS, 3)).astype(np.float32))
    torch.save({"conditional": cond, "context": context,
                "realnvp": rnvp(), "realnvp_eval": rnvp(), "x": torch.from_numpy(x),
                "lr": LR, "flagship": flagship(), "kld_draw": kld_draw, "n_kld": N_KLD,
                "hais": th, "chains": CHAINS, "chain_seed": 11,
                "hais_jax_noise": jax_hais_noise(hkey, len(jh.layers), CHAINS),
                "images": images, "labels": labels}, root / "inputs.pt")
    script = root / "worker.py"
    script.write_text(WORKER)
    procs = start_world(script, [f"127.0.0.1:{free_port()}", str(root / "inputs.pt"),
                                 str(root)])
    try:
        mesh = jparallel.make_mesh({"data": 2}, devices=jax.devices()[:2])
        xs = jparallel.shard_batch(jnp.asarray(x), mesh)
        ref = {"jax_dp": jax_step_grads(
                   jparallel.make_data_parallel_step(jm_rnvp, optax.sgd(1.0),
                                                     lambda m, b, k: m.forward_kld(b), mesh,
                                                     donate=False),
                   rnvp(), xs, jax.random.key(0)),
               "jax_kld": jax_step_grads(
                   jparallel.make_reverse_kld_step(jm_flag, optax.sgd(1.0), mesh, N_KLD,
                                                   donate=False), flagship(), key),
               "jax_chains": jparallel.parallel_chain_sample(jh, mesh, CHAINS)(hkey),
               "port_dp": single_process_step(rnvp(), lambda m, b, g: m.forward_kld(b),
                                              torch.from_numpy(x))}
        tm = flagship()
        tm.q0 = Draw(tm.q0, *kld_draw)
        ref["port_kld"] = single_process_step(tm, lambda m, b, g: m.reverse_kld(N_KLD))
        with torch.no_grad():
            ref["port_conditional_kld"] = float(cond.reverse_kld(
                CHAINS, context, generator=torch.Generator().manual_seed(11)))
            ref["port_chains"] = th.sample(CHAINS, generator=torch.Generator().manual_seed(11))
            ref["port_log_prob"] = rnvp().log_prob(torch.from_numpy(x))
    finally:
        outs = join_world(procs)
    assert all(f"WORLDOK {r}" in out for r, out in enumerate(outs))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "images": images, "labels": labels, **ref}


def test_process_batches(world):
    for got in world["ranks"]:
        assert got["local_batch"] == got["device_batch"] == 16
        assert got["indivisible_raised"] == ["process_local_batch", "local_device_batch"]


def test_make_mesh_rules(world):
    for r, got in enumerate(world["ranks"]):
        assert got["default_mesh"] == (("data",), (2,))
        assert got["mesh_2d"] == (("data", "chain"), (1, 2), r, 0)
        assert got["mesh_fill"] == (2, 1)
        assert len(got["mesh_errors"]) == 3
        assert all("!= 2 ranks" in e or "-1 once" in e for e in got["mesh_errors"])


def test_shard_batch_and_chains(world):
    x = torch.arange(24.0).reshape(8, 3)
    for r, got in enumerate(world["ranks"]):
        assert torch.equal(got["shard"], x[4 * r:4 * r + 4])
        assert torch.equal(got["shard_chain_axis"], x[4 * r:4 * r + 4])
        assert torch.equal(got["shard_data_axis_of_2d"], x)  # one rank along data
        assert got["shard_indivisible_raised"]


def test_replicate_gives_rank_zeros_values_in_fresh_storage(world):
    a, b = (got["replicated"] for got in world["ranks"])
    torch.manual_seed(0)
    want = torch.nn.Linear(3, 2).state_dict()
    for k in want:
        assert torch.equal(a[k], want[k]) and torch.equal(b[k], want[k])
    for got in world["ranks"]:
        assert got["untouched"] and got["fresh_storage"]
        t, _, fresh = got["replicated_tensor"]
        assert torch.equal(t, torch.zeros(2)) and fresh
    assert world["ranks"][1]["replicated_tensor"][1] == 1.0  # rank 1 kept its own


def hold_step(got, port, jax_ref):
    """A data-parallel step's averaged loss and gradients (the same on both
    ranks) against the single-process port's and JAX's."""
    r0, r1 = got
    assert r0["loss"] == r1["loss"]
    loss, grads = port
    assert_close(r0["loss"], loss, atol=PORT_TOL, rtol=PORT_TOL)
    jloss, jgrads = jax_ref
    assert_close(r0["loss"], jloss, atol=TOL, rtol=TOL)
    assert r0["grads"].keys() == grads.keys() == jgrads.keys() and len(grads) > 0
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n
        assert_close(g.numpy(), grads[n].numpy(), atol=PORT_TOL, rtol=PORT_TOL, msg=n)
        assert_close(g.numpy(), jgrads[n].numpy(), atol=TOL, rtol=TOL, msg=n)


def test_data_parallel_step_matches_one_process_and_jax(world):
    r0, r1 = (got["dp"] for got in world["ranks"])
    hold_step((r0, r1), world["port_dp"], world["jax_dp"])
    assert r0["finite"] and r0["step"] == 1
    # the ranks' own losses average to the global one
    assert_close((r0["local_loss"] + r1["local_loss"]) / 2, r0["loss"], atol=PORT_TOL,
                 rtol=PORT_TOL)
    for n in r0["params"]:  # the replicas stay equal after Adam
        assert torch.equal(r0["params"][n], r1["params"][n]), n


def test_reverse_kld_step_matches_one_process_and_jax(world):
    hold_step([got["kld"] for got in world["ranks"]], world["port_kld"], world["jax_kld"])


def test_reverse_kld_keeps_the_rows_of_a_per_sample_context(world):
    """``reverse_kld(z_sharding=...)`` of a conditional flow whose context
    has a row a sample: each rank keeps its rows of the draws and of the
    context, and the ranks' losses average to the single-process loss on
    the same generator."""
    local = [got["conditional_kld"] for got in world["ranks"]]
    assert local[0] != local[1]
    assert_close(sum(local) / 2, world["port_conditional_kld"], atol=PORT_TOL, rtol=PORT_TOL)


def test_chain_shards_stack_to_the_single_process_sample(world):
    z = torch.cat([got["chains_seeded"][0] for got in world["ranks"]])
    log_w = torch.cat([got["chains_seeded"][1] for got in world["ranks"]])
    want_z, want_w = world["port_chains"]
    assert torch.equal(z, want_z) and torch.equal(log_w, want_w)
    for got in world["ranks"]:
        assert got["chains_seeded"][0].shape == (CHAINS // 2, 2)
        assert "Linear has no draw_noise or from_noise" in got["chains_refused"]


def test_chain_shards_match_jax_parallel_chain_sample(world):
    z = torch.cat([got["chains_jax_draws"][0] for got in world["ranks"]])
    log_w = torch.cat([got["chains_jax_draws"][1] for got in world["ranks"]])
    jz, jw = world["jax_chains"]
    assert_close(z.numpy(), np.asarray(jz), atol=HAIS_Z_TOL, rtol=HAIS_Z_TOL)
    assert_close(log_w.numpy(), np.asarray(jw), atol=HAIS_W_TOL, rtol=HAIS_W_TOL)


def test_eval_step_and_prefetch_give_each_rank_its_rows(world):
    got = torch.cat([r["eval"] for r in world["ranks"]])
    assert_close(got.numpy(), world["port_log_prob"].numpy(), atol=PORT_TOL, rtol=PORT_TOL)
    images, labels = world["images"], world["labels"]
    for r, ranks in enumerate(world["ranks"]):
        for b, (xb, yb) in enumerate(ranks["prefetched"]):
            rows = slice(8 * b + 4 * r, 8 * b + 4 * r + 4)
            want = torch.from_numpy(images[rows] / 255.0 * (255.0 / 256.0))
            want = torch.log((0.05 + 0.95 * want) / (1 - (0.05 + 0.95 * want))).float()
            assert torch.equal(yb, torch.from_numpy(labels[rows]))
            assert_close(xb.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def halves_against_whole(num_samples=2**14, seed=3):
    """The flagship at full width (``examples.nsf_cylinder.build_model``) on
    the CPU: the reverse-KL loss and gradient on ``num_samples`` base draws
    against the mean of the two halves' (what a world of two averages):
    the relative loss gap, the largest gradient leaf's gap over its norm and
    the whole gradient's.  The bar of ``chip_smoke.py``'s world of 2 was set
    from this reading."""
    from normflows_tpu_torch.examples.nsf_cylinder import build_model

    model = build_model("cpu")
    z, log_q = model.q0.sample_and_log_prob(num_samples,
                                            generator=torch.Generator().manual_seed(seed))
    base = model.q0

    def loss_and_grads(rows):
        model.q0 = Draw(base, z[rows], log_q[rows])
        model.zero_grad(set_to_none=True)
        loss = model.reverse_kld(rows.stop - rows.start)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    half = num_samples // 2
    lw, gw = loss_and_grads(slice(0, num_samples))
    (l0, g0), (l1, g1) = loss_and_grads(slice(0, half)), loss_and_grads(slice(half, num_samples))
    gap = {n: (g0[n] + g1[n]) / 2 - g for n, g in gw.items()}
    leaves = {n: float(gap[n].norm() / g.norm()) for n, g in gw.items() if float(g.norm()) > 0}
    whole = float(torch.cat([v.reshape(-1) for v in gap.values()]).norm()
                  / torch.cat([g.reshape(-1) for g in gw.values()]).norm())
    worst = max(leaves, key=leaves.get)
    return {"loss_rel": abs((l0 + l1) / 2 - lw) / abs(lw), "worst_leaf": worst,
            "worst_leaf_rel": leaves[worst], "whole_gradient_rel": whole,
            "nonzero_leaves": len(leaves)}


if __name__ == "__main__":
    import json

    torch.set_num_threads(4)
    print(json.dumps(halves_against_whole()))
