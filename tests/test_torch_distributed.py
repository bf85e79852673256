"""Multi-process setup of the port (``parallel.distributed``) and checkpoints
in a data-parallel world (``training.checkpoint``), in worlds of two CPU
processes joined by gloo, as tests/test_distributed.py checks the JAX
package's:

* an explicit coordinator that cannot be reached raises (a 2 s timeout),
  where the JAX package's explicit path propagates its error too; no
  torchrun environment leaves a single process, and ``make_mesh`` there
  starts a world of one;
* ``process_local_batch`` and ``local_device_batch`` split a global batch
  over the processes and reject a size they do not divide;
* a world started as ``torchrun`` starts it (its environment variables)
  trains two data-parallel steps, rank 0 writes the checkpoint while every
  rank waits, and a FRESH world restores it and resumes: the resumed losses
  equal the uninterrupted run's bit for bit, and both ranks see the same
  global loss.
"""

import json
import textwrap

import pytest
import torch
import torch.distributed as dist

from normflows_tpu_torch import parallel
from normflows_tpu_torch.parallel import distributed
from tests.test_torch_parallel import free_port, join_world, start_world

CKPT_WORKER = textwrap.dedent('''
    import json
    import sys
    import numpy as np
    import torch

    rank, world, phase, ckpt = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from normflows_tpu_torch import parallel
    from normflows_tpu_torch.examples.real_nvp_twomoons import build_model
    from normflows_tpu_torch.training import CheckpointManager

    device = parallel.initialize_distributed(device="cpu", timeout=60)  # torchrun's env
    assert device == torch.device("cpu")
    mesh = parallel.make_mesh(devices="cpu")
    rows = parallel.process_local_batch(16)
    batches = torch.from_numpy(
        np.random.default_rng(7).normal(size=(4, 16, 2)).astype(np.float32))
    errors = []
    for f in (parallel.process_local_batch, parallel.local_device_batch):
        try:
            f(15)
        except ValueError as exc:
            errors.append(str(exc))

    model = build_model(4, "cpu", torch.Generator().manual_seed(100 + rank))
    with torch.no_grad():  # every net's last layer off zero, differently a rank
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(rank)))
    state, step = parallel.make_data_parallel_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3),
        lambda m, b, g: m.forward_kld(b), mesh)
    manager = CheckpointManager(ckpt, max_to_keep=1)
    if phase == "full":
        for i in range(2):
            state, _ = step(state, parallel.shard_batch(batches[i], mesh))
            manager.save(state.step, state)
    else:
        assert manager.latest_step() == 2 and manager.all_steps() == [2]
        manager.restore(state)
    tail = []
    for i in (2, 3):
        state, metrics = step(state, parallel.shard_batch(batches[i], mesh))
        tail.append(float(metrics["loss"]))
    print("CKPT " + json.dumps({"rank": rank, "rows": rows,
                                "device_rows": parallel.local_device_batch(16),
                                "step": state.step, "tail": tail, "errors": errors}),
          flush=True)
''')


def test_unreachable_coordinator_raises():
    """Rank 1 of two, pointed at a port nobody serves (1, reserved): the
    store's connect gives up after the timeout and the error propagates."""
    with pytest.raises((RuntimeError, dist.DistStoreError, TimeoutError)):
        parallel.initialize_distributed("127.0.0.1:1", 2, 1, device="cpu", timeout=2)
    assert not dist.is_initialized()


def test_no_environment_is_a_single_process(monkeypatch):
    for name in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert parallel.initialize_distributed(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert parallel.process_local_batch(7) == parallel.local_device_batch(7) == 7
    try:
        mesh = parallel.make_mesh(devices="cpu")  # a world of one, no socket
        assert dist.get_world_size() == 1 and mesh.mesh_dim_names == ("data",)
        assert tuple(mesh.mesh.shape) == (1,)
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(parallel.shard_batch(x, mesh), x)
    finally:
        dist.destroy_process_group()


def ckpt_run(root, phase):
    script = root / "ckpt_worker.py"
    script.write_text(CKPT_WORKER)
    port = str(free_port())

    def env_of(rank):
        return {"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}

    outs = join_world(start_world(script, [phase, str(root / "ckpt")], env_of=env_of))
    lines = [json.loads(line[5:]) for out in outs for line in out.splitlines()
             if line.startswith("CKPT ")]
    assert [line["rank"] for line in lines] == [0, 1], outs
    return lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_world")
    return ckpt_run(root, "full"), ckpt_run(root, "resume")


def test_process_batches_split_and_check(runs):
    for line in runs[0] + runs[1]:
        assert line["rows"] == line["device_rows"] == 8
        assert len(line["errors"]) == 2
        assert all("not divisible by 2" in e for e in line["errors"])


def test_two_process_checkpoint_save_restore_resume(runs):
    full, resumed = ([line["tail"] for line in lines] for lines in runs)
    for a, b in (full, resumed):
        assert a == b and len(a) == 2  # both ranks see the same global loss
    assert resumed[0] == full[0]
    assert all(line["step"] == 4 for line in runs[0] + runs[1])


def test_explicit_arguments_are_complete():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        parallel.initialize_distributed("127.0.0.1:1", device="cpu")
