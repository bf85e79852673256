"""Checkpoints of the port (``training.save_checkpoint`` /
``restore_checkpoint`` / ``CheckpointManager``, ``NormalizingFlow.save`` /
``load`` and ``load_params_like``), on the CPU, on the flagship cut to 3
layers of hidden width 64 (tests/test_torch_flow_model.py): the whole
training state (model, Adam, step) round trips exactly; loading converts
each tensor to the model's dtype and names the first path that differs
(trap 3 of the JAX package, facades.py:262-335); a chunk restored from a
checkpoint, before or after its first call, trains on exactly as the run
that was not interrupted."""

import copy

import pytest
import torch

import normflows_tpu_torch as tnf
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch import training
from normflows_tpu_torch.core.facades import load_params_like
from tests.test_torch_flow_model import SCALE, TAIL_BOUND, torch_model

torch.set_num_threads(2)

LR = 5e-4


def reverse_kld(model, batch, generator):
    return model.reverse_kld(256, generator=generator)


def small_model(layers=3, hidden=64):
    base = tdist.UniformGaussian.create(2, [1], SCALE, device="cpu")
    return tnf.NormalizingFlow.create(base, [
        tflows.CircularAutoregressiveRationalQuadraticSpline.create(
            torch.Generator().manual_seed(10 + i), 2, 1, hidden, ind_circ=[1], num_bins=10,
            tail_bound=TAIL_BOUND, permute_mask=True, rng_seed=i, init_identity=False,
            device="cpu") for i in range(layers)], p=tdist.GaussianVonMises(device="cpu"),
        device="cpu")


def trained(steps=2, seed=0):
    model = torch_model()
    state, step = training.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LR), reverse_kld)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        step(state, None, gen)
    return state


def assert_same_state(a, b):
    for (n, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert int(a.step) == int(b.step)


def test_train_state_round_trip(tmp_path):
    state = trained()
    training.save_checkpoint(tmp_path / "ckpt", state, step=2)
    assert (tmp_path / "ckpt" / "2").is_file()
    model = torch_model()
    fresh = training.TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.zero_()
    restored = training.restore_checkpoint(tmp_path / "ckpt", fresh, step=2)
    assert restored is fresh and fresh.step == 2
    assert_same_state(state, fresh)
    # and again, now into the state the optimizer holds, in place
    held = {id(v) for s in fresh.optimizer.state.values() for v in s.values()}
    training.restore_checkpoint(tmp_path / "ckpt", fresh, step=2)
    assert {id(v) for s in fresh.optimizer.state.values() for v in s.values()} == held
    assert_same_state(state, fresh)


def test_dicts_generators_and_tensors_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(5)
    tree = {"w": torch.arange(6.0).view(2, 3), "n": 3, "nested": [torch.ones(2), "x"],
            "generator": gen}
    training.save_checkpoint(tmp_path / "c", tree)
    want = torch.rand(4, generator=gen)
    like = {"w": torch.zeros(2, 3), "n": 0, "nested": [torch.zeros(2), ""],
            "generator": torch.Generator()}
    got = training.restore_checkpoint(tmp_path / "c", like)
    assert torch.equal(got["w"], tree["w"]) and got["n"] == 3 and got["nested"][1] == "x"
    assert torch.equal(torch.rand(4, generator=got["generator"]), want)
    with pytest.raises(ValueError, match="shape"):
        training.restore_checkpoint(tmp_path / "c", dict(like, w=torch.zeros(3, 2)))


def test_load_converts_to_the_model_dtype(tmp_path):
    model = small_model()
    model.save(tmp_path / "m.pt")
    again = tnf.NormalizingFlow.load(tmp_path / "m.pt")
    for (n, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
    narrow = small_model().to(torch.bfloat16)
    restored = load_params_like(narrow, tmp_path / "m.pt")
    assert restored is narrow
    for (n, p), q in zip(narrow.named_parameters(), model.parameters()):
        assert p.dtype == torch.bfloat16, n
        assert torch.equal(p, q.detach().to(torch.bfloat16)), n


def test_load_names_the_first_path_that_differs(tmp_path):
    small_model().save(tmp_path / "m.pt")
    wide = small_model(hidden=32)
    with pytest.raises(ValueError, match=r"'flows\.0\.mprqat\.autoregressive_net\."
                                         r"initial_layer\.weight' has shape"):
        load_params_like(wide, tmp_path / "m.pt")
    with pytest.raises(ValueError, match=r"first unmatched path 'flows\.2\."):
        load_params_like(small_model(layers=2), tmp_path / "m.pt")
    renamed = small_model()
    renamed.flows = torch.nn.ModuleList([tflows.Identity(), *renamed.flows[:2]])
    with pytest.raises(ValueError, match="first differing path"):
        load_params_like(renamed, tmp_path / "m.pt")
    torch.save(torch.nn.Linear(2, 2), tmp_path / "linear.pt")
    with pytest.raises(TypeError, match="contains Linear, not NormalizingFlow"):
        tnf.NormalizingFlow.load(tmp_path / "linear.pt")


def test_manager_keeps_the_newest(tmp_path):
    manager = training.CheckpointManager(tmp_path / "run", max_to_keep=2)
    assert manager.latest_step() is None
    assert manager.restore({"t": torch.zeros(1)}) is None
    for step in range(1, 5):
        manager.save(step, {"t": torch.full((1,), float(step))})
    assert manager.all_steps() == [3, 4] and manager.latest_step() == 4
    assert float(manager.restore({"t": torch.zeros(1)})["t"]) == 4.0
    assert float(manager.restore({"t": torch.zeros(1)}, step=3)["t"]) == 3.0
    manager.close()


@pytest.mark.parametrize("when", ["before_the_first_chunk", "after_a_chunk"])
def test_restored_chunk_trains_on_as_the_uninterrupted_run(tmp_path, when):
    """A chunk, a checkpoint of the training state and the generator, a
    second chunk; then a fresh model, optimizer and chunk restored from the
    checkpoint (before its first call, through load_state_dict; or after a
    chunk, in place into the tensors it holds) gives the second chunk's
    losses and state bit for bit."""
    model = torch_model()
    state, chunk = training.make_step_chunk(
        model, torch.optim.Adam(model.parameters(), lr=LR), reverse_kld, chunk_len=3)
    gen = torch.Generator().manual_seed(7)
    chunk(state, gen)
    training.save_checkpoint(tmp_path / "ckpt", {"train": state, "generator": gen})
    _, want = chunk(state, gen)

    fresh = torch_model()
    fstate, fchunk = training.make_step_chunk(
        fresh, torch.optim.Adam(fresh.parameters(), lr=LR), reverse_kld, chunk_len=3)
    fgen = torch.Generator()
    if when == "after_a_chunk":
        fchunk(fstate, fgen)
    training.restore_checkpoint(tmp_path / "ckpt", {"train": fstate, "generator": fgen})
    assert int(fstate.step) == 3
    _, got = fchunk(fstate, fgen)
    assert torch.equal(got["loss"], want["loss"])
    assert_same_state(state, fstate)


def test_a_replaced_optimizer_state_is_refused():
    model = torch_model()
    state, chunk = training.make_step_chunk(
        model, torch.optim.Adam(model.parameters(), lr=LR), reverse_kld, chunk_len=1)
    chunk(state, torch.Generator().manual_seed(0))
    # new tensors, as loading a file gives
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    with pytest.raises(RuntimeError, match="replaced"):
        chunk(state, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("held", [False, True], ids=["into_a_fresh_adam", "in_place"])
def test_restore_keeps_the_optimizers_device_flags(tmp_path, held):
    """A checkpoint whose parameter groups say ``capturable`` and
    ``foreach`` (as the card's Adam saves them) restores into a plain Adam on
    the CPU, fresh or holding state: the template keeps its own flags, the
    state and hyperparameters come across, and its next step is the one the
    saved optimizer takes."""
    state = trained()
    training.save_checkpoint(tmp_path / "plain", state)
    for group in state.optimizer.param_groups:
        group.update(capturable=True, foreach=True)
    training.save_checkpoint(tmp_path / "card", state)
    want = training.TrainState(torch_model(), None)
    want.optimizer = torch.optim.Adam(want.model.parameters(), lr=LR)
    training.restore_checkpoint(tmp_path / "plain", want)

    got = trained(steps=1, seed=3) if held else training.TrainState(torch_model(), None)
    if not held:
        got.optimizer = torch.optim.Adam(got.model.parameters(), lr=LR)
    training.restore_checkpoint(tmp_path / "card", got)
    assert all(not g["capturable"] and not g["foreach"] for g in got.optimizer.param_groups)
    assert_same_state(want, got)
    for s in (want, got):
        _, step = training.make_train_step(s.model, s.optimizer, reverse_kld)
        step(s, None, torch.Generator().manual_seed(5))
    assert_same_state(want, got)


def test_restore_moves_a_learning_rate_between_float_and_tensor(tmp_path):
    """A float learning rate restores into a chunk whose schedule holds it as
    a tensor (written in place, the tensor kept), and a chunk's tensor rate
    into a plain Adam's float; both then step."""
    model = torch_model()
    state, chunk = training.make_step_chunk(
        model, torch.optim.Adam(model.parameters(), lr=LR), reverse_kld, chunk_len=2,
        schedule=training.cosine_decay_schedule(LR, 10))
    gen = torch.Generator().manual_seed(8)
    chunk(state, gen)
    lr = state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor)
    training.save_checkpoint(tmp_path / "chunk", state)

    eager = trained()
    eager.optimizer.param_groups[0]["lr"] = 1e-3
    training.save_checkpoint(tmp_path / "eager", eager)
    training.restore_checkpoint(tmp_path / "eager", state)
    assert state.optimizer.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(1e-3)
    assert int(state.step) == 2
    _, metrics = chunk(state, gen)
    assert bool(torch.isfinite(metrics["loss"]).all()) and int(state.step) == 4

    plain = training.TrainState(torch_model(), None)
    plain.optimizer = torch.optim.Adam(plain.model.parameters(), lr=LR)
    training.restore_checkpoint(tmp_path / "chunk", plain)
    saved_lr = float(training.cosine_decay_schedule(LR, 10)(torch.tensor(1)))
    assert plain.optimizer.param_groups[0]["lr"] == pytest.approx(saved_lr)
    assert isinstance(plain.optimizer.param_groups[0]["lr"], float)
    _, step = training.make_train_step(plain.model, plain.optimizer, reverse_kld)
    assert bool(torch.isfinite(step(plain, None, torch.Generator().manual_seed(9))[1]["loss"]))
