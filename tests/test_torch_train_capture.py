"""The captured train step (``train/step.py::make_train_step``,
``train/capture.py``) on the CPU, where no CUDA graph can be made: the
program through a stand-in backend (``Snapshot``) against the eager step,
its graph key, which steps capture, the BN momentum as a tensor against
the JAX package's step, and optimizer state across the two kinds of Adam
(capturable on the card, plain on the CPU).

Tolerances: the program against the eager step with ``torch.equal`` (the
same ops on the same inputs in one process); BN running stats against JAX
within rtol 1e-5, atol 1e-5 (``tests/test_torch_train_step.py``); a
restored optimizer's next update with ``torch.equal`` against the same
state restored as the CPU's Adam wrote it."""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.config import TrainConfig as JaxTrainConfig
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.train.step import init_train_state
from spacap3d_tpu.train.step import make_optimizer as jax_make_optimizer
from spacap3d_tpu.train.step import make_train_step as jax_make_train_step
from spacap3d_tpu.utils.convert import convert_state_dict
from spacap3d_tpu_torch.config import ModelConfig, TrainConfig
from spacap3d_tpu_torch.data.synthetic import train_batch
from spacap3d_tpu_torch.models import SpaCapNet, init_spacap
from spacap3d_tpu_torch.train import capture
from spacap3d_tpu_torch.train import step as step_module
from spacap3d_tpu_torch.train.solver import BN_MOMENTUM_INIT, BN_MOMENTUM_MAX
from spacap3d_tpu_torch.train.step import (
    TRAIN_KEYS,
    captured,
    load_optimizer_state,
    make_optimizer,
    make_train_step,
)
from spacap3d_tpu_torch.utils.checkpoint import save_checkpoint_sync
from spacap3d_tpu_torch.utils.convert import params_from_jax
from test_torch_capture import Rerun
from test_torch_solver import port_solver, split  # noqa: F401 (a fixture)
from test_torch_train_step import leaves, to_np

CPU, CUDA = torch.device("cpu"), torch.device("cuda")
# the BN momenta of detection pretraining's schedule at the default
# TrainConfig: 0.5 halved every bn_decay_step epochs, floored at 0.001
SCHEDULE = sorted({max(BN_MOMENTUM_INIT * TrainConfig().bn_decay_rate ** k, BN_MOMENTUM_MAX)
                   for k in range(12)}, reverse=True)
# (ModelConfig, TrainConfig) changes of each program case; the scheduled
# case decays the rate at updates 1 and 2 (one step an epoch)
CASES = {
    "dropout 0": ({"transformer_dropout": 0.0}, {}),
    "dropout 0.1": ({"transformer_dropout": 0.1}, {}),
    "detection pretraining": ({"no_caption": True, "check_relation": False},
                              {"no_caption": True, "lr_decay_step": (1, 2)}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Snapshot(Rerun):
    """The stand-in backend for a train step: a CUDA capture records the
    step and runs none of it, but the stand-in's capture runs the part, a
    second update. It snapshots the model's parameters and buffers, the
    optimizer's state and the registered generators before, and restores
    them in place after, so that a capture call does one update, as on the
    card."""

    def __init__(self, device, keep_graphs=False, model=None, optimizer=None):
        self.model, self.optimizer = model, optimizer

    def tensors(self):
        state = [v for s in self.optimizer.state.values() for v in s.values()
                 if torch.is_tensor(v)]
        return [*self.model.parameters(), *self.model.buffers(), *state]

    def capture(self, fn, generators=()):
        saved = [t.detach().clone() for t in self.tensors()]
        states = [g.get_state() for g in generators]
        graph, static = super().capture(fn, generators)
        with torch.no_grad():
            for t, v in zip(self.tensors(), saved):
                t.copy_(v)
        for g, s in zip(generators, states):
            g.set_state(s)
        return graph, static


@pytest.fixture
def on_the_card(monkeypatch):
    """Makes ``make_train_step`` on the CPU decide as on CUDA and capture
    through ``Snapshot``; returns a function (model, optimizer) -> the
    backend to give the step's program."""
    real = captured
    monkeypatch.setattr(step_module, "captured",
                        lambda capture, device, model=None, group=None:
                        real(capture, CUDA, model, group))

    def backend(model, opt):
        return functools.partial(Snapshot, model=model, optimizer=opt)

    def program(cfg, tc, opt, model, sched=None, **kw):
        monkeypatch.setattr(step_module, "CapturedFunction", functools.partial(
            capture.CapturedFunction, backend=backend(model, opt)))
        return make_train_step(cfg, tc, opt, device="cpu", scheduler=sched, **kw)
    return program


def tiny(**kw):
    return ModelConfig(**dataclasses.asdict(dataclasses.replace(_flagship_cfg(tiny=True), **kw)))


def opt_state(opt):
    return {(i, k): v.clone() for i, s in enumerate(opt.state.values()) for k, v in s.items()}


def assert_same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_the_eager_step(on_the_card, case):
    """Three calls of the program (its capture, then two replays) and of
    the eager step from the same weights, batches, momenta (each a step of
    the schedule) and generator seed: equal metrics and gradients after
    each call (after the capture call, the warm-up's), then equal
    parameters, optimizer state, BN buffers and caller's generator state. With dropout the masks come from the program's own
    generator, loaded with the caller's state; a float rate that the
    scheduler moves is part of the key, so its milestones recapture."""
    mkw, tkw = CASES[case]
    cfg, tc = tiny(**mkw), TrainConfig(**tkw)
    batches = [train_batch(cfg, 2, seed=s) for s in (1, 2, 3)]
    runs = {}
    for kind in ("eager", "program"):
        model = init_spacap(cfg, seed=0, device="cpu")
        opt, sched = make_optimizer(model, tc, steps_per_epoch=1)
        step = (on_the_card(cfg, tc, opt, model, sched) if kind == "program"
                else make_train_step(cfg, tc, opt, device="cpu", scheduler=sched,
                                     capture=False))
        gen = torch.Generator().manual_seed(11)
        metrics, grads, flags = [], [], []
        for b, m in zip(batches, SCHEDULE):
            metrics.append(step(model, b, gen, m))
            grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None})
            if step.program is not None:
                flags.append(step.program.last["captured"])
        runs[kind] = dict(model=model, opt=opt, gen=gen, metrics=metrics, grads=grads,
                          flags=flags)
    want, got = runs["eager"], runs["program"]
    assert got["flags"] == ([True, True, True] if sched is not None else [True, False, False])
    for i in range(len(batches)):
        assert_same(got["metrics"][i], want["metrics"][i], f"metrics of call {i}")
        assert_same(got["grads"][i], want["grads"][i], f"gradients after call {i}")
    assert_same(dict(got["model"].named_parameters()), dict(want["model"].named_parameters()),
                "parameters")
    assert_same(dict(got["model"].named_buffers()), dict(want["model"].named_buffers()),
                "buffers")
    assert_same(opt_state(got["opt"]), opt_state(want["opt"]), "optimizer state")
    assert torch.equal(got["gen"].get_state(), want["gen"].get_state())
    fresh = torch.Generator().manual_seed(11)
    assert (torch.equal(got["gen"].get_state(), fresh.get_state())
            == (cfg.transformer_dropout == 0.0 or cfg.no_caption))


def test_loaded_state_and_replaced_parameters_recapture(on_the_card):
    """An optimizer state loaded anew (new tensors) and a replaced parameter
    each make a new key, whose capture drops the old graph; an in-place
    update of the weights replays, and the replay reads the new values."""
    cfg, tc = tiny(transformer_dropout=0.0), TrainConfig()
    model = init_spacap(cfg, seed=0, device="cpu")
    opt, _ = make_optimizer(model, tc, steps_per_epoch=1)
    step = on_the_card(cfg, tc, opt, model)
    batch = train_batch(cfg, 2, seed=1)
    step(model, batch)
    step(model, batch)
    assert not step.program.last["captured"]
    eager = copy.deepcopy(model)
    eager_opt, _ = make_optimizer(eager, tc, steps_per_epoch=1)
    eager_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    with torch.no_grad():
        for m in (model, eager):
            for p in m.parameters():
                p.mul_(1.01)
    got = step(model, batch)
    assert not step.program.last["captured"]
    assert_same(got, make_train_step(cfg, tc, eager_opt, device="cpu", capture=False)(
        eager, batch), "metrics after an in-place update")
    load_optimizer_state(opt, copy.deepcopy(opt.state_dict()))
    step(model, batch)
    assert step.program.last["captured"] and len(step.program.entries) == 1
    step(model, batch)
    assert not step.program.last["captured"]
    head = model.proposal.proposal[6]
    head.bias = torch.nn.Parameter(head.bias.detach().clone())
    step(model, batch)
    assert step.program.last["captured"] and len(step.program.entries) == 1


def test_cpu_steps_run_eagerly():
    cfg, tc = tiny(), TrainConfig()
    model = SpaCapNet(cfg)
    opt, _ = make_optimizer(model, tc, steps_per_epoch=1)
    assert not any(g["capturable"] for g in opt.param_groups)
    assert make_train_step(cfg, tc, opt, device="cpu").program is None
    assert not captured(True, CPU, model)


def test_which_steps_capture(on_the_card, monkeypatch):
    """On CUDA, ``capture=False`` runs eagerly, and so do a data-parallel
    group and a TP-cut model whose groups are gloo (their collectives run
    on the host); with NCCL groups (a stubbed backend) they capture. A
    captured step refuses ``marks``."""
    cfg, tc = tiny(), TrainConfig()
    model = SpaCapNet(cfg)
    opt, _ = make_optimizer(model, tc, steps_per_epoch=1)
    for backend, want in (("gloo", False), ("nccl", True)):
        monkeypatch.setattr(step_module, "group_backend", lambda g, backend=backend: backend)
        assert captured(True, CUDA, model, group=object()) == want
        assert captured(True, CUDA, model) and not captured(False, CUDA, model)
        model.caption.tp_group = object()       # as parallel/tp.py::shard_model sets it
        assert captured(True, CUDA, model) == want
        model.caption.tp_group = None
        assert (on_the_card(cfg, tc, opt, model, group=object()).program is None) != want
    assert on_the_card(cfg, tc, opt, model, capture=False).program is None
    step = on_the_card(cfg, tc, opt, model)
    assert step.program is not None
    with pytest.raises(ValueError, match="marks"):
        step(model, train_batch(cfg, 2, seed=1), None, 0.1, marks=[])
    assert not step.program.entries


def test_parameters_without_a_gradient_stay_skipped(on_the_card):
    """The input of ROADMAP's record "Adam and parameters without a
    gradient": the tiny config with the relation head built
    (``check_relation``) but out of the loss (``use_relation=False``), the
    JAX package's ``synthetic_batch(B=8, seed=3)``, lr 1e-3. The capture
    sets every ``.grad`` to None, as the eager step does, so the relation
    head's parameters get no gradient in either and Adam leaves them as
    they were (optax decays them: the record); two calls of the program
    equal two eager steps."""
    cfg, tc = tiny(transformer_dropout=0.0), TrainConfig(use_relation=False, lr=1e-3)
    batch, _, _ = synthetic_batch(_flagship_cfg(tiny=True), batch_size=8, seed=3,
                                  vocab_size=cfg.vocab_size)
    batch = {k: batch[k] for k in TRAIN_KEYS}
    runs = {}
    for kind in ("eager", "program"):
        model = init_spacap(cfg, seed=0, device="cpu")
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt, _ = make_optimizer(model, tc, steps_per_epoch=1)
        step = (on_the_card(cfg, tc, opt, model) if kind == "program"
                else make_train_step(cfg, tc, opt, device="cpu", capture=False))
        for _ in range(2):
            step(model, batch)
        none = [n for n, p in model.named_parameters() if p.grad is None]
        assert none and all(n.startswith("caption.relation_proposal.") for n in none)
        assert all(torch.equal(model.get_parameter(n), init[n]) for n in none)
        runs[kind] = (none, dict(model.named_parameters()))
    assert runs["program"][0] == runs["eager"][0]
    assert_same(runs["program"][1], runs["eager"][1], "parameters")


@pytest.fixture(scope="module")
def pretraining():
    """Detection pretraining's tiny config, dropout 0, JAX weights and its
    jitted train step, and one synthetic batch."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), no_caption=True, check_relation=False,
                              transformer_dropout=0.0)
    params, state = jax_init_spacap(jax.random.PRNGKey(0), cfg, JaxDatasetConfig().mean_size_arr)
    batch, _, _ = synthetic_batch(cfg, batch_size=2, seed=3, vocab_size=cfg.vocab_size)
    batch = {k: batch[k] for k in TRAIN_KEYS}
    jtc = JaxTrainConfig(no_caption=True)
    tx = jax_make_optimizer(params, jtc, steps_per_epoch=10)
    return dict(cfg=cfg, params=params, state=state, batch=batch, tx=tx,
                step=jax_make_train_step(cfg, jtc, tx))


@pytest.mark.parametrize("momentum", SCHEDULE)
def test_bn_running_stats_match_jax_at_each_momentum(pretraining, momentum):
    """One step of each package from the same weights and batch at a
    momentum of the schedule: every BN running stat within rtol 1e-5,
    atol 1e-5 of the JAX step's, which takes ``(1 - m)`` in f32 on the
    device as the port's tensor momentum does."""
    s = pretraining
    ts, _ = s["step"](init_train_state(s["params"], s["state"], s["tx"]),
                      {k: jnp.asarray(v) for k, v in s["batch"].items()},
                      jax.random.PRNGKey(0), momentum)
    cfg = ModelConfig(**dataclasses.asdict(s["cfg"]))
    model = SpaCapNet(cfg)
    model.load_state_dict(params_from_jax(to_np(s["params"]), to_np(s["state"])))
    tc = TrainConfig(no_caption=True)
    opt, _ = make_optimizer(model, tc, steps_per_epoch=10)
    make_train_step(cfg, tc, opt, device="cpu")(model, s["batch"], None, momentum)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _, new_state, _ = convert_state_dict(sd, s["params"], s["state"], strict=True)
    got, want = leaves(new_state), leaves(to_np(ts.state))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


def capturable_like(opt_sd, scheduled):
    """An optimizer state dict as a capturable Adam on the card writes it,
    after a checkpoint's copy to the CPU: ``capturable`` groups, each step
    count a 0-dim f32 tensor and, where a scheduler moves them, the rates
    0-dim f32 tensors (``make_optimizer``)."""
    sd = copy.deepcopy(opt_sd)
    for g in sd["param_groups"]:
        g["capturable"] = True
        for k in ("lr", "initial_lr"):
            if k in g and scheduled:
                g[k] = torch.tensor(float(g[k]))
    for s in sd["state"].values():
        s["step"] = s["step"].to(torch.float32)
    return sd


@pytest.mark.parametrize("no_caption", [False, True])
def test_checkpoint_of_a_capturable_optimizer_resumes_on_the_cpu(split, tmp_path, no_caption):
    """A solver's payload written with a capturable Adam's state resumes
    into the CPU's plain Adam through ``Solver.restore``: its groups stay
    plain with float rates, and the next step equals that from the same
    payload as the CPU's Adam wrote it, bit for bit. Detection pretraining
    also carries the MultiStepLR's state, and its rates are f32 tensors on
    the card: the rates here are f32 numbers, which such a tensor holds
    exactly."""
    train = dict(lr=2.0 ** -10, transformer_lr=2.0 ** -11)
    if no_caption:
        train.update(no_caption=True, use_relation=False, lr_decay_step=(1,), lr_decay_rate=0.5)
    first = port_solver(split, str(tmp_path / "a"), **train)
    batch = train_batch(first.mc, 2, seed=1)
    for i in range(2):
        first.train_step(first.model, batch, None, 0.1)
    payload = {"epoch": 0, "iter": 2, "model_state_dict": first.model.state_dict(),
               "optimizer_state_dict": first.optimizer.state_dict(),
               "scheduler_state_dict": (None if first.scheduler is None
                                        else first.scheduler.state_dict()),
               "best": {"epoch": 0, "cider": 0.0}}
    after = {}
    for kind, opt_sd in (("plain", payload["optimizer_state_dict"]),
                         ("capturable", capturable_like(payload["optimizer_state_dict"],
                                                        no_caption))):
        path = str(tmp_path / f"{kind}.ckpt")
        save_checkpoint_sync(path, dict(payload, optimizer_state_dict=opt_sd))
        solver = port_solver(split, str(tmp_path / kind), **train)
        solver.restore(path)
        groups = solver.optimizer.param_groups
        assert all(not g["capturable"] and isinstance(g["lr"], float) for g in groups)
        assert all(s["step"].device == CPU for s in solver.optimizer.state.values())
        solver.train_step(solver.model, batch, None, 0.1)
        after[kind] = (dict(solver.model.named_parameters()), opt_state(solver.optimizer),
                       [g["lr"] for g in groups])
    assert_same(after["capturable"][0], after["plain"][0], "parameters")
    assert_same(after["capturable"][1], after["plain"][1], "optimizer state")
    assert after["capturable"][2] == after["plain"][2]
