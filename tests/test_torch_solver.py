"""The port's run config, checkpoints and Solver on the CPU: ``RunConfig``
files across the two packages, the BN-momentum schedule, the port's
``Solver`` against the JAX package's on the same split and converted
weights (1 epoch, val_step 3, verbose 1, dropout 0, no augmentation),
resume against an uninterrupted run within the port, and
``AsyncCheckpointer``'s atomic writes and deferred errors.

Tolerances: the first step's metrics within rtol 1e-4, the train step's
tolerance against JAX (tests/test_torch_train_step.py); see
``LATER_LOSS_RTOL`` for the later steps. Validation metrics and candidates
with ``==``: equal tokens and boxes within the trunk's tolerance give equal
host arithmetic (tests/test_torch_eval_cap.py). Resume: bit for bit."""
import dataclasses
import json
import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from spacap3d_tpu.config import DataConfig as JaxDataConfig
from spacap3d_tpu.config import ModelConfig as JaxModelConfig
from spacap3d_tpu.config import RunConfig as JaxRunConfig
from spacap3d_tpu.config import TrainConfig as JaxTrainConfig
from spacap3d_tpu.data.dataset import ScanReferDataset as JaxDataset
from spacap3d_tpu.data.dataset import SceneStore as JaxSceneStore
from spacap3d_tpu.data.loader import DataLoader as JaxDataLoader
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig
from spacap3d_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.train.solver import Solver as JaxSolver
from spacap3d_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig
from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
from spacap3d_tpu_torch.data.vocabulary import Vocabulary, load_or_build_vocabulary
from spacap3d_tpu_torch.models import SpaCapNet, init_spacap
from spacap3d_tpu_torch.train.solver import Solver
from spacap3d_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
    save_checkpoint_sync,
)
from spacap3d_tpu_torch.utils import trace
from spacap3d_tpu_torch.utils.convert import params_from_jax
from test_torch_mul_eval import MODEL

FIRST_STEP_RTOL, FIRST_STEP_ATOL = 1e-4, 1e-6
# Later steps. Adam's first update moves every entry by +-lr whatever the
# size of its gradient, so an entry whose gradient is zero up to rounding
# (a BN scale, attention key biases; tests/test_torch_train_step.py) may
# move one way on one side and the other way on the other. At the default
# lr 1e-3 such flips moved the second step's loss by 30% on this split, so
# the comparison runs at lr 1e-5 (both groups), where they move an entry
# by 2e-5 and every later loss stayed within 4e-5 of JAX's; each later
# loss must lie within 1e-3 (atol 1e-6), the share tests/test_torch_train_step.py
# allows a gradient leaf.
COMPARE_LR = 1e-5
LATER_LOSS_RTOL, LATER_LOSS_ATOL = 1e-3, 1e-6
EPOCH_SCALARS = ("mean_fetch_ms", "mean_step_ms")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while the module runs. The tiny CPU
    steps are hundreds of small ops; when several test workers share the
    host, torch's intra-op threads wait on each other at every op (a resume
    test took 251 s under six workers against 8 s alone, at either thread
    count alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """3 synthetic scenes: two train (12 annotations each, relation labels),
    one val."""
    root = str(tmp_path_factory.mktemp("solver_data"))
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=3, seed=5)
    train = [a for a in anns if a["scene_id"] != scene_ids[2]]
    val = [a for a in anns if a["scene_id"] == scene_ids[2]]
    return root, train, val


def run_config(root, out, **train):
    model = dict(MODEL, transformer_dropout=0.0, no_caption=train.get("no_caption", False))
    data = dict(data_root=root, num_points=MODEL["num_points"], augment=False,
                use_relation=True, max_des_len=MODEL["max_des_len"], num_workers=1)
    tc = dict(batch_size=4, epoch=1, val_step=3, verbose=1, seed=7)
    tc.update(train)
    return model, data, tc, out


def port_solver(split, out, vocab_size=None, state_dict=None, stamp="run", **train):
    root, train_anns, val_anns = split
    model, data, tc, out = run_config(root, out, **train)
    vocab = Vocabulary.build(train_anns, max_len=MODEL["max_des_len"])
    cfg = RunConfig(model=ModelConfig(**model, vocab_size=vocab_size or len(vocab)),
                    train=TrainConfig(**tc), data=DataConfig(**data), output_dir=out)
    dc = ScannetDatasetConfig()
    scenes = sorted({a["scene_id"] for a in train_anns})
    train_ds = ScanReferDataset(train_anns, SceneStore(cfg.data.scannet_data, scenes,
                                                       load_relations=True),
                                vocab, dc, cfg.data, split="train")
    val_cfg = dataclasses.replace(cfg.data, use_relation=False)
    val_ds = ScanReferDataset(val_anns[:1], SceneStore(cfg.data.scannet_data,
                                                       [val_anns[0]["scene_id"]]),
                              vocab, dc, val_cfg, split="val")
    if state_dict is None:
        net = init_spacap(cfg.model, seed=3, device="cpu")
    else:
        net = SpaCapNet(cfg.model)
        net.load_state_dict(state_dict)
    return Solver(cfg, net, DataLoader(train_ds, 4, shuffle=True, seed=7, num_workers=1),
                  DataLoader(val_ds, 1, shuffle=False, num_workers=1), train_ds, val_ds,
                  vocab, dc, val_anns, stamp, device="cpu")


def jax_solver(split, out, **train):
    root, train_anns, val_anns = split
    model, data, tc, out = run_config(root, out, **train)
    vocab = JaxVocabulary.build(train_anns, max_len=MODEL["max_des_len"])
    cfg = JaxRunConfig(model=JaxModelConfig(**model, vocab_size=len(vocab)),
                       train=JaxTrainConfig(**tc), data=JaxDataConfig(**data), output_dir=out)
    dc = JaxDatasetConfig()
    scenes = sorted({a["scene_id"] for a in train_anns})
    train_ds = JaxDataset(train_anns, JaxSceneStore(cfg.data.scannet_data, scenes,
                                                    load_relations=True),
                          vocab, dc, cfg.data, split="train")
    val_cfg = dataclasses.replace(cfg.data, use_relation=False)
    val_ds = JaxDataset(val_anns[:1], JaxSceneStore(cfg.data.scannet_data,
                                                    [val_anns[0]["scene_id"]]),
                        vocab, dc, val_cfg, split="val")
    params, state = jax_init_spacap(jax.random.PRNGKey(4), cfg.model, dc.mean_size_arr)
    solver = JaxSolver(cfg, params, state,
                       JaxDataLoader(train_ds, 4, shuffle=True, seed=7, num_workers=1),
                       JaxDataLoader(val_ds, 1, shuffle=False, num_workers=1),
                       train_ds, val_ds, vocab, dc, val_anns, "run")
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    return solver, sd


def read_run(root):
    with open(os.path.join(root, "all_scalars.json")) as f:
        scalars = json.load(f)
    with open(os.path.join(root, "best.json")) as f:
        best = json.load(f)
    with open(os.path.join(root, "pred_val.json")) as f:
        pred = json.load(f)
    return scalars, best, pred, sorted(os.listdir(root))


def test_run_config_files_load_across_packages(tmp_path):
    """A config.json written by either package loads in the other into the
    same values (JSON arrays: the JAX loader keeps the model's as lists)."""
    jax_cfg = JaxRunConfig(
        model=JaxModelConfig(**MODEL, vocab_size=77, early_guide=False),
        train=JaxTrainConfig(lr_decay_step=(3, 9), no_caption=True, criterion="sum"),
        data=JaxDataConfig(data_root="somewhere", use_color=True), output_dir="o", tag="t")
    jax_cfg.save(str(tmp_path / "jax.json"))
    port = RunConfig.load(str(tmp_path / "jax.json"))
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    port.save(str(tmp_path / "port.json"))
    back = JaxRunConfig.load(str(tmp_path / "port.json"))

    def normal(cfg):
        return json.loads(json.dumps(dataclasses.asdict(cfg)))

    assert normal(back) == normal(jax_cfg) == normal(port)
    assert RunConfig.load(str(tmp_path / "port.json")) == port


@pytest.mark.parametrize("no_caption", [False, True])
def test_bn_momentum_matches_jax(no_caption):
    tc = dict(no_caption=no_caption, bn_decay_step=20, bn_decay_rate=0.5)
    jax_self = types.SimpleNamespace(tc=JaxTrainConfig(**tc))
    port_self = types.SimpleNamespace(tc=TrainConfig(**tc))
    got = [Solver.bn_momentum(port_self, e) for e in range(200)]
    assert got == [JaxSolver.bn_momentum(jax_self, e) for e in range(200)]
    assert len(set(got)) == (10 if no_caption else 1)   # 0.5 * 0.5^k, k < 9, then 0.001


def test_solver_matches_jax(split, tmp_path):
    lr = dict(lr=COMPARE_LR, transformer_lr=COMPARE_LR)
    jax_side, sd = jax_solver(split, str(tmp_path / "jax"), **lr)
    jax_side(1, verbose=1)
    port = port_solver(split, str(tmp_path / "port"), state_dict=sd, **lr)
    port(1, verbose=1)
    scalars, best, pred, files = read_run(port.root)
    want_scalars, want_best, want_pred, want_files = read_run(jax_side.root)

    assert files == want_files
    assert "model.ckpt" in files and "model_last.ckpt" in files
    assert sorted(best) == sorted(want_best)
    assert sorted(scalars) == sorted(want_scalars)
    assert port.global_iter == jax_side.global_iter == 6
    for key, series in want_scalars.items():
        got = scalars[key]
        assert [s for _, s, _ in got] == [s for _, s, _ in series], key
        phase, name = key.split("/")
        if phase == "val":
            continue
        if name in EPOCH_SCALARS:
            continue
        want = np.array([v for _, _, v in series])
        have = np.array([v for _, _, v in got])
        np.testing.assert_allclose(have[0], want[0], rtol=FIRST_STEP_RTOL,
                                   atol=FIRST_STEP_ATOL, err_msg=key)
        if name.endswith("loss"):
            np.testing.assert_allclose(have, want, rtol=LATER_LOSS_RTOL, atol=LATER_LOSS_ATOL,
                                       err_msg=key)
    # validations at iterations 2 and 5 (the 3rd and 6th step)
    assert [s for _, s, _ in scalars["val/cider"]] == [3, 6]
    assert pred == want_pred
    for key in want_scalars:
        if key.startswith("val/"):
            assert [v for _, _, v in scalars[key]] == [v for _, _, v in want_scalars[key]], key
    assert best == want_best


@pytest.mark.parametrize("no_caption", [False, True])
def test_resume_is_bit_equal_to_an_uninterrupted_run(split, tmp_path, no_caption):
    """2 epochs straight against 1 epoch, ``restore`` from model_last.ckpt,
    then 1 more: equal model and optimizer state dicts, bit for bit, and,
    for detection pretraining, the MultiStepLR's state (its milestones at
    update 6 fall inside the second epoch)."""
    kw = dict(no_caption=no_caption, use_relation=not no_caption, lr_decay_step=(1,))
    straight = port_solver(split, str(tmp_path / "a"), **kw)
    straight(2, verbose=1)
    first = port_solver(split, str(tmp_path / "b"), **kw)
    first(1, verbose=1)
    resumed = port_solver(split, str(tmp_path / "b"), **kw)
    resumed.restore(os.path.join(first.root, "model_last.ckpt"))
    assert resumed.start_epoch == 1 and resumed.global_iter == 6
    resumed(2, verbose=1)

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            elif isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert a[k] == b[k], k

    same(resumed.model.state_dict(), straight.model.state_dict())
    same(resumed.optimizer.state_dict()["state"], straight.optimizer.state_dict()["state"])
    assert (resumed.optimizer.state_dict()["param_groups"]
            == straight.optimizer.state_dict()["param_groups"])
    if no_caption:
        assert resumed.scheduler.state_dict() == straight.scheduler.state_dict()
        assert resumed.scheduler.get_last_lr() == [1e-4]
    with open(os.path.join(straight.root, "best.json")) as f:
        want_best = json.load(f)
    with open(os.path.join(resumed.root, "best.json")) as f:
        assert json.load(f) == want_best
    ckpt = load_checkpoint(os.path.join(resumed.root, "model_last.ckpt"))
    assert ckpt["epoch"] == 1 and ckpt["iter"] == 12
    assert (ckpt["scheduler_state_dict"] is None) == (not no_caption)


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """In-place updates after ``save`` returns do not reach the file."""
    w = torch.zeros(1000)
    cp = AsyncCheckpointer()
    cp.save(str(tmp_path / "a.ckpt"), {"w": w, "n": 3, "best": {"cider": -float("inf")}})
    w += 1
    cp.wait()
    got = load_checkpoint(str(tmp_path / "a.ckpt"))
    assert torch.equal(got["w"], torch.zeros(1000)) and got["n"] == 3
    assert got["best"] == {"cider": -float("inf")}
    rec = cp.records[0]
    assert rec["path"].endswith("a.ckpt") and rec["write_s"] >= 0 and rec["snapshot_s"] >= 0


def test_checkpoint_writes_are_atomic_and_errors_surface(tmp_path, monkeypatch):
    """A reader polling the path while large payloads are rewritten sees
    either no file or a whole one; a failed write raises on ``wait()``
    (and the next ``save`` after it works)."""
    path = str(tmp_path / "big.ckpt")
    stop = threading.Event()
    seen, bad = [], []

    def reader():
        while not stop.is_set():
            if os.path.exists(path):
                try:
                    seen.append(int(load_checkpoint(path)["i"]))
                except Exception as e:  # a partial file
                    bad.append(repr(e))

    t = threading.Thread(target=reader)
    t.start()
    try:
        cp = AsyncCheckpointer()
        for i in range(8):
            cp.save(path, {"i": i, "x": torch.full((1 << 20,), float(i))})
        cp.wait()
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert not bad, bad[:3]
    assert seen and seen == sorted(seen)
    assert load_checkpoint(path)["i"] == 7

    def fail(obj, f):
        raise OSError("disk full")

    cp = AsyncCheckpointer()
    monkeypatch.setattr(torch, "save", fail)
    cp.save(path, {"i": 8})
    with pytest.raises(OSError, match="disk full"):
        cp.wait()
    cp.wait()   # the error is raised once
    monkeypatch.undo()
    save_checkpoint_sync(path, {"i": 9})
    assert load_checkpoint(path)["i"] == 9 and not os.path.exists(path + ".tmp")


def test_load_or_build_vocabulary(split, tmp_path):
    _, train_anns, _ = split
    path = str(tmp_path / "v" / "ScanRefer_vocabulary.json")
    built = load_or_build_vocabulary(path, train_anns)
    assert os.path.exists(path)
    assert built.word2idx == Vocabulary.build(train_anns).word2idx
    again = load_or_build_vocabulary(path, train_anns[:1])
    assert again.word2idx == built.word2idx


def test_fetch_and_step_spans_are_the_solvers_timing(split, tmp_path):
    """The ``solver.fetch`` and ``solver.step`` spans are the clock reads
    of ``Solver.timing``'s fetch times and sampled step times (every second
    step at verbose 2), their request the global iteration; the step's
    upload is its child. The last fetch finds the epoch's end."""
    solver = port_solver(split, str(tmp_path), val_step=0)
    trace.enable()
    try:
        solver._feed_epoch(0, 0.1, 2, len(solver.train_loader), time.time())
    finally:
        records = trace.disable()
    steps = len(solver.train_loader)
    fetch = [r for r in records if r["name"] == "solver.fetch"]
    step = [r for r in records if r["name"] == "solver.step"]
    assert [r["request"] for r in fetch] == list(range(steps + 1))
    assert [r["request"] for r in step] == list(range(steps))
    seconds = [(r["end_ns"] - r["start_ns"]) * 1e-9 for r in fetch + step]
    assert seconds[:steps] == solver.timing["fetch"]
    assert seconds[steps + 1::2] == solver.timing["step"] and len(solver.timing["step"]) == 3
    uploads = [r for r in records if r["name"] == "upload"]
    assert [(r["parent"], r["request"]) for r in uploads] == [(r["id"], r["request"])
                                                              for r in step]


def test_profile_and_interrupt(split, tmp_path):
    """``profile`` writes a torch.profiler trace of real updates into
    <run>/profile; an interrupt in the second epoch waits for the first
    epoch's model_last.ckpt, dumps the scalars and re-raises."""
    solver = port_solver(split, str(tmp_path))
    before = {k: v.clone() for k, v in solver.model.state_dict().items()}
    trace_dir = solver.profile(num_steps=1)
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
    assert any(not torch.equal(v, solver.model.state_dict()[k]) for k, v in before.items())

    step, calls = solver.train_step, []

    def interrupted(*a, **kw):
        calls.append(1)
        if len(calls) == 8:          # the second step of the second epoch
            raise KeyboardInterrupt
        return step(*a, **kw)

    solver.train_step = interrupted
    with pytest.raises(KeyboardInterrupt):
        solver(3, verbose=1)
    assert load_checkpoint(os.path.join(solver.root, "model_last.ckpt"))["epoch"] == 0
    with open(os.path.join(solver.root, "all_scalars.json")) as f:
        assert len(json.load(f)["train/loss"]) == 7
    with open(os.path.join(solver.root, "log.txt")) as f:
        assert "interrupted" in f.read()
    assert not os.path.exists(os.path.join(solver.root, "best.json"))
