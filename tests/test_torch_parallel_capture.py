"""The captured parallel steps (``train/step.py``, ``train/capture.py``) on
the CPU, where no CUDA graph can be made: the data- and tensor-parallel
train steps and the tensor-parallel eval forward through the program, on
two gloo ranks whose groups the steps take for NCCL (``group_backend``
patched; ``captured`` decides as on CUDA), the graphs stood in for by
``Snapshot`` (train) and ``Rerun`` (eval), against the eager group steps
on the same weights, batches and generators. ``mp_dryrun``'s captured
turns (``Worker.captured_train_turns``, ``captured_eval_turns``) run the
comparisons; the TP Solver runs 2 epochs each way.

Tolerances: ``torch.equal`` throughout (the same ops on the same inputs in
one process a rank): metrics, dropout masks, parameters, Adam state, BN
buffers and generator states of three train steps at dropout 0.1, and
every output of the TP eval forward, unfused and fused. At tp 2 the model
ranks draw their own slices' masks (about 18% of the entries differ at
rate 0.1), and a replay with another seed draws other local masks. Ranks
whose graph keys disagree both raise within RAISE_S seconds."""
import argparse
import copy
import dataclasses
import functools
import json
import os
import sys
import time
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
INIT_TIMEOUT, WORLD_TIMEOUT = 60, 240
# seconds within which ranks whose keys disagree must both have raised
RAISE_S = 20.0
CUDA = torch.device("cuda")


def on_nccl(step_module, dryrun, Snapshot, Rerun, *more):
    """In this process: steps on the CPU decide as on CUDA and take every
    group for NCCL; the train and eval steps that ``mp_dryrun`` (and this
    worker, through ``dryrun``'s names) and the modules ``more`` build
    capture through ``Snapshot`` (bound to the model of the step's call and
    its optimizer) and ``Rerun``."""
    real = step_module.captured
    step_module.group_backend = lambda group: "nccl"
    step_module.captured = (lambda capture, device, model=None, group=None:
                            real(capture, CUDA, model, group))
    make_train, make_eval = step_module.make_train_step, step_module.make_eval_step

    def make_train_step(cfg, tc, opt, *args, **kw):
        inner = make_train(cfg, tc, opt, *args, **kw)
        if inner.program is None:
            return inner
        bound = {}
        inner.program.backend = lambda device, keep_graphs=False: Snapshot(
            device, keep_graphs, model=bound["model"], optimizer=opt)

        def step(model, *a, **k):
            bound["model"] = model
            return inner(model, *a, **k)
        step.program = inner.program
        return step

    def make_eval_step(cfg, *args, **kw):
        step = make_eval(cfg, *args, **kw)
        if step.program is not None:
            step.program.backend = Rerun
        return step

    for module in (dryrun, *more):
        module.make_train_step, module.make_eval_step = make_train_step, make_eval_step


def worker(argv):
    """One of two gloo ranks: the DP step's turns, the TP (tp 2) step's and
    eval forward's turns, the early-exit TP forward, the TP masks of a
    replay with another seed, and a disagreement; writes ``rank{i}.json``
    and the masks to ``rank{i}.pt``."""
    p = argparse.ArgumentParser()
    p.add_argument("--out")
    p.add_argument("--root")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_capture import Rerun
    from test_torch_train_capture import Snapshot
    from spacap3d_tpu_torch.config import EOS_ID, DataConfig, RunConfig, TrainConfig
    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
    from spacap3d_tpu_torch.data.loader import DataLoader
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import Vocabulary
    from spacap3d_tpu_torch.train import solver as solver_module
    from spacap3d_tpu_torch.models import captioner
    from spacap3d_tpu_torch.parallel import mesh as mesh_mod
    from spacap3d_tpu_torch.parallel import mp_dryrun as dryrun
    from spacap3d_tpu_torch.parallel import multihost
    from spacap3d_tpu_torch.parallel import tp as tp_mod
    from spacap3d_tpu_torch.train import step as step_module
    from spacap3d_tpu_torch.train.solver import dropout_generator

    on_nccl(step_module, dryrun, Snapshot, Rerun, solver_module)
    # the fused decode's plain kernels on CPU tensors (bf16 decode)
    captioner.decode_fused = lambda cfg, dd, dev: (bool(cfg.eval_decode_fused)
                                                   and dd == torch.bfloat16)
    rank, world = multihost.initialize_from_env(device="cpu", timeout_s=INIT_TIMEOUT)
    res = {"rank": rank}
    opts = dryrun.parse_args(["--out", args.out, "--device", "cpu", "--dropout", "0.1",
                              "--global_batch", "4", "--captured"])
    w = dryrun.Worker(opts, rank, world)
    batch = w.global_batch()

    # DP: the world's group, each rank 2 of the 4 rows
    model = w.fresh_model()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    group = mesh_mod.make_mesh()
    res["dp"] = w.captured_train_turns(start, mesh_mod.shard_batch(group, batch), group, rank)

    # TP: one model group of both ranks
    mesh = tp_mod.make_tp_mesh(2)
    local = mesh_mod.shard_batch(mesh.data, batch)
    res["tp"] = w.captured_train_turns(start, local, mesh.data, mesh.data_rank,
                                       prepare=lambda m: tp_mod.shard_model(m, mesh))

    def sharded(**kw):
        m = w.fresh_model_local(start, dataclasses.replace(w.cfg, **kw))
        return tp_mod.shard_model(m, mesh)
    eval_batch = dryrun.to_device_batch({k: batch[k] for k in dryrun.EVAL_INPUT_KEYS}, w.dev)
    res["tp_eval"] = w.captured_eval_turns(
        {"unfused": sharded(), "fused": sharded(eval_decode_fused=True)}, eval_batch,
        {"unfused": None, "fused": None}, turns=1)

    # the early exit: the host's all-EOS test between the decode's graphs
    res["early_exit"] = {}
    for bias in (0.0, 30.0):
        m = sharded(eval_decode_early_exit=True)
        with torch.no_grad():
            m.caption.model.generator.proj.bias[EOS_ID] += bias
        step = dryrun.make_eval_step(m.cfg, device="cpu")
        eager = dryrun.make_eval_step(m.cfg, device="cpu", capture=False)(m, eval_batch)
        calls = []
        for _ in range(2):
            out = step(m, eval_batch)
            calls.append({"captured": step.program.last["captured"],
                          "replayed": step.program.last["replayed"],
                          "equal": all(torch.equal(out[k], eager[k]) for k in eager)})
        res["early_exit"][str(bias)] = {
            "calls": calls, "graphs": len(next(iter(step.program.entries.values())).graphs),
            "token_digest": dryrun.digest({"lang_cap": out["lang_cap"]})}

    # TP masks: a capture call, then a replay from a generator of another seed
    draws, plain = [], captioner.dropout

    def recording(x, rate, gen, local=False):
        y = plain(x, rate, gen, local)
        draws.append({"local": local, "nonzero": x != 0, "dropped": (y == 0) & (x != 0)})
        return y
    captioner.dropout = recording
    m = sharded()
    tc = TrainConfig()
    step = dryrun.make_train_step(w.cfg, tc, dryrun.make_optimizer(m, tc, 10)[0],
                                  device="cpu", group=mesh.data)
    calls = []
    for it in range(2):
        draws.clear()
        step(m, local, dropout_generator("cpu", 5, it, mesh.data_rank), 0.1)
        got = list(draws)
        if step.program.last["captured"]:
            got = got[:len(got) // 2]           # the warm-up's; the capture's follow
        calls.append(got)
    captioner.dropout = plain
    torch.save({"calls": [[{k: v if k == "local" else v.detach() for k, v in d.items()}
                           for d in call] for call in calls]},
               os.path.join(args.out, f"rank{rank}.pt"))

    # ranks whose keys disagree: rank 1 loads its optimizer state anew
    m = w.fresh_model_local(start, dataclasses.replace(w.cfg, transformer_dropout=0.0))
    opt = dryrun.make_optimizer(m, tc, 10)[0]
    step = dryrun.make_train_step(w.cfg, tc, opt, device="cpu", group=group)
    dp_local = mesh_mod.shard_batch(group, batch)
    for _ in range(2):
        step(m, dp_local, None, 0.1)
    if rank == 1:
        step_module.load_optimizer_state(opt, copy.deepcopy(opt.state_dict()))
    t0 = time.perf_counter()
    try:
        step(m, dp_local, None, 0.1)
        res["disagree"] = {"raised": None}
    except RuntimeError as e:
        res["disagree"] = {"raised": str(e)}
    res["disagree"]["seconds"] = time.perf_counter() - t0
    # the TP solver (data 1 x model 2), 2 epochs at dropout 0.1: captured
    # against eager, the train step's calls per rank
    with open(os.path.join(args.root, "ScanRefer_filtered_all.json")) as f:
        anns = json.load(f)
    vocab = Vocabulary.build(anns, max_len=w.cfg.max_des_len)
    run = RunConfig(model=dataclasses.replace(w.cfg, vocab_size=len(vocab)),
                    train=TrainConfig(batch_size=4, epoch=2, val_step=0, verbose=1, seed=5),
                    data=DataConfig(data_root=args.root, num_points=w.cfg.num_points,
                                    augment=False, use_relation=True,
                                    max_des_len=w.cfg.max_des_len, num_workers=1),
                    output_dir=args.out)
    dc = ScannetDatasetConfig()
    ds = ScanReferDataset(anns, SceneStore(run.data.scannet_data, sorted(
        {a["scene_id"] for a in anns}), load_relations=True), vocab, dc, run.data, split="train")
    captured_step, solvers = solver_module.make_train_step, {}
    for kind in ("eager", "captured"):
        solver_module.make_train_step = (captured_step if kind == "captured" else
                                         functools.partial(captured_step, capture=False))
        m = dryrun.init_spacap(run.model, seed=3, device="cpu")
        solvers[kind] = solver_module.Solver(
            run, m, DataLoader(ds, 4, shuffle=True, seed=5, num_workers=1), None, ds, None,
            vocab, dc, anns, f"tp_{kind}", device="cpu", tp_mesh=mesh)
        program = solvers[kind].train_step.program
        calls = []
        if program is not None:
            inner = solvers[kind].train_step

            def counted(*a, inner=inner, calls=calls, **k):
                out = inner(*a, **k)
                calls.append(inner.program.last["captured"])
                return out
            counted.program = program
            solvers[kind].train_step = counted
        solvers[kind](epochs=2, verbose=1)
        res.setdefault("solver", {})[kind] = {"calls": calls}
    e, c = (solvers[k].model for k in ("eager", "captured"))
    res["solver"]["state_differ"] = sorted(dryrun.differences(c.state_dict(), e.state_dict()))
    res["solver"]["iterations"] = solvers["captured"].global_iter
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    worker(sys.argv[2:])
    sys.exit(0)

from spacap3d_tpu_torch.config import TrainConfig  # noqa: E402
from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from spacap3d_tpu_torch.models import SpaCapNet  # noqa: E402
from spacap3d_tpu_torch.parallel.mp_dryrun import launch  # noqa: E402
from spacap3d_tpu_torch.train import capture  # noqa: E402
from spacap3d_tpu_torch.train import step as step_module  # noqa: E402
from spacap3d_tpu_torch.train.step import captured, make_optimizer  # noqa: E402
from test_torch_train_capture import on_the_card, tiny  # noqa: E402,F401 (a fixture)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_capture")
    root = str(out / "data")
    write_synthetic_dataset(root, num_scenes=2, seed=3)
    t0 = time.perf_counter()
    done = launch([os.path.abspath(__file__), "--worker", "--out", str(out), "--root", root],
                  2, WORLD_TIMEOUT, env=ENV)
    for p in done:
        assert p.returncode == 0, p.stderr[-4000:]
    results = [json.load(open(out / f"rank{r}.json")) for r in range(2)]
    masks = [torch.load(out / f"rank{r}.pt", weights_only=True)["calls"] for r in range(2)]
    return {"results": results, "masks": masks, "seconds": time.perf_counter() - t0}


class Group:
    """A stand-in process group with a backend."""

    def __init__(self, backend):
        self.backend = backend


@pytest.mark.parametrize("kind", ["data group", "model group", "TP data group"])
def test_capture_decides_by_backend(on_the_card, monkeypatch, kind):
    """NCCL groups capture; a gloo group stays eager, whichever group of
    the step it is (a data-parallel ``group``, a TP-cut model's model group,
    its data group); ``capture=False`` and the CPU stay eager."""
    monkeypatch.setattr(step_module, "group_backend", lambda g: g.backend)
    cfg, tc = tiny(), TrainConfig()
    for backend, want in (("nccl", True), ("gloo", False)):
        model = SpaCapNet(cfg)
        groups = {k: Group("nccl") for k in ("data group", "model group", "TP data group")}
        groups[kind] = Group(backend)
        group = groups["data group"]
        if kind != "data group":
            model.caption.tp_group = groups["model group"]     # as shard_model sets them
            model.tp_mesh = types.SimpleNamespace(data=groups["TP data group"])
        assert step_module.captured(True, CUDA, model, group) == want
        assert not step_module.captured(False, CUDA, model, group)
        assert not captured(True, torch.device("cpu"), model, group)
        opt, _ = make_optimizer(model, tc, steps_per_epoch=1)
        step = on_the_card(cfg, tc, opt, model, group=group)
        assert (step.program is not None) == (kind != "data group" or want)


def assert_equal_turns(turns, steps=3):
    """A captured run equal to the eager one under ``torch.equal``: each
    call's metrics and dropout masks, then parameters, Adam state, BN
    buffers and every call's generator state."""
    assert [c["captured"] for c in turns["calls"]] == [True] + [False] * (steps - 1)
    assert not any(turns["metrics_differ"]), turns["metrics_differ"]
    assert not any(turns["masks_differ"]), turns["masks_differ"]
    assert min(turns["masks_per_step"][:steps]) > 0     # the last call is the profiled one
    for k in ("parameters_differ", "adam_state_differ", "bn_buffers_differ"):
        assert turns[k] == {}, (k, turns[k])
    assert turns["generator_states_equal"]


@pytest.mark.parametrize("leg", ["dp", "tp"])
def test_parallel_train_program_equals_eager(world, leg):
    """Two DP ranks, and two TP ranks (tp 2), at dropout 0.1: three calls
    of the program (its capture, then two replays) equal the eager group
    steps; the ranks' parameters stay bit-equal; each replay agreed with
    the other rank over the side group."""
    results = world["results"]
    for r in results:
        assert_equal_turns(r[leg])
        assert all(c["agree_ms"] is not None for c in r[leg]["calls"])
    assert results[0][leg]["param_digest"] == results[1][leg]["param_digest"]


def test_tp_replays_draw_their_own_local_masks(world):
    """A replay of the TP step from a generator of another seed draws other
    masks on the rank's slices (none baked in at capture), and the model
    ranks' local masks differ while the whole tensors' agree."""
    a, b = world["masks"]
    for calls in (a, b):
        first, second = ([d for d in call if d["local"]] for call in calls)
        assert first and len(first) == len(second)
        assert any(not torch.equal(x["dropped"], y["dropped"]) for x, y in zip(first, second))
    for x, y in zip(a[1], b[1]):
        both = x["nonzero"] & y["nonzero"]
        if x["local"]:
            differ = ((x["dropped"] ^ y["dropped"]) & both).sum() / both.sum()
            assert 0.1 < float(differ) < 0.26, float(differ)
        else:
            assert torch.equal(x["dropped"] & both, y["dropped"] & both)


@pytest.mark.parametrize("path", ["unfused", "fused"])
def test_tp_eval_program_equals_eager(world, path):
    """The TP eval forward through the program, unfused and fused (the
    decode kernels' plain versions): every output ``==`` the eager TP
    forward's, capture call and replays alike."""
    for r in world["results"]:
        ev = r["tp_eval"][path]
        assert [c["captured"] for c in ev["calls"]] == [True, False]
        assert not any(ev["differ"]), ev["differ"]


@pytest.mark.parametrize("bias", ["0.0", "30.0"])
def test_tp_early_exit_ranks_replay_alike(world, bias):
    """With the decode's early exit (and an EOS logit raised by 30, so that
    every row ends in the first stage) the ranks decode equal tokens and
    replay the same graphs, equal to the eager forward."""
    runs = [r["early_exit"][bias] for r in world["results"]]
    assert runs[0]["token_digest"] == runs[1]["token_digest"]
    assert runs[0]["calls"] == runs[1]["calls"]
    calls = runs[0]["calls"]
    assert [c["captured"] for c in calls] == [True, False] and all(c["equal"] for c in calls)
    replayed = calls[1]["replayed"]
    graphs = runs[0]["graphs"]
    assert graphs > 2
    assert replayed == ([0, graphs - 1] if bias == "30.0" else list(range(graphs)))


def test_tp_solver_captures_once_and_equals_eager(world):
    """The Solver on a (data=1, model=2) split, its train step taken for
    NCCL: the first iteration captures on both ranks, every later one
    replays, and after 2 epochs at dropout 0.1 the model equals the eager
    solver's under ``torch.equal``."""
    for r in world["results"]:
        sv = r["solver"]
        n = sv["iterations"]
        assert n >= 2 and sv["captured"]["calls"] == [True] + [False] * (n - 1)
        assert sv["eager"]["calls"] == [] and sv["state_differ"] == []


def test_disagreeing_ranks_raise(world):
    """Rank 1 loads its optimizer state anew (a new key), rank 0 does not:
    both raise, naming the ranks and the field, well inside the world's
    timeout."""
    for r in world["results"]:
        msg = r["disagree"]["raised"]
        assert msg is not None and "ranks [1]" in msg and "weights" in msg, msg
        assert "ranks [0] replay" in msg
        assert r["disagree"]["seconds"] < RAISE_S


# (the fields in which rank 0's key differs from its last, None: its key is
# live; rank 1's; what they do: capture, replay or raise)
AGREE_CASES = {
    "both replay": (None, None, False),
    "both new": (("static",), ("weights",), True),
    "a new table on rank 1 alone": (None, ("addresses",), True),
    "a new table on rank 0 alone": (("addresses",), None, True),
    "a loaded optimizer state on rank 1 alone": (None, ("weights",), "weights"),
    "rank 1 cleared alone": (None, "first", "first call"),
}


@pytest.mark.parametrize("case", sorted(AGREE_CASES))
def test_ranks_agree_on_capture_or_replay(monkeypatch, case):
    """``CapturedFunction.agree`` on rank 0 of two from both ranks' codes
    (the all-gather stubbed): all live replays, all new captures, keys new
    only in the ``by_address`` inputs' addresses on some ranks make every
    rank capture, and any other mix raises, naming the ranks and fields."""
    mine, theirs, want = AGREE_CASES[case]
    last = capture.Key(1, ("s",), ("w",), ("a",), ("g",))

    def code(fields):
        if fields is None:
            return 0
        if fields == "first":
            return capture.new_key_code(last, None)
        return capture.new_key_code(last._replace(**{f: ("new",) for f in fields}), last)
    program = capture.CapturedFunction(lambda model: None)
    program.entries[last] = None
    key = last if mine is None else last._replace(**{f: ("new",) for f in mine})
    monkeypatch.setattr(capture.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(capture.multihost, "allgather_ints", lambda c: [c, code(theirs)])
    if isinstance(want, bool):
        assert program.agree(key, mine is not None, [object()]) == want
    else:
        with pytest.raises(RuntimeError, match=rf"ranks \[1\] have a new graph key \(rank 1: "
                                               rf"{want} changed\), ranks \[0\] replay"):
            program.agree(key, False, [object()])
