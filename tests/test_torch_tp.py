"""Tensor parallelism of the port's captioner on the CPU, over gloo
(``spacap3d_tpu_torch/parallel/tp.py``), as tests/test_tp.py pins the JAX
package's: the layout leaf by leaf against ``tp_param_specs`` with its
divisibility guard, and two ranks of one model group (started as processes
of ``mp_dryrun``, or of this file for the solver) against the replicated
model on the same weights. The greedy tokens are equal and the objectness
within rtol 1e-5, atol 1e-6 (tests/test_tp.py); the TP train step's
metrics within rel 1e-5 of the replicated step's, and, with SGD (as
tests/test_tp.py takes it for the equality run), its gathered parameters
within rtol 1e-5, atol 1e-6 of the replicated ones. The TP solver saves
whole tensors, a restore cuts them back to the saved slices, and the
checkpoint loads into a model without TP; its ranks keep one best
checkpoint when their validation scores differ. At dropout 0.1 each model
rank draws its own slices' masks, and the whole parameters stay
bit-equal."""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
INIT_TIMEOUT, WORLD_TIMEOUT = 60, 240
MODEL = dict(num_points=1024, num_proposals=16, num_layers=2, num_heads=4, d_model=32,
             d_ff=64, max_des_len=7, vocab_size=64, sa_npoints=(128, 64, 32, 16),
             sa_nsamples=(16, 8, 8, 4),
             sa_widths=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
             fp_width=64, seed_feature_dim=64, proposal_feature_dim=32,
             transformer_dropout=0.0)


def solver_worker(argv):
    """One rank of the TP solver run: a (data=1, model=2) split, 2 epochs
    with a checkpoint, then a fresh solver from other weights restored from
    it; writes ``rank{i}.json`` with the checks' results."""
    p = argparse.ArgumentParser()
    p.add_argument("--root")
    p.add_argument("--out")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    from spacap3d_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig
    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
    from spacap3d_tpu_torch.data.loader import DataLoader
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import Vocabulary
    from spacap3d_tpu_torch.models import init_spacap
    from spacap3d_tpu_torch.parallel import multihost
    from spacap3d_tpu_torch.parallel.tp import count_sharded, make_tp_mesh
    from spacap3d_tpu_torch.train.solver import Solver

    rank, world = multihost.initialize_from_env(device="cpu", timeout_s=INIT_TIMEOUT)
    mesh = make_tp_mesh(2)
    with open(os.path.join(args.root, "ScanRefer_filtered_all.json")) as f:
        anns = json.load(f)
    vocab = Vocabulary.build(anns, max_len=MODEL["max_des_len"])
    cfg = RunConfig(model=ModelConfig(**dict(MODEL, vocab_size=len(vocab))),
                    train=TrainConfig(batch_size=4, epoch=2, val_step=0, verbose=1, seed=5,
                                      lr=1e-2, transformer_lr=1e-2),
                    data=DataConfig(data_root=args.root, num_points=MODEL["num_points"],
                                    augment=False, use_relation=True,
                                    max_des_len=MODEL["max_des_len"], num_workers=1),
                    output_dir=args.out)
    dc = ScannetDatasetConfig()
    scenes = sorted({a["scene_id"] for a in anns})
    ds = ScanReferDataset(anns, SceneStore(cfg.data.scannet_data, scenes, load_relations=True),
                          vocab, dc, cfg.data, split="train")

    def fresh(stamp, seed):
        model = init_spacap(cfg.model, seed=seed, device="cpu")
        multihost.replicate_global(model)
        return Solver(cfg, model, DataLoader(ds, 4, shuffle=True, seed=5, num_workers=1),
                      None, ds, None, vocab, dc, anns, stamp, device="cpu", tp_mesh=mesh)

    a = fresh("tpA", 3)
    sharded = count_sharded(a.model)
    a(epochs=2, verbose=1)
    b = fresh("tpB", 7)
    before = {k: v.clone() for k, v in b.model.state_dict().items()}
    b.restore(os.path.join(args.out, "tpA", "model_last.ckpt"))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    res = {
        "sharded": sharded, "start_epoch": b.start_epoch,
        "restored_equal": sorted(k for k in sa if torch.equal(sa[k], sb[k])) == sorted(sa),
        "moved_by_restore": sum(not torch.equal(before[k], sb[k]) for k in sb),
        "moments_equal": all(torch.equal(oa[i][m], ob[i][m]) for i in oa
                             for m in ("exp_avg", "exp_avg_sq")),
        "shard_shape": list(sa["caption.model.encoder.layers.0.self_attn.linears.0.weight"]
                            .shape),
        "shard": sa["caption.model.encoder.layers.0.feed_forward.w_2.weight"].tolist(),
        "files": sorted(os.listdir(os.path.join(args.out, "tpA")))
        if rank == 0 else None,
    }
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()


def disagree_worker(argv):
    """One rank of a TP solver whose ranks score their validations apart:
    rank 0's scores rise at every validation, rank 1's fall after the
    first, so that rank 1 alone would see no new best. A best checkpoint
    under TP is a collective, so the ranks must take one decision; writes
    ``rank{i}.json`` with the rank's ``best``."""
    p = argparse.ArgumentParser()
    p.add_argument("--root")
    p.add_argument("--out")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    from spacap3d_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig
    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
    from spacap3d_tpu_torch.data.loader import DataLoader
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import Vocabulary
    from spacap3d_tpu_torch.models import init_spacap
    from spacap3d_tpu_torch.parallel import multihost
    from spacap3d_tpu_torch.parallel.tp import make_tp_mesh
    from spacap3d_tpu_torch.train import solver as solver_mod

    rank, _ = multihost.initialize_from_env(device="cpu", timeout_s=INIT_TIMEOUT)
    mesh = make_tp_mesh(2)
    with open(os.path.join(args.root, "ScanRefer_filtered_all.json")) as f:
        anns = json.load(f)
    vocab = Vocabulary.build(anns, max_len=MODEL["max_des_len"])
    cfg = RunConfig(model=ModelConfig(**dict(MODEL, vocab_size=len(vocab))),
                    train=TrainConfig(batch_size=4, epoch=1, val_step=1, verbose=1, seed=5),
                    data=DataConfig(data_root=args.root, num_points=MODEL["num_points"],
                                    augment=False, use_relation=True,
                                    max_des_len=MODEL["max_des_len"], num_workers=1),
                    output_dir=args.out)
    dc = ScannetDatasetConfig()
    ds = ScanReferDataset(anns, SceneStore(cfg.data.scannet_data,
                                           sorted({a["scene_id"] for a in anns}),
                                           load_relations=True),
                          vocab, dc, cfg.data, split="train")
    validations = []

    def eval_cap(*_, **__):
        validations.append(None)
        n = len(validations)
        score = float(n) if rank == 0 else 1.0 / n
        return {k: score for k in solver_mod.CAPTION_METRICS}, []

    solver_mod.eval_cap = eval_cap
    model = init_spacap(cfg.model, seed=3, device="cpu")
    multihost.replicate_global(model)
    loader = DataLoader(ds, 4, shuffle=True, seed=5, num_workers=1)
    solver = solver_mod.Solver(cfg, model, loader, loader, ds, ds, vocab, dc, anns, "tpD",
                               device="cpu", tp_mesh=mesh)
    solver(epochs=1, verbose=1)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump({"best": solver.best, "validations": len(validations)}, f)
    multihost.shutdown()


def dropout_worker(argv):
    """One rank of a TP = 2 train step at dropout 0.1 on a (data=1, model=2)
    split. Records each dropout draw (whether it drew from the rank's own
    generator, and which nonzero entries of its input it dropped) into
    ``rank{i}.pt``, with the parameters that every rank holds whole after
    the step (Adam)."""
    p = argparse.ArgumentParser()
    p.add_argument("--out")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    from spacap3d_tpu_torch.config import ModelConfig, TrainConfig
    from spacap3d_tpu_torch.data.synthetic import train_batch
    from spacap3d_tpu_torch.models import captioner, init_spacap
    from spacap3d_tpu_torch.parallel import mesh as mesh_mod
    from spacap3d_tpu_torch.parallel import multihost
    from spacap3d_tpu_torch.parallel.mp_dryrun import digest
    from spacap3d_tpu_torch.parallel.tp import make_tp_mesh, shard_model
    from spacap3d_tpu_torch.train.solver import dropout_generator
    from spacap3d_tpu_torch.train.step import make_optimizer, make_train_step

    rank, _ = multihost.initialize_from_env(device="cpu", timeout_s=INIT_TIMEOUT)
    mesh = make_tp_mesh(2)
    cfg = ModelConfig(**dict(MODEL, transformer_dropout=0.1))
    model = init_spacap(cfg, seed=2, device="cpu")
    shard_model(model, mesh)
    tc = TrainConfig()
    step = make_train_step(cfg, tc, make_optimizer(model, tc, 10)[0], device="cpu",
                           group=mesh.data)
    draws, plain = [], captioner.dropout

    def recording(x, rate, gen, local=False):
        y = plain(x, rate, gen, local)
        draws.append({"local": local, "nonzero": x != 0, "dropped": (y == 0) & (x != 0)})
        return y

    captioner.dropout = recording
    batch = mesh_mod.shard_batch(mesh.data, train_batch(cfg, 4, seed=1))
    metrics = step(model, batch, dropout_generator("cpu", 5, 0, mesh.data_rank), 0.1)
    whole = {n: p.detach() for n, p in model.named_parameters()
             if model.tp_specs.get(n) is None}
    torch.save({"draws": [{k: v if k == "local" else v.detach() for k, v in d.items()}
                          for d in draws]},
               os.path.join(args.out, f"rank{rank}.pt"))
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump({"whole_digest": digest(whole), "whole": len(whole),
                   "loss": float(metrics["loss"])}, f)
    multihost.shutdown()


WORKERS = {"--solver_worker": solver_worker, "--disagree_worker": disagree_worker,
           "--dropout_worker": dropout_worker}
if __name__ == "__main__" and sys.argv[1:2] and sys.argv[1] in WORKERS:
    sys.path.insert(0, REPO)
    WORKERS[sys.argv[1]](sys.argv[2:])
    sys.exit(0)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from spacap3d_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig  # noqa
from spacap3d_tpu.models import init_spacap as jax_init_spacap  # noqa: E402
from spacap3d_tpu.parallel.tp import tp_param_specs as jax_tp_param_specs  # noqa: E402
from spacap3d_tpu.utils.convert import convert_state_dict  # noqa: E402
from spacap3d_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from spacap3d_tpu_torch.data.synthetic import train_batch, write_synthetic_dataset  # noqa
from spacap3d_tpu_torch.models import SpaCapNet, init_spacap  # noqa: E402
from spacap3d_tpu_torch.parallel.mp_dryrun import launch  # noqa: E402
from spacap3d_tpu_torch.parallel.tp import TPMesh, shard_model, tp_param_specs  # noqa: E402
from spacap3d_tpu_torch.train.step import (  # noqa: E402
    EVAL_INPUT_KEYS,
    make_eval_step,
    make_train_step,
)
from spacap3d_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402

B = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while the module runs (as
    tests/test_torch_solver.py: several test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_world(cmd, out, world=2):
    done = launch(cmd, world, WORLD_TIMEOUT, env=ENV)
    for p in done:
        assert p.returncode == 0, p.stderr[-4000:]
    return [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(world)]


def test_layout_matches_jax_tp_param_specs():
    """Every state-dict entry's split against the JAX package's
    PartitionSpec of the same leaf (through ``convert_state_dict``, with
    each entry filled with its split's code); a dimension that tp does not
    divide raises, and so do heads that it does not divide."""
    cfg = JaxModelConfig(**MODEL)
    params, state = jax_init_spacap(jax.random.PRNGKey(0), cfg, JaxDatasetConfig().mean_size_arr)
    model = SpaCapNet(ModelConfig(**MODEL))
    specs = tp_param_specs(model.state_dict(), 2)
    codes = {k: np.full(tuple(v.shape), 0.0 if specs[k] is None else specs[k] + 1.0, np.float32)
             for k, v in model.state_dict().items()}
    got, _, report = convert_state_dict(codes, params, state, strict=True)
    assert not report["skipped"]
    want = jax_tp_param_specs(params, 2)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    checked = 0
    for path, spec in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, P))[0]:
        if path not in flat_got or "mean_size_arr" in jax.tree_util.keystr(path):
            continue
        code = np.unique(np.asarray(flat_got[path]))
        assert code.size == 1, path
        ndim = np.ndim(flat_got[path])
        expect = {0.0: P(), 2.0: P("model", None),
                  1.0: P(None, "model") if ndim == 2 else P("model")}[float(code[0])]
        assert spec == expect, (jax.tree_util.keystr(path), spec, code)
        checked += 1
    params_port = dict(model.named_parameters())
    assert checked == len(params_port)
    assert all(v is None for k, v in specs.items() if k not in params_port)
    assert sum(v is not None for v in specs.values()) == 40
    with pytest.raises(ValueError, match="not divisible"):
        tp_param_specs(model.state_dict(), 3)
    mesh = TPMesh(tp=8, model=None, data=None, model_rank=0, data_rank=0, data_size=1)
    with pytest.raises(ValueError, match="heads not divisible"):
        shard_model(SpaCapNet(ModelConfig(**dict(MODEL, d_model=64, proposal_feature_dim=64))),
                    mesh)


def test_fused_decode_refuses_tensor_parallelism():
    mesh = TPMesh(tp=2, model=None, data=None, model_rank=0, data_rank=0, data_size=1)
    model = SpaCapNet(ModelConfig(**dict(MODEL, eval_decode_fused=True)))
    with pytest.raises(NotImplementedError, match="eval_decode_fused"):
        shard_model(model, mesh)


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """Seeded weights and a batch of 4 on disk; the ``tp`` leg of
    ``mp_dryrun`` on 2 ranks (one model group), with SGD at lr 1e-4."""
    root = tmp_path_factory.mktemp("tp")
    cfg = ModelConfig(**MODEL)
    model = init_spacap(cfg, seed=2, device="cpu")
    torch.save(model.state_dict(), root / "weights.pt")
    batch = train_batch(cfg, B, seed=1)
    np.savez(root / "batch.npz", **batch)
    with open(root / "cfg.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    results = run_world(["-m", "spacap3d_tpu_torch.parallel.mp_dryrun", "--out", str(root),
                         "--legs", "tp", "--device", "cpu", "--config", str(root / "cfg.json"),
                         "--weights", str(root / "weights.pt"), "--batch",
                         str(root / "batch.npz"), "--optimizer", "sgd", "--lr", "1e-4",
                         "--timeout", str(INIT_TIMEOUT)], root)
    return dict(root=root, cfg=cfg, sd=model.state_dict(), batch=batch, results=results)


def test_tp_greedy_tokens_equal_replicated(tp_world):
    a, b = (r["tp"] for r in tp_world["results"])
    assert a["token_digest"] == b["token_digest"] and a["sharded_parameters"] == 40
    got = torch.load(tp_world["root"] / "tp_eval.pt", weights_only=True)
    model = SpaCapNet(tp_world["cfg"])
    model.load_state_dict(tp_world["sd"])
    want = make_eval_step(tp_world["cfg"], device="cpu")(
        model, {k: tp_world["batch"][k] for k in EVAL_INPUT_KEYS})
    torch.testing.assert_close(got["lang_cap"], want["lang_cap"], rtol=0, atol=0)
    assert len(torch.unique(want["lang_cap"])) > 3
    torch.testing.assert_close(got["objectness_scores"], want["objectness_scores"],
                               rtol=1e-5, atol=1e-6)


def test_tp_train_step_matches_replicated(tp_world):
    a, b = (r["tp"] for r in tp_world["results"])
    assert a["param_digest"] == b["param_digest"]
    assert a["steps"][0]["metrics"] == b["steps"][0]["metrics"]
    cfg = tp_world["cfg"]
    model = SpaCapNet(cfg)
    model.load_state_dict(tp_world["sd"])
    want = make_train_step(cfg, TrainConfig(), torch.optim.SGD(model.parameters(), lr=1e-4),
                           device="cpu")(model, tp_world["batch"], None, 0.1)
    got = a["steps"][0]["metrics"]
    assert got["relation_loss"] > 0
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    state = torch.load(tp_world["root"] / "tp_state.pt", weights_only=True)
    ref = model.state_dict()
    assert sorted(state) == sorted(ref)
    for k, v in ref.items():
        torch.testing.assert_close(state[k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_tp_with_dp_train_step(tp_world, tmp_path):
    """Four ranks: a (data=2, model=2) split, 2 rows a data rank. Batch norm
    and the losses now reduce over the data group too, so the metrics are
    held to the replicated step within tests/test_tp.py's combined-mesh
    tolerance (rtol 1e-4, atol 1e-6), and all four ranks' gathered
    parameters are bit-equal."""
    r = tp_world["root"]
    results = run_world(["-m", "spacap3d_tpu_torch.parallel.mp_dryrun", "--out", str(tmp_path),
                         "--legs", "tp", "--device", "cpu", "--config", str(r / "cfg.json"),
                         "--weights", str(r / "weights.pt"), "--batch", str(r / "batch.npz"),
                         "--optimizer", "sgd", "--lr", "1e-4", "--timeout", str(INIT_TIMEOUT)],
                        tmp_path, world=4)
    tp = [x["tp"] for x in results]
    assert [(t["data_rank"], t["model_rank"]) for t in tp] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({t["param_digest"] for t in tp}) == 1
    assert len({t["token_digest"] for t in tp}) == 1
    cfg = tp_world["cfg"]
    model = SpaCapNet(cfg)
    model.load_state_dict(tp_world["sd"])
    want = make_train_step(cfg, TrainConfig(), torch.optim.SGD(model.parameters(), lr=1e-4),
                           device="cpu")(model, tp_world["batch"], None, 0.1)
    for k, v in want.items():
        np.testing.assert_allclose(tp[0]["steps"][0]["metrics"][k], float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_tp_solver_saves_whole_tensors_and_restores_its_slices(tmp_path):
    """The production Solver on a (data=1, model=2) split: 2 epochs, then a
    restore into a solver from other weights. The restored slices and Adam
    moments equal the trained ones; the checkpoint holds whole tensors that
    load into a model without TP and whose slices are the ranks'."""
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(root, num_scenes=2, seed=3)
    results = run_world([os.path.abspath(__file__), "--solver_worker", "--root", root,
                         "--out", out], out)
    for r in results:
        assert r["sharded"] == 40 and r["start_epoch"] == 2
        assert r["restored_equal"] and r["moments_equal"] and r["moved_by_restore"] > 0
        assert r["shard_shape"] == [MODEL["d_model"] // 2, MODEL["d_model"]]
    assert {"model_last.ckpt", "log.txt", "best.txt"} <= set(results[0]["files"])
    ckpt = load_checkpoint(os.path.join(out, "tpA", "model_last.ckpt"))
    with open(os.path.join(out, "tpA", "all_scalars.json")) as f:
        loss = [v for _, _, v in json.load(f)["train/loss"]]
    assert np.mean(loss[len(loss) // 2:]) < np.mean(loss[:len(loss) // 2]), loss
    vocab = ckpt["model_state_dict"]["caption.model.generator.proj.weight"].shape[0]
    model = SpaCapNet(ModelConfig(**dict(MODEL, vocab_size=vocab)))
    model.load_state_dict(ckpt["model_state_dict"])
    w2 = ckpt["model_state_dict"]["caption.model.encoder.layers.0.feed_forward.w_2.weight"]
    half = MODEL["d_ff"] // 2
    for rank, r in enumerate(results):
        np.testing.assert_array_equal(np.asarray(r["shard"]),
                                      w2[:, rank * half:(rank + 1) * half].numpy())
    moments = ckpt["optimizer_state_dict"]["state"]
    assert {tuple(m["exp_avg"].shape) for m in moments.values()} >= {tuple(w2.shape)}


def test_tp_dropout_masks_differ_across_model_ranks(tmp_path):
    """At dropout 0.1 each model rank draws the masks of its own heads and
    FFN columns from a generator of its own (no two slices of one tensor
    share a mask, as JAX draws one mask over the whole tensor), and the
    masks of the tensors every rank holds whole from the step's generator,
    alike on both ranks; the whole parameters stay bit-equal after the
    step."""
    results = run_world([os.path.abspath(__file__), "--dropout_worker", "--out",
                         str(tmp_path)], tmp_path)
    assert results[0]["whole_digest"] == results[1]["whole_digest"] and results[0]["whole"]
    assert all(np.isfinite(r["loss"]) for r in results)
    a, b = (torch.load(tmp_path / f"rank{r}.pt", weights_only=True)["draws"] for r in (0, 1))
    assert [d["local"] for d in a] == [d["local"] for d in b]
    local = [(x, y) for x, y in zip(a, b) if x["local"]]
    whole = [(x, y) for x, y in zip(a, b) if not x["local"]]
    # per encoder and decoder layer: the attention probabilities (twice in a
    # late-guide decoder layer) and the FFN hidden layer
    assert len(local) >= 4 and len(whole) >= 4
    for x, y in whole:
        both = x["nonzero"] & y["nonzero"]
        assert torch.equal(x["dropped"] & both, y["dropped"] & both)
    for x, y in local:
        both = x["nonzero"] & y["nonzero"]
        differ = ((x["dropped"] ^ y["dropped"]) & both).sum() / both.sum()
        # independent masks at rate 0.1 differ on ~18% of the entries
        assert 0.1 < float(differ) < 0.26, float(differ)
        rate = (x["dropped"].sum() / x["nonzero"].sum()).item()
        assert 0.05 < rate < 0.15, rate


def test_tp_solver_agrees_on_the_best_checkpoint(tmp_path):
    """Ranks whose validation scores differ still take rank 0's decision,
    so every rank enters each best checkpoint's gather and the run ends;
    without it rank 0 would wait in the gather for a rank that never
    comes."""
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(root, num_scenes=2, seed=3)
    results = run_world([os.path.abspath(__file__), "--disagree_worker", "--root", root,
                         "--out", out], out)
    n = results[0]["validations"]
    assert n >= 2 and results[1]["validations"] == n
    assert results[0]["best"] == results[1]["best"]
    assert results[0]["best"]["cider"] == float(n) and results[0]["best"]["epoch"] == 1
    assert load_checkpoint(os.path.join(out, "tpD", "model.ckpt"))["best"]["cider"] == n
