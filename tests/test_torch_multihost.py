"""The port's multi-process runtime on the CPU, over gloo
(``spacap3d_tpu_torch/parallel/multihost.py``), as tests/test_multihost.py
and tests/test_multihost_cli.py pin the JAX package's.

* The seed-sharded grid: ``mul_eval_grid_multihost`` on two ranks of
  ``mp_dryrun`` with seeds [0, 1, 2] returns, on both ranks, the JAX
  package's ``mul_eval_grid`` rows on the same files and converted weights,
  under ``==`` (f32 decode, as tests/test_torch_mul_eval.py).
* The command lines: ``scripts.train --multihost`` on two ranks, where rank
  0 alone writes the one run directory whose stamp both take; then
  ``scripts.eval --multihost --mul_eval`` on two ranks, whose results CSV
  equals a one-process eval's; and the refusals of ``--tp`` and of a batch
  the ranks do not divide.
* The runtime's contract: no coordinator, no group; NCCL on the CPU and
  NCCL with two ranks on one card refused; round-robin shards.

Every spawned rank has a rendezvous and collective timeout of 60 s, and
each world a wait of at most 300 s.
"""
import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from spacap3d_tpu.eval.eval_helper import organize_annotations as jax_organize
from spacap3d_tpu.eval.eval_helper import prepare_corpus as jax_corpus
from spacap3d_tpu.eval.mul_eval import mul_eval_grid as jax_mul_eval_grid
from spacap3d_tpu.train.step import make_eval_step as jax_make_eval_step
from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
from spacap3d_tpu_torch.eval.mul_eval import GridLoader
from spacap3d_tpu_torch.parallel import multihost
from spacap3d_tpu_torch.parallel.mp_dryrun import GRID_MIN_IOU, launch
from spacap3d_tpu_torch.scripts import eval as eval_cli
from spacap3d_tpu_torch.scripts import train as train_cli
from test_torch_mul_eval import MIN_IOU, build_both
from test_torch_solver import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
INIT_TIMEOUT, WORLD_TIMEOUT = 60, 300
SEEDS = [0, 1, 2]


def run_world(cmd, world=2):
    done = launch(cmd, world, WORLD_TIMEOUT, env=ENV)
    for rank, p in enumerate(done):
        assert p.returncode == 0, f"rank {rank}:\n{p.stdout[-2000:]}\n{p.stderr[-4000:]}"
    return done


def test_grid_sharded_by_seed_equals_jax_rows(tmp_path):
    root = str(tmp_path / "data")
    anns, j, p = build_both(root)
    weights, cfg_path = tmp_path / "weights.pt", tmp_path / "cfg.json"
    torch.save(p["model"].state_dict(), weights)
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(p["cfg"]), f)
    out = tmp_path / "out"
    run_world(["-m", "spacap3d_tpu_torch.parallel.mp_dryrun", "--out", str(out), "--legs",
               "grid", "--device", "cpu", "--config", str(cfg_path), "--weights", str(weights),
               "--data_root", root, "--seeds", ",".join(map(str, SEEDS)), "--grid_batch", "4",
               "--timeout", str(INIT_TIMEOUT)])
    got = [json.load(open(out / f"rank{r}.json"))["grid"] for r in range(2)]
    assert MIN_IOU == GRID_MIN_IOU
    want = jax_mul_eval_grid(
        jax_make_eval_step(j["cfg"], compact=True), j["params"], j["state"], j["ds"],
        j["vocab"], j["dc"], jax_corpus(anns), jax_organize(anns), SEEDS, batch_size=4,
        min_iou=MIN_IOU, also_detection=True, num_workers=1, score_workers=1)
    assert [g["local_seeds"] for g in got] == [[0, 2], [1]]
    assert got[0]["rows"] == got[1]["rows"] == want
    assert len({json.dumps(r, sort_keys=True) for r in want}) == len(SEEDS)


def test_grid_loader_pads_a_shard_shorter_than_its_pad():
    """A rank's share of the seeds over a small split can hold fewer rows
    than one batch's pad (one seed x 3 scenes, batch 8): the pad cycles
    through the rows, all marked invalid."""
    class Items:
        def __len__(self):
            return 3

        def __getitem__(self, i, rng=None):
            return {"dataset_idx": np.int64(i)}

    batches = list(GridLoader(Items(), [5], batch_size=8, num_workers=1))
    assert len(batches) == 1
    np.testing.assert_array_equal(batches[0]["dataset_idx"], [0, 1, 2, 0, 1, 2, 0, 1])
    np.testing.assert_array_equal(batches[0]["__valid__"], [1, 1, 1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(batches[0]["__seed__"], [5] * 8)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 3-scene split (one train scene, two val) and one 2-rank run of the
    train CLI (global batch 8, 4 rows a rank, one epoch)."""
    root = str(tmp_path_factory.mktemp("mh_cli"))
    anns, sids = write_synthetic_dataset(root, num_scenes=3, seed=7)
    for split, keep in (("train", sids[:1]), ("val", sids[1:])):
        with open(os.path.join(root, f"ScanRefer_filtered_{split}.json"), "w") as f:
            json.dump([a for a in anns if a["scene_id"] in keep], f)
    out_dir = os.path.join(root, "outputs")
    logs = run_world(["-m", "spacap3d_tpu_torch.scripts.train", "--multihost", "--device", "cpu",
                      "--dist_timeout", str(INIT_TIMEOUT), "--data_root", root, "--output_dir",
                      out_dir, "--arch_preset", "tiny", "--num_points", "1024",
                      "--num_proposals", "16", "--batch_size", "8", "--epoch", "1",
                      "--val_step", "100", "--verbose", "1", "--num_workers", "1",
                      "--tag", "mh"])
    return root, out_dir, logs


def test_train_multihost_rank0_owns_the_run(cli_run):
    root, out_dir, logs = cli_run
    runs = os.listdir(out_dir)
    assert len(runs) == 1 and runs[0].endswith("_MH"), runs   # one stamp, rank 0's
    run_root = os.path.join(out_dir, runs[0])
    for f in ("config.json", "info.json", "log.txt", "model_last.ckpt", "best.txt"):
        assert os.path.exists(os.path.join(run_root, f)), f
    with open(os.path.join(run_root, "info.json")) as f:
        assert json.load(f)["world"] == 2
    assert "process group: 2 ranks" in logs[0].stdout
    assert "process group" not in logs[1].stdout


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_eval_multihost_mul_eval_rows_equal_one_process(cli_run):
    root, out_dir, _ = cli_run
    run = os.listdir(out_dir)[0]
    common = ["--folder", run, "--data_root", root, "--output_dir", out_dir, "--batch_size",
              "2", "--num_workers", "1", "--checkpoint", "model_last.ckpt", "--mul_eval",
              "--num_seeds", "3", "--device", "cpu"]
    logs = run_world(["-m", "spacap3d_tpu_torch.scripts.eval", "--multihost", "--dist_timeout",
                      str(INIT_TIMEOUT), "--eval_tag", "mh", *common])
    rows = eval_cli.main(["--eval_tag", "sp", *common])
    run_root = os.path.join(out_dir, run)
    mh, sp = read_csv(os.path.join(run_root, "mh_results.csv")), read_csv(
        os.path.join(run_root, "sp_results.csv"))
    assert [r["seed"] for r in mh] == ["0", "1", "2"] and mh == sp
    printed = [json.loads(ln) for ln in logs[0].stdout.splitlines() if ln.startswith('{"seed"')]
    assert printed == rows
    assert "grid batch" in logs[0].stdout and "grid batch" not in logs[1].stdout
    assert not any(ln.startswith('{"seed"') for ln in logs[1].stdout.splitlines())


@pytest.fixture
def fake_world(monkeypatch):
    """The CLIs' ``initialize_from_env`` returns (0, world) without a group."""
    def use(world):
        monkeypatch.setattr(multihost, "initialize_from_env", lambda **kw: (0, world))
    return use


def test_cli_refusals(cli_run, fake_world):
    """Evaluation with --tp k needs a world of exactly k ranks; training
    with --tp k a world of d * k; the global batch must divide over the
    data ranks."""
    root, out_dir, _ = cli_run
    run = os.listdir(out_dir)[0]
    fake_world(4)
    with pytest.raises(SystemExit, match="world of exactly 2"):
        eval_cli.main(["--multihost", "--tp", "2", "--folder", run, "--data_root", root,
                       "--output_dir", out_dir, "--device", "cpu", "--mul_eval"])
    train = ["--data_root", root, "--output_dir", out_dir, "--device", "cpu", "--multihost"]
    fake_world(3)
    with pytest.raises(SystemExit, match="d \\* 2 ranks"):
        train_cli.main(train + ["--tp", "2"])
    fake_world(1)
    with pytest.raises(SystemExit, match="d \\* 2 ranks"):
        train_cli.main(train + ["--tp", "2"])
    fake_world(4)
    with pytest.raises(SystemExit, match="global batch 6"):
        train_cli.main(train + ["--batch_size", "6"])


def test_runtime_contract(monkeypatch):
    for name in ("SPACAP_COORDINATOR", "SPACAP_NUM_PROCESSES", "SPACAP_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_from_env(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert multihost.allgather_pyobj({"a": 1}) == [{"a": 1}]
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        multihost.initialize_from_env("localhost:1", 2, 0, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="SPACAP_NUM_PROCESSES"):
        multihost.initialize_from_env("localhost:1", device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="two ranks on one device.*backend='gloo'"):
        multihost.check_one_rank_per_device(["h/GPU-a", "h/GPU-b", "h/GPU-a"], "nccl")
    multihost.check_one_rank_per_device(["h/GPU-a", "h/GPU-a"], "gloo")
    multihost.check_one_rank_per_device(["h/GPU-a", "g/GPU-a"], "nccl")
    assert multihost.process_shard(list(range(7)), 1, 3) == [1, 4]
    assert multihost.process_shard(list(range(7)), 0, 1) == list(range(7))
    # a single process's world-of-one group forms, warms up and leaves
    assert multihost.initialize_from_env(f"localhost:{multihost.free_port()}", 1, 0,
                                         device="cpu", timeout_s=INIT_TIMEOUT) == (0, 1)
    try:
        multihost.warmup_collectives("cpu")
        assert multihost.allgather_bytes(b"xyz") == [b"xyz"]
    finally:
        multihost.shutdown()
    assert not torch.distributed.is_initialized()
