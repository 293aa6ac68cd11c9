"""The port's command lines on the CPU (``--device cpu``): the flows of
tests/test_cli.py for ``spacap3d_tpu_torch.scripts.train`` and ``.eval``
(their ``--multihost`` and ``--tp`` in tests/test_torch_multihost.py), resume and
detector mounting, the overfit gate's plumbing, and the slice as a whole:
a port checkpoint, converted to the JAX package's format beside the same
config.json, evaluated by the JAX package's ``scripts/eval.py`` and by the
port's eval CLI gives equal results CSVs, for one seed and for ``--mul_eval
--num_seeds 2``; and the other direction: a run the JAX package's train CLI
wrote, evaluated by both eval CLIs into equal CSVs, its detector mounted by
``--pretrained_votenet`` and the run resumed by ``--use_checkpoint`` as the
JAX CLI resumes it. f32 decode (as tests/test_torch_mul_eval.py): equal
tokens and boxes within the trunk's tolerance give equal host arithmetic,
so the CSVs are compared as text."""
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
from spacap3d_tpu_torch.scripts import eval as eval_cli
from spacap3d_tpu_torch.scripts import overfit_gate, profile_step
from spacap3d_tpu_torch.scripts import train as train_cli
from spacap3d_tpu_torch.tools import overfit_spread
from spacap3d_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint_sync
from spacap3d_tpu_torch.utils.convert import params_from_jax
from test_torch_solver import (  # noqa: F401  (one_torch_thread: autouse fixture)
    COMPARE_LR,
    FIRST_STEP_ATOL,
    FIRST_STEP_RTOL,
    LATER_LOSS_ATOL,
    LATER_LOSS_RTOL,
    one_torch_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--arch_preset", "tiny", "--num_points", "1024", "--num_proposals", "16",
        "--batch_size", "4", "--num_workers", "1", "--device", "cpu"]
# a JAX-package run both train CLIs can resume step for step: no
# augmentation, no dropout, and lr 1e-5 as in test_torch_solver.py
JAX_RUN = ["--arch_preset", "tiny", "--num_points", "1024", "--num_proposals", "16",
           "--batch_size", "4", "--num_workers", "1", "--val_step", "1000000", "--verbose",
           "1", "--no_augment", "--transformer_dropout", "0", "--lr", str(COMPARE_LR),
           "--transformer_lr", str(COMPARE_LR)]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_cli_data"))
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=2, seed=3)
    for split, sid in (("train", scene_ids[0]), ("val", scene_ids[1])):
        with open(os.path.join(root, f"ScanRefer_filtered_{split}.json"), "w") as f:
            json.dump([a for a in anns if a["scene_id"] == sid], f)
    return root


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):
    """One epoch of the JAX package's train CLI on the split: (output dir,
    run folder)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train as jax_train_cli

    out_dir = str(tmp_path_factory.mktemp("jax_run"))
    jax_train_cli.main(["--data_root", data_root, "--output_dir", out_dir, *JAX_RUN,
                        "--epoch", "1", "--tag", "jax"])
    return out_dir, os.listdir(out_dir)[0]


def copy_run(jax_run, out_dir):
    shutil.copytree(os.path.join(*jax_run), os.path.join(out_dir, jax_run[1]))
    return os.path.join(out_dir, jax_run[1])


def train(data_root, out_dir, *extra):
    return train_cli.main(["--data_root", data_root, "--output_dir", out_dir, *TINY, *extra])


def evaluate(data_root, out_dir, run, *extra):
    return eval_cli.main(["--folder", run, "--data_root", data_root, "--output_dir", out_dir,
                          "--batch_size", "4", "--num_workers", "1", "--device", "cpu", *extra])


def read(path):
    with open(path) as f:
        return f.read()


def test_train_and_eval_cli(data_root, tmp_path):
    out_dir = str(tmp_path / "outputs")
    solver = train(data_root, out_dir, "--epoch", "1", "--val_step", "3", "--verbose", "1",
                   "--tag", "smoke")
    runs = os.listdir(out_dir)
    assert len(runs) == 1 and runs[0].endswith("_SMOKE")
    run_root = os.path.join(out_dir, runs[0])
    for f in ("config.json", "info.json", "log.txt", "model_last.ckpt", "best.txt",
              "best.json", "all_scalars.json", "model.ckpt"):
        assert os.path.exists(os.path.join(run_root, f)), f
    info = json.loads(read(os.path.join(run_root, "info.json")))
    assert info["num_params"] == sum(p.numel() for p in solver.model.parameters())
    assert info["device"] == "cpu" and solver.timing["val"]

    evaluate(data_root, out_dir, runs[0], "--checkpoint", "model.ckpt", "--eval_tag", "smoke")
    header = open(os.path.join(run_root, "smoke_results.csv")).readline()
    for col in ("cider", "bleu-4", "rouge", "meteor", "mAP@0.5"):
        assert col in header

    # mul_eval protocol: per-seed rows + best-CIDEr report; the grid's rows
    # equal the serial protocol's
    grid = evaluate(data_root, out_dir, runs[0], "--checkpoint", "model.ckpt", "--eval_tag",
                    "mul", "--mul_eval", "--num_seeds", "2", "--no_detection_eval")
    assert len(open(os.path.join(run_root, "mul_results.csv")).readlines()) == 3
    serial = evaluate(data_root, out_dir, runs[0], "--checkpoint", "model.ckpt", "--eval_tag",
                      "smul", "--mul_eval", "--num_seeds", "2", "--no_detection_eval",
                      "--serial_mul_eval")
    assert serial == grid and [r["seed"] for r in grid] == [0, 1]

    # the reference's flags: caption-only metrics on model_last.ckpt
    evaluate(data_root, out_dir, runs[0], "--eval_tag", "alias", "--eval_caption",
             "--use_last")
    header = open(os.path.join(run_root, "alias_results.csv")).readline()
    assert "cider" in header and "mAP@0.5" not in header

    # --fast_decode leaves every caption-level metric identical
    evaluate(data_root, out_dir, runs[0], "--eval_tag", "fast", "--eval_caption", "--use_last",
             "--fast_decode")
    assert read(os.path.join(run_root, "fast_results.csv")) == read(
        os.path.join(run_root, "alias_results.csv"))

    # alias resolution table
    a = eval_cli.parse_args(["--folder", "x", "--eval_detection"])
    assert a.detection_only and a.checkpoint == "model.ckpt" and a.device == "cuda"
    a = eval_cli.parse_args(["--folder", "x", "--eval_caption", "--eval_detection"])
    assert not a.detection_only and not a.no_detection_eval
    a = eval_cli.parse_args(["--folder", "x", "--mul_eval", "--eval_caption",
                             "--eval_detection", "--use_last"])
    assert not a.detection_only and not a.no_detection_eval
    assert a.checkpoint == "model_last.ckpt"

    # --use_train evaluates the train split, with train-phase file names
    evaluate(data_root, out_dir, runs[0], "--eval_tag", "ontrain", "--use_train",
             "--no_detection_eval")
    assert os.path.exists(os.path.join(run_root, "ontrain_results.csv"))
    corpus = json.loads(read(os.path.join(run_root, "corpus_train.json")))
    train_anns = json.loads(read(os.path.join(data_root, "ScanRefer_filtered_train.json")))
    assert {k.split("|")[0] for k in corpus} == {a["scene_id"] for a in train_anns}

    # --eval_visualize dumps vis/{scene}/ scene ply + predictions.json
    # (+ pred-*.ply per surviving proposal; IoU 0.0 makes box dumps likely)
    evaluate(data_root, out_dir, runs[0], "--eval_visualize", "--nodryrun", "--min_iou", "0.0")
    val_scene = json.loads(read(os.path.join(data_root, "ScanRefer_filtered_val.json")))[0][
        "scene_id"]
    vis_dir = os.path.join(run_root, "vis", val_scene)
    assert os.path.exists(os.path.join(vis_dir, f"{val_scene}.ply"))
    preds = json.loads(read(os.path.join(vis_dir, "predictions.json")))
    assert len([f for f in os.listdir(vis_dir) if f.startswith("pred-")]) == len(preds)
    for oid, entry in preds.items():
        assert os.path.exists(os.path.join(vis_dir, f"pred-{oid}-{entry['object_name']}.ply"))

    # the attention and proposal dumps (candidates need a detection: raise
    # the objectness-1 logit of a copy of the checkpoint)
    ckpt = load_checkpoint(os.path.join(run_root, "model_last.ckpt"))
    ckpt["model_state_dict"]["proposal.proposal.6.bias"][1] += 4.0
    save_checkpoint_sync(os.path.join(run_root, "detects.ckpt"), ckpt)
    evaluate(data_root, out_dir, runs[0], "--checkpoint", "detects.ckpt", "--eval_tag", "att",
             "--min_iou", "0.0", "--save_encoder_attn", "--save_decoder_attn",
             "--save_proposal")
    dumps = sorted(os.listdir(os.path.join(run_root, "dumps_att")))
    assert dumps == ["attn_weights.pkl", "proposal_related.pkl"]


def test_resume_and_mount_cli(data_root, tmp_path):
    """--use_checkpoint resumes at the next epoch with the iteration count
    carried over and the loader at the true epoch; --pretrained_votenet
    mounts a port checkpoint's detector and nothing else."""
    out_dir = str(tmp_path / "outputs")
    first = train(data_root, out_dir, "--epoch", "1", "--val_step", "1000", "--verbose", "1",
                  "--no_augment")
    run = os.listdir(out_dir)[0]
    resumed = train(data_root, out_dir, "--epoch", "2", "--val_step", "1000", "--verbose", "1",
                    "--no_augment", "--use_checkpoint", run)
    assert os.listdir(out_dir) == [run]
    assert resumed.start_epoch == 1 and resumed.global_iter == 2 * first.global_iter
    assert resumed.train_loader.epoch == 2       # pinned to 1, then one pass
    log = read(os.path.join(out_dir, run, "log.txt"))
    assert log.count("epoch 1 starting") == 1 and log.count("epoch 2 starting") == 1
    assert load_checkpoint(os.path.join(out_dir, run, "model_last.ckpt"))["epoch"] == 1

    mounted = train(data_root, str(tmp_path / "mounted"), "--epoch", "0", "--seed", "9",
                    "--pretrained_votenet", os.path.join(out_dir, run, "model_last.ckpt"))
    sd = load_checkpoint(os.path.join(out_dir, run, "model_last.ckpt"))["model_state_dict"]
    fresh = train(data_root, str(tmp_path / "fresh"), "--epoch", "0", "--seed", "9")
    for k, v in mounted.model.state_dict().items():
        if k.startswith(train_cli.DETECTOR):
            assert torch.equal(v, sd[k]), k
        else:
            assert torch.equal(v, fresh.model.state_dict()[k]), k


def test_detection_pretrain_cli(data_root, tmp_path):
    """--no_caption detection pretraining runs without --no_relation (the
    CLI turns the relation loss off itself), and detection-only eval reads
    its checkpoint."""
    out_dir = str(tmp_path / "outputs")
    solver = train(data_root, out_dir, "--epoch", "1", "--val_step", "1000000", "--verbose",
                   "1", "--no_caption", "--no_augment", "--tag", "det")
    runs = os.listdir(out_dir)
    run_root = os.path.join(out_dir, runs[0])
    assert os.path.exists(os.path.join(run_root, "model_last.ckpt"))
    cfg = json.loads(read(os.path.join(run_root, "config.json")))
    assert cfg["train"]["no_caption"] is True and cfg["train"]["use_relation"] is False
    assert cfg["data"]["augment"] is False
    assert solver.scheduler is not None
    ckpt = load_checkpoint(os.path.join(run_root, "model_last.ckpt"))
    assert ckpt["scheduler_state_dict"]["last_epoch"] == solver.global_iter
    evaluate(data_root, out_dir, runs[0], "--checkpoint", "model_last.ckpt", "--eval_tag", "det",
             "--detection_only", "--min_iou", "0.05")
    assert os.path.exists(os.path.join(run_root, "det_results.csv"))


def test_referit3d_dataset_cli(data_root, tmp_path):
    """--dataset ReferIt3D trains and evaluates from nr3d_{train,val}.json,
    with its own vocabulary cache."""
    for split in ("train", "val"):
        shutil.copyfile(os.path.join(data_root, f"ScanRefer_filtered_{split}.json"),
                        os.path.join(data_root, f"nr3d_{split}.json"))
    out_dir = str(tmp_path / "outputs")
    train(data_root, out_dir, "--dataset", "ReferIt3D", "--epoch", "1", "--val_step",
          "1000000", "--verbose", "1", "--no_augment", "--tag", "nr3d")
    run = os.listdir(out_dir)[0]
    assert os.path.exists(os.path.join(data_root, "ReferIt3D_vocabulary.json"))
    cfg = json.loads(read(os.path.join(out_dir, run, "config.json")))
    assert cfg["data"]["dataset"] == "ReferIt3D"
    evaluate(data_root, out_dir, run, "--dataset", "ReferIt3D", "--checkpoint",
             "model_last.ckpt", "--eval_tag", "nr3d")
    rows = open(os.path.join(out_dir, run, "nr3d_results.csv")).readlines()
    assert len(rows) == 2 and "cider" in rows[0]


def test_overfit_gate_plumbing(tmp_path):
    """A few epochs on the CPU: the result line's keys and the run's files
    (the learning proof itself runs on the card, chip_smoke.py)."""
    work = tmp_path / "overfit"
    result = overfit_gate.main(["--workdir", str(work), "--scenes", "2", "--epochs", "2",
                                "--threshold", "0.5", "--device", "cpu",
                                "--out", str(tmp_path / "r.json")])
    assert sorted(result) == sorted([
        "cider", "min_iou", "threshold", "passed", "cider@0.5iou", "bleu4", "rouge", "epochs",
        "train_s", "eval_s"])
    assert result["epochs"] == 2 and result["threshold"] == 0.5 and result["min_iou"] == 0.25
    assert result["passed"] == (result["cider"] > 0.5)
    assert json.loads(read(tmp_path / "r.json")) == result
    run = os.listdir(work / "outputs")[0]
    files = set(os.listdir(work / "outputs" / run))
    assert {"model_last.ckpt", "overfit0.25_results.csv", "overfit0.5_results.csv",
            "corpus_train.json"} <= files


def test_overfit_gate_deterministic_option(tmp_path, monkeypatch):
    """``--deterministic``: the train and eval command lines run under
    torch's deterministic algorithms, and the caller's setting is back
    after the gate."""
    seen = []
    for cli in (train_cli, eval_cli):
        def spy(argv, real=cli.main):
            seen.append(torch.are_deterministic_algorithms_enabled())
            return real(argv)
        monkeypatch.setattr(cli, "main", spy)
    result = overfit_gate.main(["--workdir", str(tmp_path / "overfit"), "--scenes", "2",
                                "--epochs", "1", "--device", "cpu", "--deterministic"])
    assert seen == [True, True, True] and result["epochs"] == 1
    assert not torch.are_deterministic_algorithms_enabled()


def test_overfit_spread_runs_each_leg(capsys):
    """``tools/overfit_spread.py`` at a few epochs on the CPU: each leg's
    runs in fresh processes, one line a run and the summary."""
    summary = overfit_spread.main(["--runs", "1", "--device", "cpu",
                                   "--gate_args", "--scenes 2 --epochs 1 --threshold 0.5"])
    assert sorted(summary) == ["default", "deterministic"]
    for leg in summary.values():
        assert len(leg["cider"]) == 1 and leg["min"] == leg["max"] == leg["cider"][0]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("leg") for ln in lines] == ["deterministic", "default", None]
    assert lines[-1]["summary"] == summary


def test_jax_eval_cli_reads_a_port_checkpoint(data_root, tmp_path):
    """The slice as a whole: a port checkpoint (from the train CLI, its
    objectness-1 logit raised so that it detects; f32 decode in its
    config.json) converted with the JAX package's ``convert_state_dict``
    and saved in the JAX format beside the same config.json; the JAX eval
    CLI and the port's write equal results CSVs."""
    import jax

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import eval as jax_eval_cli
    from spacap3d_tpu.config import RunConfig as JaxRunConfig
    from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu.models import init_spacap as jax_init_spacap
    from spacap3d_tpu.utils.checkpoint import save_checkpoint_sync as jax_save
    from spacap3d_tpu.utils.convert import convert_state_dict

    out_dir = str(tmp_path / "outputs")
    train(data_root, out_dir, "--epoch", "1", "--val_step", "1000000", "--verbose", "1",
          "--tag", "port")
    port_run = os.listdir(out_dir)[0]
    port_root = os.path.join(out_dir, port_run)
    cfg = json.loads(read(os.path.join(port_root, "config.json")))
    cfg["model"]["eval_decode_dtype"] = "float32"
    with open(os.path.join(port_root, "config.json"), "w") as f:
        json.dump(cfg, f)
    ckpt = load_checkpoint(os.path.join(port_root, "model_last.ckpt"))
    ckpt["model_state_dict"]["proposal.proposal.6.bias"][1] += 2.0
    save_checkpoint_sync(os.path.join(port_root, "model_last.ckpt"), ckpt)

    jax_root = os.path.join(out_dir, "jax_run")
    os.makedirs(jax_root)
    shutil.copyfile(os.path.join(port_root, "config.json"), os.path.join(jax_root, "config.json"))
    jcfg = JaxRunConfig.load(os.path.join(jax_root, "config.json"))
    params, state = jax_init_spacap(jax.random.PRNGKey(0), jcfg.model,
                                    ScannetDatasetConfig().mean_size_arr)
    params, state, _ = convert_state_dict(
        {k: v.numpy() for k, v in ckpt["model_state_dict"].items()}, params, state, strict=True)
    jax_save(os.path.join(jax_root, "model_last.ckpt"), {"params": params, "state": state})

    common = ["--data_root", data_root, "--output_dir", out_dir, "--batch_size", "4",
              "--num_workers", "1", "--checkpoint", "model_last.ckpt", "--min_iou", "0.05"]
    for tag, extra in (("one", []), ("grid", ["--mul_eval", "--num_seeds", "2"])):
        jax_eval_cli.main(["--folder", "jax_run", *common, "--eval_tag", tag, *extra])
        eval_cli.main(["--folder", port_run, *common, "--eval_tag", tag, "--device", "cpu",
                       *extra])
        want = read(os.path.join(jax_root, f"{tag}_results.csv"))
        assert read(os.path.join(port_root, f"{tag}_results.csv")) == want, tag
    preds = json.loads(read(os.path.join(port_root, "pred_val_one_42.json")))
    assert any(c != ["sos eos"] for c in preds.values())
    rows = read(os.path.join(port_root, "grid_results.csv")).splitlines()
    assert len(rows) == 3 and rows[1] != rows[2]
    assert np.isfinite([float(x) for x in rows[1].split(",")]).all()


def test_profile_step_on_the_cpu(tmp_path):
    """The tiny eval step under torch.profiler: a trace file, and no device
    time reported from a CPU run."""
    fams = profile_step.main(["--mode", "eval", "--smoke", "--device", "cpu", "--steps", "1",
                              "--out", str(tmp_path)])
    assert fams == {} and os.path.getsize(tmp_path / "trace.json") > 0
    # kernel names as an H100 trace gives them
    for name, want in (
            ("void (anonymous namespace)::fps_kernel_cluster<10>(float const*, int, int*)",
             "fps_kernel_cluster"),
            ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
             "at::native::MeanOps<float, float> > >(at::native::ReduceOp<float>)",
             "native::reduce_kernel"),
            ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, "
             "false, 7>(cublasGemvParamsEx<int>)", "gemvx::kernel"),
            ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
            ("gen_argmax_kernel", "gen_argmax_kernel"),
            ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3",
             "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage")):
        assert profile_step.family(name) == want, name


def test_port_eval_cli_reads_a_jax_checkpoint(data_root, jax_run, tmp_path):
    """A run the JAX package's train CLI wrote (its objectness-1 logit
    raised so that it detects; f32 decode in its config.json): the JAX
    eval CLI and the port's, each on the same JAX checkpoint, write equal
    results CSVs, for one seed and for the grid."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import eval as jax_eval_cli
    from spacap3d_tpu.utils.checkpoint import load_checkpoint as jax_load
    from spacap3d_tpu.utils.checkpoint import save_checkpoint_sync as jax_save

    out_dir = str(tmp_path / "outputs")
    root = copy_run(jax_run, out_dir)
    cfg = json.loads(read(os.path.join(root, "config.json")))
    cfg["model"]["eval_decode_dtype"] = "float32"
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    payload = jax_load(os.path.join(root, "model_last.ckpt"))
    payload["params"]["proposal"]["conv2"]["bias"][1] += 2.0
    jax_save(os.path.join(root, "detects.ckpt"), payload)

    common = ["--folder", jax_run[1], "--data_root", data_root, "--output_dir", out_dir,
              "--batch_size", "4", "--num_workers", "1", "--checkpoint", "detects.ckpt",
              "--min_iou", "0.05"]
    for tag, extra in (("one", []), ("grid", ["--mul_eval", "--num_seeds", "2"])):
        jax_eval_cli.main([*common, "--eval_tag", f"jax_{tag}", *extra])
        eval_cli.main([*common, "--eval_tag", f"port_{tag}", "--device", "cpu", *extra])
        want = read(os.path.join(root, f"jax_{tag}_results.csv"))
        assert read(os.path.join(root, f"port_{tag}_results.csv")) == want, tag
    preds = json.loads(read(os.path.join(root, "pred_val_port_one_42.json")))
    assert preds == json.loads(read(os.path.join(root, "pred_val_jax_one_42.json")))
    assert any(c != ["sos eos"] for c in preds.values())
    rows = read(os.path.join(root, "port_grid_results.csv")).splitlines()
    assert len(rows) == 3 and rows[1] != rows[2]


def test_pretrained_votenet_mounts_a_jax_checkpoint(data_root, jax_run, tmp_path, monkeypatch):
    """--pretrained_votenet with a JAX .ckpt: the port's detector tensors
    equal the JAX CLI's mounted ones, bit for bit, and the captioner keeps
    the port's seeded initialisation."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train as jax_train_cli
    from spacap3d_tpu.train import solver as jax_solver_module

    ckpt = os.path.join(*jax_run, "model_last.ckpt")
    made = []

    class Capture(jax_solver_module.Solver):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(jax_solver_module, "Solver", Capture)
    jax_train_cli.main(["--data_root", data_root, "--output_dir", str(tmp_path / "jax"),
                        *JAX_RUN, "--epoch", "0", "--pretrained_votenet", ckpt])
    ts = made[0].train_state
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ts.params),
                           jax.tree_util.tree_map(np.asarray, ts.state))
    mounted = train(data_root, str(tmp_path / "mounted"), "--epoch", "0", "--seed", "9",
                    "--pretrained_votenet", ckpt)
    fresh = train(data_root, str(tmp_path / "fresh"), "--epoch", "0", "--seed", "9")
    n = 0
    for k, v in mounted.model.state_dict().items():
        if k.startswith(train_cli.DETECTOR):
            n += 1
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, fresh.model.state_dict()[k]), k
    assert n > 50


def test_use_checkpoint_resumes_a_jax_run(data_root, jax_run, tmp_path):
    """--use_checkpoint on a JAX run: the port resumes at the JAX run's
    epoch, iteration and best, and its second epoch's losses lie within
    test_torch_solver.py's tolerances of the JAX CLI's resume of the same
    run (lr 1e-5, dropout 0); every parameter within 2 lr of JAX's a step."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train as jax_train_cli
    from spacap3d_tpu.utils.checkpoint import load_checkpoint as jax_load

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_root, port_root = copy_run(jax_run, jax_out), copy_run(jax_run, port_out)
    before = jax_load(os.path.join(jax_root, "model_last.ckpt"))
    jax_train_cli.main(["--data_root", data_root, "--output_dir", jax_out, *JAX_RUN,
                        "--epoch", "2", "--use_checkpoint", jax_run[1]])
    port = train_cli.main(["--data_root", data_root, "--output_dir", port_out, *JAX_RUN,
                           "--device", "cpu", "--epoch", "2", "--use_checkpoint", jax_run[1]])
    assert port.start_epoch == 1 and port.global_iter == 2 * int(before["iter"])
    want_sc = json.loads(read(os.path.join(jax_root, "all_scalars.json")))
    got_sc = json.loads(read(os.path.join(port_root, "all_scalars.json")))
    steps = int(before["iter"])
    for key, series in want_sc.items():
        if not key.startswith("train/") or not key.endswith("loss"):
            continue
        want = np.array([v for _, s, v in series if s >= steps])
        have = np.array([v for _, s, v in got_sc[key] if s >= steps])
        assert len(have) == len(want) == steps, key
        np.testing.assert_allclose(have[0], want[0], rtol=FIRST_STEP_RTOL, atol=FIRST_STEP_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(have, want, rtol=LATER_LOSS_RTOL, atol=LATER_LOSS_ATOL,
                                   err_msg=key)
    after = jax_load(os.path.join(jax_root, "model_last.ckpt"))
    assert int(after["iter"]) == port.global_iter and int(after["epoch"]) == 1
    want = params_from_jax(after["params"], after["state"])
    got = load_checkpoint(os.path.join(port_root, "model_last.ckpt"))["model_state_dict"]
    start = params_from_jax(before["params"], before["state"])
    for name, _ in port.model.named_parameters():
        moved = (want[name] - start[name]).abs().max()
        assert moved > 0 or name == "caption.model.tgt_embed.0.lut.weight", name
        torch.testing.assert_close(got[name], want[name], rtol=0,
                                   atol=2 * COMPARE_LR * steps, msg=name)


OPTIMIZER_CASES = {
    "two groups": dict(lr=1e-3, transformer_lr=3e-4, wd=1e-2),
    "no_detection": dict(lr=1e-3, transformer_lr=3e-4, wd=1e-2, no_detection=True),
    "no_caption, MultiStepLR": dict(lr=1e-3, wd=1e-2, no_caption=True, lr_decay_step=(1, 2),
                                    lr_decay_rate=0.1),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_adam_state_of_a_jax_checkpoint(case, tmp_path):
    """The JAX package's flat two-group Adam takes two updates from random
    gradients and its state is saved as its Solver saves it; the port's
    Adam, restored from that file through ``Solver.restore``'s mapping,
    takes a third update from the same gradients as JAX's: every parameter
    within 1e-6 (as tests/test_torch_train_step.py holds the port's Adam
    to optax's). The moments carry every entry's history: a fresh Adam's
    third update would move entries by about lr."""
    import optax

    from spacap3d_tpu.config import ModelConfig as JaxModelConfig
    from spacap3d_tpu.config import TrainConfig as JaxTrainConfig
    from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig
    from spacap3d_tpu.models import init_spacap as jax_init_spacap
    from spacap3d_tpu.train.step import make_optimizer as jax_make_optimizer
    from spacap3d_tpu.utils.checkpoint import save_checkpoint_sync as jax_save
    from spacap3d_tpu_torch.config import ModelConfig, TrainConfig
    from spacap3d_tpu_torch.models import SpaCapNet
    from spacap3d_tpu_torch.train.step import load_optimizer_state, make_optimizer
    from spacap3d_tpu_torch.utils.convert import payload_from_jax
    from spacap3d_tpu_torch.utils.jax_checkpoint import load_jax_checkpoint
    from test_torch_mul_eval import MODEL

    tkw = OPTIMIZER_CASES[case]
    mkw = dict(MODEL, vocab_size=40, no_caption=tkw.get("no_caption", False))
    params, state = jax_init_spacap(jax.random.PRNGKey(0), JaxModelConfig(**mkw),
                                    JaxDatasetConfig().mean_size_arr)
    tx = jax_make_optimizer(params, JaxTrainConfig(**tkw), steps_per_epoch=1)
    opt_state = tx.init(params)
    rng = np.random.RandomState(5)
    grads = [jax.tree_util.tree_map(lambda x: rng.randn(*np.shape(x)).astype(np.float32),
                                    params) for _ in range(3)]
    jp = params
    for g in grads[:2]:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
    path = str(tmp_path / "model_last.ckpt")
    jax_save(path, {"epoch": 1, "iter": 2, "params": jp, "state": state,
                    "opt_state": opt_state, "step": jax.numpy.asarray(2),
                    "best": {"epoch": 0, "cider": 0.25}, "config": None})
    updates, opt_state = tx.update(grads[2], opt_state, jp)
    jp = optax.apply_updates(jp, updates)

    model = SpaCapNet(ModelConfig(**mkw))
    opt, sched = make_optimizer(model, TrainConfig(**tkw), steps_per_epoch=1)
    payload = payload_from_jax(load_jax_checkpoint(path), model, opt, sched,
                               tkw.get("no_detection", False))
    model.load_state_dict(payload["model_state_dict"])
    load_optimizer_state(opt, payload["optimizer_state_dict"])
    if sched is not None:
        sched.load_state_dict(payload["scheduler_state_dict"])
    assert (payload["epoch"], payload["iter"], payload["best"]) == (1, 2, {"epoch": 0,
                                                                            "cider": 0.25})
    tg = params_from_jax(jax.tree_util.tree_map(np.asarray, grads[2]),
                         jax.tree_util.tree_map(np.asarray, state))
    for n, p in model.named_parameters():
        p.grad = tg[n].clone()
    opt.step()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           jax.tree_util.tree_map(np.asarray, state))
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=0, atol=1e-6, msg=n)
