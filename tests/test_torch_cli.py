"""The port's command lines on the CPU (``--device cpu``): the flows of
tests/test_cli.py for ``spacap3d_tpu_torch.scripts.train`` and ``.eval``
(their ``--multihost`` and ``--tp`` in tests/test_torch_multihost.py), resume and
detector mounting, the overfit gate's plumbing, and the slice as a whole:
a port checkpoint, converted to the JAX package's format beside the same
config.json, evaluated by the JAX package's ``scripts/eval.py`` and by the
port's eval CLI gives equal results CSVs, for one seed and for ``--mul_eval
--num_seeds 2``. f32 decode (as tests/test_torch_mul_eval.py): equal tokens
and boxes within the trunk's tolerance give equal host arithmetic, so the
CSVs are compared as text."""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
from spacap3d_tpu_torch.scripts import eval as eval_cli
from spacap3d_tpu_torch.scripts import overfit_gate, profile_step
from spacap3d_tpu_torch.scripts import train as train_cli
from spacap3d_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint_sync
from test_torch_solver import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--arch_preset", "tiny", "--num_points", "1024", "--num_proposals", "16",
        "--batch_size", "4", "--num_workers", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_cli_data"))
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=2, seed=3)
    for split, sid in (("train", scene_ids[0]), ("val", scene_ids[1])):
        with open(os.path.join(root, f"ScanRefer_filtered_{split}.json"), "w") as f:
            json.dump([a for a in anns if a["scene_id"] == sid], f)
    return root


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
