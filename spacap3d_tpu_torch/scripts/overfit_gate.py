"""Overfit gate of the port, as the JAX package's ``scripts/overfit_gate.py``:
train the whole stack from scratch on a tiny synthetic corpus until the
captioner memorises it, then score CIDEr on that same train split through
the eval harness.

It drives the port's two command lines: synthetic scenes ->
ScanReferDataset -> Solver (train step, both optimizer groups, BN state,
checkpoints) -> model_last.ckpt -> ``scripts.eval --use_train`` ->
eval_cap (NMS, IoU matching, decode) -> CIDEr. Detection must localise the
objects and the captioner must reproduce their annotations to pass: a
CIDEr above 1.0 (100 in the reference's x100 convention) is out of reach of
a model that has not learnt both.

    python -m spacap3d_tpu_torch.scripts.overfit_gate [--epochs 150] [--scenes 6] [--device cuda]

Prints one JSON line {"cider": ..., "passed": bool, ...}.
"""
import argparse
import csv
import json
import os
import shutil
import sys
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "spacap_overfit"))
    p.add_argument("--scenes", type=int, default=6)
    p.add_argument("--objects", type=int, default=4)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--num_proposals", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--transformer_lr", type=float, default=2e-3)
    p.add_argument("--threshold", type=float, default=1.0,
                   help="CIDEr gate (raw scale; 1.0 == 100 in the "
                        "reference tables' x100 convention)")
    p.add_argument("--min_iou", type=float, default=0.25,
                   help="caption-match IoU for the PASS bar (0.25 = the "
                        "reference's TRAIN.MIN_IOU_THRESHOLD, "
                        "lib/config.py:58); CIDEr@0.5 is also reported")
    p.add_argument("--arch_preset", type=str, default="tiny")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--out", type=str, default=None,
                   help="also write the one-line JSON result to this path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
    from spacap3d_tpu_torch.scripts import eval as eval_cli
    from spacap3d_tpu_torch.scripts import train as train_cli

    data_root = os.path.join(args.workdir, "data")
    out_dir = os.path.join(args.workdir, "outputs")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(data_root, exist_ok=True)

    # One annotation per object: an unambiguous memorisation target. Scenes
    # hold fewer points than num_points, so random_sampling draws with
    # replacement and every draw covers the whole scene: the tiny model then
    # learns geometry from a near-deterministic input instead of fighting
    # per-step subsample noise.
    ppo = max(64, (args.num_points * 3 // 4) // max(1, args.objects))
    bg = max(32, args.num_points // 8)
    anns, scene_ids = write_synthetic_dataset(
        data_root, num_scenes=args.scenes, seed=args.seed, anns_per_object=1,
        num_objects=args.objects, points_per_object=ppo, background_points=bg)
    # the gate trains and evaluates on the same (train) corpus
    with open(os.path.join(data_root, "ScanRefer_filtered_train.json"), "w") as f:
        json.dump(anns, f)
    with open(os.path.join(data_root, "ScanRefer_filtered_val.json"), "w") as f:
        json.dump([a for a in anns if a["scene_id"] == scene_ids[0]], f)
    os.remove(os.path.join(data_root, "ScanRefer_filtered_all.json"))

    t0 = time.time()
    train_cli.main([
        "--data_root", data_root, "--output_dir", out_dir,
        "--arch_preset", args.arch_preset,
        "--num_points", str(args.num_points),
        "--num_proposals", str(args.num_proposals),
        "--batch_size", str(args.batch_size),
        "--epoch", str(args.epochs),
        "--lr", str(args.lr), "--transformer_lr", str(args.transformer_lr),
        "--transformer_dropout", "0.0",
        "--no_augment",
        "--ckpt_every", str(max(1, args.epochs // 10)),
        "--val_step", "1000000",       # no in-loop val: the gate is the final eval
        "--verbose", str(max(1, args.epochs // 10)),
        "--num_workers", "2", "--seed", str(args.seed),
        "--tag", "overfit", "--device", args.device,
    ])
    train_s = time.time() - t0
    run = os.listdir(out_dir)[0]

    t0 = time.time()
    rows = {}
    for iou in (args.min_iou, 0.5):
        tag = f"overfit{iou}"
        eval_cli.main([
            "--folder", run, "--data_root", data_root, "--output_dir", out_dir,
            "--batch_size", str(min(args.batch_size, args.scenes)),
            "--num_workers", "2", "--checkpoint", "model_last.ckpt",
            "--eval_tag", tag, "--use_train",
            "--min_iou", str(iou), "--no_detection_eval", "--device", args.device,
        ])
        with open(os.path.join(out_dir, run, f"{tag}_results.csv")) as f:
            rows[iou] = next(csv.DictReader(f))
    eval_s = time.time() - t0
    cider = float(rows[args.min_iou]["cider"])
    result = {
        "cider": round(cider, 4),
        "min_iou": args.min_iou,
        "threshold": args.threshold,
        "passed": cider > args.threshold,
        "cider@0.5iou": round(float(rows[0.5]["cider"]), 4),
        "bleu4": round(float(rows[args.min_iou]["bleu-4"]), 4),
        "rouge": round(float(rows[args.min_iou]["rouge"]), 4),
        "epochs": args.epochs,
        "train_s": round(train_s, 1),
        "eval_s": round(eval_s, 1),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
