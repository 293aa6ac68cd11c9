"""Evaluation command line of the port, as the JAX package's
``scripts/eval.py`` (reference scripts/eval.py:380-483):

    python -m spacap3d_tpu_torch.scripts.eval --folder <run> [--device cuda] ...

Single-seed caption and detection evaluation of a trained checkpoint, and
the ``--mul_eval`` protocol (point sampling re-seeded a seed; per-seed
CIDEr, BLEU-4, METEOR, ROUGE and mAP in ``{eval_tag}_results.csv``; the
best-CIDEr seed reported, reference :446-478). Caption and detection share
one forward a scene; ``--mul_eval`` streams the seed x scene grid
(``eval/mul_eval.py``) unless ``--serial_mul_eval``. ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions) is the port's own.

``--multihost`` (``parallel/multihost.py``; the ``SPACAP_*`` variables as
for the train CLI) shards the ``--mul_eval`` grid by seed over the ranks,
each streaming its seeds on its own device; the rows are merged by
all-gather. ``--tp k`` splits the captioner over exactly k ranks
(``parallel/tp.py``), which all run the same grid: a TP run is not
seed-sharded, as in the JAX package, and a world of other than k ranks is
refused. Rank 0 alone prints rows and writes files.
"""
import argparse
import csv
import dataclasses
import json
import os
import warnings
from copy import deepcopy

from spacap3d_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT_S


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, required=True,
                   help="run folder under --output_dir containing model.ckpt")
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--data_root", type=str,
                   default=os.environ.get("SPACAP_DATA_ROOT", "data"))
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mul_eval", action="store_true")
    p.add_argument("--serial_mul_eval", action="store_true",
                   help="run mul_eval seeds serially (the reference protocol "
                        "loop) instead of the seed-x-scene grid")
    p.add_argument("--num_seeds", type=int, default=100)
    p.add_argument("--eval_tag", type=str, default="eval")
    p.add_argument("--min_iou", type=float, default=0.5)
    p.add_argument("--no_detection_eval", action="store_true")
    p.add_argument("--detection_only", action="store_true",
                   help="detection AP only (works for --no_caption ckpts)")
    p.add_argument("--save_encoder_attn", action="store_true")
    p.add_argument("--save_decoder_attn", action="store_true")
    p.add_argument("--save_proposal", action="store_true")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--checkpoint", type=str, default="model.ckpt")
    p.add_argument("--use_train", action="store_true",
                   help="evaluate on the train split (reference eval.py:405)")
    p.add_argument("--eval_visualize", action="store_true",
                   help="dump vis/{scene}/ scene ply + predicted bbox "
                        "meshes + predictions.json (reference eval.py:247)")
    p.add_argument("--verbose", action="store_true",
                   help="eval_visualize: print path info")
    p.add_argument("--nodryrun", action="store_true",
                   help="eval_visualize: actually write files")
    p.add_argument("--fast_decode", action="store_true",
                   help="stage-granular early exit for the greedy decode "
                        "(eval_decode_early_exit): skip the remaining stages "
                        "once every row has emitted EOS; caption-level "
                        "outputs identical")
    # the reference's flags (reference eval.py:386-387,406), so that a
    # reference command line parses and does the same thing
    p.add_argument("--eval_caption", action="store_true",
                   help="reference alias (eval.py:386): caption metrics; "
                        "alone (without --eval_detection) it implies "
                        "--no_detection_eval")
    p.add_argument("--eval_detection", action="store_true",
                   help="reference alias (eval.py:387): detection AP; "
                        "alone (without --eval_caption) it implies "
                        "--detection_only")
    p.add_argument("--use_last", action="store_true",
                   help="reference alias (eval.py:406): evaluate "
                        "model_last.ckpt instead of --checkpoint")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group (SPACAP_COORDINATOR / SPACAP_NUM_PROCESSES / "
                        "SPACAP_PROCESS_ID): --mul_eval seeds shard over the ranks, rows "
                        "merge by all-gather")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: split the captioner over exactly this many "
                        "ranks, which all evaluate every seed")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process-group backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--dist_timeout", type=float, default=DEFAULT_TIMEOUT_S,
                   help="seconds a rendezvous or a collective waits for the other ranks")
    args = p.parse_args(argv)
    # under --mul_eval the reference loop always runs caption and detection
    # (eval.py:446-478), so the single-eval aliases do not restrict it
    if args.use_last:
        args.checkpoint = "model_last.ckpt"
    if not args.mul_eval:
        if args.eval_caption and not args.eval_detection:
            args.no_detection_eval = True
        elif args.eval_detection and not args.eval_caption:
            args.detection_only = True
    return args


def main(argv=None):
    """Evaluates; returns the per-seed metric rows (None for
    ``--eval_visualize``)."""
    args = parse_args(argv)

    from spacap3d_tpu_torch.parallel import multihost

    rank, world = 0, 1
    if args.multihost or args.tp > 1:
        # before any other device use; the warm-up forms the groups'
        # connections while the ranks are in step (the next collective, the
        # grid's row merge, comes when each has finished its seeds)
        rank, world = multihost.initialize_from_env(
            device=args.device, backend=args.dist_backend, timeout_s=args.dist_timeout)
        multihost.warmup_collectives(args.device)
    if args.tp > 1 and world != args.tp:
        raise SystemExit(f"--tp {args.tp} evaluates on a world of exactly {args.tp} ranks "
                         f"(a TP grid is not seed-sharded); this one has {world}")
    device = str(multihost.rank_device(args.device))
    writes = rank == 0

    import numpy as np

    from spacap3d_tpu_torch.config import RunConfig
    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
    from spacap3d_tpu_torch.data.loader import DataLoader
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import Vocabulary
    from spacap3d_tpu_torch.eval.eval_helper import (
        eval_cap,
        eval_detection,
        eval_visualize,
        organize_annotations,
        prepare_corpus,
    )
    from spacap3d_tpu_torch.eval.mul_eval import mul_eval_grid, mul_eval_grid_multihost
    from spacap3d_tpu_torch.models import SpaCapNet
    from spacap3d_tpu_torch.parallel.tp import make_tp_mesh, shard_model
    from spacap3d_tpu_torch.train.step import make_attn_dump_step, make_eval_step
    from spacap3d_tpu_torch.utils.checkpoint import load_model_state_dict

    root = os.path.join(args.output_dir, args.folder)
    run_cfg = RunConfig.load(os.path.join(root, "config.json"))
    model_cfg = run_cfg.model
    if args.fast_decode:
        model_cfg = dataclasses.replace(model_cfg, eval_decode_early_exit=True)
    dc = ScannetDatasetConfig()

    phase = "train" if args.use_train else "val"
    prefix = "ScanRefer_filtered" if args.dataset == "ScanRefer" else "nr3d"
    with open(os.path.join(args.data_root, f"{prefix}_{phase}.json")) as f:
        val_anns = json.load(f)
    val_scenes = sorted({a["scene_id"] for a in val_anns})
    eval_list = []
    for sid in val_scenes:  # one forward per scene (reference eval.py:97-117)
        e = deepcopy(val_anns[0])
        e["scene_id"] = sid
        eval_list.append(e)

    vocab_path = os.path.join(args.data_root, f"{args.dataset}_vocabulary.json")
    if os.path.exists(vocab_path):
        vocab = Vocabulary.load(vocab_path)
    elif args.detection_only:
        vocab = Vocabulary.build(val_anns)  # tokens only feed the dataset
    else:
        raise FileNotFoundError(f"vocabulary not found: {vocab_path}")

    data_cfg = dataclasses.replace(run_cfg.data, augment=False, use_relation=False,
                                   data_root=args.data_root)
    mv = os.path.join(args.data_root, "scannet", "scannet_data",
                      "enet_feats_maxpool.hdf5") if data_cfg.use_multiview else None
    store = SceneStore(data_cfg.scannet_data, val_scenes, load_relations=False,
                       multiview_hdf5=mv)
    ds = ScanReferDataset(eval_list, store, vocab, dc, data_cfg, split="val")

    model = SpaCapNet(model_cfg, dc.mean_size_arr)
    # a port checkpoint or one the JAX package wrote
    model.load_state_dict(load_model_state_dict(os.path.join(root, args.checkpoint)))
    model = model.eval().to(device)
    if args.tp > 1:
        shard_model(model, make_tp_mesh(args.tp))

    grid_mode = args.mul_eval and not args.detection_only and not args.serial_mul_eval
    eff_batch = args.batch_size if grid_mode else min(args.batch_size, len(ds))
    # the grid reads no corners or centres on the host: the compact step
    # fetches fewer bytes a batch
    eval_step = make_eval_step(model_cfg, device=device, compact=grid_mode)

    attn_dump_step = None
    if args.save_encoder_attn or args.save_decoder_attn:
        if args.fast_decode:
            warnings.warn(
                "--fast_decode fills token slots after the all-EOS point with EOS; "
                "the teacher-forced attention dump re-runs over those tokens, so dumped "
                "weights past each caption's EOS differ from a normal-decode run "
                "(captions and metrics do not).", RuntimeWarning)
        attn_dump_step = make_attn_dump_step(device=device)

    if args.eval_visualize:
        loader = DataLoader(ds, min(args.batch_size, len(ds)), shuffle=False, seed=args.seed,
                            num_workers=args.num_workers)
        scans_dir = os.path.join(args.data_root, "scannet", "scans")
        eval_visualize(
            eval_step, model, ds, loader, vocab, organize_annotations(val_anns), dc, root,
            scans_dir=scans_dir if os.path.isdir(scans_dir) else None,
            min_iou=args.min_iou, verbose=args.verbose and writes,
            nodryrun=args.nodryrun and writes, device=device)
        if writes:
            print(f"visualization dumps under {os.path.join(root, 'vis')}"
                  + ("" if args.nodryrun else " (dry run: pass --nodryrun to write)"))
        if world > 1:
            multihost.shutdown()
        return None

    seeds = list(range(args.num_seeds)) if args.mul_eval else [args.seed]
    rows = []
    if grid_mode:
        corpus_cache = os.path.join(root, f"corpus_{phase}.json")
        if os.path.exists(corpus_cache):
            with open(corpus_cache) as f:
                corpus = json.load(f)
        else:
            corpus = prepare_corpus(val_anns)
            if writes:
                # a rank that finds the file must never read half of it
                tmp = corpus_cache + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(corpus, f, indent=4)
                os.replace(tmp, corpus_cache)
        grid_fn = mul_eval_grid_multihost if world > 1 and args.tp == 1 else mul_eval_grid
        rows = grid_fn(
            eval_step, model, ds, vocab, dc, corpus, organize_annotations(val_anns), seeds,
            eff_batch, min_iou=args.min_iou, also_detection=not args.no_detection_eval,
            num_workers=args.num_workers, device=device,
            progress=(lambda i, n: print(f"\rgrid batch {i}/{n}", end="", flush=True))
            if writes else None)
        if writes:
            print()
            for row in rows:
                print(json.dumps(row))
        seeds = []
    for seed in seeds:
        loader = DataLoader(ds, eff_batch, shuffle=False, seed=seed,
                            num_workers=args.num_workers)
        if args.detection_only:
            det = eval_detection(eval_step, model, loader, dc, ap_iou=args.min_iou,
                                 device=device)
            metrics = {"mAP@0.5": det["mAP"], "AR@0.5": det["AR"]}
        else:
            metrics, _ = eval_cap(
                eval_step, model, ds, loader, vocab, dc, val_anns,
                min_iou=args.min_iou, also_detection=not args.no_detection_eval,
                corpus_cache=os.path.join(root, f"corpus_{phase}.json") if writes else None,
                pred_path=os.path.join(root, f"pred_{phase}_{args.eval_tag}_{seed}.json")
                if writes else None,
                attn_dump_step=attn_dump_step, save_proposal=args.save_proposal,
                dump_dir=os.path.join(root, f"dumps_{args.eval_tag}")
                if (attn_dump_step or args.save_proposal) and writes else None,
                device=device)
        row = {"seed": seed, **{k: v for k, v in metrics.items()
                                if isinstance(v, (int, float))}}
        rows.append(row)
        if writes:
            print(json.dumps(row))

    if world > 1:
        multihost.shutdown()
    if not writes:
        return rows
    with open(os.path.join(root, f"{args.eval_tag}_results.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=sorted(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)

    if args.mul_eval and not args.detection_only:
        best = max(rows, key=lambda r: r["cider"])
        mean_cider = float(np.mean([r["cider"] for r in rows]))
        print(f"best seed {best['seed']}: CIDEr {best['cider']:.4f} "
              f"(mean over {len(rows)} seeds: {mean_cider:.4f})")
        print(json.dumps({"best": best, "mean_cider": mean_cider}))
    return rows


if __name__ == "__main__":
    main()
