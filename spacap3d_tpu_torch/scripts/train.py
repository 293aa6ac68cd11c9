"""Training command line of the port, as the JAX package's ``scripts/train.py``:

    python -m spacap3d_tpu_torch.scripts.train --data_root data [--device cuda] ...

The reference's argparse surface (reference scripts/train.py:352-398) flag
for flag, so reference commands map one to one, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions) and the JAX
CLI's ``--multihost`` and ``--tp``:

    SPACAP_COORDINATOR=host:port SPACAP_NUM_PROCESSES=N SPACAP_PROCESS_ID=i \
        python -m spacap3d_tpu_torch.scripts.train --multihost [--tp k] ...

starts rank i of N (``parallel/multihost.py``; NCCL on CUDA with one rank
a card, gloo on the CPU or with ``--dist_backend gloo``). ``--batch_size``
stays the global batch, which the data ranks must divide; each loads its
row-block. ``--tp k`` splits the captioner over model groups of k ranks
(``parallel/tp.py``) on a world of d * k ranks. Rank 0 alone writes the
run directory, whose stamp every rank takes from rank 0.

Data layout expected under --data_root:
    <root>/ScanRefer_filtered_train.json / _val.json   (or nr3d_*.json)
    <root>/scannet/scannet_data/<scene>_{aligned_vert,ins_label,
        sem_label,aligned_bbox,x,y,z}.npy
"""
import argparse
import dataclasses
import json
import os
from copy import deepcopy
from datetime import datetime

from spacap3d_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT_S


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--dataset", type=str, default="ScanRefer",
                   help="ScanRefer or ReferIt3D")
    p.add_argument("--data_root", type=str,
                   default=os.environ.get("SPACAP_DATA_ROOT", "data"))
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--verbose", type=int, default=1000)
    p.add_argument("--val_step", type=int, default=2000)
    p.add_argument("--ckpt_every", type=int, default=1,
                   help="model_last.ckpt cadence in epochs (reference "
                        "saves every epoch)")
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--num_proposals", type=int, default=256)
    p.add_argument("--num_scenes", type=int, default=-1)
    p.add_argument("--criterion", type=str, default="cider")
    p.add_argument("--no_height", action="store_true")
    p.add_argument("--no_augment", action="store_true",
                   help="disable train-time augmentation (the reference "
                        "always augments; used by the overfit gate)")
    p.add_argument("--no_detection", action="store_true")
    p.add_argument("--no_caption", action="store_true")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--use_checkpoint", type=str, default="")
    # Transformer
    p.add_argument("--no_enc", action="store_true")
    p.add_argument("--late_guide", action="store_true")
    p.add_argument("--N", type=int, default=6)
    p.add_argument("--h", type=int, default=8)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--transformer_dropout", type=float, default=0.1)
    p.add_argument("--no_learnt_src_pos", action="store_true")
    p.add_argument("--src_pos_type", type=str, default="xyz")
    p.add_argument("--no_relation", action="store_true")
    p.add_argument("--transformer_lr", type=float, default=1e-3)
    p.add_argument("--eval_on_train", action="store_true")
    p.add_argument("--pretrained_votenet", type=str, default="",
                   help="path to a reference PRETRAIN_VOTENET .pth or a "
                        "port .ckpt to mount the detector from")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--arch_preset", type=str, default="full",
                   choices=["full", "tiny"],
                   help="'tiny' shrinks the trunk/captioner for smoke tests")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group (SPACAP_COORDINATOR / SPACAP_NUM_PROCESSES / "
                        "SPACAP_PROCESS_ID): each rank loads its row-block of every global "
                        "batch and the train step reduces over the ranks")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: split the captioner's attention and FFN "
                        "layers over model groups of this many ranks (the world must be "
                        "d * tp ranks); 1 = data parallelism only")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process-group backend (default: nccl on cuda, gloo on cpu); gloo "
                        "for ranks that share one card")
    p.add_argument("--dist_timeout", type=float, default=DEFAULT_TIMEOUT_S,
                   help="seconds a rendezvous or a collective waits for the other ranks")
    return p.parse_args(argv)


TINY_ARCH = dict(
    num_layers=2, num_heads=4, d_model=32, d_ff=64, max_des_len=7,
    sa_npoints=(128, 64, 32, 16), sa_nsamples=(16, 8, 8, 4),
    sa_widths=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
    fp_width=64, seed_feature_dim=64, proposal_feature_dim=32,
)
DETECTOR = ("backbone_net.", "vgen.", "proposal.")


def load_annotations(args):
    if args.dataset == "ScanRefer":
        names = ("ScanRefer_filtered_train.json", "ScanRefer_filtered_val.json")
    elif args.dataset == "ReferIt3D":
        names = ("nr3d_train.json", "nr3d_val.json")
    else:
        raise ValueError("Invalid dataset.")
    out = []
    for name in names:
        with open(os.path.join(args.data_root, name)) as f:
            out.append(json.load(f))
    return tuple(out)


def one_per_scene(annotations, scene_list, template):
    """Eval lists carry one entry per scene (reference train.py:81-91)."""
    out = []
    for sid in scene_list:
        entry = deepcopy(template)
        entry["scene_id"] = sid
        out.append(entry)
    return out


def build_configs(args):
    from spacap3d_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig

    data = DataConfig(
        dataset=args.dataset, data_root=args.data_root,
        num_points=args.num_points, use_height=not args.no_height,
        use_color=args.use_color, use_normal=args.use_normal,
        use_multiview=args.use_multiview, augment=not args.no_augment,
        use_relation=not args.no_relation, num_workers=args.num_workers,
    )
    arch = dict(num_layers=args.N, num_heads=args.h, d_model=args.d_model, d_ff=args.d_ff)
    if args.arch_preset == "tiny":
        arch.update(TINY_ARCH)
        data = dataclasses.replace(data, max_des_len=TINY_ARCH["max_des_len"])
    model = ModelConfig(
        num_points=args.num_points,
        input_feature_dim=data.input_feature_dim,
        num_proposals=args.num_proposals,
        transformer_dropout=args.transformer_dropout,
        src_pos_type=None if args.no_learnt_src_pos else args.src_pos_type,
        use_transformer_encoder=not args.no_enc,
        early_guide=not args.late_guide,
        check_relation=not args.no_relation,
        no_caption=args.no_caption,
        **arch,
    )
    train = TrainConfig(
        batch_size=args.batch_size, epoch=args.epoch, lr=args.lr,
        transformer_lr=args.transformer_lr, wd=args.wd, seed=args.seed,
        val_step=args.val_step, verbose=args.verbose, criterion=args.criterion,
        ckpt_every=args.ckpt_every,
        no_detection=args.no_detection, no_caption=args.no_caption,
        # the relation head lives in the captioner, so --no_caption implies
        # no relation loss (the reference would KeyError on 'relation_pred'
        # in this combination; its pretrain runs pass --no_relation)
        use_relation=not args.no_relation and not args.no_caption,
    )
    return RunConfig(model=model, train=train, data=data,
                     output_dir=args.output_dir, tag=args.tag)


def mount_detector(model, path: str):
    """--pretrained_votenet (reference train.py:158-181): a reference .pth
    loads by name (only the keys it holds); a port .ckpt, or one the JAX
    package wrote, mounts only the detector (``backbone_net``, ``vgen``,
    ``proposal``). Returns the number of tensors loaded."""
    import torch

    from spacap3d_tpu_torch.utils.checkpoint import load_model_state_dict
    from spacap3d_tpu_torch.utils.convert import load_reference_state_dict

    if path.endswith(".pth"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        sd = payload.get("model_state_dict", payload)
        return load_reference_state_dict(model, sd, strict=False)
    sd = {k: v for k, v in load_model_state_dict(path).items() if k.startswith(DETECTOR)}
    missing = [k for k in model.state_dict() if k.startswith(DETECTOR) and k not in sd]
    if missing:
        raise KeyError(f"{path} lacks detector tensors: {missing[:5]}")
    model.load_state_dict(sd, strict=False)
    return len(sd)


def main(argv=None):
    """Trains; returns the Solver, whose ``timing`` and ``ckpt.records``
    hold the run's telemetry."""
    args = parse_args(argv)

    from spacap3d_tpu_torch.parallel import multihost

    rank, world = 0, 1
    if args.multihost or args.tp > 1:
        # before any other device use: the rank's card becomes current
        rank, world = multihost.initialize_from_env(
            device=args.device, backend=args.dist_backend, timeout_s=args.dist_timeout)
        multihost.warmup_collectives(args.device)
    if world % args.tp:
        raise SystemExit(f"--tp {args.tp} needs a world of d * {args.tp} ranks (launch "
                         f"with --multihost and SPACAP_NUM_PROCESSES); this one has {world}")
    data_size = world // args.tp
    if args.batch_size % data_size:
        raise SystemExit(f"--multihost: global batch {args.batch_size} must divide over "
                         f"{data_size} data ranks")
    device = str(multihost.rank_device(args.device))

    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
    from spacap3d_tpu_torch.data.loader import DataLoader
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import load_or_build_vocabulary
    from spacap3d_tpu_torch.models import init_spacap
    from spacap3d_tpu_torch.parallel.mesh import make_mesh
    from spacap3d_tpu_torch.parallel.tp import make_tp_mesh
    from spacap3d_tpu_torch.train.solver import Solver

    tp_mesh = make_tp_mesh(args.tp) if args.tp > 1 else None
    group = None if tp_mesh is not None else make_mesh()
    data_rank = rank // args.tp
    if world > 1 and rank == 0:
        print(f"process group: {world} ranks ({data_size} data x {args.tp} model)")

    train_anns, val_anns = load_annotations(args)
    train_scenes = sorted({a["scene_id"] for a in train_anns})
    val_scenes = sorted({a["scene_id"] for a in val_anns})
    if args.num_scenes != -1:
        train_scenes = train_scenes[: args.num_scenes]
        val_scenes = val_scenes[: args.num_scenes]
        train_anns = [a for a in train_anns if a["scene_id"] in set(train_scenes)]
    eval_val_anns_full = [a for a in val_anns if a["scene_id"] in set(val_scenes)]
    eval_val_list = one_per_scene(val_anns, val_scenes, train_anns[0])

    run_cfg = build_configs(args)
    dc = ScannetDatasetConfig()

    vocab_cache = os.path.join(args.data_root, f"{args.dataset}_vocabulary.json")
    glove_path = os.path.join(args.data_root, "glove.p")
    glove = glove_vocab = None
    if os.path.exists(glove_path):
        import pickle
        with open(glove_path, "rb") as f:
            glove = pickle.load(f)
        glove_vocab = set(glove.keys())
    vocab = load_or_build_vocabulary(vocab_cache, train_anns, glove_vocab)
    run_cfg = dataclasses.replace(
        run_cfg, model=dataclasses.replace(run_cfg.model, vocab_size=len(vocab)))

    mv = os.path.join(args.data_root, "scannet", "scannet_data",
                      "enet_feats_maxpool.hdf5") if args.use_multiview else None
    train_store = SceneStore(run_cfg.data.scannet_data, train_scenes,
                             load_relations=run_cfg.data.use_relation, multiview_hdf5=mv)
    val_store = SceneStore(run_cfg.data.scannet_data, val_scenes, load_relations=False,
                           multiview_hdf5=mv)
    train_ds = ScanReferDataset(train_anns, train_store, vocab, dc, run_cfg.data,
                                split="train", glove=glove)
    val_data_cfg = dataclasses.replace(run_cfg.data, augment=False, use_relation=False)
    val_ds = ScanReferDataset(eval_val_list, val_store, vocab, dc, val_data_cfg, split="val")
    train_eval_ds = None
    if args.eval_on_train:
        eval_train_list = one_per_scene(train_anns, train_scenes, train_anns[0])
        train_eval_ds = ScanReferDataset(eval_train_list, train_store, vocab, dc,
                                         val_data_cfg, split="train_eval")

    batch = args.batch_size
    train_loader = DataLoader(train_ds, batch, shuffle=True, seed=args.seed,
                              num_workers=args.num_workers, process_index=data_rank,
                              process_count=data_size)
    val_loader = DataLoader(val_ds, min(batch, len(val_ds)), shuffle=False,
                            num_workers=args.num_workers)
    train_eval_loader = None
    if train_eval_ds is not None:
        train_eval_loader = DataLoader(train_eval_ds, min(batch, len(train_eval_ds)),
                                       shuffle=False, num_workers=args.num_workers)

    model = init_spacap(run_cfg.model, dc.mean_size_arr, seed=args.seed, device=device)
    if args.pretrained_votenet:
        n = mount_detector(model, args.pretrained_votenet)
        if rank == 0:
            print(f"mounted the detector from {args.pretrained_votenet}: {n} tensors")
    num_params = int(sum(p.numel() for p in model.parameters()))
    multihost.replicate_global(model)

    stamp = args.use_checkpoint or (
        datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        + (f"_{args.tag.upper()}" if args.tag else ""))
    # every rank takes rank 0's stamp (the ranks' clocks differ)
    stamp = multihost.allgather_pyobj(stamp)[0]
    solver = Solver(
        run_cfg, model, train_loader, val_loader, train_ds, val_ds, vocab, dc,
        eval_val_anns_full, stamp, device=device,
        eval_on_train=args.eval_on_train, train_eval_loader=train_eval_loader,
        train_eval_dataset=train_eval_ds, train_corpus_annotations=train_anns,
        group=group, tp_mesh=tp_mesh,
    )
    if args.use_checkpoint:
        solver.restore(os.path.join(args.output_dir, args.use_checkpoint, "model_last.ckpt"))

    if rank == 0:
        run_cfg.save(os.path.join(solver.root, "config.json"))
    info = dict(vars(args))
    info.update(num_train=len(train_ds), num_eval_val=len(val_ds),
                num_train_scenes=len(train_scenes), num_eval_val_scenes=len(val_scenes),
                num_params=num_params, world=world)
    solver.logger.write_json("info.json", info)

    solver(args.epoch, args.verbose)
    if world > 1:
        multihost.shutdown()
    return solver


if __name__ == "__main__":
    main()
