"""Multi-process dry-run worker, as the JAX package's
``parallel/mp_dryrun.py``:

    SPACAP_COORDINATOR=localhost:PORT SPACAP_NUM_PROCESSES=N SPACAP_PROCESS_ID=i \\
        python -m spacap3d_tpu_torch.parallel.mp_dryrun --out DIR [--legs dp,tp,grid] ...

Started once a rank (``launch`` starts them all), each worker joins the
process group (``multihost.initialize_from_env``) and runs its legs:

* ``dp``: data-parallel train steps on its row-block of one global batch
  (``--global_batch``; the synthetic ``train_batch`` or ``--batch``) with
  the data group, then all-gathers the loss and asserts that every rank
  holds the same value. ``--plain`` also runs rank 0 through the same
  steps on the whole global batch without a group, from the same weights
  and dropout generators, and records the differences (bit for bit over
  several steps only with ``--deterministic``; ``--pin`` makes the
  data-parallel step's FPS and ball-query indices and max-pools take the
  plain step's, and counts where its own differ).
* ``tp``: tensor parallelism over model groups of ``TP`` ranks
  (``parallel/tp.py``): the eval forward's tokens and objectness on the
  global batch, and one train step, from the same weights; also the eval
  forward with ``eval_decode_fused`` (the fused decode kernels, the FFN's
  in its partial-sum mode on the rank's d_ff slice), its launch counts set
  to 0 just before it and read just after, and both forwards timed in
  turns.
* ``grid``: the seed-sharded ``mul_eval_grid_multihost`` over a synthetic
  split (``--data_root``).
* ``refuse_nccl``: asks for NCCL and exits 0 only if the runtime refuses
  (two ranks on one card).

Weights come from ``--weights`` (a state dict) or the seed. Each rank
writes ``rank{i}.json`` into ``--out``: per leg its metrics, digests of
its parameters and BN buffers (equal digests: bit-equal tensors), kernel
launch counts on CUDA, step times and, from rank 0, tensors for a caller
to hold against a reference (``dp_state.pt``, ``tp_eval.pt``,
``tp_eval_fused.pt``, ``tp_state.pt``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from spacap3d_tpu_torch.models import SpaCapNet, init_spacap
from spacap3d_tpu_torch.models.core import BatchNorm
from spacap3d_tpu_torch.parallel import mesh as mesh_mod
from spacap3d_tpu_torch.parallel import multihost, tp as tp_mod
from spacap3d_tpu_torch.train.solver import dropout_generator, synchronize
from spacap3d_tpu_torch.train.step import (
    EVAL_INPUT_KEYS,
    METRIC_KEYS,
    TRAIN_KEYS,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

# the tiny smoke config of the JAX worker (fast on the CPU)
TINY = dict(num_points=1024, num_proposals=16, num_layers=2, num_heads=4, d_model=32,
            d_ff=64, max_des_len=7, vocab_size=64, sa_npoints=(128, 64, 32, 16),
            sa_nsamples=(16, 8, 8, 4),
            sa_widths=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
            fp_width=64, seed_feature_dim=64, proposal_feature_dim=32)
# the seed of the weights, the synthetic batch and the dropout masks; the
# model group's size; the grid's caption-match IoU (random weights leave
# candidates at 0.05, none at 0.5)
SEED, TP, GRID_MIN_IOU = 0, 2, 0.05
# the neighbour max-pools of the train path, by the module whose output
# they reduce over its neighbour axis
POOLS = {**{f"sa{i}": f"backbone_net.sa{i}.mlp_module" for i in range(1, 5)},
         "aggregation": "proposal.vote_aggregation.mlp_module"}
KERNELS = {"fps": ops.furthest_point_sample, "ball_query": ops.ball_query,
           "generator_argmax": ops.generator_argmax, "ffn": ops.ffn,
           "ffn_partial": ops.ffn_partial}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="directory for rank{i}.json and tensors")
    p.add_argument("--legs", default="dp", help="comma-separated: dp, tp, grid, refuse_nccl")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="seconds for the rendezvous and every collective")
    p.add_argument("--config", default="tiny",
                   help="'tiny', 'full' (the default ModelConfig) or a JSON of its fields")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--weights", default="", help="a state dict (torch.save) to start from")
    p.add_argument("--batch", default="", help="an .npz global batch (TRAIN_KEYS)")
    p.add_argument("--global_batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--no_relation", action="store_true",
                   help="no relation loss, and no relation head (as the train CLI's flag)")
    p.add_argument("--plain", action="store_true",
                   help="dp: rank 0 also runs the steps without a group on the global batch")
    p.add_argument("--pin", action="store_true",
                   help="dp with --plain, one step: each rank's FPS and ball-query indices "
                        "and neighbour max-pools take those of rank 0's plain step, whose "
                        "discrete choices can flip between the two paths' roundings of the "
                        "BN sums; the flips are counted")
    p.add_argument("--deterministic", action="store_true",
                   help="torch's deterministic algorithms (the CUDA backward otherwise sums "
                        "with atomics, so two runs of one step differ in the last bits)")
    p.add_argument("--data_root", default="")
    p.add_argument("--anns", default="", help="grid: annotations JSON (default: all)")
    p.add_argument("--vocab", default="", help="grid: vocabulary JSON (default: built)")
    p.add_argument("--scenes", type=int, default=0, help="grid: the first N scenes (0: all)")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--grid_batch", type=int, default=4)
    p.add_argument("--workers", type=int, default=2)
    return p.parse_args(argv)


def model_config(spec: str, dropout: float) -> ModelConfig:
    if spec == "tiny":
        cfg = ModelConfig(**TINY)
    elif spec == "full":
        cfg = ModelConfig()
    else:
        with open(spec) as f:
            fields = json.load(f)
        cfg = ModelConfig(**{k: tuple(map(tuple, v)) if k == "sa_widths" else
                             tuple(v) if isinstance(v, list) else v
                             for k, v in fields.items()})
    return dataclasses.replace(cfg, transformer_dropout=dropout)


def digest(tensors: Dict[str, torch.Tensor]) -> str:
    """SHA-256 over the names and bytes of ``tensors`` (equal: bit-equal)."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def record_pools(model, into: Dict[str, torch.Tensor]) -> list:
    """Forward hooks that record each POOLS max-pool's argmax over its
    neighbours into ``into``; returns the hooks."""
    return [model.get_submodule(path).register_forward_hook(
        lambda m, i, o, k=k: into.__setitem__(k, o.argmax(2).cpu()))
        for k, path in POOLS.items()]


def pin_pools(model, pin: Dict[str, torch.Tensor], flips: Dict[str, int]) -> list:
    """Forward hooks that make each POOLS max-pool take the neighbours
    ``pin`` names instead of its own maximum, counting into ``flips`` the
    entries where the two differ. Returns the hooks."""
    def hook(o, k):
        ref = pin[k].to(o.device)
        flips[k] = int((o.argmax(2) != ref).sum())
        return o.gather(2, ref[:, :, None, :])

    return [model.get_submodule(path).register_forward_hook(
        lambda m, i, o, k=k: hook(o, k)) for k, path in POOLS.items()]


@contextlib.contextmanager
def index_tape(tape: list, rows: Optional[slice] = None, flips: Optional[list] = None):
    """Within: FPS and ball query append their index outputs to ``tape``
    (``rows`` None), or run and then return ``rows`` of ``tape``'s outputs
    in call order, appending to ``flips`` how many of their own indices
    differ. The kernels run (and count their launches) either way."""
    names = ("furthest_point_sample", "ball_query")
    saved = {n: getattr(ops, n) for n in names}
    played = iter(tape)

    def taped(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if rows is None:
                tape.append(out.cpu())
                return out
            ref = next(played)[rows].to(out.device)
            flips.append(int((out != ref).sum()))
            return ref
        return call

    for n in names:
        setattr(ops, n, taped(saved[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(ops, n, saved[n])


def bn_state(model) -> Dict[str, torch.Tensor]:
    return {f"{n}.{k}": getattr(m, k) for n, m in model.named_modules()
            if isinstance(m, BatchNorm) for k in ("running_mean", "running_var")}


class Worker:
    def __init__(self, args, rank: int, world: int):
        self.args, self.rank, self.world = args, rank, world
        self.dev = multihost.rank_device(args.device)
        self.cfg = model_config(args.config, args.dropout)
        if args.no_relation:
            self.cfg = dataclasses.replace(self.cfg, check_relation=False)
        self.result: Dict = {"rank": rank, "world": world, "device": str(self.dev),
                             "backend": torch.distributed.get_backend()
                             if torch.distributed.is_initialized() else None}

    # ------------------------------------------------------------ helpers
    def fresh_model(self, cfg=None) -> SpaCapNet:
        cfg = cfg or self.cfg
        model = init_spacap(cfg, seed=SEED, device=self.dev)
        if self.args.weights:
            model.load_state_dict(torch.load(self.args.weights, map_location="cpu",
                                             weights_only=True))
        multihost.replicate_global(model)
        return model

    def global_batch(self) -> Dict[str, np.ndarray]:
        if self.args.batch:
            with np.load(self.args.batch) as f:
                return {k: f[k] for k in TRAIN_KEYS}
        from spacap3d_tpu_torch.data.synthetic import train_batch

        return train_batch(self.cfg, self.args.global_batch, seed=SEED)

    def train_config(self) -> TrainConfig:
        return TrainConfig(lr=self.args.lr, transformer_lr=self.args.lr,
                           use_relation=not self.args.no_relation)

    def optimizer(self, model, tc):
        if self.args.optimizer == "sgd":
            return torch.optim.SGD(model.parameters(), lr=self.args.lr)
        return make_optimizer(model, tc, steps_per_epoch=10)[0]

    def run_steps(self, model, batch, group, data_rank) -> List[Dict]:
        """``--steps`` train steps; per step its metrics, launches and ms.
        Eager (``capture=False``): a group step runs eagerly anyway, and the
        plain step without a group is its reference, whose launches and
        pinned choices (``--pin``'s hooks and index tape) are taken op by
        op."""
        tc = self.train_config()
        step = make_train_step(self.cfg, tc, self.optimizer(model, tc), device=self.dev,
                               group=group, capture=False)
        out = []
        for it in range(self.args.steps):
            gen = (dropout_generator(self.dev, SEED, it, data_rank)
                   if self.cfg.transformer_dropout else None)
            before = {k: f.launches for k, f in KERNELS.items()}
            synchronize(self.dev)
            t0 = time.perf_counter()
            metrics = step(model, batch, gen, 0.1)
            synchronize(self.dev)
            ms = (time.perf_counter() - t0) * 1e3
            out.append({"metrics": {k: float(v) for k, v in metrics.items()}, "ms": ms,
                        "launches": {k: f.launches - before[k] for k, f in KERNELS.items()}})
        return out

    def save(self, name: str, obj) -> None:
        if self.rank == 0:
            torch.save(obj, os.path.join(self.args.out, name))

    # --------------------------------------------------------------- legs
    def leg_dp(self) -> Dict:
        group = mesh_mod.make_mesh()
        batch = self.global_batch()
        local = mesh_mod.shard_batch(group, batch)
        model = self.fresh_model()
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        plain = pools = None
        if self.args.pin and (self.args.steps != 1 or not self.args.plain):
            raise ValueError("--pin pins the choices of one --plain step")
        if self.args.plain and self.rank == 0:
            ref = self.fresh_model_local(start)
            pools, tape = {}, []
            hooks = record_pools(ref, pools) if self.args.pin else []
            with index_tape(tape) if self.args.pin else contextlib.nullcontext():
                plain = self.run_steps(ref, batch, None, 0)
            for h in hooks:
                h.remove()
            if self.args.pin:
                torch.save({"pools": pools, "tape": tape},
                           os.path.join(self.args.out, "pins.pt"))
        hooks, flips, index_flips, pinned = [], {}, [], contextlib.nullcontext()
        if self.args.pin:
            multihost.allgather_pyobj(0)        # rank 0's choices are on disk
            pins = torch.load(os.path.join(self.args.out, "pins.pt"), weights_only=True)
            per = next(iter(local.values())).shape[0]
            rows = slice(self.rank * per, (self.rank + 1) * per)
            hooks = pin_pools(model, {k: v[rows] for k, v in pins["pools"].items()}, flips)
            pinned = index_tape(pins["tape"], rows, index_flips)
        with pinned:
            steps = self.run_steps(model, local, group, self.rank)
        for h in hooks:
            h.remove()
        loss = steps[-1]["metrics"]["loss"]
        if not np.isfinite(loss):
            raise AssertionError(f"rank {self.rank}: loss {loss}")
        losses = multihost.allgather_pyobj(loss)
        if any(v != loss for v in losses):
            raise AssertionError(f"ranks disagree on the loss: {losses}")
        params = dict(model.named_parameters())
        res = {"rows": int(next(iter(local.values())).shape[0]), "steps": steps,
               "losses": losses, "param_digest": digest(params),
               "bn_digest": digest(bn_state(model)),
               "pinned": self.args.pin, "pool_flips": flips, "index_flips": index_flips,
               "param_abs_sum": float(sum(p.detach().double().abs().sum() for p in
                                          params.values()))}
        self.save("dp_state.pt", {k: v.cpu() for k, v in model.state_dict().items()})
        if plain is not None:
            res["plain_steps"] = plain
            res["plain_rel"] = [max(abs(g["metrics"][k] - p["metrics"][k])
                                    / max(abs(p["metrics"][k]), 1e-6) for k in METRIC_KEYS)
                                for g, p in zip(steps, plain)]
            res["plain_param_max_abs"] = max(
                float((a.detach() - ref.get_parameter(n).detach()).abs().max())
                for n, a in params.items())
            ref_sd = ref.state_dict()
            res["plain_bit_equal"] = all(torch.equal(v, ref_sd[k])
                                         for k, v in model.state_dict().items())
        return res

    def fresh_model_local(self, state, cfg=None) -> SpaCapNet:
        """A model holding ``state``, without a collective (rank 0 alone)."""
        model = SpaCapNet(cfg or self.cfg).to(self.dev)
        model.load_state_dict(state)
        return model

    def eval_times(self, paths, batch, turns=1) -> Dict:
        """Per path (name -> (eval step, model)): the synchronised wall ms of
        its eval forwards and of their greedy decodes, in turns (``turns``
        times unfused, fused, fused, unfused), and their medians."""
        times = {name: {"forward_ms": [], "decode_ms": []} for name in paths}
        for name in ["unfused", "fused", "fused", "unfused"] * turns:
            step, model = paths[name]
            cap = model.caption
            decode = cap.greedy_decode

            def timed(obj, decode=decode, into=times[name]["decode_ms"]):
                synchronize(self.dev)
                t0 = time.perf_counter()
                toks = decode(obj)
                synchronize(self.dev)
                into.append((time.perf_counter() - t0) * 1e3)
                return toks

            cap.greedy_decode = timed
            try:
                synchronize(self.dev)
                t0 = time.perf_counter()
                step(model, batch)
                synchronize(self.dev)
            finally:
                del cap.greedy_decode
            times[name]["forward_ms"].append((time.perf_counter() - t0) * 1e3)
        for t in times.values():
            t.update({f"{k}_median": float(np.median(v)) for k, v in list(t.items())})
        return times

    def tp_tokens(self, name: str, out) -> str:
        """The digest of a TP eval forward's tokens, which every rank of the
        world must share; rank 0 saves the tokens and objectness as
        ``name``."""
        tokens = out["lang_cap"].cpu()
        token_digest = digest({"lang_cap": tokens})
        digests = multihost.allgather_pyobj(token_digest)
        if len(set(digests)) != 1:
            raise AssertionError(f"TP ranks decoded different tokens: {digests}")
        self.save(name, {"lang_cap": tokens, "objectness_scores": out["objectness_scores"].cpu()})
        return token_digest

    def leg_tp(self) -> Dict:
        mesh = tp_mod.make_tp_mesh(TP)
        batch = self.global_batch()
        res = {"tp": mesh.tp, "model_rank": mesh.model_rank, "data_rank": mesh.data_rank}
        model = self.fresh_model()
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tp_mod.shard_model(model, mesh)
        res["sharded_parameters"] = tp_mod.count_sharded(model)
        eval_batch = {k: batch[k] for k in EVAL_INPUT_KEYS}
        before = {k: f.launches for k, f in KERNELS.items()}
        out = make_eval_step(self.cfg, device=self.dev)(model, eval_batch)
        res["eval_launches"] = {k: f.launches - before[k] for k, f in KERNELS.items()}
        res["token_digest"] = self.tp_tokens("tp_eval.pt", out)
        cfg = dataclasses.replace(self.cfg, eval_decode_fused=True)
        fused = self.fresh_model_local(start, cfg)   # the flag travels in the config
        tp_mod.shard_model(fused, mesh)
        fused_step = make_eval_step(cfg, device=self.dev)
        for f in KERNELS.values():
            f.launches = 0
        out = fused_step(fused, eval_batch)
        synchronize(self.dev)
        res["fused"] = {"eval_launches": {k: f.launches for k, f in KERNELS.items()},
                        "token_digest": self.tp_tokens("tp_eval_fused.pt", out)}
        res["eval_ms"] = self.eval_times({
            "unfused": (make_eval_step(self.cfg, device=self.dev), model),
            "fused": (fused_step, fused)}, eval_batch)

        model = self.fresh_model_local(start)
        tp_mod.shard_model(model, mesh)
        local = mesh_mod.shard_batch(mesh.data, batch)
        res["steps"] = self.run_steps(model, local, mesh.data, mesh.data_rank)
        full = tp_mod.gather_state_dict(model.state_dict(), mesh, model.tp_specs)
        res["param_digest"] = digest({k: full[k] for k, _ in model.named_parameters()})
        self.save("tp_state.pt", {k: v.cpu() for k, v in full.items()})
        return res

    def leg_grid(self) -> Dict:
        from spacap3d_tpu_torch.eval.eval_helper import organize_annotations, prepare_corpus
        from spacap3d_tpu_torch.eval.mul_eval import mul_eval_grid_multihost

        anns, ds, vocab, dc = grid_dataset(self.args.data_root, self.args.anns,
                                           self.args.vocab, self.cfg, self.args.scenes)
        cfg = dataclasses.replace(self.cfg, vocab_size=len(vocab))
        model = self.fresh_model(cfg)
        # each forward's launches as the wrappers count them, and whether it
        # ran eagerly (None), captured a graph (True: the warm-up and the
        # capture each count the launches) or replayed one (False: no count)
        counted = {"forwards": 0, "launches": [], "captured": []}
        base = make_eval_step(cfg, device=self.dev, compact=True)

        def step(m, b):
            before = {k: f.launches for k, f in KERNELS.items()}
            out = base(m, b)
            counted["forwards"] += 1
            counted["launches"].append({k: f.launches - before[k] for k, f in KERNELS.items()})
            counted["captured"].append(None if base.program is None
                                       else base.program.last["captured"])
            return out

        seeds = [int(s) for s in self.args.seeds.split(",")]
        t0 = time.perf_counter()
        rows = mul_eval_grid_multihost(
            step, model, ds, vocab, dc, prepare_corpus(anns), organize_annotations(anns),
            seeds, self.args.grid_batch, min_iou=GRID_MIN_IOU,
            num_workers=self.args.workers, score_workers=self.args.workers, device=self.dev)
        return {"rows": rows, "seconds": time.perf_counter() - t0,
                "local_seeds": multihost.process_shard(seeds), **counted}


def grid_dataset(root: str, anns_path: str, vocab_path: str, cfg: ModelConfig,
                 num_scenes: int = 0):
    """The grid leg's split: the annotations under ``root`` (``anns_path``,
    else ``ScanRefer_filtered_all.json``), the first annotation of each of
    the first ``num_scenes`` scenes (0: all) as the eval list, and the
    vocabulary at ``vocab_path`` (else built from the annotations).
    Returns (annotations, dataset, vocabulary, dataset config)."""
    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import Vocabulary

    with open(anns_path or os.path.join(root, "ScanRefer_filtered_all.json")) as f:
        anns = json.load(f)
    scene_ids = sorted({a["scene_id"] for a in anns})
    if num_scenes:
        scene_ids = scene_ids[:num_scenes]
        anns = [a for a in anns if a["scene_id"] in set(scene_ids)]
    seen = set()
    eval_list = [a for a in anns if not (a["scene_id"] in seen or seen.add(a["scene_id"]))]
    vocab = (Vocabulary.load(vocab_path) if vocab_path
             else Vocabulary.build(anns, max_len=cfg.max_des_len))
    dc = ScannetDatasetConfig()
    data = DataConfig(data_root=root, num_points=cfg.num_points, augment=False,
                      use_relation=False, max_des_len=cfg.max_des_len)
    ds = ScanReferDataset(eval_list, SceneStore(data.scannet_data, scene_ids), vocab, dc,
                          data, split="val")
    return anns, ds, vocab, dc


def launch(cmd: List[str], world: int, timeout: float,
           env: Optional[Dict[str, str]] = None) -> List[subprocess.CompletedProcess]:
    """Runs ``python *cmd`` as ``world`` ranks joined through the
    ``SPACAP_*`` variables on a free local port; waits at most ``timeout``
    seconds for each (then kills them all) and returns the finished
    processes, output and errors captured."""
    port = multihost.free_port()
    procs = []
    for rank in range(world):
        e = dict(os.environ if env is None else env)
        e.update(SPACAP_COORDINATOR=f"localhost:{port}", SPACAP_NUM_PROCESSES=str(world),
                 SPACAP_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, *cmd], env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    done = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def main(argv=None) -> int:
    args = parse_args(argv)
    legs = [leg for leg in args.legs.split(",") if leg]
    os.makedirs(args.out, exist_ok=True)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # before cuBLAS starts
        torch.use_deterministic_algorithms(True, warn_only=True)
    if args.device == "cpu":
        torch.set_num_threads(1)
    if legs == ["refuse_nccl"]:
        try:
            multihost.initialize_from_env(device=args.device, backend="nccl",
                                          timeout_s=args.timeout)
        except ValueError as e:
            print(f"refused: {e}", flush=True)
            return 0
        multihost.shutdown()
        print("NCCL formed a group of ranks that share one card", flush=True)
        return 1
    rank, world = multihost.initialize_from_env(device=args.device, backend=args.backend,
                                                timeout_s=args.timeout)
    try:
        multihost.warmup_collectives(args.device)
        if args.device != "cpu":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        worker = Worker(args, rank, world)
        for leg in legs:
            t0 = time.perf_counter()
            worker.result[leg] = getattr(worker, f"leg_{leg}")()
            worker.result[leg]["wall_s"] = time.perf_counter() - t0
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump(worker.result, f)
        print(f"mp_dryrun rank {rank}/{world}: {', '.join(legs)} done", flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
