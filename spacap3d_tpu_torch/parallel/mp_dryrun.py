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
* ``tp``: tensor parallelism over model groups of ``--tp`` ranks (``TP``
  by default; 1 on a world of one makes every attention and FFN
  all-reduce a collective over a group of one)
  (``parallel/tp.py``): the eval forward's tokens and objectness on the
  global batch, and one train step, from the same weights; also the eval
  forward with ``eval_decode_fused`` (the fused decode kernels, the FFN's
  in its partial-sum mode on the rank's d_ff slice), its launch counts set
  to 0 just before it and read just after, and both forwards timed in
  turns.
* ``--captured``: the dp and tp legs also run the captured steps
  (``train/capture.py``; their collectives inside the graphs, where every
  group is NCCL) beside eager ones from the same weights, batches and
  generators, in turns: CAPTURED_STEPS train steps of each, then the
  eval forwards of the tp leg, unfused and fused. Per rank: each call's ms
  and what the program did (``captured``, the graph indices ``replayed``,
  the rank agreement's ms, from its ``capture.agree`` span: the tracer is
  on over these legs), the tensors where the captured run differs from
  the eager one (metrics, dropout masks, outputs, then parameters, Adam
  state, BN buffers, generator states; with their largest differences),
  the launches of a profiled replay and of a profiled eager call from
  their kernel spans (a replay counts nothing in Python; NCCL's kernels
  under ``nccl``), the eager call's collectives, and the peak reserved
  memory. The ``--pin`` hooks and the index tape cannot act inside a
  replay: the pinned comparison stays on the eager step.
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
import functools
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

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
    to_device_batch,
)
from spacap3d_tpu_torch.utils import trace

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
# device spans by name in a profile: the kernels', and NCCL's
PROFILED = {"fps": "fps_kernel", "ball_query": "ball_query_kernel",
            "generator_argmax": "gen_argmax_kernel", "ffn": "ffn_kernel",
            "ffn_partial": "ffn_partial_kernel", "nccl": "nccl"}
# marker kernels (``torch.cuda._sleep``) that open a profile's window: a
# profile can drop the device spans at its head
PROFILE_MARKERS, PROFILE_MARKER_CYCLES = 64, 1_000
# ``--captured``: train steps of each kind in turns (a capture, then replays)
CAPTURED_STEPS = 3


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
    p.add_argument("--tp", type=int, default=TP, help="tp: the model group's size")
    p.add_argument("--captured", action="store_true",
                   help="dp, tp: also the captured steps against eager ones, in turns")
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


def adam_state(opt) -> Dict[str, torch.Tensor]:
    """The optimizer's state tensors by group, parameter index and name."""
    return {f"{gi}.{pi}.{k}": v for gi, g in enumerate(opt.param_groups)
            for pi, p in enumerate(g["params"]) for k, v in opt.state.get(p, {}).items()
            if torch.is_tensor(v)}


def differences(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The entries of two tensor dicts that are not ``torch.equal``, each
    with its largest absolute difference (inf where only one dict holds
    it or the shapes differ)."""
    out = {}
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k), b.get(k)
        if x is None or y is None or x.shape != y.shape:
            out[k] = float("inf")
        elif not torch.equal(x, y):
            out[k] = float((x.to(torch.float64) - y.to(torch.float64)).abs().max())
    return out


@contextlib.contextmanager
def recorded_masks():
    """Within: every ``Tensor.bernoulli_`` (the dropout masks' draw in
    ``models/core.py::dropout``) appends its result to the list it yields.
    A mask drawn in a capture is the graph's tensor, which each replay
    rewrites."""
    real, masks = torch.Tensor.bernoulli_, []

    def bernoulli_(self, *a, **kw):
        masks.append(real(self, *a, **kw))
        return masks[-1]

    torch.Tensor.bernoulli_ = bernoulli_
    try:
        yield masks
    finally:
        torch.Tensor.bernoulli_ = real


def kernel_spans(fn, dev: torch.device, want: Optional[Dict[str, int]] = None,
                 tries: int = 3) -> Optional[Dict]:
    """One call of ``fn`` under torch.profiler, on CUDA (None elsewhere):
    its device spans by ``PROFILED`` name and the collectives the host
    issued (the process group's ``nccl:`` ranges; a replay issues none),
    counted after PROFILE_MARKERS marker kernels that open the window. A
    profile whose kernel spans differ from ``want`` (the launches of one
    call) is taken again, up to ``tries`` times."""
    if dev.type != "cuda":
        return None
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize(dev)
            fn()
            torch.cuda.synchronize(dev)
        events = p.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        opened = max((e.time_range.end for e in device if "spin_kernel" in e.name),
                     default=float("-inf"))
        names = [e.name for e in device if e.time_range.start >= opened]
        counted = {k: sum(pat in n for n in names) for k, pat in PROFILED.items()}
        complete = want is None or all(counted[k] == n for k, n in want.items())
        if complete:
            break
    return {"kernel_spans": counted, "complete": complete, "incomplete_profiles": attempt,
            "collectives": sum(e.device_type == DeviceType.CPU and e.name.startswith("nccl:")
                               for e in events),
            "nccl_device_spans": [n[:80] for n in names if "nccl" in n.lower()][:8]}


def peak_reserved_gib(dev: torch.device) -> Optional[float]:
    return torch.cuda.max_memory_reserved(dev) / 2 ** 30 if dev.type == "cuda" else None


def traced(method):
    """``method`` with the tracer (``utils/trace.py``) on, whose
    ``capture.agree`` spans ``Worker.program_call`` reads."""
    @functools.wraps(method)
    def run(*args, **kwargs):
        trace.enable()
        try:
            return method(*args, **kwargs)
        finally:
            trace.disable()
    return run


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

    def timed(self, fn):
        """(``fn()``, its synchronised wall ms)."""
        synchronize(self.dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(self.dev)
        return out, (time.perf_counter() - t0) * 1e3

    @staticmethod
    def program_call(step) -> Optional[Dict]:
        """What the last call of ``step`` did: None where it ran eagerly,
        else whether it captured, the graphs it replayed and the rank
        agreement's ms (its ``capture.agree`` span, among the records since
        the last drain: the tracer is on over the captured legs)."""
        agree = [r for r in trace.drain() if r["name"] == "capture.agree"]
        program = step.program
        if program is None:
            return None
        last = program.last
        return {"captured": last["captured"], "replayed": last["replayed"],
                "agree_ms": (agree[-1]["end_ns"] - agree[-1]["start_ns"]) * 1e-6
                if agree else None}

    def whole_digest(self, model) -> str:
        """The digest of ``model``'s parameters, gathered whole under TP (a
        collective)."""
        params = dict(model.named_parameters())
        if getattr(model, "tp_mesh", None) is not None:
            params = tp_mod.gather_state_dict(params, model.tp_mesh, model.tp_specs)
        return digest(params)

    @traced
    def captured_train_turns(self, start, batch, group, data_rank, prepare=None) -> Dict:
        """CAPTURED_STEPS train steps of the eager and of the captured
        step (``make_train_step(capture=...)``), each on a model from the
        weights ``start`` (``prepare`` cuts it for TP), in turns, each call
        with the dropout generator of its iteration, then one profiled call
        of each (``kernel_spans``). What differs under ``torch.equal``
        (module docstring), each call's ms and what the program did, the
        ranks' digest of the captured model's parameters, and the peak
        reserved memory over the turns."""
        tc = self.train_config()
        runs = {}
        for kind in ("eager", "captured"):
            model = self.fresh_model_local(start)
            if prepare is not None:
                prepare(model)
            opt = self.optimizer(model, tc)
            runs[kind] = {"model": model, "opt": opt, "metrics": [], "masks": [], "ms": [],
                          "calls": [], "graph_masks": [], "gens": [],
                          "step": make_train_step(self.cfg, tc, opt, device=self.dev,
                                                  group=group, capture=kind == "captured")}
        if runs["captured"]["step"].program is None:
            raise AssertionError("the captured train step has no program: a group is not NCCL")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        profiles = {}
        for it in range(CAPTURED_STEPS + 1):
            profiled = it == CAPTURED_STEPS
            for kind in (("eager", "captured"), ("captured", "eager"))[it % 2 and not profiled]:
                run = runs[kind]
                gen = (dropout_generator(self.dev, SEED, it, data_rank)
                       if self.cfg.transformer_dropout else None)

                def call(run=run, gen=gen):
                    return run["step"](run["model"], batch, gen, 0.1)
                if profiled:
                    before = {k: f.launches for k, f in KERNELS.items()}
                    out = {}
                    want = (None if kind == "eager" else
                            {k: n for k, n in profiles["eager"]["wrapper_launches"].items()})
                    profiles[kind] = kernel_spans(lambda: out.update(call()), self.dev, want) or {}
                    profiles[kind]["wrapper_launches"] = {k: f.launches - before[k]
                                                         for k, f in KERNELS.items()}
                    profiles[kind]["call"] = self.program_call(run["step"])
                    metrics = out
                    masks = []
                else:
                    with recorded_masks() as rec:
                        metrics, ms = self.timed(call)
                    masks = list(rec)
                    run["ms"].append(ms)
                    run["calls"].append(self.program_call(run["step"]))
                    if kind == "captured":
                        if run["calls"][-1]["captured"]:
                            half = len(masks) // 2
                            masks, run["graph_masks"] = masks[:half], masks[half:]
                        elif not masks:     # a replay draws into the graph's masks
                            masks = run["graph_masks"]
                run["masks"].append([t.clone() for t in masks])
                run["metrics"].append(metrics)
                run["gens"].append(None if gen is None else gen.get_state())
        e, c = runs["eager"], runs["captured"]
        return {
            "steps": CAPTURED_STEPS, "ms": {"eager": e["ms"], "captured": c["ms"]},
            "metrics": {kind: [{k: float(v) for k, v in m.items()} for m in run["metrics"]]
                        for kind, run in runs.items()},
            "calls": c["calls"], "profiles": profiles,
            "metrics_differ": [differences(a, b) for a, b in zip(c["metrics"], e["metrics"])],
            "masks_per_step": [len(m) for m in e["masks"]],
            "masks_differ": [[i for i, (a, b) in enumerate(zip(cm, em)) if not torch.equal(a, b)]
                             + ([] if len(cm) == len(em) else ["count"])
                             for cm, em in zip(c["masks"], e["masks"])],
            "parameters_differ": differences(dict(c["model"].named_parameters()),
                                             dict(e["model"].named_parameters())),
            "adam_state_differ": differences(adam_state(c["opt"]), adam_state(e["opt"])),
            "bn_buffers_differ": differences(bn_state(c["model"]), bn_state(e["model"])),
            "generator_states_equal": all(
                (a is None and b is None) or torch.equal(a, b)
                for a, b in zip(c["gens"], e["gens"])),
            "param_digest": self.whole_digest(c["model"]),
            "peak_reserved_gib": peak_reserved_gib(self.dev),
        }

    @traced
    def captured_eval_turns(self, paths, batch, want, turns: int = 2) -> Dict:
        """The eval forward of each path (name -> model) through the eager
        and the captured step, in turns (unfused, fused, fused, unfused,
        ``turns`` times, each path's eager and captured call in alternating
        order),
        then one profiled call of each (``want``: each path's launches).
        Per path: each call's ms, what the program did, the outputs where
        the captured forward differs from the eager one under
        ``torch.equal``, the profiles, and the peak reserved memory."""
        steps = {name: {"eager": make_eval_step(model.cfg, device=self.dev, capture=False),
                        "captured": make_eval_step(model.cfg, device=self.dev)}
                 for name, model in paths.items()}
        if any(s["captured"].program is None for s in steps.values()):
            raise AssertionError("the captured eval step has no program")
        res = {name: {"ms": {"eager": [], "captured": []}, "calls": [], "differ": [],
                      "profiles": {}} for name in paths}
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        order = ["unfused", "fused", "fused", "unfused"] * turns
        for i, name in enumerate(n for n in order if n in paths):
            outs = {}
            for kind in (("eager", "captured"), ("captured", "eager"))[i % 2]:
                step = steps[name][kind]
                outs[kind], ms = self.timed(lambda: step(paths[name], batch))
                res[name]["ms"][kind].append(ms)
            res[name]["calls"].append(self.program_call(steps[name]["captured"]))
            res[name]["differ"].append(differences(outs["captured"], outs["eager"]))
        for name in paths:
            for kind in ("eager", "captured"):
                step = steps[name][kind]
                before = {k: f.launches for k, f in KERNELS.items()}
                prof = kernel_spans(lambda: step(paths[name], batch), self.dev,
                                    want[name]) or {}
                prof["wrapper_launches"] = {k: f.launches - before[k] for k, f in KERNELS.items()}
                prof["call"] = self.program_call(step)
                res[name]["profiles"][kind] = prof
        res["peak_reserved_gib"] = peak_reserved_gib(self.dev)
        return res

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
        if self.args.captured:
            res["captured"] = self.captured_train_turns(start, local, group, self.rank)
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
        mesh = tp_mod.make_tp_mesh(self.args.tp)
        batch = self.global_batch()
        res = {"tp": mesh.tp, "model_rank": mesh.model_rank, "data_rank": mesh.data_rank}
        model = self.fresh_model()
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tp_mod.shard_model(model, mesh)
        res["sharded_parameters"] = tp_mod.count_sharded(model)
        eval_batch = {k: batch[k] for k in EVAL_INPUT_KEYS}
        before = {k: f.launches for k, f in KERNELS.items()}
        out = make_eval_step(self.cfg, device=self.dev, capture=False)(model, eval_batch)
        res["eval_launches"] = {k: f.launches - before[k] for k, f in KERNELS.items()}
        res["token_digest"] = self.tp_tokens("tp_eval.pt", out)
        cfg = dataclasses.replace(self.cfg, eval_decode_fused=True)
        fused = self.fresh_model_local(start, cfg)   # the flag travels in the config
        tp_mod.shard_model(fused, mesh)
        fused_step = make_eval_step(cfg, device=self.dev, capture=False)
        for f in KERNELS.values():
            f.launches = 0
        out = fused_step(fused, eval_batch)
        synchronize(self.dev)
        res["fused"] = {"eval_launches": {k: f.launches for k, f in KERNELS.items()},
                        "token_digest": self.tp_tokens("tp_eval_fused.pt", out)}
        res["eval_ms"] = self.eval_times({
            "unfused": (make_eval_step(self.cfg, device=self.dev, capture=False), model),
            "fused": (fused_step, fused)}, eval_batch)
        if self.args.captured:
            unfused_want = {k: (res["eval_launches"][k] if k in ("fps", "ball_query") else 0)
                            for k in KERNELS}
            res["captured_eval"] = self.captured_eval_turns(
                {"unfused": model, "fused": fused},
                to_device_batch(eval_batch, self.dev),
                {"unfused": unfused_want, "fused": res["fused"]["eval_launches"]})

        model = self.fresh_model_local(start)
        tp_mod.shard_model(model, mesh)
        local = mesh_mod.shard_batch(mesh.data, batch)
        res["steps"] = self.run_steps(model, local, mesh.data, mesh.data_rank)
        if self.args.captured:
            res["captured"] = self.captured_train_turns(
                start, local, mesh.data, mesh.data_rank,
                prepare=lambda m: tp_mod.shard_model(m, mesh))
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
