"""Training solver: the epoch loop, in-loop validation, checkpoints and
telemetry, as ``spacap3d_tpu/train/solver.py`` (reference lib/solver.py:80-697)
for one process on one device:

  * each iteration runs the train step (``train/step.py``) on a batch of
    the train loader;
  * fetch and step times are kept (reference :464-505), with an ETA; the
    step time is taken on sampled iterations only, every
    ``min(verbose, 50)``, behind a device synchronisation, so that the other
    iterations queue their work without waiting for it;
  * validation every ``val_step`` iterations runs ``eval_cap`` on the val
    loader and keeps the best checkpoint (``model.ckpt``) by ``criterion``
    (default CIDEr, :556-580); ``model_last.ckpt`` is written every
    ``ckpt_every`` epochs and after the last, on a background thread;
  * the BN momentum of detection pretraining: 0.5 * rate^(epoch // step),
    floored at 0.001 (:179-187); 0.1 otherwise.

On CUDA the train step runs captured (``train/step.py::make_train_step``:
one CUDA graph a step, replayed with the batch, the momentum and the
dropout generator's state loaded into it), and so does the validation's
eval forward; the validation's graphs are dropped after each validation,
the train graph is kept. Under data and tensor parallelism over NCCL
(``--multihost`` on CUDA) the steps capture too, their collectives inside
the graphs; every rank runs the same iterations and validations, so every
rank captures, replays, clears and recaptures at the same call, as the
steps' rank agreement requires (``train/capture.py``). Over gloo (ranks
sharing a card, or on the CPU) they run eagerly. The ``timing`` fields
mean the same either way.

Dropout masks come from a generator on the model's device seeded from
(``TrainConfig.seed``, the global iteration) at every step, so a resumed
run draws the masks an uninterrupted one would. They are not the JAX
package's masks: the two frameworks' random streams differ.

Data parallelism (``group``, ``parallel/``): every rank runs the same loop
on its row-block of each global batch (its loader's process slicing) with
the train step's group path, so the parameters stay equal on every rank.
Each rank validates redundantly on its own device over the whole val
loader, and every rank takes rank 0's scores (one all-gather), so the
best-checkpoint decisions agree; rank 0 alone writes logs, checkpoints,
``best.txt`` and the corpus and prediction files (the others log to a
``_NullLogger``). Dropout generators are seeded from (seed, global
iteration, data rank); under TP the captioner draws the masks of the
rank's heads and FFN columns from a second generator that folds in the
model rank (``models/core.py::split_generators``, split by the train step
before its graph).

Tensor parallelism (``tp_mesh``, ``parallel/tp.py``): the captioner is
cut to this rank's slices before the optimizer is built, the data group
of the mesh takes the part of ``group``, and a checkpoint holds whole
tensors: every rank gathers the slices (a collective) before rank 0
writes, and ``restore`` cuts them again. The JAX package runs TP in one
process and refuses it across processes; torch has no one-process
multi-device mesh, so here TP always spans processes.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from spacap3d_tpu_torch.config import RunConfig
from spacap3d_tpu_torch.eval.eval_helper import eval_cap, eval_device
from spacap3d_tpu_torch.parallel import tp as tp_mod
from spacap3d_tpu_torch.parallel.mesh import group_rank_size
from spacap3d_tpu_torch.parallel.multihost import allgather_pyobj, process_count, process_index
from spacap3d_tpu_torch.train.step import (
    load_optimizer_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from spacap3d_tpu_torch.utils.checkpoint import AsyncCheckpointer, load_checkpoint
from spacap3d_tpu_torch.utils.convert import payload_from_jax
from spacap3d_tpu_torch.utils.jax_checkpoint import is_jax_checkpoint, load_jax_checkpoint
from spacap3d_tpu_torch.utils.logging import RunLogger, decode_eta

BN_MOMENTUM_INIT = 0.5
BN_MOMENTUM_MAX = 0.001
CAPTION_METRICS = ("bleu-1", "bleu-2", "bleu-3", "bleu-4", "cider", "rouge", "meteor")
SUM_METRICS = ("bleu-4", "cider", "rouge", "meteor")


def dropout_generator(device, seed: int, global_iter: int, data_rank: int = 0
                      ) -> torch.Generator:
    """The dropout masks' generator of a step, seeded from (seed, global
    iteration, data rank): a resumed run draws the masks of an
    uninterrupted one, each data rank its own, and data rank 0 those of a
    single process."""
    gen = torch.Generator(device=device)
    s = (seed * 1_000_003 + global_iter) % (2 ** 63)
    gen.manual_seed((s * 1009 + data_rank) % (2 ** 63) if data_rank else s)
    return gen


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _NullLogger:
    """The logger of ranks other than 0: rank 0 owns log.txt,
    all_scalars.json and best.txt; the others run the same loop silently
    (their metrics are the same global values)."""

    def log(self, *a, **k):
        pass

    def scalar(self, *a, **k):
        pass

    def write_json(self, *a, **k):
        pass

    def dump_scalars(self, *a, **k):
        pass

    def close(self, *a, **k):
        pass


class Solver:
    """``model`` must lie on ``device``, with the same weights on every rank
    (``multihost.replicate_global``). ``timing`` holds every sampled step
    time, every fetch time and every validation's wall time, in seconds
    (``step``, ``fetch``, ``val``). ``group``: the data-parallel process
    group; ``tp_mesh``: a tensor-parallel split (its data group then
    replaces ``group``)."""

    def __init__(
        self,
        run_cfg: RunConfig,
        model: torch.nn.Module,
        train_loader,
        val_loader,
        train_dataset,
        val_dataset,
        vocab,
        dataset_config,
        corpus_annotations,
        stamp: str,
        device="cuda",
        eval_on_train: bool = False,
        meteor_jar: Optional[str] = None,
        train_eval_loader=None,
        train_eval_dataset=None,
        train_corpus_annotations=None,
        group=None,
        tp_mesh: Optional[tp_mod.TPMesh] = None,
    ):
        self.device = eval_device(model, device)
        self.tp_mesh = tp_mesh
        self.group = tp_mesh.data if tp_mesh is not None else group
        self.process_index, self.process_count = process_index(), process_count()
        self.data_rank = group_rank_size(self.group)[0]
        if tp_mesh is not None:
            tp_mod.shard_model(model, tp_mesh)
        self.cfg = run_cfg
        self.tc = run_cfg.train
        self.mc = run_cfg.model
        self.model = model
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.vocab = vocab
        self.dc = dataset_config
        self.corpus_annotations = corpus_annotations
        self.stamp = stamp
        self.start_epoch = 0
        self.eval_on_train = eval_on_train
        self.meteor_jar = meteor_jar
        self.train_eval_loader = train_eval_loader
        self.train_eval_dataset = train_eval_dataset
        self.train_corpus_annotations = train_corpus_annotations

        self.root = os.path.join(run_cfg.output_dir, stamp)
        self.logger = RunLogger(self.root) if self.process_index == 0 else _NullLogger()
        self.ckpt = AsyncCheckpointer()
        self.optimizer, self.scheduler = make_optimizer(model, self.tc, len(train_loader))
        self.train_step = make_train_step(self.mc, self.tc, self.optimizer, self.device,
                                          self.scheduler, group=self.group)
        self.eval_step = make_eval_step(self.mc, self.device)

        self.best = {"epoch": 0, **{k: -float("inf") for k in CAPTION_METRICS},
                     "sum": -float("inf")}
        self.global_iter = 0
        self.timing = {"fetch": [], "step": [], "val": []}

    # ------------------------------------------------------------------
    def bn_momentum(self, epoch: int) -> float:
        if not self.tc.no_caption:
            return 0.1  # torch default; only detection pretraining schedules it
        m = BN_MOMENTUM_INIT * (self.tc.bn_decay_rate ** (epoch // self.tc.bn_decay_step))
        return max(m, BN_MOMENTUM_MAX)

    def dropout_generator(self, global_iter: int) -> torch.Generator:
        return dropout_generator(self.device, self.tc.seed, global_iter, self.data_rank)

    def _save(self, name: str, epoch: int):
        model_sd, opt_sd = self.model.state_dict(), self.optimizer.state_dict()
        if self.tp_mesh is not None:
            # a collective: every rank gathers before rank 0 writes
            model_sd = tp_mod.gather_state_dict(model_sd, self.tp_mesh, self.model.tp_specs)
            opt_sd = tp_mod.gather_optimizer_state(self.optimizer, self.model, self.tp_mesh)
        if self.process_index != 0:
            return
        payload = {
            "epoch": epoch,
            "iter": self.global_iter,
            "model_state_dict": model_sd,
            "optimizer_state_dict": opt_sd,
            "scheduler_state_dict": (None if self.scheduler is None
                                     else self.scheduler.state_dict()),
            "best": dict(self.best),
        }
        self.ckpt.save(os.path.join(self.root, name), payload)

    def restore(self, path: str):
        """Resumes from a port checkpoint, or from one the JAX package wrote
        (parameters, BN state, Adam moments, step, iter, epoch and best)."""
        if is_jax_checkpoint(path):
            payload = payload_from_jax(load_jax_checkpoint(path), self.model, self.optimizer,
                                       self.scheduler, self.tc.no_detection)
        else:
            payload = load_checkpoint(path)
        model_sd, opt_sd = payload["model_state_dict"], payload["optimizer_state_dict"]
        if self.tp_mesh is not None:
            model_sd = tp_mod.shard_state_dict(model_sd, self.tp_mesh, self.model.tp_specs)
            opt_sd = tp_mod.shard_optimizer_state(opt_sd, self.optimizer, self.model,
                                                  self.tp_mesh)
        self.model.load_state_dict(model_sd)
        # the optimizer's own kind (capturable on CUDA, plain on the CPU)
        # whatever kind wrote the state; new state tensors recapture
        load_optimizer_state(self.optimizer, opt_sd)
        if self.scheduler is not None:
            self.scheduler.load_state_dict(payload["scheduler_state_dict"])
        # native types for json.dump in dump_scalars and best.json
        self.best = {k: int(v) if k == "epoch" else float(v)
                     for k, v in payload["best"].items()}
        self.global_iter = int(payload["iter"])
        self.start_epoch = int(payload["epoch"]) + 1

    # ------------------------------------------------------------------
    def profile(self, num_steps: int = 5):
        """A torch.profiler trace of ``num_steps`` train steps (real
        updates) into <run>/profile/trace.json, one warm-up step outside it
        (on CUDA that step also captures the train graph, so the trace holds
        its replays) (the port's counterpart of the reference's wall-clock telemetry,
        lib/solver.py:464-505). View it in chrome://tracing or Perfetto."""
        from torch.profiler import ProfilerActivity, profile

        trace_dir = os.path.join(self.root, "profile")
        batch = next(iter(self.train_loader))
        self.train_step(self.model, batch, self.dropout_generator(0), 0.1)
        synchronize(self.device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for i in range(num_steps):
                self.train_step(self.model, batch, self.dropout_generator(i + 1), 0.1)
            synchronize(self.device)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        self.logger.log(f"profiler trace written to {trace_dir}")
        return trace_dir

    # ------------------------------------------------------------------
    def __call__(self, epochs: int, verbose: int = 1000):
        total_iters = len(self.train_loader) * epochs
        t_start = time.time()
        try:
            for epoch in range(self.start_epoch, epochs):
                self.logger.log(f"epoch {epoch + 1} starting...")
                self._feed_epoch(epoch, self.bn_momentum(epoch), verbose, total_iters, t_start)
                if (epoch + 1) % self.tc.ckpt_every == 0 or epoch == epochs - 1:
                    self._save("model_last.ckpt", epoch)
        except KeyboardInterrupt:
            self.logger.log("interrupted; saving previous-epoch snapshot...")
            self.ckpt.wait()
            self.logger.dump_scalars()
            raise
        self.ckpt.wait()
        self._finish()

    def _feed_epoch(self, epoch, momentum, verbose, total_iters, t_start):
        # pin the loader's shuffle epoch to the true epoch index, so that a
        # --use_checkpoint restart sees the batch order an uninterrupted run
        # would (the loader otherwise counts its own __iter__ calls from 0)
        self.train_loader.epoch = epoch
        sample_every = max(1, min(verbose, 50))
        epoch_fetch, epoch_step = [], []
        epoch_t0 = time.time()
        n_iters = 0
        fetch_t0 = time.time()
        for batch in self.train_loader:
            fetch_time = time.time() - fetch_t0
            gen = self.dropout_generator(self.global_iter)
            sampled = self.global_iter % sample_every == 0
            if sampled:
                synchronize(self.device)
            t0 = time.time()
            metrics = self.train_step(self.model, batch, gen, momentum)
            if sampled:
                synchronize(self.device)
                step_time = time.time() - t0
                epoch_step.append(step_time)
                self.timing["step"].append(step_time)
            if (self.global_iter + 1) % verbose == 0 or self.global_iter == 0:
                metrics = {k: v.item() for k, v in metrics.items()}
                step_time = time.time() - t0
                self._report(epoch, metrics, fetch_time, step_time, total_iters, t_start)
                for k, v in metrics.items():
                    self.logger.scalar("train", k, v, self.global_iter)
            epoch_fetch.append(fetch_time)
            self.timing["fetch"].append(fetch_time)

            self.global_iter += 1
            n_iters += 1
            if self.tc.val_step and self.global_iter % self.tc.val_step == 0:
                self._validate(epoch)
            fetch_t0 = time.time()
        epoch_wall = time.time() - epoch_t0
        if n_iters:
            mean_fetch = float(np.mean(epoch_fetch)) * 1000
            mean_step = float(np.mean(epoch_step)) * 1000 if epoch_step else 0.0
            self.logger.log(
                f"epoch {epoch + 1} done | {n_iters} iters in "
                f"{epoch_wall:.1f}s ({epoch_wall / n_iters * 1000:.0f}ms/iter) "
                f"| mean fetch {mean_fetch:.0f}ms | mean step {mean_step:.0f}ms "
                f"(synchronised, {len(epoch_step)} samples)")
            self.logger.scalar("train", "mean_fetch_ms", mean_fetch, self.global_iter)
            self.logger.scalar("train", "mean_step_ms", mean_step, self.global_iter)

    def _report(self, epoch, metrics, fetch_time, step_time, total_iters, t_start):
        done = max(self.global_iter, 1)
        eta = decode_eta((time.time() - t_start) / done * (total_iters - done))
        parts = [f"epoch {epoch + 1} iter {self.global_iter}/{total_iters}"]
        for k in ("loss", "det_loss", "cap_loss", "relation_loss", "cap_acc", "obj_acc"):
            if k in metrics:
                parts.append(f"{k} {metrics[k]:.4f}")
        parts.append(f"fetch {fetch_time * 1000:.0f}ms step {step_time * 1000:.0f}ms")
        parts.append(f"eta {eta['h']}h{eta['m']}m")
        self.logger.log(" | ".join(parts))

    # ------------------------------------------------------------------
    def _validate(self, epoch):
        if self.tc.no_caption or self.val_loader is None:
            return
        t0 = time.perf_counter()
        # pin the val (and eval-on-train) loaders' subsample epoch to the
        # validation count, derived from global_iter, so that a restart
        # validates on the subsamples an uninterrupted run would
        if self.tc.val_step:
            val_idx = max(0, self.global_iter // self.tc.val_step - 1)
            for loader in (self.val_loader, self.train_eval_loader):
                if loader is not None:
                    loader.epoch = val_idx
        if self.eval_on_train and self.train_eval_loader is not None:
            self.logger.log("evaluating on train split...")
            train_metrics, _ = eval_cap(
                self.eval_step, self.model, self.train_eval_dataset, self.train_eval_loader,
                self.vocab, self.dc, self.train_corpus_annotations,
                corpus_cache=self._own_file("corpus_train.json"),
                pred_path=self._own_file("pred_train.json"),
                meteor_jar=self.meteor_jar, device=self.device)
            for k, v in train_metrics.items():
                if isinstance(v, (int, float)):
                    self.logger.scalar("train", f"eval_{k}", v, self.global_iter)
        self.logger.log("validating...")
        metrics, _ = eval_cap(
            self.eval_step, self.model, self.val_dataset, self.val_loader, self.vocab, self.dc,
            self.corpus_annotations,
            corpus_cache=self._own_file("corpus_val.json"),
            pred_path=self._own_file("pred_val.json"),
            meteor_jar=self.meteor_jar, device=self.device)
        program = getattr(self.eval_step, "program", None)
        if program is not None:
            # the validation's graphs would hold their memory pools through
            # the training until the next validation: it captures anew (the
            # train step's graph stays)
            program.clear()
        if self.process_count > 1:
            # every rank scores the same captions, but a METEOR stage that
            # differs between hosts, or any rounding, could set one apart,
            # and a save under TP is a collective: rank 0's scores decide
            scores = {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}
            metrics = {**metrics, **allgather_pyobj(scores)[0]}
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.logger.scalar("val", k, v, self.global_iter)
        crit = self.tc.criterion
        total = sum(metrics[k] for k in SUM_METRICS)
        cur = total if crit == "sum" else metrics[crit]
        self.logger.log("val: " + " ".join(f"{k}={metrics[k]:.4f}" for k in SUM_METRICS))
        if cur > self.best[crit]:
            self.logger.log(f"new best {crit}: {cur:.4f} (epoch {epoch + 1})")
            self.best.update({k: metrics.get(k, self.best.get(k)) for k in CAPTION_METRICS})
            self.best["epoch"] = epoch + 1
            self.best["sum"] = total
            self._save("model.ckpt", epoch)
        self.timing["val"].append(time.perf_counter() - t0)

    def _own_file(self, name: str) -> Optional[str]:
        """``name`` under the run directory on rank 0, which owns the files;
        None elsewhere."""
        return os.path.join(self.root, name) if self.process_index == 0 else None

    def _finish(self):
        if self.process_index != 0:
            self.logger.close()
            return
        with open(os.path.join(self.root, "best.txt"), "w") as f:
            for k, v in self.best.items():
                f.write(f"{k}: {v}\n")
        self.logger.write_json("best.json", self.best)
        self.logger.close()
