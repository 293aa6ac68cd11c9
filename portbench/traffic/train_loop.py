"""The train CLI's loop: ``train/solver.py::Solver._feed_epoch`` over a
train feed into the captured ``make_train_step``, B scenes a step, dropout
at the configuration's rate, no validation in the window.

Params: ``scenes`` and ``anns_per_object`` (the train split), ``scene``
(the synthetic scene's sizes), ``feed``: "loader" (the program's
``DataLoader`` with ``num_workers`` threads over ``ScanReferDataset``,
augmentation and relations on) or "held" (``held_batches`` batches built
once in set-up by the reference's item builder and cycled, bypassing the
loader and the dataset), ``check_steps`` (the steps the reference
follows, run in set-up through the window's own call and feed),
``trace_steps`` (the steps a traced run profiles, after ``trace_after``
steps of the window).

Set-up first calls the step once on the first check batch, which captures
the train graph (a captured step's first call runs eagerly), then puts the
weights, the batch-norm statistics and Adam's state back in place, at the
addresses the graph reads; so the check steps, which follow through the
window's call and feed, are replays of that graph, as every window step
is. The window takes batches until ``--seconds`` have passed; a CUDA event
is recorded after each step call, without synchronisation, and read once
the window has closed."""
from __future__ import annotations

import itertools
import time
from typing import Dict

import numpy as np
import torch

from portbench import counts, synthetic, weights
from portbench.reference import train_check
from portbench.trace import Window


class Feed:
    """The loop's train loader: ``source`` batches until the window's
    deadline, with the host wait of each ``next`` timed."""

    def __init__(self, source, size: int, ctx):
        self.source, self.size, self.ctx = source, size, ctx
        self.deadline = None
        self.waits = []

    def __len__(self):
        return self.size

    @property
    def epoch(self):
        return getattr(self.source, "epoch", 0)

    @epoch.setter
    def epoch(self, value):
        if hasattr(self.source, "epoch"):
            self.source.epoch = value

    def __iter__(self):
        it = iter(self.source)
        try:
            while self.deadline is None or time.perf_counter() < self.deadline:
                t0 = time.perf_counter()
                with self.ctx.spans("next(loader)"):
                    batch = next(it, None)
                if batch is None:
                    return
                if self.deadline is not None:
                    self.waits.append(time.perf_counter() - t0)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


class Held:
    """Host batches cycled, in place of the loader."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return itertools.cycle(self.batches)


def restore(model, optimizer, state0: Dict[str, torch.Tensor]) -> None:
    """Puts the model's weights and batch-norm statistics back to
    ``state0`` and Adam's moments and step counts to zero, in place: the
    tensors keep their addresses, so a captured step replays over them."""
    with torch.no_grad():
        model.load_state_dict(state0)
        for st in optimizer.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    v.zero_()


def run(ctx) -> Dict:
    from spacap3d_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig
    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, Scene
    from spacap3d_tpu_torch.data.loader import DataLoader
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import Vocabulary
    from spacap3d_tpu_torch.models.spacap import SpaCapNet
    from spacap3d_tpu_torch.train.solver import Solver

    p, conf, dev = ctx.params, ctx.config, ctx.device
    mfields = ctx.model_kwargs()
    cfg = ModelConfig(**mfields)
    batch = conf["train"]["batch_size"]
    tfields = {k: tuple(v) if isinstance(v, list) else v for k, v in dict(
        conf["train"], seed=synthetic.seed32(ctx.seed, 3), val_step=0, verbose=10 ** 9).items()}
    tc = TrainConfig(**tfields)
    data = dict(conf["data"])
    dcfg = DataConfig(**data)

    scenes, anns = synthetic.make_split(ctx.seed, p["scenes"], p["anns_per_object"], p["scene"],
                                        mfields["vocab_size"], multiview=dcfg.use_multiview)
    vocab = Vocabulary(*synthetic.vocabulary(mfields["vocab_size"]))
    ds = ScanReferDataset(anns, synthetic.store(Scene, scenes), vocab, ScannetDatasetConfig(),
                          dcfg, split="train")
    loader_seed = synthetic.seed32(ctx.seed, 4)
    steps_per_epoch = len(ds) // batch
    ref_ds = train_check.dataset(scenes, anns, mfields["vocab_size"], data)
    if p["feed"] == "held":
        held = train_check.held_batches(ref_ds, batch, loader_seed, p["held_batches"])
        source, warm = Held(held), held[0]
    else:
        held = None
        source = DataLoader(ds, batch, shuffle=True, seed=loader_seed,
                            num_workers=dcfg.num_workers)
        warm = train_check.loader_batches(ref_ds, batch, loader_seed, 1)[0]
    feed = Feed(source, steps_per_epoch, ctx)

    state0 = weights.make_state(cfg, synthetic.seed32(ctx.seed, 5), dev)
    model = SpaCapNet(cfg).to(dev)
    model.load_state_dict(state0)
    solver = Solver(RunConfig(model=cfg, train=tc, data=dcfg, output_dir=ctx.tmp, tag="bench"),
                    model, feed, None, ds, None, vocab, ScannetDatasetConfig(), anns, "run",
                    device=dev)
    inner = solver.train_step
    # the first call captures; the check steps that follow must replay
    inner(model, warm, solver.dropout_generator(0), solver.bn_momentum(0))
    restore(model, solver.optimizer, state0)
    check_steps, prog = p["check_steps"], {"loss": []}
    win = {"steps": 0, "events": [], "start": None, "traced": 0}
    tracer = Window() if ctx.trace and dev.type == "cuda" else None

    def step(model_, batch_, gen, momentum):
        k = len(prog["loss"]) if win["start"] is None else None
        if k is not None:
            with ctx.spans("train_step"):
                metrics = inner(model_, batch_, gen, momentum)
            if inner.program is not None and inner.program.last.get("captured", True):
                raise RuntimeError(f"check step {k + 1} captured: the steps the reference "
                                   "follows must be replays of the window's graph")
            prog["loss"].append(float(metrics["loss"]))
            if k == 0:
                prog["grad"] = train_check.adam_grads(model, solver.optimizer)
            if k == check_steps - 1:
                prog["change"] = train_check.changes(model, state0)
                ctx.sync()
                win["start"] = ctx.window_start()
                feed.deadline = win["start"] + ctx.seconds
                if dev.type == "cuda":
                    win["events"].append(torch.cuda.Event(enable_timing=True))
                    win["events"][-1].record()
            return metrics
        i = win["steps"]
        if tracer is not None and i == p["trace_after"]:
            tracer.open()
        with ctx.spans("train_step"):
            metrics = inner(model_, batch_, gen, momentum)
        if tracer is not None and p["trace_after"] <= i < p["trace_after"] + p["trace_steps"]:
            win["traced"] += 1
            if win["traced"] == p["trace_steps"]:
                tracer.close()
        if dev.type == "cuda":
            win["events"].append(torch.cuda.Event(enable_timing=True))
            win["events"][-1].record()
        win["steps"] += 1
        return metrics

    solver.train_step = step
    solver._feed_epoch(0, solver.bn_momentum(0), tc.verbose, steps_per_epoch, time.time())
    ctx.sync()
    t_end = time.perf_counter()
    if tracer is not None and tracer.prof is not None:
        tracer.close()
    if len(prog["loss"]) < check_steps or (win["steps"] == 0 and ctx.seconds > 0):
        raise RuntimeError(f"the loop ended after {len(prog['loss'])} set-up steps and "
                           f"{win['steps']} window steps")
    window_s = max(t_end - win["start"], 1e-9)
    intervals = [a.elapsed_time(b) for a, b in zip(win["events"], win["events"][1:])]
    end_to_end = {"train_scenes_per_s": win["steps"] * batch / window_s,
                  "peak_reserved_gib": ctx.peak_reserved() / 2 ** 30}
    if intervals:
        end_to_end["train_step_p95_ms"] = float(np.percentile(intervals, 95))
    record = {"kind": "train", "steps": win["steps"], "window_s": window_s,
              "loader_wait_s": feed.waits if p["feed"] == "loader" else None,
              "trace": ctx.reduce(tracer), "traced_steps": win["traced"],
              "ideal_step_s": counts.ideal_seconds(counts.train_step_parts(mfields, batch)),
              "fps_bound_s": counts.fps_bound_seconds(mfields, batch),
              "bq_bound_s": counts.ball_query_bound_seconds(mfields, batch)}
    first = (train_check.loader_batches(ref_ds, batch, loader_seed, check_steps)
             if held is None else held[:check_steps])
    del solver, model, inner, feed, source, ds, ref_ds

    def check(precision="float32", fault=None):
        """The numbers compared: of the program's readings, or of the
        control ("control": the reference in TF32) or a fault planted in
        the reference put in the program's place ("half", "stale")."""
        ref = train_check.follow(mfields, tfields, first, state0, dev, check_steps)
        got = prog
        if precision != "float32" or fault is not None:
            got = train_check.follow(mfields, tfields, first, state0, dev, check_steps,
                                     precision="tf32" if precision == "control" else precision,
                                     fault=fault)
        return train_check.compare(got, ref)

    return {"attempted": win["steps"] + check_steps, "failed": 0, "end_to_end": end_to_end,
            "record": record, "check": check}
