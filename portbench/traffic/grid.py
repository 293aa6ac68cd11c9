"""The user's multi-seed ``mul_eval``: ``eval/mul_eval.py::mul_eval_grid``
with the compact captured ``make_eval_step``, point tables ``auto``,
detection on, and the grid's own worker counts.

Params: ``scenes`` (the val split: one annotation a scene enters the grid,
all of them the caption corpus), ``anns_per_object``, ``scene`` (the
synthetic scene's sizes), ``seeds_per_call`` (seeds a grid call covers),
``objectness_bias`` (added to the random weights' objectness logit, so
that detections reach the post-processing; PERF.md gives the detections a
scene row it yields), ``check_forwards`` (forwards
of the window's first call whose outputs the reference judges, drawn
from the seed; the reference also post-processes and scores every
forward of that call and compares the rows), ``trace_after`` and ``trace_forwards`` (the forwards of the
window's first call that a traced run profiles).

Set-up runs one grid call over one seed, which captures the eval graph.
The window repeats calls, each over new seeds, until ``--seconds`` have
passed; every call that starts in the window is counted whole, and the
window ends when the last one returns."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import counts, synthetic, weights
from portbench.reference import grid_check, grid_rows
from portbench.trace import Window


def run(ctx) -> Dict:
    from spacap3d_tpu_torch.config import DataConfig, ModelConfig
    from spacap3d_tpu_torch.data.dataset import ScanReferDataset, Scene
    from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from spacap3d_tpu_torch.data.vocabulary import Vocabulary
    from spacap3d_tpu_torch.eval.eval_helper import organize_annotations, prepare_corpus
    from spacap3d_tpu_torch.eval.mul_eval import mul_eval_grid
    from spacap3d_tpu_torch.models.spacap import SpaCapNet
    from spacap3d_tpu_torch.train.step import make_eval_step

    p, conf, dev = ctx.params, ctx.config, ctx.device
    mfields = ctx.model_kwargs()
    cfg = ModelConfig(**mfields)
    batch = conf["train"]["batch_size"]
    data = dict(conf["data"], augment=False, use_relation=False)
    scenes, anns = synthetic.make_split(ctx.seed, p["scenes"], p["anns_per_object"], p["scene"],
                                        cfg.vocab_size, multiview=data["use_multiview"])
    seen, eval_list = set(), []
    for a in anns:
        if a["scene_id"] not in seen:
            seen.add(a["scene_id"])
            eval_list.append(a)
    vocab = Vocabulary(*synthetic.vocabulary(cfg.vocab_size))
    dc = ScannetDatasetConfig()
    ds = ScanReferDataset(eval_list, synthetic.store(Scene, scenes), vocab, dc,
                          DataConfig(**data), split="val")
    corpus, organized = prepare_corpus(anns), organize_annotations(anns)
    state0 = weights.make_state(cfg, synthetic.seed32(ctx.seed, 5), dev,
                                objectness_bias=p["objectness_bias"])
    model = SpaCapNet(cfg).to(dev).eval()
    model.load_state_dict(state0)
    inner = make_eval_step(cfg, dev, compact=True)

    rng = np.random.RandomState(synthetic.seed32(ctx.seed, 6))
    n_forwards = len(grid_check.grid_pairs(range(p["seeds_per_call"]), len(ds), batch)) // batch
    sampled = set(rng.choice(n_forwards, p["check_forwards"], replace=False).tolist())
    sampled.add(n_forwards - 1)
    state = {"call": -1, "forward": 0, "samples": [], "traced": 0, "outputs": []}
    tracer = Window() if ctx.trace and dev.type == "cuda" else None
    lo, hi = p["trace_after"], p["trace_after"] + p["trace_forwards"]

    def step(model_, batch_):
        f = state["forward"]
        state["forward"] += 1
        first = state["call"] == 0
        if first and tracer is not None and f == lo:
            tracer.open()
        with ctx.spans("grid.forward"):
            out = inner(model_, batch_)
        if first:
            state["outputs"].append(out)
        if first and f in sampled:
            state["samples"].append((f, out))
        if first and tracer is not None and lo <= f < hi:
            state["traced"] += 1
            if f == hi - 1:
                tracer.close()
        return out

    def call(seeds, timing):
        with ctx.spans("grid.call"):
            return mul_eval_grid(step, model, ds, vocab, dc, corpus, organized, seeds, batch,
                                 also_detection=True, timing_out=timing, device=dev,
                                 wordnet_dir="")

    base = synthetic.seed32(ctx.seed, 7) % (2 ** 20)
    call([base], {})
    ctx.sync()
    t0 = ctx.window_start()
    timings, calls, rows, first_rows = [], [], 0, None
    while not calls or time.perf_counter() < t0 + ctx.seconds:
        state["call"], state["forward"] = len(calls), 0
        seeds = [base + 1 + len(calls) * p["seeds_per_call"] + j
                 for j in range(p["seeds_per_call"])]
        timings.append({})
        result = call(seeds, timings[-1])
        if len(result) != len(seeds):
            raise RuntimeError(f"a grid call over {len(seeds)} seeds gave {len(result)} rows")
        calls.append(seeds)
        first_rows = first_rows or result
        rows += len(seeds) * len(ds)
    ctx.sync()
    window_s = time.perf_counter() - t0
    if tracer is not None and tracer.prof is not None:
        tracer.close()
    end_to_end = {"eval_scenes_per_s": rows / window_s,
                  "peak_reserved_gib": ctx.peak_reserved() / 2 ** 30}
    record = {"kind": "grid", "calls": len(calls), "rows": rows, "window_s": window_s,
              "timing": timings, "trace": ctx.reduce(tracer),
              "traced_forwards": state["traced"],
              "ideal_forward_s": counts.ideal_seconds(counts.eval_forward_parts(mfields, batch)),
              "fps_bound_s": counts.fps_bound_seconds(mfields, batch),
              "bq_bound_s": counts.ball_query_bound_seconds(mfields, batch)}
    pairs = grid_check.grid_pairs(calls[0], len(ds), batch)
    samples = [(pairs[f * batch:(f + 1) * batch], out) for f, out in sorted(
        state["samples"], key=lambda s: s[0])]
    outputs = state["outputs"]
    del model, inner, ds, state
    reference_rows, kept = [], []

    def check(precision="float32", fault=None):
        """The numbers compared: of the program's outputs and rows, or of
        the control ("control": the reference's forward in TF32, its decode
        with fp8 weights, in place of the sampled forwards) or a fault
        planted in the outputs ("half": half of each batch's rows zeroed;
        "token": every served token altered) or in the rows ("score": a
        score altered). Read beside them, not compared: the program's
        detections and matched boxes a scene row in the first call."""
        if not reference_rows:
            reference_rows.extend(grid_rows.rows(data, scenes, eval_list, anns, cfg.vocab_size,
                                                 calls[0], outputs, batch, kept))
        got_rows = first_rows
        if fault == "score":
            got_rows = [dict(r, cider=r["cider"] + 1e-3) for r in first_rows]
        got = samples
        if fault == "half":
            got = [(rows_, dict(out, **{k: torch.cat([out[k][:len(out[k]) // 2],
                                                      torch.zeros_like(out[k][len(out[k]) // 2:])])
                                        for k in grid_check.DET_KEYS}))
                   for rows_, out in samples]
        elif fault == "token":
            got = [(rows_, dict(out, lang_cap=(out["lang_cap"].long() + 1).clamp_max(
                cfg.vocab_size - 1).to(out["lang_cap"].dtype))) for rows_, out in samples]
        return dict(grid_check.judge(mfields, data, scenes, eval_list, state0, got, dev,
                                     control=precision == "control"),
                    rows_gap=grid_rows.rows_gap(got_rows, reference_rows),
                    detections_per_scene=float(np.mean([d for d, _ in kept])),
                    matched_per_scene=float(np.mean([m for _, m in kept])))

    return {"attempted": rows, "failed": 0, "end_to_end": end_to_end, "record": record,
            "check": check}
