"""Multi-seed evaluation as one stream of (seed, scene) rows, as
``spacap3d_tpu/eval/mul_eval.py``.

The reference's ``--mul_eval`` runs 100 seeds serially, and per seed runs
the full detector twice over the val split (caption eval + detection
eval, scripts/eval.py:446-478). Here the seed x scene grid is flattened
into a single stream of rows: each row is one scene preprocessed with
that seed's RNG (the protocol's only per-seed difference is the random
40k-point subsample). Rows are batched, so every batch is full however
141 scenes divide; one forward produces both the caption and the
detection outputs; and the host post-processing (NMS, IoU match, caption
decode) of batch i, on a thread pool, overlaps the forward of batch i+1,
which the main thread launches meanwhile (the forward queues its kernels
on the device and returns). Each thread pool worker copies its batch's
outputs to the host (``.cpu()``), which blocks that worker only.

Per-seed metrics come out in the reference CSV layout; each seed is
scored on a thread pool as soon as its last row is in.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spacap3d_tpu_torch.config import EVAL_MIN_IOU
from spacap3d_tpu_torch.data.loader import stack_batch
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.data.vocabulary import Vocabulary
from spacap3d_tpu_torch.eval import capeval
from spacap3d_tpu_torch.eval.detection import APCalculator
from spacap3d_tpu_torch.eval.eval_helper import (
    POST_DICT_DEFAULTS,
    caption_metrics,
    check_candidates,
    eval_device,
    fetch_outputs,
    organize_candidates,
    postprocess_batch,
    resolve_winning_proposals,
)
from spacap3d_tpu_torch.train.step import EVAL_INPUT_KEYS, to_device_batch
from spacap3d_tpu_torch.utils import trace

# batches whose outputs wait for the host at most; the main thread stops
# launching forwards beyond this
MAX_IN_FLIGHT = 8
# the host batch keys post-processing reads, besides the step's inputs
HOST_KEYS = ("dataset_idx", "scene_object_ids", "gt_box_corner_label",
             "box_label_mask", "sem_cls_label")


def _cached_items_ok(dataset) -> bool:
    """Whether ``dataset`` serves the cached val-item path
    (``getitem_cached``: non-augmented, non-train)."""
    return not (getattr(dataset, "getitem_cached", None) is None
                or getattr(dataset.cfg, "augment", False)
                or getattr(dataset, "split", "val") == "train")


class GridLoader:
    """Iterates the flattened (seed x dataset item) grid in fixed-size
    batches. Every item is built with an RNG keyed by (seed, idx) — the
    per-seed independent point subsample the mul_eval protocol requires
    (the reference reseeds the global numpy RNG per seed,
    scripts/eval.py:456-460). Emits ``__seed__`` and ``__valid__`` row
    vectors; the final batch wraps (padded rows are marked invalid).
    ``keys`` restricts which item leaves are stacked into batches."""

    def __init__(self, dataset, seeds: Sequence[int], batch_size: int,
                 num_workers: int = 8, prefetch: int = 4,
                 keys: Optional[Sequence[str]] = None,
                 indices_mode: bool = False):
        self.dataset = dataset
        self.seeds = list(seeds)
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.keys = keys
        # indices_mode: items carry `pc_choices` (the per-seed subsample
        # indices) instead of `point_clouds` — the device-resident
        # point-table path (requires the cached val-item getter)
        self.indices_mode = indices_mode

    def __len__(self):
        n = len(self.seeds) * len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        grid = np.array(
            [(s, i) for s in self.seeds for i in range(len(self.dataset))],
            dtype=np.int64,
        )
        n = grid.shape[0]
        valid = np.ones(n, bool)
        if n % self.batch_size:
            pad = self.batch_size - n % self.batch_size
            # cycled, so that a grid shorter than the pad fills it too (a
            # rank's share of the seeds over a small split)
            grid = np.concatenate([grid, np.resize(grid, (pad, 2))])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        return grid, valid

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        grid, valid = self._pairs()
        batches = grid.reshape(-1, self.batch_size, 2)
        valid = valid.reshape(-1, self.batch_size)

        # the cached fast path (per-scene features built once, only the
        # point subsample per seed) is bit-identical to __getitem__ for
        # non-augmented val items
        if _cached_items_ok(self.dataset):
            getter = self.dataset.getitem_cached
        elif self.indices_mode:
            raise ValueError("GridLoader(indices_mode=True) requires the cached "
                             "val-item path (non-augmented, non-train dataset)")
        else:
            getter = self.dataset.__getitem__
        indices_mode = self.indices_mode

        def build_item(pair):
            seed, idx = int(pair[0]), int(pair[1])
            # same key schedule as DataLoader (epoch 0) so grid-mode rows
            # are bit-identical to the serial per-seed path
            rng = np.random.RandomState((seed * 2654435761 + idx) % (2 ** 31))
            if indices_mode:
                return getter(idx, rng=rng, with_points=False)
            return getter(idx, rng=rng)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(batches.shape[0]):
                    if stop.is_set():
                        break
                    items = list(pool.map(build_item, batches[b]))
                    batch = stack_batch(items, keys=self.keys)
                    batch["__seed__"] = batches[b, :, 0].copy()
                    batch["__valid__"] = valid[b].copy()
                    q.put(batch)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()


def _build_point_tables(dataset, device: torch.device, budget: Optional[int] = None):
    """Device-resident per-scene tables for the indices-mode grid stream.

    Returns ``(point_table, center_table, row_of_idx)`` — the padded
    (num_scenes, N_max, C) float32 cloud table and the (num_scenes, M, 3)
    GT-centre table, both on ``device``, and the item-index -> scene-row
    map — or ``None`` when the dataset can't use the cached val-item path
    or the padded table would exceed the device-memory budget
    (``SPACAP_POINT_TABLE_BYTES``, default 4 GiB).

    Both tables are keyed by unique scene: the full cloud and
    ``center_label`` are functions of the scene alone on non-augmented
    val items. They are uploaded once; thereafter each grid row ships
    only its subsample indices (uint16 for scenes of at most 65,535
    points), about 8x fewer bytes than its 40k x C f32 cloud."""
    if not _cached_items_ok(dataset) or len(dataset) == 0:
        return None
    if budget is None:
        budget = int(os.environ.get("SPACAP_POINT_TABLE_BYTES", 4 << 30))

    scene_ids = [dataset.annotations[i]["scene_id"] for i in range(len(dataset))]
    first_idx: Dict[str, int] = {}
    for i, sid in enumerate(scene_ids):
        first_idx.setdefault(sid, i)
    uniq = list(first_idx)
    row_of_scene = {sid: r for r, sid in enumerate(uniq)}
    row_of_idx = np.array([row_of_scene[s] for s in scene_ids], np.int32)

    clouds = [dataset.full_cloud_f32(first_idx[sid]) for sid in uniq]
    n_max = max(c.shape[0] for c in clouds)
    channels = clouds[0].shape[1]
    if len(uniq) * n_max * channels * 4 > budget:
        return None
    table = np.zeros((len(uniq), n_max, channels), np.float32)
    centers = None
    for r, (sid, c) in enumerate(zip(uniq, clouds)):
        table[r, :c.shape[0]] = c
        tmpl = dataset.getitem_cached(first_idx[sid], np.random.RandomState(0),
                                      with_points=False)
        if centers is None:
            centers = np.zeros((len(uniq),) + tmpl["center_label"].shape, np.float32)
        centers[r] = tmpl["center_label"]
    return (torch.from_numpy(table).to(device), torch.from_numpy(centers).to(device),
            row_of_idx)


def _score_seed(args):
    """One seed's full scoring (capeval + detection AP). Runs on a thread
    pool overlapped with the stream: the grid is seed-major, so a seed's
    candidate set is complete long before the stream ends. The METEOR
    scorer is one shared object (one jar process when a jar is present,
    whose lock serializes the stdio protocol across pool threads)."""
    corpus, candidates, meteor_scorer, ap_state, class2type, cider_refs = args
    candidates = check_candidates(corpus, dict(candidates))
    candidates = organize_candidates(corpus, candidates)
    metrics = caption_metrics(
        capeval.Bleu(4).compute_score(corpus, candidates),
        capeval.Cider(refs=cider_refs).compute_score(corpus, candidates),
        capeval.Rouge().compute_score(corpus, candidates),
        meteor_scorer.compute_score(corpus, candidates),
    )
    if ap_state is not None:
        calc = APCalculator(0.5, class2type)
        calc.pred_map_cls, calc.gt_map_cls = ap_state
        calc.scan_cnt = len(ap_state[0])
        det = calc.compute_metrics(num_workers=1)
        metrics["mAP@0.5"] = det["mAP"]
        metrics["AR@0.5"] = det["AR"]
    return metrics


def mul_eval_grid(
    step, model,
    dataset, vocab: Vocabulary, dc: ScannetDatasetConfig,
    corpus: Dict, organized: Dict,
    seeds: Sequence[int],
    batch_size: int,
    min_iou: float = EVAL_MIN_IOU,
    also_detection: bool = True,
    meteor_jar: Optional[str] = None,
    num_workers: int = 8,
    score_workers: int = 8,
    timing_out: Optional[Dict] = None,
    point_table: str = "auto",
    device="cuda",
    progress: Optional[Callable[[int, int], None]] = None,
    wordnet_dir: Optional[str] = None,
) -> List[Dict]:
    """Returns one metrics row per seed (reference CSV layout), running
    ``step(model, batch)`` (``make_eval_step``; the compact step fetches
    the fewest bytes) on ``device`` (the model must sit there).

    ``timing_out``: optional dict filled with phase wall-clocks in
    seconds: 'table_s' (one-time point-table build and upload),
    'stream_s' (loader, forwards and post-processing, overlapped),
    'score_s' (the scoring tail after the stream); the stream's
    main-thread share: 'load_s' (waiting for the loader's next batch),
    'launch_s' (uploading a batch and launching its forward: host time
    that consume threads holding the interpreter lock stretch), with
    'forwards' the number of forwards; and the consume threads' time
    summed over threads, 'consume_s', split into 'fetch_s' (copying a
    batch's outputs to the host, which waits for its forward), 'post_s'
    (host numpy, NMS, IoU and decode work, without the lock) and
    'lock_s' (waiting for and holding the shared bookkeeping lock).
    The same clock reads make spans (``utils/trace.py``): a forward's
    upload and launch are a ``grid.launch`` span on the main thread, and
    its outputs' consumption a ``grid.consume`` span on a consume thread,
    whose parts are ``grid.fetch``, ``grid.post`` and ``grid.lock``; their
    request is the forward's index.

    ``point_table``: 'auto' (default) keeps the per-scene clouds on the
    device and ships only the subsample indices a row (falling back to
    per-row cloud upload when the dataset can't use the cached val path or
    the table exceeds the budget); 'off' forces the per-row upload. Rows
    are bit-identical either way (the f64->f32 cast and the row select
    commute elementwise).

    ``progress(i, n)`` is called after the i-th of the grid's n batches is
    launched. ``wordnet_dir`` goes to METEOR's synonym stage (None: locate
    a dictionary; "": off)."""
    if point_table not in ("auto", "off"):
        raise ValueError(f"point_table={point_table!r}: 'auto' or 'off'")
    dev = eval_device(model, device)
    post = dict(POST_DICT_DEFAULTS, dataset_config=dc)
    candidates: Dict[int, Dict[str, List[str]]] = {s: {} for s in seeds}
    # detection AP is always at IoU 0.5 (min_iou only gates caption
    # matching) — same as feed_scene_cap / the reference protocol
    ap_calcs: Dict[int, APCalculator] = (
        {s: APCalculator(0.5, dc.class2type) for s in seeds} if also_detection else {})
    # each seed's (prediction, GT) by dataset index: AP depends on the order
    # of its scans (ties in confidence), so they enter a seed's calculator in
    # dataset order, as the serial protocol steps them, whichever consume
    # thread finished first
    ap_rows: Dict[int, Dict[int, Tuple]] = {s: {} for s in seeds}

    t0 = time.perf_counter()
    tables = _build_point_tables(dataset, dev) if point_table != "off" else None
    table_s = time.perf_counter() - t0

    # stack only what the step and the host post-processing read; a val
    # item carries ~30 keys (a 1.4 MB all-zero vote_label among them)
    if tables is not None:
        point_tbl, center_tbl, row_of_idx = tables
        grid_keys = sorted({"pc_choices", *HOST_KEYS})
    else:
        grid_keys = sorted({*EVAL_INPUT_KEYS, *HOST_KEYS})
    loader = GridLoader(dataset, seeds, batch_size, num_workers=num_workers,
                        keys=grid_keys, indices_mode=tables is not None)
    lock = threading.Lock()
    spent = dict.fromkeys(("consume_s", "fetch_s", "post_s", "lock_s"), 0.0)
    rows_per_seed = len(dataset)
    seed_done_rows = {s: 0 for s in seeds}
    score_pool = ThreadPoolExecutor(max_workers=max(1, score_workers))
    score_futures: Dict[int, object] = {}
    # reference-side CIDEr state is seed-invariant: build once, reuse in
    # every seed's scoring pass (bit-equal scores — see capeval.CiderRefs)
    cider_refs = capeval.CiderRefs(corpus)
    # one METEOR scorer for the whole run (one jar spawn, not one per seed)
    meteor_scorer = capeval.Meteor(meteor_jar, wordnet_dir=wordnet_dir)

    def submit_seed(seed):
        """Seed complete: score it now, overlapped with the stream."""
        ap_state = None
        if also_detection:
            for idx in sorted(ap_rows[seed]):
                pred, gt = ap_rows[seed].pop(idx)
                ap_calcs[seed].step([pred], [gt])
            ap_state = (ap_calcs[seed].pred_map_cls, ap_calcs[seed].gt_map_cls)
        score_futures[seed] = score_pool.submit(
            _score_seed, (corpus, candidates[seed], meteor_scorer, ap_state, dc.class2type,
                          cider_refs))

    def consume(batch, out, forward):
        marks = [trace.mark()]
        out = fetch_outputs(out)
        marks.append(trace.mark())
        captions = out["lang_cap"]
        row_valid = batch["__valid__"].astype(bool)
        row_seed = batch["__seed__"]
        nms_mask, det_ids, ious, preds, gts = postprocess_batch(
            out, batch, post, min_iou, with_detection=also_detection)
        keep = (nms_mask == 1) & (ious > min_iou)        # (B, K)
        updates = []
        for b in range(captions.shape[0]):
            if not row_valid[b]:
                continue
            scene_id = dataset.annotations[int(batch["dataset_idx"][b])]["scene_id"]
            final_k = resolve_winning_proposals(keep[b], det_ids[b], organized, scene_id)
            caps = {key: [vocab.decode(captions[b, k])] for key, k in final_k.items()}
            updates.append((int(row_seed[b]), caps, b, int(batch["dataset_idx"][b])))
        marks.append(trace.mark())
        with lock:
            for seed, caps, b, idx in updates:
                candidates[seed].update(caps)
                if also_detection:
                    ap_rows[seed][idx] = (preds[b], gts[b])
                seed_done_rows[seed] += 1
                if seed_done_rows[seed] == rows_per_seed:
                    submit_seed(seed)
            marks.append(trace.mark())
            for k, (a, b) in zip(("fetch_s", "post_s", "lock_s"), zip(marks, marks[1:])):
                spent[k] += trace.seconds(a, b)
            spent["consume_s"] += trace.seconds(marks[0], marks[-1])
        trace.phases("grid.consume", marks, ["grid.fetch", "grid.post", "grid.lock"], forward)

    forwards, load_s, launch_s = 0, 0.0, 0.0
    try:
        t_stream = time.perf_counter()
        futures, pending = [], []
        with ThreadPoolExecutor(max_workers=4) as pool:
            batches = iter(loader)
            while True:
                t_wait = time.perf_counter_ns()
                batch = next(batches, None)
                if batch is None:
                    load_s += (time.perf_counter_ns() - t_wait) * 1e-9
                    break
                with trace.timed("grid.launch", forwards) as launch:
                    if tables is not None:
                        dev_batch = to_device_batch(
                            {"pc_choices": batch["pc_choices"],
                             "scene_row": row_of_idx[batch["dataset_idx"]]}, dev)
                        dev_batch["point_table"] = point_tbl
                        dev_batch["center_table"] = center_tbl
                    else:
                        dev_batch = to_device_batch({k: batch[k] for k in EVAL_INPUT_KEYS}, dev)
                    out = step(model, dev_batch)
                load_s += (launch.start_ns - t_wait) * 1e-9
                launch_s += launch.seconds
                futures.append(pool.submit(consume, batch, out, forwards))
                forwards += 1
                pending = [f for f in pending + futures[-1:] if not f.done()]
                while len(pending) > MAX_IN_FLIGHT:
                    pending.pop(0).result()
                if progress is not None:
                    progress(forwards, len(loader))
            for f in futures:
                f.result()
        stream_s = time.perf_counter() - t_stream

        # any seed that never reached its full row count (only possible if
        # the dataset is empty) plus the tail of in-flight scoring futures
        t_score = time.perf_counter()
        with lock:
            for s in seeds:
                if s not in score_futures:
                    submit_seed(s)
        scored = [score_futures[s].result() for s in seeds]
    finally:
        # no-op on the success path (all futures already resolved); on an
        # exception mid-stream this stops the pool instead of leaking it
        score_pool.shutdown(wait=False)
        meteor_scorer.close()
    if timing_out is not None:
        timing_out.update(table_s=table_s, point_table=tables is not None,
                          stream_s=stream_s, load_s=load_s, launch_s=launch_s,
                          forwards=forwards, **spent,
                          score_s=time.perf_counter() - t_score)
    return [{"seed": int(s), **m} for s, m in zip(seeds, scored)]


def mul_eval_grid_multihost(
    step, model,
    dataset, vocab: Vocabulary, dc: ScannetDatasetConfig,
    corpus: Dict, organized: Dict,
    seeds: Sequence[int],
    batch_size: int,
    **kwargs,
) -> List[Dict]:
    """``mul_eval_grid`` sharded by seed over the ranks of the process
    group (``parallel/multihost.py``): each rank streams the grid of its
    round-robin share of ``seeds`` on its own device, and the per-seed rows
    are merged by one all-gather. Every rank returns the same full list in
    ``seeds`` order, equal to a single-process run's, since a seed's whole
    pipeline (its RNG schedule included) is local to one rank. Outside a
    process group this is ``mul_eval_grid``.

    The ranks first all-gather whether each finds a WordNet dictionary for
    METEOR's synonym stage: if any lacks one, all score without the stage
    (``wordnet_dir=""``), so that every seed is scored under one metric. The
    decision travels as an argument, not through the environment. That
    all-gather also forms the side group's connections while the ranks are
    still in step; the row merge comes when each has finished its seeds."""
    from spacap3d_tpu_torch.parallel.multihost import allgather_pyobj, process_shard

    if kwargs.get("wordnet_dir") is None:
        found = capeval.locate_wordnet_dir()
        have = allgather_pyobj(found is not None)
        kwargs["wordnet_dir"] = found if all(have) else ""
    local_seeds = process_shard(list(seeds))
    local_rows = (mul_eval_grid(step, model, dataset, vocab, dc, corpus, organized,
                                local_seeds, batch_size, **kwargs) if local_seeds else [])
    merged: Dict[int, Dict] = {}
    for rank_rows in allgather_pyobj(local_rows):
        for row in rank_rows:
            merged[int(row["seed"])] = row
    return [merged[int(s)] for s in seeds]
