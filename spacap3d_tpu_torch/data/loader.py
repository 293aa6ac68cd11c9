"""Batch assembly and the prefetching loader, as
``spacap3d_tpu/data/loader.py``.

A thread-pool prefetcher in place of the reference's torch
DataLoader(num_workers=4) (reference scripts/train.py:119): items are built
by worker threads (numpy releases the GIL in the hot gather and percentile
ops) and stacked into fixed-shape numpy batches, with the JAX package's
per-item RNG key schedule, so that the two packages yield equal batches.
Where the dataset names leaves it can write into given rows
(``in_place_leaves``: a train item's float32 point block and votes), the
producer allocates those arrays of each batch and every item writes its
row of them; the rest is stacked.
Each item is a ``loader.item`` span on its worker thread (``in_place``:
its point block went straight into the batch) and each batch's stacking
a ``loader.stack`` span (``bytes``: what it still copied)
(``utils/trace.py``), their request the batch's index in the epoch.
"""
from __future__ import annotations

import functools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from spacap3d_tpu_torch.utils import trace


def stack_batch(items, keys=None, placed=None) -> Dict[str, np.ndarray]:
    """Stack a list of item dicts. ``keys`` restricts which leaves are
    stacked — the eval/grid paths pass only what the device step + host
    post-processing consume (e.g. a val item's all-zero (40k, 9)
    vote_label alone is ~1.4 MB/item of dead copy otherwise). ``placed``
    holds batch arrays whose rows the items already wrote: they are taken
    as they are."""
    if keys is None:
        keys = items[0].keys()
    placed = placed or {}
    return {k: placed[k] if k in placed else np.stack([it[k] for it in items]) for k in keys}


class DataLoader:
    """Iterates fixed-size batches; per-epoch shuffling with a dedicated
    RNG; drop_last=False pads the final batch by wrapping around, so every
    batch has one shape (the reference ran a ragged last batch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0
        # data parallelism: ``batch_size`` stays the global batch; every
        # process computes the same index order (same seed and epoch) and
        # builds only its contiguous row-block of each global batch. Items
        # equal the single-process batch's, since the per-item RNG is keyed
        # by (seed, epoch, dataset index), not by batch position.
        if batch_size % max(1, process_count):
            raise ValueError(f"global batch_size {batch_size} must divide evenly over "
                             f"{process_count} processes")
        self.process_index = process_index
        self.process_count = max(1, process_count)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.RandomState((self.seed * 100003 + self.epoch) % (2 ** 31))
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.drop_last:
            idx = idx[: (n // self.batch_size) * self.batch_size]
        elif n % self.batch_size:
            pad = self.batch_size - n % self.batch_size
            idx = np.concatenate([idx, np.resize(idx, pad)])   # cycled: n may be < pad
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        batches = indices.reshape(-1, self.batch_size)
        # Rows appended by the wrap-around pad are duplicates of already-
        # emitted items; mark them so eval does not double-count scenes
        # (the reference ran a ragged final batch and had no duplicates,
        # scripts/eval.py:46 — DataLoader without padding).
        valid = np.ones(indices.shape[0], bool)
        n = len(self.dataset)
        if not self.drop_last and n % self.batch_size:
            valid[n:] = False
        valid = valid.reshape(-1, self.batch_size)
        if self.process_count > 1:
            per = self.batch_size // self.process_count
            lo = self.process_index * per
            batches = batches[:, lo:lo + per]
            valid = valid[:, lo:lo + per]
        epoch = self.epoch
        self.epoch += 1

        # non-augmented val datasets expose a cached fast path that is
        # bit-identical to __getitem__ (dataset.getitem_cached): only the
        # point subsample is RNG-dependent, so per-scene features build
        # once — the serial mul_eval protocol and the solver's in-loop
        # val reuse them across epochs/seeds
        getter = getattr(self.dataset, "getitem_cached", None)
        leaves = {}
        if getter is None or getattr(self.dataset.cfg, "augment", True) \
                or getattr(self.dataset, "split", "train") == "train":
            getter = self.dataset.__getitem__
            # a dataset that writes leaves into given rows builds them
            # straight into the batch's arrays, which are not stacked
            in_place = getattr(self.dataset, "in_place_leaves", None)
            leaves = in_place() if in_place is not None else {}

        def build_item(b, placed, i, idx):
            rows = {"out": {k: v[i] for k, v in placed.items()}} if placed else {}
            with trace.span("loader.item", b, index=int(idx),
                            in_place="point_clouds" in placed):
                rng = np.random.RandomState(
                    (self.seed * 2654435761 + epoch * 97 + int(idx)) % (2 ** 31)
                )
                return getter(int(idx), rng=rng, **rows)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b, batch_idx in enumerate(batches):
                    if stop.is_set():
                        break
                    # a new array each batch: the caller may keep every batch
                    placed = {k: np.empty((len(batch_idx),) + shape, np.float32)
                              for k, shape in leaves.items()}
                    items = list(pool.map(functools.partial(build_item, b, placed),
                                          range(len(batch_idx)), batch_idx))
                    with trace.span("loader.stack", b) as s:
                        batch = stack_batch(items, placed=placed)
                        if s:
                            s.set(bytes=sum(v.nbytes for k, v in batch.items()
                                            if k not in placed))
                    batch["__valid__"] = valid[b]
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
