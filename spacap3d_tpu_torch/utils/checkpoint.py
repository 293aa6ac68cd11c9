"""Checkpoints written on a background thread, as
``spacap3d_tpu/utils/checkpoint.py`` (the reference's torch.save payloads,
lib/solver.py:216-225, :556-580: model_last each epoch, model on a new
best).

``load_model_state_dict`` also reads the JAX package's checkpoints
(``utils/jax_checkpoint.py``).

``save`` copies every tensor of the payload to the CPU before it returns,
so the train loop may go on updating its parameters in place (torch's
Adam does); only the file write runs on the thread. Files are written to
``<path>.tmp`` and renamed onto ``path``, so a reader sees either the old
file or the whole new one. A failed write raises on the next ``wait()`` or
``save()``. The payload holds CPU tensors and plain Python values, so that
``torch.load(path, weights_only=True)`` reads it.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch


def snapshot(tree):
    """``tree`` with every tensor replaced by a CPU copy that owns its
    memory (a device-to-host copy waits for the work that writes the
    tensor)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)({k: snapshot(v) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree


class AsyncCheckpointer:
    """``records`` holds one dict a save: ``path``, ``snapshot_s`` (the
    copy to the CPU, inside ``save``), ``saved_at`` (``perf_counter`` when
    ``save`` returned) and, once the file is in place, ``write_s`` and
    ``written_at``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.records: List[Dict[str, Any]] = []

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path: str, payload: Dict[str, Any]):
        """Snapshots ``payload`` now and writes it on a thread."""
        self.wait()
        t0 = time.perf_counter()
        data = snapshot(payload)
        record = {"path": path, "snapshot_s": time.perf_counter() - t0}
        self.records.append(record)

        def write():
            try:
                t1 = time.perf_counter()
                tmp = path + ".tmp"
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                torch.save(data, tmp)
                os.replace(tmp, path)
                record["written_at"] = time.perf_counter()
                record["write_s"] = record["written_at"] - t1
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        record["saved_at"] = time.perf_counter()


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model's state dict from a port checkpoint, or from a JAX-package
    one (its ``params`` and ``state`` mapped by ``convert.params_from_jax``)."""
    from spacap3d_tpu_torch.utils.jax_checkpoint import is_jax_checkpoint, load_jax_checkpoint

    if is_jax_checkpoint(path):
        from spacap3d_tpu_torch.utils.convert import params_from_jax

        payload = load_jax_checkpoint(path)
        return params_from_jax(payload["params"], payload["state"])
    return load_checkpoint(path)["model_state_dict"]


def save_checkpoint_sync(path: str, payload: Dict[str, Any]):
    cp = AsyncCheckpointer()
    cp.save(path, payload)
    cp.wait()
