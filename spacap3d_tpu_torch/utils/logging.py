"""Run logging, as ``spacap3d_tpu/utils/logging.py``: the log.txt mirror,
the scalar history in all_scalars.json, optional TensorBoard and ETA
formatting.

Parity with the reference's observability surface: tensorboard scalars per
iteration and evaluation (lib/solver.py:309-333), a plain-text log.txt
(:155-156), all_scalars.json at the end (:596-602), the info.json run
manifest (scripts/train.py:291-305) and best.txt (:696-697).

The JAX module's ``enable_compilation_cache`` turns on XLA's persistent
compile cache. The port compiles nothing per process but its CUDA kernels,
which ``ops/_build.py`` caches itself, so it has no counterpart here.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict


def decode_eta(seconds: float) -> Dict[str, int]:
    seconds = int(max(0, seconds))
    return {"h": seconds // 3600, "m": (seconds % 3600) // 60, "s": seconds % 60}


class RunLogger:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._fout = open(os.path.join(root, "log.txt"), "a")
        self._scalars = defaultdict(list)  # tag -> [(wall, step, value)]
        self._tb = {}
        # Opt-in via SPACAP_TENSORBOARD=1: tensorboard's record writer blocks
        # the training thread once its event queue fills, and on slow
        # filesystems each event write can take over a second. The full
        # scalar history always lands in all_scalars.json.
        if os.environ.get("SPACAP_TENSORBOARD") == "1":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                for phase in ("train", "val"):
                    d = os.path.join(root, "tensorboard", phase)
                    os.makedirs(d, exist_ok=True)
                    self._tb[phase] = SummaryWriter(d)

    def log(self, msg: str):
        self._fout.write(msg + "\n")
        self._fout.flush()
        print(msg, flush=True)

    def scalar(self, phase: str, tag: str, value: float, step: int):
        self._scalars[f"{phase}/{tag}"].append((time.time(), step, float(value)))
        if phase in self._tb:
            self._tb[phase].add_scalar(tag, float(value), step)

    def dump_scalars(self):
        with open(os.path.join(self.root, "all_scalars.json"), "w") as f:
            json.dump(self._scalars, f)

    def write_json(self, name: str, payload):
        with open(os.path.join(self.root, name), "w") as f:
            json.dump(payload, f, indent=4, default=str)

    def close(self):
        self.dump_scalars()
        for w in self._tb.values():
            w.close()
        self._fout.close()
