"""Finds a cell's files by name: its workload, its configuration, its
traffic kind and the per-layer metric readers."""
from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(kind: str, name: str) -> Dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> Dict:
    """``workloads/<name>.json``: config, traffic, params, chips, why."""
    return dict(_json("workloads", name), name=name)


def config(name: str) -> Dict:
    """``configs/<name>.json``: source, model, data and train fields,
    precisions, reduced, assumed."""
    return dict(_json("configs", name), name=name)


def traffic(kind: str) -> ModuleType:
    """``traffic/<kind>.py``: a module with ``run(ctx) -> Result``."""
    path = os.path.join(HERE, "traffic", f"{kind}.py")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no traffic kind {kind!r} ({path})")
    return _load_module(path, f"portbench_traffic_{kind}")


def metric_readers() -> List[ModuleType]:
    """Every ``metrics/<name>.py``, sorted by name. A reader declares
    ``LAYER``, ``UNIT``, ``MOVES`` (an end-to-end metric), ``KERNELS`` (the
    kernel-name patterns it matches, maybe empty) and ``read(record)``,
    which returns a number or None where the record holds nothing to read."""
    folder = os.path.join(HERE, "metrics")
    readers = []
    for fname in sorted(os.listdir(folder)):
        if fname.endswith(".py") and not fname.startswith("_"):
            module = _load_module(os.path.join(folder, fname),
                                  "portbench_metric_" + fname[:-3].replace(".", "_"))
            module.NAME = fname[:-3]
            readers.append(module)
    return readers


def names(kind: str) -> List[str]:
    """The names of the files of ``kind`` (configs, workloads, traffic, metrics)."""
    ext = ".py" if kind in ("traffic", "metrics") else ".json"
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(ext) and not f.startswith("_"))
