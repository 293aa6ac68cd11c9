"""Runs one cell of the benchmark and prints its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (data and weights from the seed, the program's first calls, which
capture its graphs) runs before the window; the window runs the cell's
traffic for ``--seconds``; then the program is freed and the reference
judges what the window produced. ``--trace 1`` profiles part of the window
and reports the per-layer metrics instead of the end-to-end ones. The run
exits non-zero, with no result, where there is no CUDA device, where it
fails, or where JAX or the JAX package was loaded."""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time

FORBIDDEN = {"jax", "jaxlib", "flax", "spacap3d_tpu"}


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Context:
    """What a traffic kind gets: the seed, the window's length, the
    configuration and the cell's params, the device, host spans, and the
    hooks that mark the window's start and read the device."""

    def __init__(self, args, workload, config, device, tmp):
        from portbench.trace import Spans

        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.workload, self.config, self.params = workload, config, workload["params"]
        self.device, self.tmp = device, tmp
        self.spans = Spans(self.trace and device.type == "cuda")
        self.setup_s = None

    def model_kwargs(self):
        return {k: _tuples(v) for k, v in self.config["model"].items()}

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_start(self) -> float:
        """Marks the end of set-up; returns the window's start (perf_counter)."""
        self.setup_s = process_age_s()
        return time.perf_counter()

    def peak_reserved(self) -> int:
        import torch

        return torch.cuda.max_memory_reserved(self.device) if self.device.type == "cuda" else 0

    def reduce(self, window):
        from portbench.trace import reduce

        return None if window is None or window.events is None else reduce(window.events)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(argv, allow_cpu: bool = False, overrides=None, variants=None):
    """One run: returns the result dict (not printed). ``allow_cpu`` (tests
    only) runs on the CPU where there is no CUDA device; ``overrides``
    (tests only) replaces the cell's config and params; ``variants``
    (readings for the limits, ``portbench/control.py``) maps a name to the
    check's arguments; the result's ``readings`` holds each variant's
    numbers and its own ``correct`` against the cell's limits, and the
    program's under "program"."""
    args = parse(argv)
    from portbench import spec

    workload = spec.workload(args.workload)
    config = spec.config(workload["config"])
    if overrides:
        workload, config = overrides(workload, config)
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= workload["chips"]:
        device = torch.device("cuda", 0)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        raise SystemExit(f"portbench: the cell needs {workload['chips']} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(args, workload, config, device, tmp)
        out = spec.traffic(workload["traffic"]).run(ctx)
        metrics = per_layer(out["record"]) if ctx.trace else {
            k: {"value": v, "unit": UNITS[k]}
            for k, v in dict(out["end_to_end"], setup_s=ctx.setup_s).items()}
        device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                       "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu", "count": 1,
                       "memory_peak_bytes": ctx.peak_reserved()}
        trace = out["record"].get("trace")
        if ctx.trace and trace is not None:
            device_info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        check = out.pop("check")
        out.pop("record")
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = check()
        readings = {name: check(**kw) for name, kw in (variants or {}).items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    checks, correct = judge(numbers, workload["limits"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if ctx.trace and trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    if variants is not None:
        result["readings"] = {name: {"numbers": nums, "correct": judge(nums, workload["limits"])[1]}
                              for name, nums in dict(readings, program=numbers).items()}
    result["checks"] = checks
    return result


def judge(numbers, limits):
    """-> (each compared number beside its limit, whether all are within)."""
    checks = {k: {"value": numbers[k], "limit": limit} for k, limit in limits.items()}
    return checks, all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values())


UNITS = {"eval_scenes_per_s": "scenes/s", "train_scenes_per_s": "scenes/s",
         "train_step_p95_ms": "ms", "peak_reserved_gib": "GiB", "setup_s": "s"}


def per_layer(record):
    """Every reader's number, with its unit, for this run's record; a
    reader with nothing to read is left out."""
    from portbench import spec

    out = {}
    for reader in spec.metric_readers():
        value = reader.read(record)
        if value is not None:
            out[reader.NAME] = {"value": value, "unit": reader.UNIT}
    return out


def main(argv=None) -> int:
    result = execute(sys.argv[1:] if argv is None else argv)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
