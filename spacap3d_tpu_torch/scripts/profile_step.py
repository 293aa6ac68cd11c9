"""A torch.profiler capture of the port's train or eval step, with the
device time of its kernels summed by name family, as the JAX package's
``scripts/profile_step.py`` does for XLA ops:

    python -m spacap3d_tpu_torch.scripts.profile_step --mode train         # full width
    python -m spacap3d_tpu_torch.scripts.profile_step --mode eval --smoke  # tiny

The full-width step is the default ``ModelConfig`` at B = 8 (40,000 points,
vocab 4528) on the port's synthetic batch, seeded random weights; one step
runs before the profile. On CUDA the steps run captured (one CUDA graph a
step, which that first step captures), as the solver runs them. Kernels are summed by family (``family``): the
name without template arguments, parameters and trailing digits. Device busy is the union of the
kernel and copy spans, so families that overlap can sum past it. On the CPU
the trace has no device spans, and the script prints the host's op times
by name instead, labelled as such. The port's tracer (``utils/trace.py``)
is on over the profiled steps: a table of its spans follows, with the
device's idle time inside each on CUDA.
"""
from __future__ import annotations

import argparse
import os
import re
import tempfile
from collections import defaultdict

from spacap3d_tpu_torch.utils import trace


def tiny_config():
    from spacap3d_tpu_torch.config import ModelConfig
    from spacap3d_tpu_torch.scripts.train import TINY_ARCH

    return ModelConfig(num_points=1024, num_proposals=16, vocab_size=64, **TINY_ARCH)


def capture(mode: str, smoke: bool, n_steps: int, device: str):
    """Returns the profiler after ``n_steps`` steps of ``mode``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spacap3d_tpu_torch.config import ModelConfig, TrainConfig
    from spacap3d_tpu_torch.data.synthetic import train_batch
    from spacap3d_tpu_torch.models import init_spacap
    from spacap3d_tpu_torch.train.solver import synchronize
    from spacap3d_tpu_torch.train.step import (
        EVAL_INPUT_KEYS,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    cfg = tiny_config() if smoke else ModelConfig(num_points=40000, vocab_size=4528)
    model = init_spacap(cfg, seed=0, device=device)
    dev = next(model.parameters()).device
    batch = train_batch(cfg, 8, seed=0)
    if mode == "train":
        tc = TrainConfig(batch_size=8, use_relation=True)
        opt, sched = make_optimizer(model, tc, steps_per_epoch=4584)
        step = make_train_step(cfg, tc, opt, device=dev, scheduler=sched)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)

        def run():
            step(model, batch, gen, 0.1)
    else:
        step = make_eval_step(cfg, device=dev)
        eval_batch = {k: batch[k] for k in EVAL_INPUT_KEYS}

        def run():
            step(model, eval_batch)

    run()
    synchronize(dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace.enable()
    try:
        with profile(activities=activities) as prof:
            for _ in range(n_steps):
                run()
            synchronize(dev)
    finally:
        records = trace.disable()
    return prof, records


def family(name: str) -> str:
    """A kernel's name without its return type, template arguments,
    parameters, trailing digits and namespaces but the innermost; a copy or
    a set keeps its direction."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    name = name.replace("(anonymous namespace)::", "")
    while True:   # template arguments, innermost first (they may nest)
        stripped = re.sub(r"<[^<>]*>", "", name)
        if stripped == name:
            break
        name = stripped
    head = name.split("(")[0].split() or [name]
    return re.sub(r"[\d_]+$", "", "::".join(head[-1].split("::")[-2:]))


def device_spans(events):
    """(start, end, name) of the profile's kernel, copy and set spans, in
    microseconds, by start."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def summarize(prof, n_steps: int, top: int = 25):
    spans = device_spans(prof.events())
    if not spans:
        print("no device spans in the trace (a CPU run); host op self time by name, "
              "us per step:")
        host = sorted(((e.self_cpu_time_total, e.key) for e in prof.key_averages()),
                      reverse=True)[:top]
        for t, key in host:
            print(f"{key[:70]:70s} {t / n_steps:12.1f}")
        return {}
    busy, end = 0.0, float("-inf")
    fam, names = defaultdict(float), defaultdict(float)
    for s, e, name in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
        fam[family(name)] += e - s
        names[name] += e - s
    print(f"device busy {busy / n_steps:.0f} us/step over {len(spans) / n_steps:.0f} "
          "spans/step")
    print(f"{'kernel family':70s} {'us/step':>12s}")
    for k, v in sorted(fam.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{k[:70]:70s} {v / n_steps:12.1f}")
    print(f"\n{'top kernels':100s} {'us/step':>12s}")
    for k, v in sorted(names.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{k[:100]:100s} {v / n_steps:12.1f}")
    return {k: v / n_steps for k, v in fam.items()}


def span_table(records, events, n_steps: int):
    """The tracer's spans over the profiled steps (``utils/trace.py``): each
    name's count, wall ms a step, CPU share (the thread's CPU time over the
    wall time: below 100% where it waited for the interpreter lock, a core
    or the device) and, where the profile has device spans, the device's
    idle ms a step inside them (the records put on the profile's clock)."""
    gaps, end = [], None
    for s, e, _ in device_spans(events):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    idle = defaultdict(float)
    for r in trace.on_profile_clock(records, events) if gaps else []:
        idle[r["name"]] += sum(max(0.0, min(e, r["end_us"]) - max(s, r["start_us"]))
                               for s, e in gaps)
    print(f"\n{'span':24s} {'count':>6s} {'wall ms/step':>13s} {'cpu %':>7s}"
          + (f" {'device idle ms/step':>20s}" if gaps else ""))
    table = trace.summary(records)
    for name, t in sorted(table.items(), key=lambda kv: -kv[1]["wall_s"]):
        share = 100 * t["cpu_s"] / t["wall_s"] if t["wall_s"] else 0.0
        print(f"{name:24s} {t['count']:6d} {t['wall_s'] * 1e3 / n_steps:13.3f} {share:7.1f}"
              + (f" {idle[name] * 1e-3 / n_steps:20.3f}" if gaps else ""))
    return table


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["train", "eval"], default="train")
    p.add_argument("--out", default=None, help="trace dir (default: temp)")
    p.add_argument("--smoke", action="store_true", help="tiny arch")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    outdir = args.out or tempfile.mkdtemp(prefix="spacap_torch_profile_")
    prof, records = capture(args.mode, args.smoke, args.steps, args.device)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"trace: {path}")
    families = summarize(prof, args.steps, args.top)
    span_table(records, prof.events(), args.steps)
    return families


if __name__ == "__main__":
    main()
