"""Tracing of a run: host spans around the calls into each layer, and a
torch.profiler window over part of the measured window, reduced to the
record that the per-layer readers read.

The profile opens with marker kernels (``torch.cuda._sleep``) that the
host waits for, because a profile can drop the head of its window: the
window opens at the end of the last marker's device span and closes at a
host mark taken after a synchronisation. Spans are kept in memory and
reduced once the run's window has closed."""
from __future__ import annotations

import contextlib
import re
from typing import Dict, Optional

import torch

MARKERS, MARKER_CYCLES = 128, 1_000
PREFIX = "pb:"
TOP = 10


class Spans:
    """Host spans as profiler ranges named ``pb:<name>``; no-ops when off."""

    def __init__(self, on: bool):
        self.on = on

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield


class Window:
    """A profile over a stretch of the run: ``open()``, the work, ``close()``."""

    def __init__(self):
        self.prof = None
        self.events = None

    def open(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        with torch.profiler.record_function(PREFIX + "marker"):
            for _ in range(MARKERS):
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()

    def close(self):
        torch.cuda.synchronize()
        with torch.profiler.record_function(PREFIX + "close"):
            pass
        self.prof.stop()
        self.events = list(self.prof.events())
        self.prof = None


def family(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template and argument lists."""
    bare = name.replace("(anonymous namespace)::", "").strip()
    if bare.startswith("std::enable_if<"):       # a templated return type
        depth = 0
        for i, ch in enumerate(bare):
            depth += (ch == "<") - (ch == ">")
            if ch == ">" and depth == 0:
                bare = bare[i + 1:].split(" ", 1)[-1]
                break
    bare = re.sub(r"^void ", "", bare).strip()
    return (re.split(r"[<(]", bare, 1)[0].strip() or bare)[:80]


def reduce(events) -> Optional[Dict]:
    """The profile's device spans inside its window: busy seconds (the
    union of kernel, copy and memset spans), the window's seconds, device
    seconds by kernel name, host-to-device copy seconds, the top device
    ops by family, and the longest idle gaps named by the innermost host
    span open at their middle. None if the window cannot be found."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    by_id = {e.id: e for e in device}
    marker = next((e for e in cpu if e.name == PREFIX + "marker"), None)
    close = next((e for e in cpu if e.name == PREFIX + "close"), None)
    if marker is None or close is None:
        return None
    launches = sorted((e for e in cpu if "LaunchKernel" in e.name
                       and marker.time_range.start <= e.time_range.start <= marker.time_range.end),
                      key=lambda e: e.time_range.start)
    last = by_id.get(launches[-1].id) if launches else None
    if last is None:
        return None
    opened, closed = last.time_range.end, close.time_range.start
    spans = sorted((e.time_range.start, min(e.time_range.end, closed), e.name) for e in device
                   if opened <= e.time_range.start < closed)
    busy, end, gaps, by_name = 0.0, opened, [], {}
    for s, e, name in spans:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    if closed > end:
        gaps.append((end, closed))
    host = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):]) for e in cpu
            if e.name.startswith(PREFIX) and e.name not in (PREFIX + "marker", PREFIX + "close")]

    def open_span(t):
        inside = [(e - s, name) for s, e, name in host if s <= t <= e]
        return min(inside)[1] if inside else "no host span"

    families: Dict[str, float] = {}
    for name, t in by_name.items():
        families[family(name)] = families.get(family(name), 0.0) + t
    idle: Dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        key = open_span(0.5 * (s + e))
        idle[key] = max(idle.get(key, 0.0), (e - s) * 1e-6)
    return {
        "busy_s": busy * 1e-6,
        "window_s": (closed - opened) * 1e-6,
        "spans": len(spans),
        "kernel_s": {name: t * 1e-6 for name, t in by_name.items()},
        "htod_s": sum(e - s for s, e, name in spans if "HtoD" in name) * 1e-6,
        "device_ops": [[n, t * 1e-6] for n, t in
                       sorted(families.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, t] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def kernel_seconds(record: Dict, patterns) -> float:
    """Device seconds of the kernels whose names hold one of ``patterns``."""
    return sum(t for name, t in record["kernel_s"].items() if any(p in name for p in patterns))


