"""Spans of the port's host work: the train loop's fetch and step, the
loader's items, the upload, the captured programs' calls and the eval
grid's consume threads, on every thread, placed on a device profile's
clock.

    from spacap3d_tpu_torch.utils import trace

    trace.enable()
    ...                          # train, evaluate
    records = trace.disable()    # or trace.drain() to keep tracing

Off (the default), a span site tests one module flag and returns one
shared null span: it reads no clock, keeps nothing and never synchronises
the device. On, a span keeps one record: its name, its thread, its start
and end (``time.perf_counter_ns``), the thread's CPU time over it
(``time.thread_time_ns``; below the wall time where the thread waited for
the interpreter lock, a core, a lock or the device), its id and the id of
the span open around it on its thread (0: none), a request id that the
spans of one unit of work share (the solver's global iteration, the
grid's forward, the loader's batch; a span without one takes its
parent's) and its attributes. Each thread appends to a list of its own,
with no lock; ``drain`` collects them.

``timed`` is a span whose caller reads its seconds (``Span.seconds``):
where the program already timed a stretch (``Solver.timing``, the grid's
``timing_out``), one pair of clock reads serves both, so it reads the
wall clock on and off whether or not the tracer is on.

A span opened on the thread that started a ``torch.profiler`` profile,
while it runs, also opens a profiler range ``sp:<name>`` (as
``torch.profiler.record_function`` does) around its clock reads; the
profiler sees no range opened on another thread. ``profile_offset_ns``
pairs those ranges with their records to put every thread's records on
the profile's clock. ``mark`` and ``phases`` record consecutive spans
from one clock read a boundary, after the fact.
"""
from __future__ import annotations

import itertools
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "sp:"
# a profiler range opened and closed in C++: within a few microseconds of
# the span's clock reads, where ``torch.profiler.record_function``'s
# operator calls take tens, and over a hundred on a busy host
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
# pairing a profile's ranges with their records (``profile_offset_ns``): the
# width of the cluster of differences that correct pairs share, and the
# ranges a profile may lose at either end of its window
MATCH_NS, MAX_LOST = 50_000, 4

_on = False
_ids = itertools.count(1)
_local = threading.local()
_threads: List[Tuple[threading.Thread, List["Span"]]] = []   # each thread's records
_threads_lock = threading.Lock()


class _Null:
    """The span of a site while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


NULL = _Null()


def _state():
    """This thread's open spans and records, registered at its first span."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
        _local.records = []
        with _threads_lock:
            _threads.append((threading.current_thread(), _local.records))
    return st


class Span:
    """One span (module docstring). Truthy while the tracer records it, so
    that a site computes costly attributes only then (``if s: s.set(...)``)."""

    __slots__ = ("name", "request", "attrs", "id", "parent", "start_ns", "end_ns", "cpu_ns",
                 "ranged", "_live", "_range", "_cpu0")

    def __init__(self, name: str, request: Optional[int], attrs: Dict):
        self.name, self.request, self.attrs = name, request, attrs
        self.start_ns = self.end_ns = 0
        self._live = False

    def __bool__(self):
        return self._live

    def set(self, **attrs):
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        self._live = _on
        if self._live:
            st = _state()
            up = st[-1] if st else None
            self.parent = up.id if up is not None else 0
            if self.request is None and up is not None:
                self.request = up.request
            self.id = next(_ids)
            st.append(self)
            # thread-local: true only on the thread that started the profile
            self.ranged = torch.autograd._profiler_enabled()
            self._range = None
            if self.ranged:
                self._range = _Range(PREFIX + self.name)
                self._range.__enter__()
        # the wall clock's reads enclose the CPU clock's, which the range's enclose
        self.start_ns = time.perf_counter_ns()
        if self._live:
            self._cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        if self._live:
            self.cpu_ns = time.thread_time_ns() - self._cpu0
        self.end_ns = time.perf_counter_ns()
        if self._live:
            if self._range is not None:
                self._range.__exit__(None, None, None)
                self._range = None
            _local.stack.pop()
            _local.records.append(self)
            self._live = False
        return False


def span(name: str, request: Optional[int] = None, **attrs):
    """A span of ``name`` (a context manager); the null span while off."""
    if not _on:
        return NULL
    return Span(name, request, attrs)


def timed(name: str, request: Optional[int] = None, **attrs) -> Span:
    """A span whose ``seconds`` the caller reads: it reads the wall clock
    whether or not the tracer is on, and is recorded only while on."""
    return Span(name, request, attrs)


def enable() -> None:
    """Turns the tracer on, forgetting records not yet drained."""
    global _on
    drain()
    _on = True


def disable() -> List[Dict]:
    """Turns the tracer off; returns the records not yet drained."""
    global _on
    _on = False
    return drain()


def drain() -> List[Dict]:
    """The records of spans closed since the last drain, on every thread,
    by start: dicts of ``name``, ``thread`` (its ident), ``thread_name``,
    ``id``, ``parent``, ``request``, ``start_ns``, ``end_ns``, ``cpu_ns``,
    ``ranged`` (it opened an ``sp:`` range) and ``attrs``."""
    out = []
    with _threads_lock:           # one drain at a time; threads append without it
        for thread, records in _threads:
            got = records[:]      # the thread may append meanwhile: take a prefix
            del records[:len(got)]
            out.extend({"name": s.name, "thread": thread.ident, "thread_name": thread.name,
                        "id": s.id, "parent": s.parent, "request": s.request,
                        "start_ns": s.start_ns, "end_ns": s.end_ns, "cpu_ns": s.cpu_ns,
                        "ranged": s.ranged, "attrs": dict(s.attrs)} for s in got)
        _threads[:] = [t for t in _threads if t[0].is_alive() or t[1]]
    return sorted(out, key=lambda r: r["start_ns"])


def summary(records: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Each span name's ``count``, wall seconds (``wall_s``) and thread CPU
    seconds (``cpu_s``) summed over its records."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        s = out.setdefault(r["name"], {"count": 0, "wall_s": 0.0, "cpu_s": 0.0})
        s["count"] += 1
        s["wall_s"] += (r["end_ns"] - r["start_ns"]) * 1e-9
        s["cpu_s"] += r["cpu_ns"] * 1e-9
    return out


def profile_offset_ns(records: List[Dict], events) -> Optional[float]:
    """Nanoseconds to add to a record's ``perf_counter_ns`` times to place
    it on the clock of a profile's ``events`` (``prof.events()``, whose
    ``time_range`` is in microseconds), from the records that opened an
    ``sp:`` range: the median of the differences between a range's start
    and its record's that the most pairs share, within ``MATCH_NS``. A
    profile can lose ranges at either end of its window (its head; a span
    still open when it stopped), so each name's records pair with its
    ranges at every shift up to ``MAX_LOST`` past either end's alignment.
    None where no range pairs."""
    ranges: Dict[str, List[float]] = {}
    for e in events:
        if e.name.startswith(PREFIX):
            ranges.setdefault(e.name[len(PREFIX):], []).append(e.time_range.start * 1e3)
    diffs = []
    for name, starts in ranges.items():
        starts.sort()
        mine = sorted(r["start_ns"] for r in records if r["ranged"] and r["name"] == name)
        extra = len(starts) - len(mine)
        for k in range(min(0, extra) - MAX_LOST, max(0, extra) + MAX_LOST + 1):
            diffs.extend(starts[i + k] - t for i, t in enumerate(mine) if 0 <= i + k < len(starts))
    if not diffs:
        return None
    diffs.sort()
    lo, best = 0, (0, 0)
    for hi, d in enumerate(diffs):
        while d - diffs[lo] > MATCH_NS:
            lo += 1
        if hi - lo > best[1] - best[0]:
            best = (lo, hi)
    return statistics.median(diffs[best[0]:best[1] + 1])


def on_profile_clock(records: List[Dict], events) -> List[Dict]:
    """``records`` with ``start_us`` and ``end_us`` on the clock of the
    profile's ``events`` (``profile_offset_ns``); none if no range pairs."""
    offset = profile_offset_ns(records, events)
    if offset is None:
        return []
    return [dict(r, start_us=(r["start_ns"] + offset) * 1e-3, end_us=(r["end_ns"] + offset) * 1e-3)
            for r in records]


class Mark(NamedTuple):
    """A boundary between consecutive spans (``phases``)."""
    ns: int                 # time.perf_counter_ns()
    cpu_ns: Optional[int]   # time.thread_time_ns() while tracing, else None


def mark() -> Mark:
    """Reads the wall clock, and the thread's CPU clock while tracing."""
    return Mark(time.perf_counter_ns(), time.thread_time_ns() if _on else None)


def seconds(a: Mark, b: Mark) -> float:
    return (b.ns - a.ns) * 1e-9


def phases(name: str, marks: List[Mark], parts: List[str], request: Optional[int] = None,
           **attrs) -> None:
    """Records, where every mark was taken while tracing, a span ``name``
    from the first of ``marks`` to the last, and its children: ``parts[i]``
    from ``marks[i]`` to ``marks[i + 1]``. One clock read a boundary then
    serves the caller's timings and the spans. The span open around them
    on this thread is their parent; they open no ``sp:`` range."""
    if not _on or any(m.cpu_ns is None for m in marks):
        return
    st = _state()
    up = st[-1] if st else None
    if request is None and up is not None:
        request = up.request
    whole = _closed(name, request, up.id if up is not None else 0, marks[0], marks[-1], attrs)
    for part, a, b in zip(parts, marks, marks[1:]):
        _closed(part, whole.request, whole.id, a, b, {})


def _closed(name, request, parent, a: Mark, b: Mark, attrs) -> Span:
    s = Span(name, request, attrs)
    s.id, s.parent, s.ranged = next(_ids), parent, False
    s.start_ns, s.end_ns, s.cpu_ns = a.ns, b.ns, b.cpu_ns - a.cpu_ns
    _local.records.append(s)
    return s
