"""The port's tracer (``spacap3d_tpu_torch/utils/trace.py``) on the CPU:
off, a span site reads no clock and keeps nothing; on, spans of the main
thread and of the loader's threads nest by thread with their request ids;
under a CPU ``torch.profiler`` the records land on the profile's clock;
the registry of threads' records under concurrent spans and drains. The
spans of the captured programs, the solver and the eval grid are tested
beside their code's other tests (``test_torch_capture.py``,
``test_torch_solver.py``, ``test_torch_mul_eval.py``)."""
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.train.step import to_device_batch
from spacap3d_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and nothing kept."""
    trace.disable()
    yield
    trace.disable()


class Items:
    """A dataset of ``n`` items, each its index and a draw of its RNG."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx, rng=None):
        return {"index": np.int64(idx), "x": rng.rand(4).astype(np.float64)}


def no_clock(monkeypatch):
    def boom():
        raise AssertionError("a span site read a clock with the tracer off")

    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(time, "thread_time_ns", boom)


def test_off_a_site_reads_no_clock_and_keeps_nothing(monkeypatch):
    no_clock(monkeypatch)
    with trace.span("a", 1, k=2) as s:
        s.set(more=3)
        assert not s and s is trace.NULL
    batches = list(DataLoader(Items(5), 2, shuffle=True, seed=3, num_workers=3))
    to_device_batch(batches[0], torch.device("cpu"))
    assert len(batches) == 3
    monkeypatch.undo()
    assert trace.drain() == []
    # a timed span reads the wall clock for its caller, and keeps nothing
    with trace.timed("t") as t:
        time.sleep(0.001)
    assert t.seconds >= 0.001 and not t and trace.drain() == []


def test_spans_nest_by_thread_with_their_requests():
    trace.enable()
    with trace.span("outer", 7) as outer:
        loader = DataLoader(Items(5), 2, shuffle=True, seed=3, num_workers=3)
        batches = []
        for b, batch in enumerate(loader):
            with trace.span("inner", b=b):
                to_device_batch(batch, torch.device("meta"))
            batches.append(batch)
    records = trace.disable()
    by = {}
    for r in records:
        by.setdefault(r["name"], []).append(r)
    main = threading.get_ident()
    assert by["outer"][0]["id"] == outer.id and by["outer"][0]["parent"] == 0
    assert [r["parent"] for r in by["inner"]] == [outer.id] * 3
    assert [r["request"] for r in by["inner"]] == [7] * 3
    inner_ids = [r["id"] for r in by["inner"]]
    assert [r["parent"] for r in by["upload"]] == inner_ids
    assert {r["request"] for r in by["upload"]} == {7}
    # float64 is uploaded as float32: 2 rows of 4 floats, 2 int64 indices, 2 valid flags
    assert {r["attrs"]["bytes"] for r in by["upload"]} == {2 * 4 * 4 + 2 * 8 + 2}
    assert {r["attrs"]["pinned"] for r in by["upload"]} == {False}
    # the loader's spans: on its own threads, outside any span there, the
    # request their batch's index; the wrapped last batch repeats an item
    items = by["loader.item"]
    assert len(items) == 6 and all(r["thread"] != main and r["parent"] == 0 for r in items)
    for b, batch in enumerate(batches):
        got = sorted(r["attrs"]["index"] for r in items if r["request"] == b)
        assert got == sorted(batch["index"].tolist())
    # a dataset without in-place leaves: every item is stacked whole
    assert not any(r["attrs"]["in_place"] for r in items)
    stacks = by["loader.stack"]
    assert sorted(r["request"] for r in stacks) == [0, 1, 2]
    assert all(r["thread"] != main and r["parent"] == 0 for r in stacks)
    assert {r["attrs"]["bytes"] for r in stacks} == {2 * 8 + 2 * 4 * 8}
    for r in records:
        assert 0 <= r["cpu_ns"] <= r["end_ns"] - r["start_ns"], r


def test_enable_forgets_and_disable_returns_what_was_not_drained():
    trace.enable()
    with trace.span("old"):
        pass
    trace.enable()
    with trace.span("a"):
        pass
    assert [r["name"] for r in trace.drain()] == ["a"]
    with trace.span("b"):
        pass
    assert [r["name"] for r in trace.disable()] == ["b"]
    assert trace.span("c") is trace.NULL


def spin(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_records_land_on_the_profile_clock():
    """Main-thread spans open ``sp:`` ranges; the offset their pairs share
    puts each within 100 us of its range, and a worker thread's span,
    which has no range, inside the main-thread span that started and
    joined it."""
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("first range"):  # the profiler's own set-up
            pass
        for i in range(6):
            with trace.span("step", i):
                spin(0.002)
                with trace.span("part"):
                    spin(0.001)
        with trace.span("join"):
            spin(0.001)
            worker = threading.Thread(target=lambda: trace.span("work").__enter__().__exit__())
            worker.start()
            worker.join(10)
            spin(0.001)
    assert not worker.is_alive()
    records = trace.disable()
    events = prof.events()
    mapped = trace.on_profile_clock(records, events)
    assert mapped and all(r["ranged"] for r in mapped if r["name"] != "work")
    for name in ("step", "part", "join"):
        ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                        if e.name == trace.PREFIX + name)
        mine = sorted((r["start_us"], r["end_us"]) for r in mapped if r["name"] == name)
        assert len(ranges) == len(mine) > 0
        for (s, e), (a, b) in zip(ranges, mine):
            assert abs(a - s) < 100 and abs(b - e) < 100, (name, s, e, a, b)
    work = next(r for r in mapped if r["name"] == "work")
    join = next(r for r in mapped if r["name"] == "join")
    assert work["thread"] != join["thread"] and not work["ranged"]
    assert join["start_us"] < work["start_us"] <= work["end_us"] < join["end_us"]


def ev(name, start):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start))


def rec(name, start_ns, end_ns, cpu_ns, ranged=True):
    return {"name": name, "start_ns": start_ns, "end_ns": end_ns, "cpu_ns": cpu_ns,
            "ranged": ranged}


def test_offset_pairs_despite_ranges_lost_at_either_end_and_summary_sums():
    """A profile that lost ranges at the head of its window, and the range
    of a span still open when it stopped: the differences that the most
    pairs share give the offset, though the spans recur at a fixed period;
    records without a range take no part."""
    period, offset = 1_000_000, 2_000
    records = [rec("a", i * period, i * period + 300_000 + 1000 * i, 100_000)
               for i in range(8)]
    records += [rec("b", i * period + 400_000, i * period + 500_000, 50_000) for i in range(8)]
    records.append(rec("w", 0, 9 * period, 400_000, ranged=False))
    # the clock is the records' + 2 us (1 us of jitter on every other
    # range); the first two "a" ranges and the last "b" range were lost
    events = [ev("sp:a", (r["start_ns"] + offset + 1000 * (i % 2)) * 1e-3)
              for i, r in enumerate(records[2:8])]
    events += [ev("sp:b", (r["start_ns"] + offset) * 1e-3) for r in records[8:15]]
    events.append(ev("aten::mm", 1.0))
    assert trace.profile_offset_ns(records, events) == pytest.approx(offset, abs=1000)
    mapped = trace.on_profile_clock(records, events)
    assert [r["start_us"] for r in mapped] == pytest.approx(
        [(r["start_ns"] + offset) * 1e-3 for r in records], abs=1)
    assert trace.profile_offset_ns(records, [ev("aten::mm", 1.0)]) is None
    assert trace.on_profile_clock(records, []) == []
    got = trace.summary(records)
    assert got["a"]["count"] == 8 and got["a"]["wall_s"] == pytest.approx(8 * 0.3e-3 + 28e-6)
    assert got["b"] == {"count": 8, "wall_s": pytest.approx(0.8e-3), "cpu_s": pytest.approx(0.4e-3)}
    assert got["w"]["count"] == 1 and got["w"]["cpu_s"] == pytest.approx(0.4e-3)


def test_marks_make_consecutive_spans_from_one_read_a_boundary():
    trace.enable()
    with trace.span("around", 4) as around:
        marks = [trace.mark()]
        for _ in range(2):
            spin(0.0005)
            marks.append(trace.mark())
        trace.phases("whole", marks, ["one", "two"], k=1)
    records = {r["name"]: r for r in trace.disable()}
    whole = records["whole"]
    assert whole["parent"] == around.id and whole["request"] == 4 and whole["attrs"] == {"k": 1}
    assert (whole["start_ns"], whole["end_ns"]) == (marks[0].ns, marks[2].ns)
    for name, a, b in (("one", marks[0], marks[1]), ("two", marks[1], marks[2])):
        r = records[name]
        assert r["parent"] == whole["id"] and r["request"] == 4
        assert (r["start_ns"], r["end_ns"], r["cpu_ns"]) == (a.ns, b.ns, b.cpu_ns - a.cpu_ns)
        assert r["end_ns"] - r["start_ns"] == pytest.approx(trace.seconds(a, b) * 1e9)
    # marks taken while off make no spans
    off = [trace.mark(), trace.mark()]
    trace.phases("whole", off, ["one"])
    assert off[0].cpu_ns is None and trace.drain() == []


def test_concurrent_spans_and_drains_lose_nothing():
    """More threads than cores open spans while two other threads drain,
    at a 1 us switch interval: every record comes out once."""
    threads, spans, got = 24, 200, []
    stop = threading.Event()

    def work(i):
        for j in range(spans):
            with trace.span("s", i, j=j):
                pass

    def drainer():
        while not stop.is_set():
            got.extend(trace.drain())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        drainers = [threading.Thread(target=drainer) for _ in range(2)]
        workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in drainers + workers:
            t.start()
        for w in workers:
            w.join(60)
        stop.set()
        for d in drainers:
            d.join(60)
    finally:
        sys.setswitchinterval(interval)
        got.extend(trace.disable())
    assert not any(t.is_alive() for t in drainers + workers)
    assert len(got) == threads * spans
    assert len({r["id"] for r in got}) == threads * spans
    assert sorted((r["request"], r["attrs"]["j"]) for r in got) == \
        [(i, j) for i in range(threads) for j in range(spans)]
