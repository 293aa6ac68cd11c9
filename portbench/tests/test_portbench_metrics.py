"""Each per-layer reader on a recorded synthetic record, and the profile
reduction on synthetic profiler events."""
import types

import pytest
from torch.autograd import DeviceType

from portbench import spec, trace

TRACE = {"busy_s": 0.8, "window_s": 1.0, "spans": 10, "htod_s": 0.04,
         "kernel_s": {"void fps_kernel_cluster<16>(float const*)": 0.02,
                      "void fps_kernel_cluster<1>(float const*)": 0.002,
                      "void ball_query_kernel<4>(float const*)": 0.004,
                      "sm90_gemm": 0.5},
         "device_ops": [], "idle_gaps": []}
TRAIN = {"kind": "train", "steps": 100, "window_s": 10.0, "loader_wait_s": [0.01, 0.03],
         "trace": TRACE, "traced_steps": 8, "ideal_step_s": 0.005, "fps_bound_s": 0.0001,
         "bq_bound_s": 0.0002}
GRID = {"kind": "grid", "calls": 2, "rows": 1128, "window_s": 18.0,
        "timing": [{"table_s": 1.0, "post_s": 2.0}, {"table_s": 2.0, "post_s": 4.0}],
        "trace": TRACE, "traced_forwards": 8, "ideal_forward_s": 0.002,
        "fps_bound_s": 0.0001, "bq_bound_s": 0.0002}

WANT = {
    "grid.table_s": (GRID, 1.5), "grid.post_s": (GRID, 3.0),
    "eval_forward_device_ms": (GRID, 100.0), "eval_forward_mfu": (GRID, 1.6),
    "loader_wait_ms": (TRAIN, 20.0), "h2d_ms": (TRAIN, 5.0),
    "train_step_device_ms": (TRAIN, 100.0), "train_step_mfu": (TRAIN, 4.0),
    "fps_roofline.eval": (GRID, 8 * 0.0001 / 0.022 * 100),
    "fps_roofline.train": (TRAIN, 8 * 0.0001 / 0.022 * 100),
    "ball_query_roofline.eval": (GRID, 8 * 0.0002 / 0.004 * 100),
    "ball_query_roofline.train": (TRAIN, 8 * 0.0002 / 0.004 * 100),
    "device_idle_share.eval": (GRID, 20.0), "device_idle_share.train": (TRAIN, 20.0),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    reader = next(r for r in spec.metric_readers() if r.NAME == name)
    record, want = WANT[name]
    assert reader.read(record) == pytest.approx(want)
    other = TRAIN if record is GRID else GRID
    assert reader.read(other) is None
    assert reader.read(dict(record, trace=None, timing=[], loader_wait_s=None)) is None


def test_every_reader_is_declared_and_tested():
    readers = spec.metric_readers()
    assert sorted(r.NAME for r in readers) == sorted(WANT)
    for r in readers:
        assert r.LAYER and r.UNIT and r.MOVES in ("eval_scenes_per_s", "train_scenes_per_s")


def test_a_held_feed_reads_no_loader_wait():
    reader = next(r for r in spec.metric_readers() if r.NAME == "loader_wait_ms")
    assert reader.read(dict(TRAIN, loader_wait_s=None)) is None


def event(name, start, end, device, ident=0, thread=1):
    return types.SimpleNamespace(
        name=name, id=ident, thread=thread,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end), is_user_annotation=False)


def test_reduce_opens_at_the_last_marker_and_names_the_gaps():
    events = [
        event("pb:marker", 0, 100, False),
        event("cudaLaunchKernel", 10, 11, False, ident=1),
        event("cudaLaunchKernel", 20, 21, False, ident=2),
        event("sleep", 40, 50, True, ident=1),
        event("sleep", 60, 200, True, ident=2),          # the last marker: window opens at 200
        event("pb:next(loader)", 190, 400, False),
        event("pb:train_step", 400, 450, False),
        event("void fps_kernel_cluster<16>()", 400, 500, True, ident=3),
        event("Memcpy HtoD (Pageable -> Device)", 500, 520, True, ident=4),
        event("gemm", 700, 800, True, ident=5),
        event("pb:close", 1200, 1201, False),
    ]
    got = trace.reduce(events)
    assert got["window_s"] == pytest.approx(1000e-6)
    assert got["busy_s"] == pytest.approx(220e-6)
    assert got["htod_s"] == pytest.approx(20e-6)
    assert trace.kernel_seconds(got, ["fps_kernel"]) == pytest.approx(100e-6)
    assert got["device_ops"][0][0] == "fps_kernel_cluster"
    assert trace.family("void (anonymous namespace)::k<float>(int)") == "k"
    assert trace.family("std::enable_if<!(false), void>::type at::native::reduce<4>(int)") \
        == "at::native::reduce"
    gaps = dict(got["idle_gaps"])
    assert gaps["next(loader)"] == pytest.approx(200e-6)    # 200-400
    assert gaps["no host span"] == pytest.approx(400e-6)    # 800-1200


def test_reduce_without_its_markers_reads_nothing():
    assert trace.reduce([event("gemm", 0, 1, True)]) is None
