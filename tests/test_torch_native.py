"""The port's host library (``spacap3d_tpu_torch/csrc/spacap_host.cpp``
through ``data/native.py``) on the CPU: each binding equal to its plain
numpy version under ``==``, on random inputs from a numpy seed, and to the
JAX package's binding where its library is built
(``spacap3d_tpu.data.native.has_native()``); the choice stream's
continuation; NMS decisions class-blind, class-aware and with the 1e-8
union epsilon; the floor percentile's repair; the locked build (four
processes started together compile once; a failed compile raises with
the compiler's log)."""
import os
import subprocess
import sys
import textwrap
import types
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from spacap3d_tpu.data import native as jax_native
from spacap3d_tpu.data.dataset import ScanReferDataset as JaxDataset
from spacap3d_tpu.eval import detection as jax_detection
from spacap3d_tpu_torch.config import DataConfig
from spacap3d_tpu_torch.data import dataset, native
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.eval import detection
from spacap3d_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}


def floor_case():
    """The cloud on which the library's floor and np.percentile's differ in
    the last bit: a floor near z = 0, as ScanNet's axis-aligned floors lie."""
    r = np.random.RandomState(163)
    n = r.randint(30000, 60000)
    return r.randn(n) * 0.3 + r.rand()


def formula(z, q):
    """The library's percentile, rounded once, by exact rational arithmetic
    (independent of ``native.percentile_plain``)."""
    v = np.sort(np.asarray(z, np.float64))
    pos = q / 100.0 * float(len(v) - 1)
    lo = int(np.floor(pos))
    vlo, vhi = v[lo], v[min(lo + 1, len(v) - 1)]
    return float(Fraction(float(vhi - vlo)) * Fraction(pos - lo) + Fraction(float(vlo)))


def test_floor_repair_case():
    """The port's floor equals the library formula under ``==``, lies within
    one ulp of np.percentile, and equals the JAX package's floor where its
    library runs, in the height channel of the assembled cloud too."""
    z = floor_case()
    want = formula(z, 0.99)
    assert native.percentile_z(z, 0.99) == want == native.percentile_plain(z, 0.99)
    ref = float(np.percentile(z, 0.99))
    assert want != ref and abs(want - ref) <= np.spacing(abs(ref))
    mesh = np.zeros((len(z), 9))
    mesh[:, 0] = np.arange(len(z)) * 1e-3
    mesh[:, 2] = z
    scene = types.SimpleNamespace(mesh_vertices=mesh)
    cfg = DataConfig(use_color=False, use_normal=False, use_multiview=False, use_height=True)
    cloud = dataset.ScanReferDataset._assemble_full_cloud(types.SimpleNamespace(cfg=cfg), scene)
    assert np.array_equal(cloud[:, 3], z - want)
    if jax_native.has_native():
        assert jax_native.percentile_z(z, 0.99) == want
        jax_cloud = JaxDataset._assemble_full_cloud(types.SimpleNamespace(cfg=cfg), scene)
        assert np.array_equal(cloud, jax_cloud)


@pytest.mark.parametrize("q", [0.99, 50.0, 99.0, 100.0, 0.0])
def test_percentile_equals_the_formula(q):
    for seed in range(20):
        r = np.random.RandomState(seed)
        z = r.randn(r.randint(2, 60000)) * 0.3 + r.rand()
        got = native.percentile_z(z, q)
        assert got == formula(z, q) == native.percentile_plain(z, q), seed
        if jax_native.has_native():
            assert got == jax_native.percentile_z(z, q), seed


def random_inputs(name, r):
    """Arguments of binding ``name`` (without the RNG), as the data layer
    and the eval give them, at a few thousand points."""
    n = r.randint(2000, 8000)
    if name in ("gather_f32", "gather_f64", "gather_i64"):
        idx = r.randint(0, n, r.randint(1, 4000))
        src = {"gather_f32": r.randn(n, 4).astype(np.float32), "gather_f64": r.randn(n, 7),
               "gather_i64": r.randint(-5, 50, n).astype(np.int64)}[name]
        return (src, idx)
    if name == "votes":
        ins = r.randint(0, 30, n)
        sem = r.randint(0, 41, n)
        return (r.randn(n, 3) * 2, ins, sem, ScannetDatasetConfig().nyu40ids)
    if name.startswith("in_box"):
        pc = (r.rand(n, 3) * 4).astype(np.float32)
        c = r.rand(64, 3).astype(np.float32) * 4
        s = (0.05 + r.rand(64, 3) * 1.5).astype(np.float32)
        return (pc, c - s / 2, c + s / 2, 5 if name == "in_box_cap" else 0)
    raise KeyError(name)


BINDINGS = {
    "gather_f32": (native.gather_rows, native.gather_rows_plain, "gather_rows"),
    "gather_f64": (native.gather_rows, native.gather_rows_plain, "gather_rows"),
    "gather_i64": (native.gather_rows, native.gather_rows_plain, "gather_rows"),
    "votes": (native.compute_votes_native, native.compute_votes_plain, "compute_votes_native"),
    "in_box": (native.points_in_boxes_native, native.points_in_boxes_plain,
               "points_in_boxes_native"),
    "in_box_cap": (native.points_in_boxes_native, native.points_in_boxes_plain,
                   "points_in_boxes_native"),
}


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_binding_equals_its_plain_version(name):
    lib_fn, plain_fn, jax_name = BINDINGS[name]
    for seed in range(5):
        args = random_inputs(name, np.random.RandomState(seed))
        got, want = lib_fn(*args), plain_fn(*args)
        if isinstance(want, tuple):
            assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), (name, seed)
        if jax_native.has_native():
            theirs = getattr(jax_native, jax_name)(*args)
            theirs = theirs if isinstance(theirs, tuple) else (theirs,)
            mine = got if isinstance(got, tuple) else (got,)
            assert all(np.array_equal(g, w) for g, w in zip(mine, theirs)), (name, seed)


def test_votes_only_count_detection_instances():
    """An instance whose first point is not a detection class gets no
    votes, even if its later points are."""
    xyz = np.arange(12, dtype=np.float64).reshape(4, 3)
    votes, mask = native.compute_votes_native(xyz, np.array([1, 1, 2, 2]),
                                              np.array([1, 4, 4, 1]), [4])
    assert mask.tolist() == [0, 0, 1, 1]
    assert np.array_equal(votes[2:, :3], [[1.5, 1.5, 1.5], [-1.5, -1.5, -1.5]])
    assert np.array_equal(votes[:, :3], votes[:, 3:6]) and not votes[:2].any()


@pytest.mark.parametrize("n,k", [(52000, 40000), (40000, 40000), (1000, 1)])
def test_choice_equals_numpy_and_continues_the_stream(n, k):
    """The library's choice equals ``rng.choice(n, k, replace=False)``, and
    ``rng`` then draws what numpy's would: over three calls interleaved
    with other draws, and through ``dataset.random_sampling``."""
    a, b = np.random.RandomState(k), np.random.RandomState(k)
    for _ in range(3):
        assert np.array_equal(native.choice_noreplace_native(n, k, a),
                              native.choice_noreplace_plain(n, k, b))
        assert a.random_sample() == b.random_sample()
        assert np.array_equal(a.randn(3), b.randn(3))   # the Gaussian cache too
    assert np.array_equal(dataset.random_sampling(n, k, a), b.choice(n, k, replace=False))
    assert a.get_state()[2] == b.get_state()[2]
    assert np.array_equal(a.get_state()[1], b.get_state()[1])


def test_random_sampling_draws_with_replacement_below_the_sample_size():
    a, b = np.random.RandomState(1), np.random.RandomState(1)
    assert np.array_equal(dataset.random_sampling(100, 128, a), b.choice(100, 128, replace=True))
    with pytest.raises(ValueError, match="without replacement"):
        native.choice_noreplace_native(100, 128, a)


@pytest.mark.parametrize("mode", ["class-blind", "class-aware, eps 1e-8"])
def test_nms_decisions_equal_the_matrix_version(mode):
    """Random dense box sets (3-260 boxes): the library's picks, through
    ``detection._greedy_nms``, equal the matrix version's and the JAX
    package's, as tests/test_native.py holds them."""
    r = np.random.RandomState(0)
    for trial in range(25):
        k = r.randint(3, 260)
        centers = r.rand(k, 3) * 3
        sizes = 0.3 + r.rand(k, 3) * 2
        lo = (centers - sizes / 2).astype(np.float32)
        hi = (centers + sizes / 2).astype(np.float32)
        score = r.rand(k).astype(np.float32)
        cls, eps = ((None, 0.0) if mode == "class-blind"
                    else (r.randint(0, 4, k).astype(np.float64), 1e-8))
        got = detection._greedy_nms(lo, hi, score, 0.25, cls=cls, union_eps=eps)
        want = native.greedy_nms_plain(lo, hi, cls, np.argsort(score), 0.25, eps)
        assert got == want.tolist(), trial
        assert got == jax_detection._greedy_nms(lo, hi, score, 0.25, cls=cls, union_eps=eps)


def test_nms_suppresses_nan_overlaps_as_the_matrix_version_does():
    """Zero-volume boxes at union_eps 0: 0/0 overlaps are suppressed on
    both sides; 2-D boxes too."""
    lo = np.zeros((4, 2))
    hi = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [2.0, 2.0]])
    order = np.array([0, 1, 2, 3])
    for cls in (None, np.array([0.0, 0.0, 1.0, 1.0])):
        got = native.greedy_nms_native(lo, hi, cls, order, 0.25, 0.0)
        assert np.array_equal(got, native.greedy_nms_plain(lo, hi, cls, order, 0.25, 0.0))


def test_remove_empty_box_counts_in_the_library(monkeypatch):
    """The prediction mask without a precomputed ``nonempty_box`` counts
    each box's points in the library: its predictions equal those with the
    broadcast test in its place and the JAX package's, and no box of fewer
    than 5 points survives."""
    r = np.random.RandomState(2)
    b, k, n = 2, 16, 3000
    pc = (r.rand(b, n, 3) * 4).astype(np.float32)
    c = (r.rand(b, k, 3) * 4).astype(np.float32)
    s = (0.02 + r.rand(b, k, 3) * 0.8).astype(np.float32)
    ep = {"bbox_lo": c - s / 2, "bbox_hi": c + s / 2, "point_clouds": pc,
          "sem_cls_scores": r.randn(b, k, 18).astype(np.float32),
          "objectness_scores": r.randn(b, k, 2).astype(np.float32)}
    config = {"remove_empty_box": True, "use_3d_nms": True, "nms_iou": 0.25,
              "use_old_type_nms": False, "cls_nms": True, "per_class_proposal": True,
              "conf_thresh": 0.05, "dataset_config": ScannetDatasetConfig()}
    nonempty = np.stack([native.points_in_boxes_plain(pc[i], ep["bbox_lo"][i],
                                                      ep["bbox_hi"][i]) >= 5 for i in range(b)])
    assert (0 < nonempty.sum(-1)).all() and nonempty.sum() < b * k
    got = detection._pred_mask(dict(ep), config)[0]
    want = jax_detection._pred_mask(dict(ep), config)[0]
    monkeypatch.setattr(native, "points_in_boxes_native", native.points_in_boxes_plain)
    plain = detection._pred_mask(dict(ep), config)[0]
    assert np.array_equal(got, plain) and np.array_equal(got, want)
    assert got.any() and not (got.astype(bool) & ~nonempty).any()


def test_gather_rows_refuses_other_dtypes():
    with pytest.raises(TypeError, match="gather_rows"):
        native.gather_rows(np.zeros((4, 2), np.int32), np.arange(2))
    empty = native.gather_rows(np.zeros((0, 3), np.float32), np.zeros(0, np.int64))
    assert empty.shape == (0, 3)


@pytest.mark.parametrize("src_dtype", ["float32", "float64"])
def test_gather_rows_into_equals_its_plain_version(src_dtype):
    """A column range of random rows, cast to float32, into the columns of
    a wider destination (strided rows), equals the plain version's; the
    rest of the destination is untouched."""
    for seed in range(8):
        r = np.random.RandomState(seed)
        n, width = r.randint(1, 6000), r.randint(1, 140)
        src = (r.randn(n, width) * 10.0 ** r.randint(-3, 30)).astype(src_dtype)
        lo = r.randint(0, width)
        hi = r.randint(lo + 1, width + 1)
        idx = r.randint(0, n, r.randint(0, 5000))
        dst_width = r.randint(hi - lo, hi - lo + 20)
        col = r.randint(0, dst_width - (hi - lo) + 1)
        got = np.full((2, len(idx), dst_width), -1.5, np.float32)
        want = got.copy()
        native.gather_rows_into(src[:, lo:hi], idx, got[1, :, col:col + hi - lo])
        native.gather_rows_into_plain(src[:, lo:hi], idx, want[1, :, col:col + hi - lo])
        assert np.array_equal(got, want, equal_nan=True), seed
        assert np.array_equal(got[1, :, col:col + hi - lo], src[idx, lo:hi].astype(np.float32))


def test_gather_rows_into_refuses_other_dtypes_and_shapes():
    src, idx = np.zeros((10, 4), np.float32), np.arange(3)
    for bad in (np.zeros((10, 4), np.int32), np.zeros((10, 4), np.float16), np.zeros(10)):
        with pytest.raises(TypeError, match="gather_rows_into"):
            native.gather_rows_into(bad, idx, np.zeros((3, 4), np.float32))
    for out in (np.zeros((3, 4), np.float64), np.zeros((3, 5), np.float32),
                np.zeros((4, 4), np.float32)):
        with pytest.raises(ValueError, match="gather_rows_into"):
            native.gather_rows_into(src, idx, out)
    with pytest.raises(ValueError, match="contiguous"):
        native.gather_rows_into(src, idx, np.zeros((3, 8), np.float32)[:, ::2])
    with pytest.raises(IndexError, match="outside"):
        native.gather_rows_into(src, np.array([0, 10]), np.zeros((2, 4), np.float32))
    empty = native.gather_rows_into(src, np.zeros(0, np.int64), np.zeros((0, 4), np.float32))
    assert empty.shape == (0, 4)


COUNTING_CXX = textwrap.dedent("""\
    #!{python}
    import os, subprocess, sys, time
    with open({count!r}, "a") as f:
        f.write("compile\\n")
    time.sleep(0.5)
    sys.exit(subprocess.call(["g++", *sys.argv[1:]]))
""")
HOST_BUILD_SCRIPT = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from spacap3d_tpu_torch.ops import _build
    from spacap3d_tpu_torch.data import native
    _build.BUILD_DIR = Path(sys.argv[1])
    _build._cxx = lambda: sys.argv[2]
    r = __import__("numpy").random.RandomState(0)
    assert native.percentile_z(r.randn(100), 50.0) == native.percentile_plain(
        __import__("numpy").random.RandomState(0).randn(100), 50.0)
    print(_build.host_build())
""")


def test_host_library_builds_once_for_processes_started_together(tmp_path):
    """Four processes call a binding at once, with a compiler that counts
    its calls and takes half a second longer: one compile, one library
    path, which exists, and every process's binding works; no temporary
    file is left."""
    build, count = tmp_path / "build", tmp_path / "calls.txt"
    cxx = tmp_path / "g++"
    cxx.write_text(COUNTING_CXX.format(python=sys.executable, count=str(count)))
    cxx.chmod(0o755)
    procs = [subprocess.Popen([sys.executable, "-c", HOST_BUILD_SCRIPT, str(build), str(cxx)],
                              env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip().splitlines()[-1] for o, _ in outs}
    assert len(paths) == 1
    path = Path(paths.pop())
    assert path.exists() and path.name.startswith("libspacap_host-")
    assert count.read_text().splitlines() == ["compile"]
    assert sorted(p.name for p in build.iterdir()) == sorted([path.name, "host.lock"])


def test_host_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int f() { return undefined_name; }\n")
    monkeypatch.setattr(_build, "HOST_SOURCE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undefined_name"):
        _build.host_build()
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["host.lock"]
    monkeypatch.setattr(_build, "_cxx", lambda: (_ for _ in ()).throw(
        RuntimeError("g++ not found: the host library cannot be built")))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.host_build()


def test_host_library_is_named_by_its_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "a.cpp"
    src.write_text("extern \"C\" int f() { return 1; }\n")
    monkeypatch.setattr(_build, "HOST_SOURCE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.host_build()
    monkeypatch.setattr(_build, "HOST_FLAGS", [*_build.HOST_FLAGS, "-DX=1"])
    second = _build.host_build()
    src.write_text("extern \"C\" int f() { return 2; }\n")
    third = _build.host_build()
    assert len({first, second, third}) == 3 and all(p.exists() for p in (first, second, third))
